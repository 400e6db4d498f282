"""The port stands alone: no module under src/repro_torch/, nor
chip_smoke.py, imports jax or anything of the reference package."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_the_scan_sees_the_port():
    assert len(FILES) > 15
    assert any(p.name == "engine.py" for p in FILES)
    assert any(p.name == "prefix_cache.py" for p in FILES)
    assert any(p.name == "telemetry.py" for p in FILES)
    assert any(p.name == "multimodal.py" for p in FILES)
    assert any(p.name == "moe.py" for p in FILES)


@pytest.mark.parametrize(
    "path", FILES, ids=[str(p.relative_to(ROOT)) for p in FILES]
)
def test_module_imports_neither_jax_nor_the_reference(path):
    bad = sorted({m for m in _imported_modules(path) if _forbidden(m)})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
