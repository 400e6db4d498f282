"""Static guard of the port's async serving pipeline.

The async engine's point is that plan and dispatch never wait for the
device.  One innocent ``.cpu()`` on a step output, or a host array moved
to the card with a blocking ``.to(device)``, would serialize host and
device again without failing any functional test.  The port's
counterpart of tests/test_async_guard.py scans every module of
``src/repro_torch/runtime/`` with the AST:

  * no device readback (``.cpu()``, ``.tolist()``, ``.item()``,
    ``.numpy()``) and no synchronize (``torch.cuda.synchronize``, an
    event's or a stream's ``.synchronize()``) outside a function marked
    ``@_drain_point`` (``runtime/telemetry.py``);
  * no copy to a device that blocks: every ``.to(<device>)`` carries
    ``non_blocking=True``, and no ``torch.tensor`` / ``torch.as_tensor``
    builds a tensor on a device from host data, outside drain points.

A positive control keeps the matcher honest, and the functions the AST
sees marked carry the marker on the live objects (and the hot paths do
not)."""

import ast
import importlib
import re
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUNTIME_DIR = ROOT / "src" / "repro_torch" / "runtime"

READBACKS = ("cpu", "tolist", "item", "numpy", "synchronize")
HOST_TO_DEVICE = ("tensor", "as_tensor")


def _is_drain_marked(fn) -> bool:
    for dec in fn.decorator_list:
        name = dec.id if isinstance(dec, ast.Name) else getattr(
            dec, "attr", None)
        if name == "_drain_point":
            return True
    return False


def _names(node) -> str:
    """The dotted text of a Name / Attribute chain ('' for others)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return f"{_names(node.value)}.{node.attr}"
    return ""


def _device_like(node) -> bool:
    """A ``.to()`` argument that names a device: a string, a
    ``torch.device(...)`` call, or a name whose last part says "dev"
    (``dev``, ``device``, ``self.device``); ``torch.int32`` and a
    ``dtype`` name do not."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return True
    if isinstance(node, ast.Call) and _names(node.func).endswith("device"):
        return True
    return "dev" in _names(node).split(".")[-1]


def _kw(call, name):
    return next((k.value for k in call.keywords if k.arg == name), None)


def _violation(call: ast.Call):
    """The message for a synchronizing call, or None."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return None
    if func.attr in READBACKS:
        return f".{func.attr}() synchronizes with the device"
    if func.attr == "to":
        dev = _kw(call, "device")
        if dev is None and call.args and _device_like(call.args[0]):
            dev = call.args[0]
        if dev is None:
            return None
        nb = _kw(call, "non_blocking")
        if not (isinstance(nb, ast.Constant) and nb.value is True):
            return ".to(<device>) without non_blocking=True blocks"
    if (func.attr in HOST_TO_DEVICE and _names(func.value) == "torch"
            and _kw(call, "device") is not None):
        return (f"torch.{func.attr}(..., device=) copies host data to the "
                "device and blocks")
    return None


def findings(source: str, path: str = "<src>"):
    """[(path, line, message)] for every synchronizing call outside a
    ``@_drain_point`` function (nested functions inherit the marker)."""
    out = []

    def visit(node, drained):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            drained = drained or _is_drain_marked(node)
        if isinstance(node, ast.Call) and not drained:
            msg = _violation(node)
            if msg:
                out.append((path, node.lineno, msg))
        for child in ast.iter_child_nodes(node):
            visit(child, drained)

    visit(ast.parse(source), False)
    return out


def _runtime_files():
    return sorted(RUNTIME_DIR.glob("*.py"))


def _marked(tree):
    """Qualified names of the ``@_drain_point`` functions of a module."""
    out = set()
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and _is_drain_marked(node):
            out.add(node.name)
        if isinstance(node, ast.ClassDef):
            out.update(f"{node.name}.{fn.name}" for fn in node.body
                       if isinstance(fn, ast.FunctionDef)
                       and _is_drain_marked(fn))
    return out


# ------------------------------------------------------- the tree is clean --

def test_no_sync_outside_drain_points():
    """The plan and dispatch path (step, _run_prefill, _run_decode,
    _compose_feed, admission, release, the telemetry hooks) never waits
    for the device."""
    found = []
    for path in _runtime_files():
        found += findings(path.read_text(), str(path.relative_to(ROOT)))
    assert found == [], "; ".join(f"{p}:{n}: {m}" for p, n, m in found)


def test_guard_covers_the_whole_runtime_tree():
    names = {p.name for p in _runtime_files()}
    assert {"engine.py", "telemetry.py", "paged_cache.py", "prefix_cache.py",
            "scheduler.py", "spec_decode.py"} <= names


# -------------------------------------------------------- positive control --

_BAD = textwrap.dedent("""\
    import torch

    class ServeEngine:
        def step(self):
            vals = self._tok.cpu()
            torch.cuda.synchronize()
            t = torch.from_numpy(self.table).to(self.device)
            u = torch.tensor(self.rows, device=self.device)
            return vals, t, u

        def peek(self, x, ev):
            ev.synchronize()
            return x.item(), x.tolist(), x.numpy(), x.to("cuda")
    """)

_GOOD = textwrap.dedent("""\
    import numpy as np
    import torch

    class ServeEngine:
        @_drain_point
        def _retire_one(self):
            self.event.synchronize()
            return self.host.tolist()

        @_drain_point
        def sample(self, pool):
            def read(name):
                return pool[name].cpu().numpy()
            return read("k")

        def _dispatch(self, table, dev):
            host = np.array(table)
            t = torch.from_numpy(host).pin_memory()
            return t.to(dev, non_blocking=True), t.to(torch.int32)
    """)


def test_guard_detects_synchronizing_calls():
    bad = findings(_BAD)
    assert [n for _, n, _ in bad] == [5, 6, 7, 8, 12, 13, 13, 13, 13]
    assert findings(_GOOD) == []


def test_module_level_functions_are_guarded_too():
    src = "def helper(x):\n    return x.cpu()\n"
    assert len(findings(src)) == 1


def test_legal_sites_are_visible_to_the_matcher():
    """The scan must SEE the sanctioned readbacks, or the clean result
    above could be vacuous: stripped of their markers, ``_retire_one``
    and the probe's ``sample`` are findings."""
    for rel, fn_name in (("engine.py", "_retire_one"),
                         ("telemetry.py", "sample")):
        src = re.sub(r"^\s*@_drain_point\n", "",
                     (RUNTIME_DIR / rel).read_text(), flags=re.M)
        lines = {n for _, n, _ in findings(src)}
        tree = ast.parse(src)
        fn = next(f for f in ast.walk(tree)
                  if isinstance(f, ast.FunctionDef) and f.name == fn_name)
        assert any(fn.lineno <= n <= fn.end_lineno for n in lines), rel


# -------------------------------------------------- runtime marker parity --

def test_runtime_markers_match_source():
    """The functions the AST sees marked carry ``__drain_point__`` on the
    live objects, no other function of the module does, and the hot paths
    are not quietly allowlisted."""
    for path in _runtime_files():
        mod = importlib.import_module(f"repro_torch.runtime.{path.stem}")
        marked = _marked(ast.parse(path.read_text()))
        live = set()
        for name, obj in vars(mod).items():
            if getattr(obj, "__module__", None) != mod.__name__:
                continue
            if getattr(obj, "__drain_point__", False):
                live.add(name)
            if isinstance(obj, type):
                live.update(f"{name}.{k}" for k, v in vars(obj).items()
                            if getattr(v, "__drain_point__", False))
        assert live == marked, (path.name, live, marked)
    from repro_torch.runtime.engine import ServeEngine
    from repro_torch.runtime.telemetry import NumericsProbe, Telemetry

    assert ServeEngine._retire_one.__drain_point__
    assert ServeEngine.drain.__drain_point__
    assert NumericsProbe.sample.__drain_point__
    for name in ("step", "_run_prefill", "_run_decode", "_compose_feed",
                 "_try_admit", "_tensor", "_ship", "cancel",
                 "_retire_backlog"):
        assert not getattr(getattr(ServeEngine, name), "__drain_point__",
                           False), name
    for name in ("end_step", "on_submit", "on_first_token",
                 "sample_numerics"):
        assert not getattr(getattr(Telemetry, name), "__drain_point__",
                           False), name
