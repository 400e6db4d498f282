"""Build the CUDA kernels with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` compiles into its own shared library with a plain
C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<digest>.so csrc/<name>.cu

Libraries are built on first use, only from the sources in this package,
into ``<repo>/build/repro_torch/`` (``REPRO_TORCH_BUILD_DIR`` overrides
it); the file name carries a digest of the sources and flags, so an edited
source is rebuilt.  ``build()`` starts one nvcc per source, all at once.
The compiler's register/shared-memory report goes to ``<lib>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("pasa_paged_decode", "pasa_paged_decode_fp16",
           "pasa_paged_decode_int8", "pasa_paged_decode_fp8",
           "pasa_paged_prefill", "pasa_paged_prefill_q8",
           "pasa_paged_prefill_wide", "pasa_paged_prefill_wide_q8",
           "pasa_decode_walk",
           "shift_kv", "pasa_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> the repository root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"lib{name}-{_digest()}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels that are not built yet, one nvcc each, all
    started together.  Returns {name: seconds from the start to that
    source's end} for the ones compiled; raises RuntimeError with the
    compiler's output if any build fails."""
    names = list(SOURCES if names is None else names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        log = open(target.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT, text=True,
        ), tmp, target, log)
    # each source's own seconds to its end
    times, errors = {}, []
    while len(times) < len(procs):
        for name, (proc, tmp, target, log) in procs.items():
            if name in times or proc.poll() is None:
                continue
            times[name] = time.perf_counter() - t0
            log.close()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n"
                              + target.with_suffix(".log").read_text())
                continue
            os.replace(tmp, target)
        time.sleep(0.05)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib
