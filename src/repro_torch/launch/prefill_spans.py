"""Where the paged prefill kernel's time goes, phase by phase, on the card.

    PYTHONPATH=src python -m repro_torch.launch.prefill_spans \
        [--cases serve_page16 serve_page16_int8 serve_page128] [--iters 5]

Builds ``pasa_paged_prefill.cu`` and ``pasa_paged_prefill_q8.cu`` with
``-DPASA_PREFILL_SPANS`` (one nvcc each, both at once) into
``<build dir>/spans/``.  Built so, the 128-row tile's converter thread 0
and the first consumer warpgroup's thread 0 of every CTA add the clock64
cycles since their previous mark to a span of the kernel's phases
(``pasa_paged_prefill.cuh``, "Cycle spans"), and count its stages and
pages.  The op then runs on these libraries at ``ab_kernels``' fixtures of
the paged serve's first prefill call (4 rows x 28 heads x 512 queries at
start 0, kv 512 / 512 / 300 / 129, KVH 4, D 128, fp16 PASA; pages 16, 8,
24, 64 and 128, bf16 and int8 pools).

For each case it prints one JSON line: the instrumented call's ms (CUDA
events; the marks cost time of their own, so compare shares, not this
against an uninstrumented run), and for the converter and the consumer
the cycles of each span summed over CTAs and calls, its share of that
thread's total, and its cycles per stage and per page.  Then the card's
name and power limit.  Needs one CUDA card; imports neither jax nor
``repro``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time

SPANS = {
    "converter": ("waiting for the pages", "km", "waiting for the operand stage",
                  "K' and V", "the hand-off"),
    "consumer": ("waiting for the stage", "the score GEMM", "sums and maxima",
                 "P", "P V issued", "the rows' step", "waiting for P V",
                 "the fold", "the rest"),
}
SOURCES = ("pasa_paged_prefill", "pasa_paged_prefill_q8")


def build_spans() -> dict:
    """The two prefill sources built with the span marks, loaded:
    {name: CDLL}."""
    from repro_torch.kernels import _build

    out = _build.build_dir() / "spans"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs, t0 = {}, time.perf_counter()
    for name in SOURCES:
        lib = out / f"lib{name}-{_build._digest()}.so"
        if lib.exists():
            continue
        cmd = [nvcc, *_build.NVCC_FLAGS, "-DPASA_PREFILL_SPANS", "-I",
               str(_build.CSRC), "-o", str(lib), str(_build.CSRC / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    if procs:
        print(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(procs)})")
    return {name: ctypes.CDLL(str(out / f"lib{name}-{_build._digest()}.so"))
            for name in SOURCES}


def read_spans(lib, name: str) -> list:
    """The library's 2 x 16 counters (then zeroed on the card)."""
    host = (ctypes.c_ulonglong * 32)()
    err = getattr(lib, f"{name}_spans")(host)
    if err:
        raise RuntimeError(f"{name}_spans: CUDA error {err}")
    return list(host)


def report(counters: list) -> dict:
    """The counters as {thread: {span: {cycles, share, per_stage,
    per_page}}, with the thread's stages and pages}."""
    out = {}
    for who, (thread, names) in enumerate(SPANS.items()):
        row = counters[16 * who:16 * who + 16]
        total = sum(row[:len(names)]) or 1
        stages, pages = row[14] or 1, row[15] or 1
        out[thread] = {"stages": row[14], "pages": row[15]}
        for k, span in enumerate(names):
            out[thread][span] = dict(cycles=row[k], share=row[k] / total,
                                     per_stage=row[k] / stages,
                                     per_page=row[k] / pages)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", nargs="*", default=None,
                    help="ab_kernels serve-call fixtures (default: all)")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("prefill_spans: no CUDA device available")
        return 2
    from repro_torch.kernels import _build
    from repro_torch.launch.ab_kernels import _serve_call_cases

    libs = build_spans()
    with _build._LOCK:   # the op loads these libraries from now on
        _build._LIBS.update(libs)
    dev = torch.device("cuda", 0)
    cases = _serve_call_cases(dev)
    for key, (call, _) in cases.items():
        case = key.split("/", 1)[1]
        if args.cases and case not in args.cases:
            continue
        name = "pasa_paged_prefill" + ("_q8" if "_int8" in case
                                       or "_fp8" in case else "")
        call()
        torch.cuda.synchronize()
        read_spans(libs[name], name)               # zeroed
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(args.iters):
            call()
        b.record()
        torch.cuda.synchronize()
        counters = read_spans(libs[name], name)
        print(json.dumps(dict(case=case, iters=args.iters,
                              ms=a.elapsed_time(b) / args.iters,
                              **report(counters))))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
