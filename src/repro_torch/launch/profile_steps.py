"""Where the device time of the two serving calls goes, on the card.

Builds qwen2-7b (full width; ``--layers`` cuts depth) with random weights,
prefills four prompts of 1000/517/300/129 tokens in 512-token chunks
through ``prefill_step_paged`` exactly as ``ServeEngine`` batches them,
then decodes.  The first prefill call and ``--decode-calls`` decode calls
run under ``torch.profiler`` (CPU + CUDA activities, after a warm-up of
each).  For each call type it prints the wall time per call (timed once
without the profiler, then under it), the device time per call by kernel
category (the two PASA kernels, GEMMs, the rest) and the device's idle
share of the unprofiled wall time, and writes the Chrome traces under
``--out``.

Run on one card from the repository root:
  PYTHONPATH=src python -m repro_torch.launch.profile_steps --out build/profile
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from pathlib import Path

PROMPTS = (1000, 517, 300, 129)
CHUNK = 512
PAGE = 128


def _category(name: str) -> str:
    low = name.lower()
    if "paged_decode_kernel" in low:
        return "pasa_paged_decode"
    if "paged_prefill_kernel" in low:
        return "pasa_paged_prefill"
    if any(s in low for s in ("gemm", "gemv", "cutlass", "xmma", "nvjet",
                              "cublas", "sm90_")):
        return "gemm"
    return "other"


def _profile(fn, n_calls: int, trace: Path) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_calls):
        fn()
    torch.cuda.synchronize()
    plain_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    prof.export_chrome_trace(str(trace))
    by_cat = {}
    spans = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = e.time_range.elapsed_us()
        cat = _category(e.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + dur
        spans.append((e.time_range.start, e.time_range.end))
    # busy time = union of kernel intervals (one stream: they do not overlap)
    busy, end = 0.0, -math.inf
    for s, e in sorted(spans):
        if s >= end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    # the profiler slows the host; the idle share is taken against the
    # wall time of the same calls run without it
    return {
        "calls": n_calls,
        "wall_ms_per_call": plain_us / n_calls / 1e3,
        "wall_ms_per_call_profiled": wall_us / n_calls / 1e3,
        "device_busy_ms_per_call": busy / n_calls / 1e3,
        "device_idle_share": 1.0 - busy / plain_us,
        "device_ms_per_call": {k: v / n_calls / 1e3 for k, v in
                               sorted(by_cat.items())},
        "trace": str(trace),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers (default: all 28)")
    ap.add_argument("--decode-calls", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build

    dev = resolve_device("cuda")
    cfg = get_config("qwen2-7b")
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    bundle = build(cfg)
    params = bundle.init(torch.Generator(device=dev).manual_seed(args.seed), dev)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in PROMPTS]
    n_pages = [math.ceil((n + args.decode_calls + 8) / PAGE) for n in PROMPTS]
    pool = bundle.init_paged_cache(1 + sum(n_pages), PAGE, device=dev)
    mp = max(n_pages)
    table = np.zeros((len(PROMPTS), mp), np.int32)
    nxt = 1
    for b, n in enumerate(n_pages):
        table[b, :n] = np.arange(nxt, nxt + n)
        nxt += n
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    table_t = to(table)

    def prefill_inputs(c0):
        b = len(PROMPTS)
        tokens = np.zeros((b, CHUNK), np.int32)
        start = np.zeros(b, np.int32)
        kv_len = np.zeros(b, np.int32)
        last = np.zeros(b, np.int32)
        rows = np.zeros((b, mp), np.int32)
        for i, p in enumerate(prompts):
            real = max(0, min(CHUNK, len(p) - c0))
            if real:
                tokens[i, :real] = p[c0:c0 + real]
                start[i], kv_len[i], last[i] = c0, c0 + real, real - 1
                rows[i] = table[i]
        return [to(x) for x in (tokens, start, kv_len, last)] + [to(rows)]

    first = prefill_inputs(0)
    call_prefill = lambda: bundle.paged_prefill_step(
        params, *first[:4], pool, first[4])
    call_prefill()                                   # warm-up
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    report = {"arch": cfg.arch_id, "layers": cfg.n_layers,
              "device": torch.cuda.get_device_name(0)}
    report["prefill"] = _profile(call_prefill, 1, out / "trace_prefill.json")
    for c0 in range(CHUNK, max(PROMPTS), CHUNK):      # finish every prompt
        nxt_in = prefill_inputs(c0)
        bundle.paged_prefill_step(params, *nxt_in[:4], pool, nxt_in[4])
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
    token = torch.zeros(len(PROMPTS), dtype=torch.int32, device=dev)

    def call_decode():
        nonlocal pos, token
        logits, _ = bundle.paged_serve_step(params, token, pos, pool, table_t)
        token = torch.argmax(logits, -1).to(torch.int32)
        pos = pos + 1

    call_decode()                                    # warm-up
    kv_start = [int(x) + 1 for x in pos.tolist()]
    report["decode"] = _profile(call_decode, args.decode_calls,
                                out / "trace_decode.json")
    report["decode"]["kv_len_at_first_call"] = kv_start
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
