#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. the card's name and power limit (nvidia-smi), then the build of every
     CUDA kernel with nvcc from the sources in the checkout;
  2. each kernel against its plain PyTorch version on the card, at the
     serving path's shapes (qwen2-7b: KVH 4, G 7, D 128, page 128, fp16
     PASA policy, beta 0.984497), and against a float64 gold: max error,
     relative RMSE, and times (kernel, plain version, and one
     scaled_dot_product_attention call on the gathered K/V as a yardstick
     the port never calls);
  3. the serving path: qwen2-7b at full width (28 layers, random weights)
     answers four requests through ServeEngine, with both kernels' launch
     counts checked per device call; the same requests served one at a
     time must give identical streams.
The line before the last is a JSON object listing the kernels; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

BETA = 0.984497
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP16_FLOPS = 989e12        # dense fp16/bf16 tensor-core peak
DECODE_KV_LENS = (1, 127, 128, 1000, 4095)
PREFILL_STARTS = (0, 512, 1024)
PREFILL_CHUNK = 512
SERVE_PROMPTS = (1000, 517, 300, 129)
SERVE_GEN = 32
# tolerances of the reference's own kernel tests: decode kernel vs oracle
# (tests/test_paged.py), prefill kernel vs oracle (tests/test_prefix_cache
# .py); both fp16 kernels within relative RMSE 0.03 of exact attention
DECODE_TOL = dict(atol=3e-3, rtol=3e-2)
PREFILL_TOL = dict(atol=1e-2, rtol=3e-2)
RMSE_MAX = 0.03


def _cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _rel_rmse(a, gold) -> float:
    return float((a.double() - gold).norm() / gold.norm())


def _close(name, got, want, atol, rtol) -> float:
    import torch

    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside atol {atol} rtol "
            f"{rtol}; max abs error {float(err.max()):.3e}"
        )
    return float(err.max())


def _paged_pool(rng, seq_lens, kvh, d, page, mean_k, n_extra, dev):
    """Shuffled-page bf16 pool holding one sequence per entry of
    ``seq_lens``; every position at or past a sequence's length, and every
    unreferenced page, is NaN (stale bytes of recycled pages)."""
    import numpy as np
    import torch

    n_pages = [math.ceil(max(n, 1) / page) for n in seq_lens]
    mp = max(n_pages)
    total = 1 + sum(n_pages) + n_extra
    ids = rng.permutation(np.arange(1, total))
    table = np.zeros((len(seq_lens), mp), np.int32)
    k = np.full((total, page, kvh, d), np.nan, np.float32)
    v = np.full((total, page, kvh, d), np.nan, np.float32)
    nxt = 0
    for b, (n, npg) in enumerate(zip(seq_lens, n_pages)):
        for j in range(npg):
            pid = int(ids[nxt])
            nxt += 1
            table[b, j] = pid
            rows = max(0, min(page, n - j * page))
            k[pid, :rows] = rng.standard_normal((rows, kvh, d)) + mean_k
            v[pid, :rows] = rng.standard_normal((rows, kvh, d))
    to = lambda a, dt: torch.from_numpy(a).to(device=dev, dtype=dt)
    return to(k, torch.bfloat16), to(v, torch.bfloat16), to(table, torch.int32)


def _gathered(pages, table, n):
    """One sequence's first n positions: (KVH, n, D) float64."""
    import torch

    flat = pages[table.long()].reshape(-1, *pages.shape[2:])[:n]
    return flat.movedim(0, 1).to(torch.float64)


def check_decode(dev):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core.precision import FP16
    from repro_torch.kernels import ops, pasa_paged_decode as mod

    kvh, g, d, page = 4, 7, 128, 128
    b = len(DECODE_KV_LENS)
    rng = np.random.default_rng(1)
    kp, vp, table = _paged_pool(rng, DECODE_KV_LENS, kvh, d, page, 30.0, 3, dev)
    kv_len = torch.tensor(DECODE_KV_LENS, dtype=torch.int32, device=dev)
    plain_args = lambda *t: mod.paged_decode_plain(
        *t, beta=BETA, policy=FP16, block_kv=page)

    def gold_of(q):
        golds = []
        for i, n in enumerate(DECODE_KV_LENS):
            kk = _gathered(kp, table[i], n)
            vv = _gathered(vp, table[i], n)
            s = q[i].double() @ kk.transpose(-1, -2) / math.sqrt(d)
            golds.append(torch.softmax(s, -1) @ vv)
        return torch.stack(golds)

    stress = {}
    for q_mean in (1.0, 0.0):      # the held fixture last: timed below
        q = torch.from_numpy(
            rng.standard_normal((b, kvh, g, d)).astype(np.float32) + q_mean
        ).to(device=dev, dtype=torch.float16)
        got = ops.pasa_paged_decode(q, kp, vp, table, kv_len, beta=BETA,
                                    policy=FP16)
        plain = plain_args(q, kp, vp, table, kv_len)
        cpu = plain_args(*(t.cpu() for t in (q, kp, vp, table, kv_len)))
        torch.cuda.synchronize()
        gold = gold_of(q)
        rmse, rmse_plain = _rel_rmse(got, gold), _rel_rmse(plain, gold)
        if not (rmse < RMSE_MAX and rmse_plain < RMSE_MAX):
            raise AssertionError(
                f"decode RMSE {rmse:.4f} / plain {rmse_plain:.4f}")
        err_cpu = float((got.cpu().float() - cpu.float()).abs().max())
        if q_mean == 0.0:
            # the held fixture: kernel vs plain on the card, at tolerance
            max_err = _close("pasa_paged_decode", got, plain, **DECODE_TOL)
            held = dict(rmse=rmse, rmse_plain=rmse_plain, err_cpu=err_cpu)
        else:
            # stress fixture (sbar ~ 5 at fp16: one ulp of sbar moves a
            # page's weight by exp(inva * ulp) ~ exp(0.25)); reported only
            stress = dict(
                q_mean=q_mean, rmse=rmse, rmse_plain=rmse_plain,
                max_abs_err=float((got.float() - plain.float()).abs().max()),
                max_abs_err_cpu_plain=err_cpu,
            )
    rmse, rmse_plain, err_cpu = held["rmse"], held["rmse_plain"], held["err_cpu"]

    call = lambda: ops.pasa_paged_decode(
        q, kp, vp, table, kv_len, beta=BETA, policy=FP16
    )
    ms = _cuda_time_ms(call, 50)
    plain_ms = _cuda_time_ms(lambda: mod.paged_decode_plain(
        q, kp, vp, table, kv_len, beta=BETA, policy=FP16, block_kv=page
    ), 3, warmup=1)
    # yardstick: SDPA over the gathered view (the gather is not timed)
    mp = table.shape[1]
    kg, vg = (
        torch.nan_to_num(x[table.long()].reshape(b, mp * page, kvh, d)
                         .movedim(1, 2).half()).repeat_interleave(g, 1)
        for x in (kp, vp)
    )
    mask = (torch.arange(mp * page, device=dev)[None, :] < kv_len[:, None])
    mask = mask[:, None, None, :]
    qh = q.reshape(b, kvh * g, 1, d)
    lib_ms = _cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qh, kg, vg, attn_mask=mask
    ), 20)
    live = sum(DECODE_KV_LENS)
    nbytes = (2 * live * kvh * d * 2          # live K and V rows, bf16
              + 2 * q.numel() * 2             # q in, out
              + table.numel() * 4 + b * 4)
    flops = 4 * g * d * live * kvh
    return dict(
        name="pasa_paged_decode", route="cuda",
        source="src/repro_torch/kernels/csrc/pasa_paged_decode.cu",
        replaces="src/repro/kernels/pasa_paged_decode.py:196",
        max_abs_err=max_err, rmse=rmse, rmse_plain=rmse_plain,
        max_abs_err_cpu_plain=err_cpu, stress=stress,
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        **_bound(nbytes, flops),
    )


def check_prefill(dev):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core.precision import FP16
    from repro_torch.kernels import ops, pasa_paged_prefill as mod

    h, kvh, d, page, cs = 28, 4, 128, 128, PREFILL_CHUNK
    starts = list(PREFILL_STARTS) + [0]
    # full chunks at 0 and 512, a ragged last chunk at 1024, one pad row
    kv_lens = [512, 1024, 1024 + 300, 0]
    b = len(starts)
    rng = np.random.default_rng(2)
    kp, vp, table = _paged_pool(rng, kv_lens, kvh, d, page, 2.0, 2, dev)
    table[3] = 0                                   # pad row: all-null table
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    kv_len = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    q = torch.from_numpy(
        rng.standard_normal((b, h, cs, d)).astype(np.float32) + 1.0
    ).to(device=dev, dtype=torch.float16)

    got = ops.pasa_paged_prefill(q, kp, vp, table, start, kv_len, beta=BETA,
                                 policy=FP16)
    plain = mod.paged_prefill_plain(q, kp, vp, table, start, kv_len,
                                    beta=BETA, policy=FP16)
    cpu = mod.paged_prefill_plain(
        *(t.cpu() for t in (q, kp, vp, table, start, kv_len)),
        beta=BETA, policy=FP16)
    torch.cuda.synchronize()
    max_err = _close("pasa_paged_prefill", got, plain, **PREFILL_TOL)
    err_cpu = float((got.cpu().float() - cpu.float()).abs().max())
    if got[3].abs().max() != 0:
        raise AssertionError("prefill pad row (kv_len 0) is not zero")
    golds = []
    for i in range(3):
        n = kv_lens[i]
        kk = _gathered(kp, table[i], n).repeat_interleave(h // kvh, 0)
        vv = _gathered(vp, table[i], n).repeat_interleave(h // kvh, 0)
        s = q[i].double() @ kk.transpose(-1, -2) / math.sqrt(d)
        qpos = starts[i] + torch.arange(cs, device=dev)[:, None]
        s = s.masked_fill(qpos < torch.arange(n, device=dev)[None, :], -math.inf)
        golds.append(torch.softmax(s, -1) @ vv)
    gold = torch.stack(golds)
    rmse = _rel_rmse(got[:3], gold)
    rmse_plain = _rel_rmse(plain[:3], gold)
    if not (rmse < RMSE_MAX and rmse_plain < RMSE_MAX):
        raise AssertionError(f"prefill RMSE {rmse:.4f} / plain {rmse_plain:.4f}")
    # bits inside the port: the kernel is invariant to the chunk schedule
    half = cs // 2
    a = ops.pasa_paged_prefill(q[:1, :, :half], kp, vp, table[:1], start[:1],
                               start[:1] + half, beta=BETA, policy=FP16)
    c = ops.pasa_paged_prefill(q[:1, :, half:], kp, vp, table[:1],
                               start[:1] + half, kv_len[:1], beta=BETA,
                               policy=FP16)
    if not torch.equal(torch.cat([a, c], 2), got[:1]):
        raise AssertionError("prefill kernel is not chunk-schedule invariant")

    call = lambda: ops.pasa_paged_prefill(q, kp, vp, table, start, kv_len,
                                          beta=BETA, policy=FP16)
    ms = _cuda_time_ms(call, 20)
    plain_ms = _cuda_time_ms(lambda: mod.paged_prefill_plain(
        q, kp, vp, table, start, kv_len, beta=BETA, policy=FP16
    ), 3, warmup=1)
    mp = table.shape[1]
    kg, vg = (
        torch.nan_to_num(x[table.long()].reshape(b, mp * page, kvh, d)
                         .movedim(1, 2).half()).repeat_interleave(h // kvh, 1)
        for x in (kp, vp)
    )
    col = torch.arange(mp * page, device=dev)
    qpos = start[:, None] + torch.arange(cs, device=dev)[None, :]
    mask = (col[None, None, :] <= qpos[:, :, None]) & (
        col[None, None, :] < kv_len[:, None, None])
    lib_ms = _cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q, kg, vg, attn_mask=mask[:, None]
    ), 10)
    visible = 0
    for s0, n in zip(starts, kv_lens):
        if n > 0:
            visible += sum(min(s0 + i + 1, n) for i in range(cs))
    live = sum(kv_lens)
    nbytes = (2 * live * kvh * d * 2 + 2 * q.numel() * 2
              + table.numel() * 4 + 2 * b * 4)
    flops = 4 * d * h * visible
    return dict(
        name="pasa_paged_prefill", route="cuda",
        source="src/repro_torch/kernels/csrc/pasa_paged_prefill.cu",
        replaces="src/repro/kernels/pasa_paged_prefill.py:368",
        max_abs_err=max_err, rmse=rmse, rmse_plain=rmse_plain,
        max_abs_err_cpu_plain=err_cpu,
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        **_bound(nbytes, flops),
    )


def _bound(nbytes: int, flops: int) -> dict:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP16_FLOPS * 1e3
    return dict(
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=nbytes, flops=flops,
    )


def serve(dev):
    """qwen2-7b at full width through the engine; returns the report."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model_zoo import build
    from repro_torch.runtime import ServeEngine

    cfg = get_config("qwen2-7b")
    bundle = build(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in SERVE_PROMPTS]

    finite = []

    def checked(step):
        def run(*a):
            logits, pool = step(*a)
            finite.append(torch.isfinite(logits).all())
            return logits, pool
        return run

    bundle = dataclasses.replace(
        bundle,
        paged_serve_step=checked(bundle.paged_serve_step),
        paged_prefill_step=checked(bundle.paged_prefill_step),
    )
    total = max(SERVE_PROMPTS) + SERVE_GEN
    kw = dict(max_batch=4, page_size=128, prefill_chunk=512, prefill_batch=4,
              num_pages=1 + sum(math.ceil((n + SERVE_GEN - 1) / 128)
                                for n in SERVE_PROMPTS),
              max_seq_len=total)

    def run(prompt_list):
        eng = ServeEngine(bundle, params, **kw)
        reqs = [eng.submit(p, SERVE_GEN) for p in prompt_list]
        marks = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while not eng.idle:
            calls = (eng.prefill_calls, eng.decode_calls)
            eng.step()                     # ends in the step's readback
            marks.append((time.perf_counter() - t0, calls,
                          (eng.prefill_calls, eng.decode_calls)))
        return eng, reqs, marks

    # warm-up serve of one short request (cuBLAS and kernel first calls)
    run([prompts[-1][:64]])
    ops.reset_launches()
    eng, reqs, marks = run(prompts)
    launches = {"pasa_paged_prefill": ops.pasa_paged_prefill.launches,
                "pasa_paged_decode": ops.pasa_paged_decode.launches}
    n_layers = cfg.n_layers
    if launches["pasa_paged_prefill"] != n_layers * eng.prefill_calls or \
            launches["pasa_paged_decode"] != n_layers * eng.decode_calls:
        raise AssertionError(
            f"launch counts {launches} != {n_layers} x "
            f"({eng.prefill_calls} prefill, {eng.decode_calls} decode) calls"
        )
    if eng.prefill_calls == 0 or eng.decode_calls == 0:
        raise AssertionError("the serve made no prefill or no decode call")
    if not bool(torch.stack(finite).all()):
        raise AssertionError("non-finite logits in the serve")
    streams = [r.generated for r in reqs]
    for s in streams:
        if len(s) != SERVE_GEN or not all(0 <= t < cfg.vocab_size for t in s):
            raise AssertionError(f"bad stream {s}")
    peak = torch.cuda.max_memory_allocated()
    wall = marks[-1][0]
    ttft = [marks[r.first_token_step][0] for r in reqs]
    decode_only = [
        marks[i][0] - (marks[i - 1][0] if i else 0.0)
        for i in range(len(marks))
        if marks[i][2][0] == marks[i][1][0] and marks[i][2][1] > marks[i][1][1]
    ]
    # one at a time: identical streams
    for p, want in zip(prompts, streams):
        _, (r,), _ = run([p])
        if r.generated != want:
            raise AssertionError(
                f"batched vs one-at-a-time streams differ: {want} vs "
                f"{r.generated}"
            )
    n_tok = sum(len(s) for s in streams)
    return dict(
        arch=cfg.arch_id, layers=n_layers, d_model=cfg.d_model,
        prompts=list(SERVE_PROMPTS), gen=SERVE_GEN, steps=eng.steps,
        prefill_calls=eng.prefill_calls, decode_calls=eng.decode_calls,
        launches=launches, wall_s=wall, tok_per_s=n_tok / wall,
        ttft_ms=[1e3 * t for t in ttft],
        decode_ms_per_step=1e3 * sum(decode_only) / max(len(decode_only), 1),
        peak_gb=peak / 1e9, init_s=init_s,
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(built)} "
          f"into {_build.build_dir()}")
    for name in _build.SOURCES:
        log = _build.library_path(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

    kernels = [check_decode(dev), check_prefill(dev)]
    for k in kernels:
        print(f"{k['name']}: max_abs_err {k['max_abs_err']:.3e}, rmse "
              f"{k['rmse']:.4f} (plain {k['rmse_plain']:.4f}), {k['ms']:.4f} "
              f"ms vs plain {k['plain_ms']:.3f} ms, sdpa {k['library_ms']:.4f} "
              f"ms, bound {k['bound_ms']:.4f} ms ({k['bound_by']}); max abs "
              f"diff vs the plain version on the CPU "
              f"{k['max_abs_err_cpu_plain']:.3e}")
        if k.get("stress"):
            print(f"  {k['name']} stress fixture: {json.dumps(k['stress'])}")

    rep = serve(dev)
    print("serve: " + json.dumps(rep))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for k in kernels:
        k["launches"] = rep["launches"][k["name"]]
    print(json.dumps({"kernels": [{key: k[key] for key in keys}
                                  for k in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
