#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. the card's name and power limit (nvidia-smi), then the build of every
     CUDA kernel with nvcc from the sources in the checkout;
  2. each kernel against its plain PyTorch version on the card, at the
     serving paths' shapes (qwen2-7b: H 28, KVH 4, G 7, D 128, block and
     page 128, fp16 PASA policy, beta 0.984497), and against a float64
     gold: max error, relative RMSE, and times (kernel, plain version,
     and one PyTorch call computing the same function - a
     scaled_dot_product_attention or a matmul - as a yardstick the port
     never calls).  The paged decode and prefill kernels, then shift-KV,
     the PASA attention kernel (with its FlashAttention-2 setting and the
     paper's fp16 overflow headline) and the contiguous decode kernel
     (bit for bit against the paged one on the same rows);
  3. the paged serving path: qwen2-7b at full width (28 layers, random
     weights) answers four requests through ServeEngine, with both paged
     kernels' launch counts checked per device call; the same requests
     served one at a time must give identical streams;
  4. the dense serving path (the default route of launch/serve.py) with
     the same weights: four 1000-token prompts in one fused prefill, then
     greedy decode to 32 tokens each; shift-KV and PASA attention launch
     28 times per prefill call, the contiguous decode kernel 28 times per
     decode call, the paged kernels never; each prompt served alone gives
     the same stream as in the batch.
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
SPIN_CYCLES_PER_S = 1.98e9      # H100 SXM boost clock: cycles of torch.cuda._sleep
DECODE_KV_LENS = (1, 127, 128, 1000, 4095)
PREFILL_STARTS = (0, 512, 1024)
PREFILL_CHUNK = 512
SERVE_PROMPTS = (1000, 517, 300, 129)
SERVE_GEN = 32
DENSE_BATCH, DENSE_PROMPT = 4, 1000
ATTN_SHAPE = (4, 28, 4, 1024, 128)   # B, H, KVH, S, D: the dense prefill's
# tolerances of the reference's own kernel tests: decode kernel vs oracle
# (tests/test_paged.py), prefill kernel vs oracle (tests/test_prefix_cache
# .py); both fp16 kernels within relative RMSE 0.03 of exact attention
DECODE_TOL = dict(atol=3e-3, rtol=3e-2)
PREFILL_TOL = dict(atol=1e-2, rtol=3e-2)
RMSE_MAX = 0.03
# the reference's own bars for the dense-route kernels (tests/test_kernels
# .py): shift-KV vs its oracle; attention vs its oracle, causal and not;
# FlashAttention-2 vs its oracle; PASA within relative RMSE 0.02 of exact
SHIFT_TOL = dict(atol=1e-2, rtol=0.0)
ATTN_CAUSAL_TOL = dict(atol=2e-3, rtol=2e-2)
ATTN_TOL = dict(atol=8e-3, rtol=2e-2)
FLASH_TOL = dict(atol=2e-3, rtol=2e-2)
ATTN_RMSE_MAX = 0.02
# shift-KV's fp16 output vs the float64 algebraic shift: the rounding of
# M's two entries and of the store, a few 1e-4 relative
SHIFT_RMSE_MAX = 1e-2


def _cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time per call of ``fn``, from CUDA events around ``iters``
    calls.  The calls are queued behind a spin kernel that lasts twice the
    host's time to issue them, so the events time the device running them
    back to back and not the host's launch rate (a 10-microsecond kernel
    issued through a Python wrapper is otherwise timed as the wrapper)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0 * iters * host_s, 2.0) * SPIN_CYCLES_PER_S))
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


def _randn(rng, shape, mean, dev, dtype):
    import numpy as np
    import torch

    x = rng.standard_normal(shape).astype(np.float32) + mean
    return torch.from_numpy(x).to(device=dev, dtype=dtype)


def check_shift_kv(dev):
    import numpy as np
    import torch

    from repro_torch.core.precision import FP16
    from repro_torch.core.shifting import shift_kv_reference
    from repro_torch.kernels import ops, shift_kv as mod

    b, _, kvh, s, d = ATTN_SHAPE
    rng = np.random.default_rng(3)
    # the dense prefill's keys: bf16 (B, S, KVH, D), read as (B, KVH, S, D)
    k = _randn(rng, (b, s, kvh, d), 5.0, dev, torch.bfloat16).transpose(1, 2)
    m = mod.device_matrix(128, d, BETA, torch.float16, dev)
    got = ops.shift_kv(k, beta=BETA, block_kv=128, policy=FP16)
    plain = mod.shift_kv_plain(m, k.to(torch.float16), 128)
    torch.cuda.synchronize()
    max_err = _close("shift_kv", got, plain, **SHIFT_TOL)
    rmse = _rel_rmse(got, shift_kv_reference(k.to(torch.float16), d, BETA, 128))
    if not rmse < SHIFT_RMSE_MAX:
        raise AssertionError(f"shift_kv RMSE {rmse:.2e} vs float64")
    ms = _cuda_time_ms(lambda: ops.shift_kv(k, beta=BETA, policy=FP16), 50)
    plain_ms = _cuda_time_ms(
        lambda: mod.shift_kv_plain(m, k.to(torch.float16), 128), 20)
    kb = k.to(torch.float16).contiguous().reshape(b, kvh, s // 128, 128, d)
    lib_ms = _cuda_time_ms(lambda: torch.matmul(m, kb), 50)
    nbytes = 2 * k.numel() * 2 + m.numel() * 2    # bf16 in, fp16 out, M
    flops = 2 * 128 * k.numel()
    return dict(
        name="shift_kv", route="cuda",
        source="src/repro_torch/kernels/csrc/shift_kv.cu",
        replaces="src/repro/kernels/shift_kv.py:48",
        max_abs_err=max_err, rmse=rmse, ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, **_bound(nbytes, flops),
    )


def _gold_attention(q, k, v, causal):
    """float64 softmax(q k^T / sqrt(d)) v, K/V expanded to q's heads, one
    batch row at a time (bounded memory)."""
    import torch

    g = q.shape[1] // k.shape[1]
    outs = []
    for i in range(q.shape[0]):
        qq = q[i].double()
        kk = k[i].double().repeat_interleave(g, 0)
        vv = v[i].double().repeat_interleave(g, 0)
        sc = qq @ kk.transpose(-1, -2) / math.sqrt(q.shape[-1])
        if causal:
            n = sc.shape[-1]
            sc = sc.masked_fill(
                torch.ones(n, n, dtype=torch.bool, device=q.device).triu(1),
                -math.inf)
        outs.append(torch.softmax(sc, -1) @ vv)
    return torch.stack(outs)


def check_attention(dev):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core.precision import FP16, FP16_FP32
    from repro_torch.core.shifting import effective_invariance
    from repro_torch.kernels import ops, pasa_attention as mod

    b, h, kvh, s, d = ATTN_SHAPE
    rng = np.random.default_rng(4)
    half = torch.float16
    k = _randn(rng, (b, kvh, s, d), 2.0, dev, half)
    v = _randn(rng, (b, kvh, s, d), 0.0, dev, half)
    report = {}
    # the held fixture has queries of mean 0; queries of mean 2 as well
    # (the reference's test_kernels fixture at 1/1000 of this size) are
    # reported only: there sbar ~ 0.7, one fp16 ulp of sbar moves a
    # block's weight by exp(inva * ulp) ~ 3 %, and the two GEMM summation
    # orders round a few sbar values apart
    for q_mean in (2.0, 0.0):
        q = _randn(rng, (b, h, s, d), q_mean, dev, half)
        for causal, tol in ((False, ATTN_TOL), (True, ATTN_CAUSAL_TOL)):
            got = ops.pasa_attention(q, k, v, beta=BETA, policy=FP16,
                                     causal=causal)
            plain = mod.attention_plain(q, k, v, beta=BETA, policy=FP16,
                                        block_kv=128, causal=causal)
            torch.cuda.synchronize()
            tag = ("causal" if causal else "full") + (
                "" if q_mean == 0.0 else f"_q_mean_{q_mean:g}")
            gold = _gold_attention(q, k, v, causal)
            report[f"rmse_{tag}"] = _rel_rmse(got, gold)
            report[f"rmse_plain_{tag}"] = _rel_rmse(plain, gold)
            del gold
            if q_mean != 0.0:
                err = (got.float() - plain.float()).abs()
                report[f"max_abs_err_{tag}"] = float(err.max())
                report[f"outside_tol_{tag}"] = int(
                    (err > tol["atol"] + tol["rtol"] * plain.float().abs())
                    .sum())
                continue
            report[f"max_abs_err_{tag}"] = _close(
                f"pasa_attention ({tag})", got, plain, **tol)
            if not report[f"rmse_{tag}"] < ATTN_RMSE_MAX:
                raise AssertionError(f"pasa_attention ({tag}) RMSE "
                                     f"{report[f'rmse_{tag}']:.4f}")
    # FlashAttention-2 at fp16_fp32 on zero-mean inputs (the reference's
    # flash test) against its plain version
    qf = _randn(rng, (b, h, s, d), 0.0, dev, half)
    kf = _randn(rng, (b, kvh, s, d), 0.0, dev, half)
    got = ops.flash_attention(qf, kf, v, policy=FP16_FP32, causal=True)
    plain = mod.attention_plain(qf, kf, v, beta=0.0, policy=FP16_FP32,
                                block_kv=128, causal=True)
    torch.cuda.synchronize()
    report["flash_max_abs_err"] = _close("flash_attention", got, plain,
                                         **FLASH_TOL)
    report["flash_ms"] = _cuda_time_ms(lambda: ops.flash_attention(
        qf, kf, v, policy=FP16_FP32, causal=True), 20)
    # the paper's headline on the card: inputs near 30 overflow the fp16
    # score store of FlashAttention-2; PASA at all-fp16 stays finite
    u = lambda: torch.from_numpy(rng.uniform(29.5, 30.5, (1, 2, 256, 128))
                                 .astype(np.float32)).to(dev, half)
    qo, ko, vo = u(), u(), u()
    bad = ops.flash_attention(qo, ko, vo, policy=FP16_FP32)
    good = ops.pasa_attention(qo, ko, vo, beta=BETA, policy=FP16)
    if bool(torch.isfinite(bad.float()).all()):
        raise AssertionError("FlashAttention-2 at fp16 did not overflow")
    if not bool(torch.isfinite(good.float()).all()):
        raise AssertionError("PASA at fp16 is not finite on inputs near 30")
    report["overflow_headline"] = "flash non-finite, pasa finite"

    # times on the path's call: the causal prefill; `ms` is the attention
    # kernel alone on the shifted keys, the plain version includes the
    # shift as ops.pasa_attention's oracle does
    k_sh = ops.shift_kv(k, beta=BETA, policy=FP16)
    inva = effective_invariance(128, d, BETA, torch.float16)
    ms = _cuda_time_ms(lambda: mod.kernel_call(
        q, k_sh, v, beta=BETA, inva=inva, policy=FP16, causal=True,
        block_q=128, block_kv=128), 20)
    plain_ms = _cuda_time_ms(lambda: mod.attention_plain(
        q, k, v, beta=BETA, policy=FP16, block_kv=128, causal=True), 3,
        warmup=1)
    ke, ve = (x.repeat_interleave(h // kvh, 1) for x in (k_sh, v))
    lib_ms = _cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q, ke, ve, is_causal=True), 20)
    nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2   # q, out, K', V at fp16
    flops = 4 * d * b * h * (s * (s + 1) // 2)        # causal: visible pairs
    return dict(
        name="pasa_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/pasa_attention.cu",
        replaces="src/repro/kernels/pasa_attention.py:218",
        max_abs_err=report["max_abs_err_causal"], rmse=report["rmse_causal"],
        rmse_plain=report["rmse_plain_causal"], detail=report,
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        **_bound(nbytes, flops),
    )


def check_contiguous_decode(dev):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core.precision import FP16
    from repro_torch.kernels import ops, pasa_decode as mod

    kvh, g, d, block = 4, 7, 128, 128
    lens = DECODE_KV_LENS
    b, s2 = len(lens), max(lens) + 1
    rng = np.random.default_rng(5)
    # the dense route's cache: bf16 (B, S2, KVH, D), NaN past kv_len
    kc = rng.standard_normal((b, s2, kvh, d)).astype(np.float32) + 30.0
    vc = rng.standard_normal((b, s2, kvh, d)).astype(np.float32)
    for i, n in enumerate(lens):
        kc[i, n:] = np.nan
        vc[i, n:] = np.nan
    to = lambda a: torch.from_numpy(a).to(dev, torch.bfloat16)
    kc_t, vc_t = to(kc), to(vc)
    kview, vview = kc_t.transpose(1, 2), vc_t.transpose(1, 2)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    run = lambda q: ops.pasa_decode(q, kview, vview, kv_len, beta=BETA,
                                    policy=FP16, block_kv=block)
    plain_of = lambda q: mod.decode_plain(q, kview, vview, kv_len, beta=BETA,
                                          policy=FP16, block_kv=block)

    # the same rows in a shuffled page pool
    n_pages = [math.ceil(n / block) for n in lens]
    ids = rng.permutation(np.arange(1, 1 + sum(n_pages)))
    kp = torch.full((1 + sum(n_pages), block, kvh, d), float("nan"),
                    dtype=torch.bfloat16, device=dev)
    vp = kp.clone()
    table = np.zeros((b, max(n_pages)), np.int32)
    nxt = 0
    for i, npg in enumerate(n_pages):
        for j in range(npg):
            pid = int(ids[nxt])
            nxt += 1
            table[i, j] = pid
            rows = min(block, s2 - j * block)
            kp[pid, :rows] = kc_t[i, j * block:j * block + rows]
            vp[pid, :rows] = vc_t[i, j * block:j * block + rows]
    table = torch.from_numpy(table).to(dev)

    report = {}
    for q_mean in (1.0, 0.0):       # the held fixture last: timed below
        q = _randn(rng, (b, kvh, g, d), q_mean, dev, torch.float16)
        got = run(q)
        plain = plain_of(q)
        paged = ops.pasa_paged_decode(q, kp, vp, table, kv_len, beta=BETA,
                                      policy=FP16)
        torch.cuda.synchronize()
        if not torch.equal(got, paged):
            raise AssertionError(
                f"contiguous decode != paged decode (q mean {q_mean}): max "
                f"diff {float((got.float() - paged.float()).abs().max()):.3e}")
        golds = []
        for i, n in enumerate(lens):
            kk = torch.from_numpy(kc[i, :n]).to(dev).to(torch.bfloat16)
            vv = torch.from_numpy(vc[i, :n]).to(dev).to(torch.bfloat16)
            sc = q[i].double() @ kk.double().permute(1, 2, 0) / math.sqrt(d)
            golds.append(torch.softmax(sc, -1) @ vv.double().transpose(0, 1))
        gold = torch.stack(golds)
        rmse, rmse_plain = _rel_rmse(got, gold), _rel_rmse(plain, gold)
        if not (rmse < RMSE_MAX and rmse_plain < RMSE_MAX):
            raise AssertionError(
                f"contiguous decode RMSE {rmse:.4f} / plain {rmse_plain:.4f}")
        if q_mean == 0.0:
            max_err = _close("pasa_decode", got, plain, **DECODE_TOL)
            report.update(rmse=rmse, rmse_plain=rmse_plain)
        else:
            report["stress"] = dict(
                q_mean=q_mean, rmse=rmse, rmse_plain=rmse_plain,
                max_abs_err=float((got.float() - plain.float()).abs().max()))
    ms = _cuda_time_ms(lambda: run(q), 50)
    plain_ms = _cuda_time_ms(lambda: plain_of(q), 3, warmup=1)
    ke, ve = (torch.nan_to_num(x.half()).repeat_interleave(g, 1)
              for x in (kview, vview))
    mask = (torch.arange(s2, device=dev)[None, :] < kv_len[:, None])
    qh = q.reshape(b, kvh * g, 1, d)
    lib_ms = _cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qh, ke, ve, attn_mask=mask[:, None, None, :]), 20)
    live = sum(lens)
    nbytes = 2 * live * kvh * d * 2 + 2 * q.numel() * 2 + b * 4
    flops = 4 * g * d * live * kvh
    return dict(
        name="pasa_decode", route="cuda",
        source="src/repro_torch/kernels/csrc/pasa_decode.cu",
        replaces="src/repro/kernels/pasa_decode.py:268",
        max_abs_err=max_err, paged_bit_equal=True, ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, **report, **_bound(nbytes, flops),
    )


def _bound(nbytes: int, flops: int) -> dict:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP16_FLOPS * 1e3
    return dict(
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=nbytes, flops=flops,
    )


def build_model(dev):
    """qwen2-7b at full width with random weights from seed 0, shared by
    both serving phases."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build

    bundle = build(get_config("qwen2-7b"))
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    return bundle, params, time.perf_counter() - t0


def serve(dev, bundle, params):
    """qwen2-7b at full width through the engine; returns the report."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.runtime import ServeEngine

    cfg = bundle.cfg
    torch.cuda.reset_peak_memory_stats()
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
        peak_gb=peak / 1e9,
    )


def serve_dense(dev, bundle, params):
    """The dense route of launch/serve.py at full width: one fused prefill
    of four 1000-token prompts, then greedy decode steps on the dense
    cache; returns the report."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_serve_step

    cfg = bundle.cfg
    finite = []

    def checked(step):
        def run(*a):
            logits, cache = step(*a)
            finite.append(torch.isfinite(logits).all())
            return logits, cache
        return run

    bundle = dataclasses.replace(bundle, prefill=checked(bundle.prefill),
                                 serve_step=checked(bundle.serve_step))
    step = make_serve_step(bundle)
    max_len = DENSE_PROMPT + SERVE_GEN + 8

    def run(prompts):
        """Fused prefill + SERVE_GEN - 1 decode steps, each call ended by
        its token's readback (as launch/serve.py's dense route)."""
        b = prompts.shape[0]
        cache = bundle.init_cache(b, max_len, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = bundle.prefill(params, prompts, cache)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out = [tok.cpu()]
        marks = [time.perf_counter() - t0]
        n = prompts.shape[1]
        for i in range(n, n + SERVE_GEN - 1):
            pos = torch.full((b,), i, dtype=torch.int32, device=dev)
            tok, _, cache = step(params, tok, pos, cache)
            out.append(tok.cpu())
            marks.append(time.perf_counter() - t0)
        return torch.stack(out, 1), marks

    rng = np.random.default_rng(1)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (DENSE_BATCH, DENSE_PROMPT), dtype=np.int32)).to(dev)
    run(prompts[:1, :256])                 # warm-up (cuBLAS first calls)
    torch.cuda.reset_peak_memory_stats()
    finite.clear()
    ops.reset_launches()
    streams, marks = run(prompts)
    launches = {name: getattr(ops, name).launches for name in (
        "shift_kv", "pasa_attention", "pasa_decode", "pasa_paged_prefill",
        "pasa_paged_decode")}
    n_prefill, n_decode = 1, SERVE_GEN - 1
    want = {"shift_kv": cfg.n_layers * n_prefill,
            "pasa_attention": cfg.n_layers * n_prefill,
            "pasa_decode": cfg.n_layers * n_decode,
            "pasa_paged_prefill": 0, "pasa_paged_decode": 0}
    if launches != want:
        raise AssertionError(f"dense launch counts {launches} != {want}")
    if not bool(torch.stack(finite).all()):
        raise AssertionError("non-finite logits in the dense serve")
    if not bool(((streams >= 0) & (streams < cfg.vocab_size)).all()):
        raise AssertionError(f"bad dense streams {streams}")
    peak = torch.cuda.max_memory_allocated()
    for i in range(DENSE_BATCH):
        alone, _ = run(prompts[i:i + 1])
        if not torch.equal(alone[0], streams[i]):
            raise AssertionError(
                f"dense batched vs one-at-a-time streams differ: "
                f"{streams[i].tolist()} vs {alone[0].tolist()}")
    wall = marks[-1]
    steps = [b - a for a, b in zip(marks, marks[1:])]
    return dict(
        arch=cfg.arch_id, layers=cfg.n_layers, batch=DENSE_BATCH,
        prompt_len=DENSE_PROMPT, gen=SERVE_GEN, max_len=max_len,
        prefill_calls=n_prefill, decode_calls=n_decode, launches=launches,
        wall_s=wall, tok_per_s=streams.numel() / wall, ttft_ms=1e3 * marks[0],
        decode_ms_per_step=1e3 * sum(steps) / len(steps),
        peak_gb=peak / 1e9, sample=streams[0, :16].tolist(),
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

    kernels = [check_decode(dev), check_prefill(dev), check_shift_kv(dev),
               check_attention(dev), check_contiguous_decode(dev)]
    for k in kernels:
        extra = (f"; max abs diff vs the plain version on the CPU "
                 f"{k['max_abs_err_cpu_plain']:.3e}"
                 if "max_abs_err_cpu_plain" in k else "")
        print(f"{k['name']}: max_abs_err {k['max_abs_err']:.3e}, rmse "
              f"{k['rmse']:.2e}, {k['ms']:.4f} ms vs plain "
              f"{k['plain_ms']:.3f} ms, library {k['library_ms']:.4f} ms, "
              f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}){extra}")
        for key in ("stress", "detail"):
            if k.get(key):
                print(f"  {k['name']} {key}: {json.dumps(k[key])}")

    bundle, params, init_s = build_model(dev)
    print(f"weights: {init_s:.1f} s")
    # each serving path is driven with every launch count set to 0 just
    # before it and read just after
    rep = serve(dev, bundle, params)
    print("serve: " + json.dumps(rep))
    rep_dense = serve_dense(dev, bundle, params)
    print("serve_dense: " + json.dumps(rep_dense))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for k in kernels:
        paged = k["name"].startswith("pasa_paged_")
        k["launches"] = (rep if paged else rep_dense)["launches"][k["name"]]
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
