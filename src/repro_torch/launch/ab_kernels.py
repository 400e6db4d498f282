"""The port's attention kernels in two checkouts, side by side on one card.

    PYTHONPATH=src python -m repro_torch.launch.ab_kernels --other <checkout>

``<checkout>`` is another tree of this repository (e.g. the parent commit
unpacked with ``git archive``).  Each tree's kernels run in a process of
their own (each builds into its own ``build/``), in the order other, this,
this, other, on the same seeded inputs at ``chip_smoke.py``'s fixtures:

  * ``pasa_attention`` causal at q (4, 28, 1024, 128), PASA at fp16 and
    fp16_fp32, and FlashAttention-2 at fp16_fp32 (keys of mean 2);
  * contiguous ``pasa_decode``: 5 sequences at kv {1, 127, 128, 1000,
    4095} of a bf16 (B, S2, KVH, D) cache read through strides, and the
    dense serve's decode shape (batch 4, kv 1002, 1040 rows);
  * ``pasa_paged_decode`` on the same rows in a shuffled bf16 page pool;
  * ``pasa_paged_prefill``: 4 rows x 28 heads x 512 queries at chunk
    starts {0, 512, 1024} plus a pad row, page 128, from a bf16 pool and
    the same pool quantized per page to int8 and fp8_e4m3;
  * ``shift_kv`` at fp16 operands on the dense prefill's keys (4, 4,
    1024, 128), bf16 (B, S, KVH, D) read through strides, blocks 128 and
    64, and the same keys at fp16;
  * head_dim 64 (``/d64``): both decodes on the decode rows at KVH 4, G 8
    (paged also from an int8 pool), ``shift_kv`` on whisper's encoder keys
    (4, 20, 1536, 64) and ``pasa_attention`` / ``flash_attention`` at
    fp16_fp32 on that shape with kv_valid 1500;
  * pages of 16 and 8 rows (``/page16``, ``/page8``): ``pasa_paged_decode``
    at block 128 on a paged serve's decode rows (batch 4, kv 1002 / 519 /
    302 / 131) and ``pasa_paged_prefill`` on the prefill rows above, from
    bf16 pools; ``pasa_paged_prefill`` also at pages of 200, 256 (the
    256-row tile; 256 also from an int8 pool) and 512 rows;
  * the algebraic shift (``/algebraic``): ``shift_kv`` on the dense
    prefill's keys above and ``pasa_attention`` causal at fp16 on the
    first fixture, both with ``gemm_shift=False``;
  * the decodes at the serves' calls with many kv heads and small groups
    (``/g1_*``), fp16 PASA, block 128, bf16 caches of (B, S2, KVH, D)
    read through strides: contiguous decode at the hybrid's call (batch
    4, KVH 32, G 1, D 64, kv 101 in 140 rows), Whisper's (KVH 20, G 1, D
    64, kv 66 in 104 rows) and the vlm's self call (KVH 8, G 8, D 128, kv
    48 in 72 rows); paged decode at a paged serve's call (batch 4, kv
    1002 / 519 / 302 / 131, page 128, a shuffled pool) at olmoe's KVH 16,
    G 1 (from bf16 and int8 pools) and qwen1.5-32b's KVH 40, G 1, and at
    qwen2-7b's KVH 4, G 7 (``pasa_paged_decode/serve_shape``, also from
    int8 and fp8_e4m3 pools);
  * paged prefill at the paged serve's first call (``/serve_page*``: 4
    rows x 28 heads x 512 queries at start 0, kv 512 / 512 / 300 / 129)
    at pages 16 and 8 from bf16 and int8 pools, 24, 64 and 128 from bf16
    pools.
A tree whose kernels do not take a fixture (a decode block other than
the page, a prefill page under 16 or over 256 rows, the algebraic shift)
reports it as not taken.

Each worker also saves ``_build.build()``'s seconds per source (empty for
a tree already built).

It prints one line per kernel: the ms of each run (CUDA events around
warm calls queued behind a spin kernel, as ``chip_smoke.py`` times them)
and whether the two trees' outputs are equal bit for bit (else how many
elements differ and their max abs difference), then the card's name and
power limit.  Output files go
under ``--out``.  Needs one CUDA card; imports neither jax nor ``repro``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

BETA = 0.984497
SPIN_CYCLES_PER_S = 1.98e9      # H100 SXM boost clock: cycles of torch.cuda._sleep
DECODE_KV_LENS = (1, 127, 128, 1000, 4095)
PREFILL_ROWS = ((0, 512, 1024, 0), (512, 1024, 1324, 0))


def _time_ms(fn, iters: int) -> float:
    import torch

    for _ in range(2):
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


def _cases(dev):
    """{name: (call, iters)} on seeded inputs."""
    import numpy as np
    import torch

    from repro_torch.core.precision import FP16, FP16_FP32
    from repro_torch.kernels import ops
    from repro_torch.runtime.paged_cache import quantize_kv_page

    rng = np.random.default_rng(0)
    randn = lambda shape, mean, dt=torch.float16: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32) + mean).to(dev, dt)
    cases = {}

    q, k, v = randn((4, 28, 1024, 128), 0.0), randn((4, 4, 1024, 128), 2.0), \
        randn((4, 4, 1024, 128), 0.0)
    for tag, policy in (("fp16", FP16), ("fp16_fp32", FP16_FP32)):
        cases[f"pasa_attention/{tag}"] = (lambda policy=policy: ops.pasa_attention(
            q, k, v, beta=BETA, policy=policy, causal=True), 20)
    cases["flash_attention/fp16_fp32"] = (lambda: ops.flash_attention(
        q, k, v, policy=FP16_FP32, causal=True), 20)

    # decode: the same rows as a strided cache and as a shuffled page pool
    kvh, g, d, page = 4, 7, 128, 128
    b, s2 = len(DECODE_KV_LENS), max(DECODE_KV_LENS) + 1
    kc = randn((b, s2, kvh, d), 30.0, torch.bfloat16)
    vc = randn((b, s2, kvh, d), 0.0, torch.bfloat16)
    for i, n in enumerate(DECODE_KV_LENS):
        kc[i, n:] = float("nan")
        vc[i, n:] = float("nan")
    kv_len = torch.tensor(DECODE_KV_LENS, dtype=torch.int32, device=dev)
    qd = randn((b, kvh, g, d), 0.0)
    cases["pasa_decode"] = (lambda: ops.pasa_decode(
        qd, kc.transpose(1, 2), vc.transpose(1, 2), kv_len, beta=BETA,
        block_kv=page), 50)
    n_pages = [math.ceil(n / page) for n in DECODE_KV_LENS]
    ids = torch.from_numpy(rng.permutation(np.arange(1, 1 + sum(n_pages))))
    table = torch.zeros((b, max(n_pages)), dtype=torch.int32)
    kp = torch.full((1 + sum(n_pages), page, kvh, d), float("nan"),
                    dtype=torch.bfloat16, device=dev)
    vp = kp.clone()
    nxt = 0
    for i, npg in enumerate(n_pages):
        for j in range(npg):
            pid = int(ids[nxt])
            nxt += 1
            table[i, j] = pid
            rows = min(page, s2 - j * page)
            kp[pid, :rows] = kc[i, j * page:j * page + rows]
            vp[pid, :rows] = vc[i, j * page:j * page + rows]
    table = table.to(dev)
    cases["pasa_paged_decode"] = (lambda: ops.pasa_paged_decode(
        qd, kp, vp, table, kv_len, beta=BETA), 50)

    sb, ss = 4, 1040
    kcs = randn((sb, ss, kvh, d), 2.0, torch.bfloat16)
    vcs = randn((sb, ss, kvh, d), 0.0, torch.bfloat16)
    qs = randn((sb, kvh, g, d), 0.0)
    kvs = torch.full((sb,), 1002, dtype=torch.int32, device=dev)
    cases["pasa_decode/serve_shape"] = (lambda: ops.pasa_decode(
        qs, kcs.transpose(1, 2), vcs.transpose(1, 2), kvs, beta=BETA,
        block_kv=page), 50)

    # paged prefill: shuffled pool, NaN past kv_len, pad row's table null
    starts, lens = PREFILL_ROWS
    n_pages = [math.ceil(max(n, 1) / page) for n in lens]
    total = 1 + sum(n_pages) + 2
    ids = rng.permutation(np.arange(1, total))
    ptab = np.zeros((len(lens), max(n_pages)), np.int32)
    pk = np.full((total, page, kvh, d), np.nan, np.float32)
    pv = np.full((total, page, kvh, d), np.nan, np.float32)
    valid = torch.zeros((total, page), dtype=torch.bool)
    nxt = 0
    for i, (n, npg) in enumerate(zip(lens, n_pages)):
        for j in range(npg):
            pid = int(ids[nxt])
            nxt += 1
            ptab[i, j] = pid
            rows = max(0, min(page, n - j * page))
            pk[pid, :rows] = rng.standard_normal((rows, kvh, d)) + 2.0
            pv[pid, :rows] = rng.standard_normal((rows, kvh, d))
            valid[pid, :rows] = True
    ptab[3] = 0
    pk, pv = (torch.from_numpy(x).to(dev, torch.bfloat16) for x in (pk, pv))
    ptab = torch.from_numpy(ptab).to(dev)
    valid = valid.to(dev)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    pl = torch.tensor(lens, dtype=torch.int32, device=dev)
    qp = randn((len(lens), 28, 512, d), 1.0)
    cases["pasa_paged_prefill"] = (lambda: ops.pasa_paged_prefill(
        qp, pk, pv, ptab, st, pl, beta=BETA), 20)
    for dtype in ("int8", "fp8_e4m3"):
        kq, ks, kh = quantize_kv_page(pk, valid, dtype)
        vq, vs, vh = quantize_kv_page(pv, valid, dtype)
        side = dict(k_scale=ks, k_shift=kh, v_scale=vs, v_shift=vh)
        cases[f"pasa_paged_prefill/{dtype}"] = (
            lambda kq=kq, vq=vq, side=side: ops.pasa_paged_prefill(
                qp, kq, vq, ptab, st, pl, beta=BETA, **side), 20)

    keys = randn((4, 1024, 4, 128), 5.0, torch.bfloat16).transpose(1, 2)
    keys16 = keys.to(torch.float16)
    for name, kk, block in (("shift_kv", keys, 128),
                            ("shift_kv/block64", keys, 64),
                            ("shift_kv/fp16_keys", keys16, 128)):
        cases[name] = (lambda kk=kk, block=block: ops.shift_kv(
            kk, beta=BETA, block_kv=block, policy=FP16), 50)
    cases["shift_kv/algebraic"] = (lambda: ops.shift_kv(
        keys, beta=BETA, block_kv=128, policy=FP16, gemm_shift=False), 50)
    cases["pasa_attention/algebraic"] = (lambda: ops.pasa_attention(
        q, k, v, beta=BETA, policy=FP16, causal=True, gemm_shift=False), 20)
    cases.update(_hd64_cases(dev, randn))
    cases.update(_page_cases(dev))
    cases.update(_g1_cases(dev))
    cases.update(_serve_call_cases(dev))
    return cases


def _serve_call_cases(dev):
    """Paged prefill at the paged serve's first call (its own seed): 4
    rows x 28 heads x 512 queries at start 0, kv 512 / 512 / 300 / 129,
    KVH 4, D 128, fp16 PASA, shuffled pools at pages 16 and 8 (bf16 and
    int8), 24, 64 and 128 (bf16)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.runtime.paged_cache import quantize_kv_page

    rng = np.random.default_rng(3)
    randn = lambda shape, mean, dt=torch.float16: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32) + mean).to(dev, dt)
    kvh, d, lens = 4, 128, (512, 512, 300, 129)
    kc = randn((len(lens), max(lens), kvh, d), 2.0, torch.bfloat16)
    vc = randn((len(lens), max(lens), kvh, d), 0.0, torch.bfloat16)
    q = randn((len(lens), 28, 512, d), 1.0)
    st = torch.zeros(len(lens), dtype=torch.int32, device=dev)
    pl = torch.tensor(lens, dtype=torch.int32, device=dev)
    cases = {}
    for page, pools in ((16, ("bf16", "int8")), (8, ("bf16", "int8")),
                        (24, ("bf16",)), (64, ("bf16",)), (128, ("bf16",))):
        kp, vp, table = _repaged(rng, kc, vc, lens, page)
        valid = torch.isfinite(kp[:, :, 0, 0]).to(dev)
        for pool in pools:
            kq, vq, side = kp, vp, {}
            if pool != "bf16":
                kq, ks, kh = quantize_kv_page(kp, valid, pool)
                vq, vs, vh = quantize_kv_page(vp, valid, pool)
                side = dict(k_scale=ks, k_shift=kh, v_scale=vs, v_shift=vh)
            name = f"pasa_paged_prefill/serve_page{page}" + (
                "" if pool == "bf16" else f"_{pool}")
            cases[name] = (
                lambda kq=kq, vq=vq, table=table, side=side:
                    ops.pasa_paged_prefill(q, kq, vq, table, st, pl,
                                           beta=BETA, **side), 20)
    return cases


def _g1_cases(dev):
    """The ``/g1_*`` decode cases of :func:`_cases` (their own seed) and
    paged decode at qwen2-7b's serve call."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.runtime.paged_cache import quantize_kv_page

    rng = np.random.default_rng(2)
    randn = lambda shape, mean, dt=torch.float16: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32) + mean).to(dev, dt)
    cases = {}
    for tag, kvh, g, d, kv, s2 in (("g1_hybrid", 32, 1, 64, 101, 140),
                                   ("g1_whisper", 20, 1, 64, 66, 104),
                                   ("g1_vlm", 8, 8, 128, 48, 72)):
        kc = randn((4, s2, kvh, d), 2.0, torch.bfloat16).transpose(1, 2)
        vc = randn((4, s2, kvh, d), 0.0, torch.bfloat16).transpose(1, 2)
        qd = randn((4, kvh, g, d), 0.0)
        kv_len = torch.full((4,), kv, dtype=torch.int32, device=dev)
        cases[f"pasa_decode/{tag}"] = (
            lambda qd=qd, kc=kc, vc=vc, kv_len=kv_len: ops.pasa_decode(
                qd, kc, vc, kv_len, beta=BETA, block_kv=128), 50)
    lens = (1002, 519, 302, 131)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    for tag, kvh, g, pools in (("g1_olmoe", 16, 1, ("bf16", "int8")),
                               ("g1_qwen15", 40, 1, ("bf16",)),
                               ("serve_shape", 4, 7,
                                ("bf16", "int8", "fp8_e4m3"))):
        kc = randn((len(lens), max(lens), kvh, 128), 30.0, torch.bfloat16)
        vc = randn((len(lens), max(lens), kvh, 128), 0.0, torch.bfloat16)
        qd = randn((len(lens), kvh, g, 128), 0.0)
        kp, vp, table = _repaged(rng, kc, vc, lens, 128)
        valid = torch.isfinite(kp[:, :, 0, 0]).to(dev)
        for pool in pools:
            kq, vq, side = kp, vp, {}
            if pool != "bf16":
                kq, ks, kh = quantize_kv_page(kp, valid, pool)
                vq, vs, vh = quantize_kv_page(vp, valid, pool)
                side = dict(k_scale=ks, k_shift=kh, v_scale=vs, v_shift=vh)
            name = f"pasa_paged_decode/{tag}" + ("" if pool == "bf16"
                                                 else f"_{pool}")
            cases[name] = (
                lambda qd=qd, kq=kq, vq=vq, table=table, side=side:
                    ops.pasa_paged_decode(qd, kq, vq, table, kv_len,
                                          beta=BETA, block_kv=128, **side), 50)
    return cases


def _repaged(rng, kc, vc, lens, page):
    """The rows of (B, S, KVH, D) K and V in a shuffled pool of
    ``page``-row pages, page 0 and the positions past each length NaN:
    (k_pages, v_pages, table)."""
    import numpy as np
    import torch

    b, s, kvh, d = kc.shape
    n_pages = [math.ceil(max(n, 1) / page) for n in lens]
    ids = rng.permutation(np.arange(1, 1 + sum(n_pages)))
    table = torch.zeros((b, max(n_pages)), dtype=torch.int32)
    kp = torch.full((1 + sum(n_pages), page, kvh, d), float("nan"),
                    dtype=kc.dtype, device=kc.device)
    vp = kp.clone()
    nxt = 0
    for i, (n, npg) in enumerate(zip(lens, n_pages)):
        for j in range(npg):
            pid = int(ids[nxt])
            nxt += 1
            table[i, j] = pid
            rows = max(0, min(page, n - j * page))
            kp[pid, :rows] = kc[i, j * page:j * page + rows]
            vp[pid, :rows] = vc[i, j * page:j * page + rows]
    return kp, vp, table.to(kc.device)


def _page_cases(dev):
    """The page-16 and page-8 cases of :func:`_cases` (their own seed),
    then paged prefill at pages 200, 256 and 512."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.runtime.paged_cache import quantize_kv_page

    rng = np.random.default_rng(1)
    randn = lambda shape, mean, dt=torch.float16: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32) + mean).to(dev, dt)
    cases = {}
    kvh, g, d = 4, 7, 128
    lens = (1002, 519, 302, 131)
    kc = randn((len(lens), max(lens), kvh, d), 2.0, torch.bfloat16)
    vc = randn((len(lens), max(lens), kvh, d), 0.0, torch.bfloat16)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    qd = randn((len(lens), kvh, g, d), 0.0)
    starts, plens = PREFILL_ROWS
    pk = randn((len(plens), max(plens), kvh, d), 2.0, torch.bfloat16)
    pv = randn((len(plens), max(plens), kvh, d), 0.0, torch.bfloat16)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    pl = torch.tensor(plens, dtype=torch.int32, device=dev)
    qp = randn((len(plens), 28, 512, d), 1.0)
    for page in (16, 8):
        kp, vp, table = _repaged(rng, kc, vc, lens, page)
        cases[f"pasa_paged_decode/page{page}"] = (
            lambda kp=kp, vp=vp, table=table: ops.pasa_paged_decode(
                qd, kp, vp, table, kv_len, beta=BETA, block_kv=128), 50)
        kp, vp, table = _repaged(rng, pk, pv, plens, page)
        table[3] = 0
        cases[f"pasa_paged_prefill/page{page}"] = (
            lambda kp=kp, vp=vp, table=table: ops.pasa_paged_prefill(
                qp, kp, vp, table, st, pl, beta=BETA), 20)
    for page in (200, 256, 512):
        kp, vp, table = _repaged(rng, pk, pv, plens, page)
        table[3] = 0
        cases[f"pasa_paged_prefill/page{page}"] = (
            lambda kp=kp, vp=vp, table=table: ops.pasa_paged_prefill(
                qp, kp, vp, table, st, pl, beta=BETA), 20)
        if page == 256:
            valid = torch.isfinite(kp[:, :, 0, 0]).to(dev)
            kq, ks, kh = quantize_kv_page(kp, valid, "int8")
            vq, vs, vh = quantize_kv_page(vp, valid, "int8")
            side = dict(k_scale=ks, k_shift=kh, v_scale=vs, v_shift=vh)
            cases["pasa_paged_prefill/page256_int8"] = (
                lambda kq=kq, vq=vq, table=table, side=side:
                    ops.pasa_paged_prefill(qp, kq, vq, table, st, pl,
                                           beta=BETA, **side), 20)
    return cases


def _hd64_cases(dev, randn):
    """The head_dim 64 cases of :func:`_cases`."""
    import torch

    from repro_torch.core.precision import FP16, FP16_FP32
    from repro_torch.kernels import ops
    from repro_torch.runtime.paged_cache import quantize_kv_page

    cases = {}
    kvh, g, d, page = 4, 8, 64, 128
    lens = DECODE_KV_LENS
    b, n_pages = len(lens), [math.ceil(n / page) for n in lens]
    s2 = max(n_pages) * page
    kc = randn((b, s2, kvh, d), 30.0, torch.bfloat16)
    vc = randn((b, s2, kvh, d), 0.0, torch.bfloat16)
    valid = torch.arange(s2, device=dev)[None, :] < torch.tensor(
        lens, device=dev)[:, None]
    kc = torch.where(valid[..., None, None], kc, float("nan")).to(kc.dtype)
    vc = torch.where(valid[..., None, None], vc, float("nan")).to(vc.dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    qd = randn((b, kvh, g, d), 0.0)
    cases["pasa_decode/d64"] = (lambda: ops.pasa_decode(
        qd, kc.transpose(1, 2), vc.transpose(1, 2), kv_len, beta=BETA,
        block_kv=page), 50)
    # the same rows as pages in table order (page j of row i is page
    # i * max_pages + j + 1; page 0 is never read)
    mp = max(n_pages)
    table = (torch.arange(b * mp, dtype=torch.int32, device=dev)
             .reshape(b, mp) + 1)
    kp = torch.cat([torch.zeros_like(kc[:1, :page]),
                    kc.reshape(b * mp, page, kvh, d)])
    vp = torch.cat([torch.zeros_like(vc[:1, :page]),
                    vc.reshape(b * mp, page, kvh, d)])
    cases["pasa_paged_decode/d64"] = (lambda: ops.pasa_paged_decode(
        qd, kp, vp, table, kv_len, beta=BETA), 50)
    pvalid = torch.cat([torch.zeros_like(valid[:1, :page]),
                        valid.reshape(b * mp, page)])
    kq, ks, kh = quantize_kv_page(kp, pvalid, "int8")
    vq, vs, vh = quantize_kv_page(vp, pvalid, "int8")
    cases["pasa_paged_decode/d64_int8"] = (lambda: ops.pasa_paged_decode(
        qd, kq, vq, table, kv_len, beta=BETA, k_scale=ks, k_shift=kh,
        v_scale=vs, v_shift=vh), 50)

    keys = randn((4, 1536, 20, d), 5.0, torch.bfloat16).transpose(1, 2)
    cases["shift_kv/d64"] = (lambda: ops.shift_kv(
        keys, beta=BETA, block_kv=128, policy=FP16), 50)
    rows = lambda x: torch.nn.functional.pad(x[:, :, :1500], (0, 0, 0, 36))
    q = rows(randn((4, 20, 1536, d), 0.0))
    k = rows(randn((4, 20, 1536, d), 2.0))
    v = rows(randn((4, 20, 1536, d), 0.0))
    cases["pasa_attention/d64"] = (lambda: ops.pasa_attention(
        q, k, v, beta=BETA, policy=FP16, kv_valid=1500), 20)
    cases["flash_attention/d64_fp16_fp32"] = (lambda: ops.flash_attention(
        q, k, v, policy=FP16_FP32, kv_valid=1500), 20)
    return cases


def worker(tree: Path, save: Path) -> None:
    """Run every case with ``tree``'s package; save outputs and times."""
    sys.path.insert(0, str(tree / "src"))
    import torch

    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    built = _build.build()
    outs, times = {}, {}
    for name, (call, iters) in _cases(dev).items():
        try:
            outs[name] = call().cpu()
        except (NotImplementedError, ValueError, TypeError):
            # a mode this tree's kernels do not take (TypeError: an
            # argument its ops do not have)
            times[name] = None
            continue
        times[name] = _time_ms(call, iters)
    torch.save(outs, save.with_suffix(".pt"))
    save.with_suffix(".json").write_text(json.dumps(times))
    save.with_suffix(".build.json").write_text(json.dumps(built))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="another checkout")
    ap.add_argument("--out", default="build/ab")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--save", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(Path(args.worker), Path(args.save))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device available", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parents[3]
    other = Path(args.other).resolve()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    runs = [("other", other), ("this", here), ("this", here), ("other", other)]
    times = []
    for i, (tag, tree) in enumerate(runs):
        save = out / f"run{i}_{tag}"
        # this file, with the tree's package first on the path
        subprocess.run([sys.executable, __file__, "--other", str(other),
                        "--worker", str(tree), "--save", str(save.resolve())],
                       cwd=tree, check=True,
                       env={**os.environ, "PYTHONPATH": str(tree / "src")})
        times.append(json.loads(save.with_suffix(".json").read_text()))
        built = json.loads(save.with_suffix(".build.json").read_text())
        if built:
            print(f"build ({tag}): " + ", ".join(
                f"{name} {sec:.1f} s" for name, sec in sorted(built.items())))
    a = torch.load(out / "run0_other.pt")
    b = torch.load(out / "run1_this.pt")
    for name in times[0]:
        if name not in a or name not in b:
            taken = [t[name] is not None for t in times]
            ms = " / ".join("not taken" if t[name] is None else
                            f"{t[name]:.4f}" for t in times)
            print(f"{name}: ms other, this, this, other = {ms}"
                  + ("" if all(taken) else "; no bit comparison"))
            continue
        same = torch.equal(a[name], b[name])
        diff = "bits equal" if same else (
            f"{int((a[name] != b[name]).sum())} of {a[name].numel()} differ, "
            f"max abs diff {float((a[name].float() - b[name].float()).abs().max()):.3e}")
        ms = " / ".join(f"{t[name]:.4f}" for t in times)
        print(f"{name}: ms other, this, this, other = {ms}; {diff}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
