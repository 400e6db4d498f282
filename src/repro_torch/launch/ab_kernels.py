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
    64, and the same keys at fp16.

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
    return cases


def worker(tree: Path, save: Path) -> None:
    """Run every case with ``tree``'s package; save outputs and times."""
    sys.path.insert(0, str(tree / "src"))
    import torch

    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build()
    outs, times = {}, {}
    for name, (call, iters) in _cases(dev).items():
        outs[name] = call().cpu()
        times[name] = _time_ms(call, iters)
    torch.save(outs, save.with_suffix(".pt"))
    save.with_suffix(".json").write_text(json.dumps(times))


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
    a = torch.load(out / "run0_other.pt")
    b = torch.load(out / "run1_this.pt")
    for name in times[0]:
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
