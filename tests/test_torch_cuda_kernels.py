"""The port on a CUDA card: every kernel against its plain version (the
paged kernels in both modes: raw and quantized pools), the contiguous
decode kernel bit for bit against the paged one and its sequential walk,
the prefill kernel's chunk-schedule invariance, the four attention
kernels in their fp32 and bf16_fp32 modes, and both serving routes'
contracts at a small size (also at ``impl="flash"``).  Every test is marked ``cuda``
and skips without a card.  The file imports neither jax nor the reference
package, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        -m cuda tests/test_torch_cuda_kernels.py
"""

import dataclasses
import functools
import importlib
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.beta import DEFAULT_BETA
from repro_torch.core.precision import BF16_FP32, F64, FP16, FP16_FP32, FP32
from repro_torch.core.shifting import shift_kv_reference
from repro_torch.kernels import ops
from repro_torch.launch.steps import make_serve_step
from repro_torch.models.convert import init_lm
from repro_torch.models.model_zoo import build
from repro_torch.runtime import ServeEngine, quantize_kv_page

# the kernel modules (the package binds these names to the ops)
amod, cmod, dmod, pmod, smod = (
    importlib.import_module(f"repro_torch.kernels.{name}")
    for name in ("pasa_attention", "pasa_decode", "pasa_paged_decode",
                 "pasa_paged_prefill", "shift_kv"))

BETA = 0.984497
# the reference's kernel-vs-oracle bars: decode (tests/test_paged.py),
# prefill (tests/test_prefix_cache.py)
DECODE_TOL = dict(atol=3e-3, rtol=3e-2)
PREFILL_TOL = dict(atol=1e-2, rtol=3e-2)
# tests/test_kernels.py: shift-KV, attention (causal / not), flash
SHIFT_TOL = dict(atol=1e-2, rtol=0.0)
# shift-KV vs float64 (chip_smoke.py's bar): relative RMSE
SHIFT_RMSE_MAX = 1e-2
ATTN_TOL = {True: dict(atol=2e-3, rtol=2e-2), False: dict(atol=8e-3, rtol=2e-2)}


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pool(rng, seq_lens, kvh, page, dev, d=128):
    """Shuffled-page bf16 pool, one sequence per length; stale positions
    and unreferenced pages are NaN."""
    n_pages = [max(1, math.ceil(n / page)) for n in seq_lens]
    total = 1 + sum(n_pages) + 2
    ids = rng.permutation(np.arange(1, total))
    table = np.zeros((len(seq_lens), max(n_pages) + 1), np.int32)
    k = np.full((total, page, kvh, d), np.nan, np.float32)
    v = np.full((total, page, kvh, d), np.nan, np.float32)
    nxt = 0
    for b, (n, npg) in enumerate(zip(seq_lens, n_pages)):
        for j in range(npg):
            pid = int(ids[nxt])
            nxt += 1
            table[b, j] = pid
            rows = max(0, min(page, n - j * page))
            k[pid, :rows] = rng.standard_normal((rows, kvh, d)) + 2.0
            v[pid, :rows] = rng.standard_normal((rows, kvh, d))
    to = lambda a, dt: torch.from_numpy(a).to(device=dev, dtype=dt)
    return to(k, torch.bfloat16), to(v, torch.bfloat16), to(table, torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("page", [64, 128])
@pytest.mark.parametrize("beta", [0.0, BETA])
@pytest.mark.parametrize("policy", [FP16, FP16_FP32])
def test_kernels_match_plain_versions(policy, beta, page):
    dev = _card()
    rng = np.random.default_rng(5)
    kvh, g = 4, 7
    kv_len = [300, page, 1]
    kp, vp, table = _pool(rng, kv_len, kvh, page, dev)
    q = torch.from_numpy(
        rng.standard_normal((3, kvh, g, 128)).astype(np.float32)
    ).to(dev, torch.float16)
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    got = ops.pasa_paged_decode(q, kp, vp, table, kvl, beta=beta, policy=policy)
    want = dmod.paged_decode_plain(q, kp, vp, table, kvl, beta=beta,
                                   policy=policy, block_kv=page)
    torch.testing.assert_close(got.float(), want.float(), **DECODE_TOL)

    start = [0, 128, 0]
    plen = [128, 300, 0]                       # row 2: a dead pad row
    kp, vp, table = _pool(rng, plen, kvh, page, dev)
    table[2] = 0
    q = torch.from_numpy(
        rng.standard_normal((3, kvh * g, 200, 128)).astype(np.float32)
    ).to(dev, torch.float16)
    st = torch.tensor(start, dtype=torch.int32, device=dev)
    pl = torch.tensor(plen, dtype=torch.int32, device=dev)
    got = ops.pasa_paged_prefill(q, kp, vp, table, st, pl, beta=beta,
                                 policy=policy)
    want = pmod.paged_prefill_plain(q, kp, vp, table, st, pl, beta=beta,
                                    policy=policy)
    torch.testing.assert_close(got.float(), want.float(), **PREFILL_TOL)
    assert not got[2].any()


@pytest.mark.cuda
def test_unsupported_inputs_raise_instead_of_falling_back():
    dev = _card()
    rng = np.random.default_rng(6)
    kp, vp, table = _pool(rng, [10], 4, 128, dev)
    q = torch.zeros((1, 4, 7, 128), dtype=torch.float16, device=dev)
    kvl = torch.tensor([10], dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError):
        ops.pasa_paged_decode(q, kp, vp, table, kvl, policy=F64)
    with pytest.raises(ValueError):
        ops.pasa_paged_decode(q, kp, vp, table, kvl, block_kv=64)
    with pytest.raises(NotImplementedError):
        ops.pasa_paged_decode(q[..., :32], kp[..., :32].contiguous(),
                              vp[..., :32].contiguous(), table, kvl)


def _quantized(kp, vp, table, seq_lens, dtype):
    """The pool quantized per page by the port (valid rows only)."""
    page = kp.shape[1]
    valid = torch.zeros(kp.shape[:2], dtype=torch.bool, device=kp.device)
    for b, n in enumerate(seq_lens):
        for j in range(math.ceil(n / page)):
            valid[int(table[b, j]), :min(page, n - j * page)] = True
    kq, ks, kh = quantize_kv_page(kp, valid, dtype)
    vq, vs, vh = quantize_kv_page(vp, valid, dtype)
    return kq, vq, dict(k_scale=ks, k_shift=kh, v_scale=vs, v_shift=vh), valid


@pytest.mark.cuda
def test_quantized_pool_mode_raises_before_any_launch():
    """A quantized call the kernels do not take raises, and nothing is
    launched: the float64 oracle policy, sidecars with a raw pool, an
    8-bit pool without sidecars, a page over 128 rows."""
    dev = _card()
    rng = np.random.default_rng(12)
    kp, vp, table = _pool(rng, [10], 4, 128, dev)
    kq, vq, quant, _ = _quantized(kp, vp, table, [10], "int8")
    q = torch.zeros((1, 4, 7, 128), dtype=torch.float16, device=dev)
    qp = torch.zeros((1, 28, 16, 128), dtype=torch.float16, device=dev)
    kvl = torch.tensor([10], dtype=torch.int32, device=dev)
    st = torch.zeros(1, dtype=torch.int32, device=dev)
    ops.reset_launches()
    with pytest.raises(NotImplementedError):
        ops.pasa_paged_decode(q, kq, vq, table, kvl, policy=F64, **quant)
    with pytest.raises(NotImplementedError):
        ops.pasa_paged_prefill(qp, kq, vq, table, st, kvl, policy=F64, **quant)
    with pytest.raises(NotImplementedError):
        ops.pasa_paged_decode(q, kp, vp, table, kvl, **quant)
    with pytest.raises(NotImplementedError):
        ops.pasa_paged_decode(q, kq, vq, table, kvl)
    big = torch.zeros((2, 256, 4, 128), dtype=torch.int8, device=dev)
    side = dict(k_scale=torch.ones(2, 4, device=dev),
                k_shift=torch.zeros(2, 4, 128, device=dev))
    side.update(v_scale=side["k_scale"], v_shift=side["k_shift"])
    with pytest.raises(NotImplementedError):
        ops.pasa_paged_decode(q, big, big, table[:, :1], kvl, block_kv=256,
                              **side)
    assert ops.pasa_paged_decode.launches == ops.pasa_paged_prefill.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("policy", [FP16, FP16_FP32])
def test_quantized_kernels_match_plain_versions(policy, dtype):
    """The quantized mode of both paged kernels against their plain
    versions on the same codes and sidecars (a shuffled pool with keys of
    mean 2, NaN past kv_len before quantization)."""
    dev = _card()
    rng = np.random.default_rng(13)
    kvh, g, page = 4, 7, 128
    kv_len = [300, page, 1]
    kp, vp, table = _pool(rng, kv_len, kvh, page, dev)
    kq, vq, quant, _ = _quantized(kp, vp, table, kv_len, dtype)
    q = torch.from_numpy(
        rng.standard_normal((3, kvh, g, 128)).astype(np.float32)
    ).to(dev, torch.float16)
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    ops.reset_launches()
    got = ops.pasa_paged_decode(q, kq, vq, table, kvl, beta=BETA,
                                policy=policy, **quant)
    want = dmod.paged_decode_plain(q, kq, vq, table, kvl, beta=BETA,
                                   policy=policy, block_kv=page, **quant)
    torch.testing.assert_close(got.float(), want.float(), **DECODE_TOL)

    start, plen = [0, 128, 0], [128, 300, 0]
    kp, vp, table = _pool(rng, plen, kvh, page, dev)
    table[2] = 0
    kq, vq, quant, _ = _quantized(kp, vp, table, plen, dtype)
    q = torch.from_numpy(
        rng.standard_normal((3, kvh * g, 200, 128)).astype(np.float32)
    ).to(dev, torch.float16)
    st = torch.tensor(start, dtype=torch.int32, device=dev)
    pl = torch.tensor(plen, dtype=torch.int32, device=dev)
    got = ops.pasa_paged_prefill(q, kq, vq, table, st, pl, beta=BETA,
                                 policy=policy, **quant)
    want = pmod.paged_prefill_plain(q, kq, vq, table, st, pl, beta=BETA,
                                    policy=policy, **quant)
    torch.testing.assert_close(got.float(), want.float(), **PREFILL_TOL)
    assert not got[2].any()
    assert ops.pasa_paged_decode.launches == ops.pasa_paged_prefill.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "fp8_e4m3"])
def test_quantized_debris_and_dead_sidecars_are_inert(dtype):
    """Codes past kv_len set to NaN (fp8) or 127 (int8) and NaN sidecars
    on every dead page change no bit of either kernel's output."""
    dev = _card()
    rng = np.random.default_rng(14)
    kvh, g, page = 4, 7, 128
    kv_len = [300, 1]
    kp, vp, table = _pool(rng, kv_len, kvh, page, dev)
    kq, vq, quant, valid = _quantized(kp, vp, table, kv_len, dtype)
    bad = float("nan") if dtype == "fp8_e4m3" else 127.0
    stale = ~valid[..., None, None]
    kq2, vq2 = (torch.where(stale, bad, x.float()).to(x.dtype) for x in (kq, vq))
    dead = ~valid.any(1)
    quant2 = {n: torch.where(dead.reshape((-1,) + (1,) * (x.dim() - 1)),
                             float("nan"), x) for n, x in quant.items()}
    q = torch.from_numpy(
        rng.standard_normal((2, kvh, g, 128)).astype(np.float32)
    ).to(dev, torch.float16)
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    clean = ops.pasa_paged_decode(q, kq, vq, table, kvl, beta=BETA, **quant)
    dirty = ops.pasa_paged_decode(q, kq2, vq2, table, kvl, beta=BETA, **quant2)
    assert torch.isfinite(clean.float()).all()
    assert torch.equal(clean, dirty)
    qp = torch.from_numpy(
        rng.standard_normal((2, kvh * g, 64, 128)).astype(np.float32)
    ).to(dev, torch.float16)
    st = torch.tensor([256, 0], dtype=torch.int32, device=dev)
    pl = torch.tensor([300, 1], dtype=torch.int32, device=dev)
    clean = ops.pasa_paged_prefill(qp, kq, vq, table, st, pl, beta=BETA,
                                   **quant)
    dirty = ops.pasa_paged_prefill(qp, kq2, vq2, table, st, pl, beta=BETA,
                                   **quant2)
    assert torch.isfinite(clean.float()).all()
    assert torch.equal(clean, dirty)


@pytest.mark.cuda
def test_engine_on_card_batched_equals_one_at_a_time():
    """A two-layer dense model at head_dim 128 served on the card: every
    attention call goes through the kernels (28 -> 2 launches per call
    here), and each request's stream among staggered others equals its
    stream served alone by an identically configured engine."""
    dev = _card()
    base = get_config("qwen2-7b")
    cfg = dataclasses.replace(
        base, n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=128,
        d_ff=512, vocab_size=512,
        attention=dataclasses.replace(base.attention, block_kv=64),
    )
    bundle = build(cfg)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    kw = dict(max_batch=3, num_pages=24, page_size=64, prefill_chunk=128,
              prefill_batch=2)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 512, n).tolist() for n in (150, 40, 260, 9)]

    ops.reset_launches()
    eng = ServeEngine(bundle, params, **kw)
    reqs = [eng.submit(p, 6) for p in prompts[:2]]
    eng.step()
    reqs += [eng.submit(p, 6) for p in prompts[2:]]
    eng.run_to_completion()
    assert ops.pasa_paged_prefill.launches == cfg.n_layers * eng.prefill_calls
    assert ops.pasa_paged_decode.launches == cfg.n_layers * eng.decode_calls
    for p, r in zip(prompts, reqs):
        alone = ServeEngine(bundle, params, **kw)
        solo = alone.submit(p, 6)
        alone.run_to_completion()
        assert solo.generated == r.generated


def _randn(rng, shape, mean, dev, dtype=torch.float16):
    x = rng.standard_normal(shape).astype(np.float32) + mean
    return torch.from_numpy(x).to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("policy", [FP16, FP16_FP32])
def test_dense_kernels_match_plain_versions(policy, causal):
    dev = _card()
    rng = np.random.default_rng(9)
    b, h, kvh, s, d = 2, 8, 4, 256, 128
    # keys as the dense prefill holds them: bf16 (B, S, KVH, D), strided
    k = _randn(rng, (b, s, kvh, d), 2.0, dev, torch.bfloat16).transpose(1, 2)
    got = ops.shift_kv(k, beta=BETA, policy=policy)
    m = smod.device_matrix(128, d, BETA, torch.float16, dev)
    torch.testing.assert_close(
        got.float(), smod.shift_kv_plain(m, k.half(), 128).float(), **SHIFT_TOL)

    q = _randn(rng, (b, h, s, d), 0.0, dev)
    v = _randn(rng, (b, kvh, s, d), 0.0, dev)
    for beta in (BETA, 0.0):
        fn = (ops.flash_attention if beta == 0.0 else
              lambda *a, **kw: ops.pasa_attention(*a, beta=BETA, **kw))
        got = fn(q, k, v, policy=policy, causal=causal)
        want = amod.attention_plain(q, k, v, beta=beta, policy=policy,
                                    block_kv=128, causal=causal)
        torch.testing.assert_close(got.float(), want.float(),
                                   **ATTN_TOL[causal])

    kv_len = torch.tensor([300, 1], dtype=torch.int32, device=dev)
    kc = _randn(rng, (b, 320, kvh, d), 2.0, dev, torch.bfloat16)
    vc = _randn(rng, (b, 320, kvh, d), 0.0, dev, torch.bfloat16)
    kc[0, 300:] = float("nan")
    vc[1, 1:] = float("nan")
    qd = _randn(rng, (b, kvh, 7, d), 0.0, dev)
    got = ops.pasa_decode(qd, kc.transpose(1, 2), vc.transpose(1, 2), kv_len,
                          beta=BETA, policy=policy, block_kv=128)
    want = cmod.decode_plain(qd, kc.transpose(1, 2), vc.transpose(1, 2),
                             kv_len, beta=BETA, policy=policy, block_kv=128)
    torch.testing.assert_close(got.float(), want.float(), **DECODE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [64, 128])
def test_contiguous_decode_equals_paged_decode_bit_for_bit(block):
    dev = _card()
    rng = np.random.default_rng(10)
    kvh, g, d = 4, 7, 128
    kv_lens = [300, block, 1]
    kp, vp, table = _pool(rng, kv_lens, kvh, block, dev)
    n = table.shape[1] * block
    # the same rows laid out contiguously: (B, n, KVH, D), NaN past kv_len
    kc = kp[table.long()].reshape(len(kv_lens), n, kvh, d)
    vc = vp[table.long()].reshape(len(kv_lens), n, kvh, d)
    q = _randn(rng, (len(kv_lens), kvh, g, d), 0.0, dev)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    for beta in (0.0, BETA):
        paged = ops.pasa_paged_decode(q, kp, vp, table, kvl, beta=beta)
        contiguous = ops.pasa_decode(q, kc.transpose(1, 2), vc.transpose(1, 2),
                                     kvl, beta=beta, block_kv=block)
        walk = cmod._walk_call(q, kc.transpose(1, 2), vc.transpose(1, 2), kvl,
                               beta=beta, policy=FP16, block_kv=block)
        assert torch.isfinite(contiguous.float()).all()
        assert torch.equal(contiguous, paged)
        assert torch.equal(contiguous, walk)


@pytest.mark.cuda
def test_unsupported_dense_inputs_raise_before_any_launch():
    dev = _card()
    q = torch.zeros((1, 4, 128, 128), dtype=torch.float16, device=dev)
    k = torch.zeros((1, 2, 128, 128), dtype=torch.float16, device=dev)
    ops.reset_launches()
    with pytest.raises(NotImplementedError):
        ops.pasa_attention(q, k, k, policy=F64)
    qd0 = torch.zeros((1, 2, 2, 128), dtype=torch.float16, device=dev)
    with pytest.raises(NotImplementedError):
        ops.pasa_decode(qd0, k, k, torch.tensor([5], dtype=torch.int32,
                                                device=dev), policy=F64)
    q2, k2 = torch.cat([q, q], 2), torch.cat([k, k], 2)      # 256 rows
    with pytest.raises(NotImplementedError):
        ops.pasa_attention(q2, k2, k2, block_q=256, block_kv=256)
    with pytest.raises(NotImplementedError):
        ops.pasa_attention(q[..., :32], k[..., :32], k[..., :32])
    with pytest.raises(ValueError):
        ops.pasa_attention(q[:, :, :100], k, k)
    with pytest.raises(ValueError):                 # a pad of a whole block
        ops.pasa_attention(q, k, k, kv_valid=0)
    qd = torch.zeros((1, 2, 2, 128), dtype=torch.float16, device=dev)
    kvl = torch.tensor([5], dtype=torch.int32, device=dev)
    k3 = torch.zeros((1, 2, 544, 128), dtype=torch.float16, device=dev)
    for block in (272, 200):        # over 256; not a multiple of 16
        with pytest.raises(NotImplementedError):
            ops.pasa_decode(qd, k3, k3, kvl, block_kv=block)
    for block in (32, 256):         # the shift kernel takes 64 or 128
        with pytest.raises(NotImplementedError):
            ops.shift_kv(k2, block_kv=block)
    # head widths: the decodes, attention and shift-KV take 64 and 128;
    # paged prefill 128 only
    with pytest.raises(NotImplementedError):
        ops.shift_kv(k[..., :32].contiguous())
    with pytest.raises(NotImplementedError):
        ops.flash_attention(q[..., :32], k[..., :32], k[..., :32])
    pool = torch.zeros((2, 128, 2, 64), dtype=torch.bfloat16, device=dev)
    table = torch.ones((1, 1), dtype=torch.int32, device=dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError):
        ops.pasa_paged_prefill(q[:, :, :16, :64].contiguous(), pool, pool,
                               table, zero, kvl)
    with pytest.raises(NotImplementedError):
        ops.pasa_decode(qd[..., :32], k[..., :32], k[..., :32], kvl)
    with pytest.raises(NotImplementedError):
        ops.pasa_paged_decode(qd[..., :32], pool[..., :32].contiguous(),
                              pool[..., :32].contiguous(), table, kvl)
    assert ops.shift_kv.launches == ops.pasa_attention.launches == 0
    assert ops.flash_attention.launches == ops.pasa_paged_prefill.launches == 0
    assert ops.pasa_decode.launches == ops.pasa_paged_decode.launches == 0


def _decode_gold(q, kc, vc, kv_lens):
    """float64 softmax(q k^T / sqrt(d)) v per sequence over its first
    kv_len rows of the (B, S2, KVH, D) cache."""
    golds = []
    for i, n in enumerate(kv_lens):
        kk, vv = kc[i, :n].double(), vc[i, :n].double()
        sc = q[i].double() @ kk.permute(1, 2, 0) / math.sqrt(q.shape[-1])
        golds.append(torch.softmax(sc, -1) @ vv.transpose(0, 1))
    return torch.stack(golds)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [7, 12])
def test_contiguous_decode_runs_at_the_default_block(g):
    """ops.pasa_decode(q, k, v, kv_len) at its default block of 256 rows
    (the reference's): a block reaches the cluster kernel in two pieces of
    128 rows and its math runs once over all 256.  Within the decode bar
    of the plain version at block 256, within relative RMSE 0.03 of
    float64 attention, and equal bit for bit to the sequential walk at
    256 - at both policies, PASA and FlashAttention-2, at kv_len 1, 255,
    256, 257, 1000 and 4095 (NaN past kv_len)."""
    dev = _card()
    rng = np.random.default_rng(16)
    kvh, d = 4, 128
    kv_lens = [1, 255, 256, 257, 1000, 4095]
    b, s2 = len(kv_lens), 4096
    kc = _randn(rng, (b, s2, kvh, d), 2.0, dev, torch.bfloat16)
    vc = _randn(rng, (b, s2, kvh, d), 0.0, dev, torch.bfloat16)
    for i, n in enumerate(kv_lens):
        kc[i, n:] = float("nan")
        vc[i, n:] = float("nan")
    kview, vview = kc.transpose(1, 2), vc.transpose(1, 2)
    q = _randn(rng, (b, kvh, g, d), 0.0, dev)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    ops.reset_launches()
    got = ops.pasa_decode(q, kview, vview, kvl)          # the defaults
    assert ops.pasa_decode.launches == 1
    want = cmod.decode_plain(q, kview, vview, kvl, beta=DEFAULT_BETA,
                             policy=FP16, block_kv=256)
    torch.testing.assert_close(got.float(), want.float(), **DECODE_TOL)
    gold = _decode_gold(q, kc, vc, kv_lens)
    assert float((got.double() - gold).norm() / gold.norm()) < 0.03
    for policy in (FP16, FP16_FP32):
        for beta in (0.0, BETA):
            cluster = ops.pasa_decode(q, kview, vview, kvl, beta=beta,
                                      policy=policy, block_kv=256)
            walk = cmod._walk_call(q, kview, vview, kvl, beta=beta,
                                   policy=policy, block_kv=256)
            assert torch.isfinite(cluster.float()).all()
            assert torch.equal(cluster, walk), (policy.name, beta)
            plain = cmod.decode_plain(q, kview, vview, kvl, beta=beta,
                                      policy=policy, block_kv=256)
            torch.testing.assert_close(cluster.float(), plain.float(),
                                       **DECODE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["strided", "contiguous"])
@pytest.mark.parametrize("mode", ["fp16", "bf16_keys", "bf16_fp32"])
@pytest.mark.parametrize("block", [64, 128])
def test_shift_kernel_matches_plain_version(block, mode, layout):
    """The shift kernel (TMA + wgmma) against its plain version at blocks
    64 and 128: fp16 keys and bf16 keys (rounded to fp16 on chip) under
    fp16 operands, and bf16 operands (the bf16_fp32 policy); keys as the
    dense prefill holds them ((B, S, KVH, D), read through strides) or
    contiguous; a grid of many blocks, a single block, and B * KVH = 1.
    Within the reference's shift bar of the plain version and within
    relative RMSE 1e-2 of the float64 product with the same M."""
    dev = _card()
    rng = np.random.default_rng(17)
    policy = BF16_FP32 if mode == "bf16_fp32" else FP16
    kdt = torch.float16 if mode == "fp16" else torch.bfloat16
    op = policy.input_dtype
    for b, kvh, s in ((2, 4, 512), (1, 2, block), (1, 1, 3 * block)):
        k = _randn(rng, (b, s, kvh, 128), 5.0, dev, kdt)
        k = k.transpose(1, 2) if layout == "strided" else \
            k.transpose(1, 2).contiguous()
        ops.reset_launches()
        got = ops.shift_kv(k, beta=BETA, block_kv=block, policy=policy)
        assert ops.shift_kv.launches == 1
        assert ops.shift_kv.launches_by_mode == {
            smod.mode_name(kdt, op, block): 1}
        assert got.dtype == op and got.is_contiguous()
        m = smod.device_matrix(block, 128, BETA, op, dev)
        want = smod.shift_kv_plain(m, k.to(op), block, out_dtype=op)
        torch.testing.assert_close(got.float(), want.float(), **SHIFT_TOL)
        gold = torch.matmul(m.double(), k.to(op).double().reshape(
            b, kvh, s // block, block, 128)).reshape(b, kvh, s, 128)
        assert float((got.double() - gold).norm() / gold.norm()) \
            < SHIFT_RMSE_MAX
        if op == torch.float16:
            ref = shift_kv_reference(k.to(op), 128, BETA, block)
            assert float((got.double() - ref).norm() / ref.norm()) \
                < SHIFT_RMSE_MAX


@pytest.mark.cuda
def test_dense_route_on_card_batched_equals_one_at_a_time():
    """A two-layer dense model at head_dim 128 on the dense route: each
    prefill call launches shift-KV and PASA attention once per layer, each
    decode step the contiguous decode kernel once per layer, and every
    prompt's stream in the batch equals its stream served alone."""
    dev = _card()
    base = get_config("qwen2-7b")
    cfg = dataclasses.replace(
        base, n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=128,
        d_ff=512, vocab_size=512,
    )
    bundle = build(cfg)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    step = make_serve_step(bundle)
    rng = np.random.default_rng(11)
    prompts = torch.from_numpy(rng.integers(0, 512, (3, 200), dtype=np.int32)
                               ).to(dev)
    gen = 6

    def run(tokens):
        b, s = tokens.shape
        cache = bundle.init_cache(b, s + gen + 8, device=dev)
        logits, cache = bundle.prefill(params, tokens, cache)
        tok = torch.argmax(logits, -1).to(torch.int32)
        out = [tok]
        for i in range(s, s + gen - 1):
            pos = torch.full((b,), i, dtype=torch.int32, device=dev)
            tok, logits, cache = step(params, tok, pos, cache)
            assert torch.isfinite(logits).all()
            out.append(tok)
        return torch.stack(out, 1)

    ops.reset_launches()
    streams = run(prompts)
    assert ops.shift_kv.launches == ops.pasa_attention.launches == cfg.n_layers
    assert sum(ops.shift_kv.launches_by_mode.values()) == cfg.n_layers
    assert ops.pasa_decode.launches == cfg.n_layers * (gen - 1)
    assert ops.pasa_paged_decode.launches == ops.pasa_paged_prefill.launches == 0
    for i in range(prompts.shape[0]):
        assert torch.equal(run(prompts[i:i + 1])[0], streams[i])


@pytest.mark.cuda
@pytest.mark.parametrize("g", [7, 12])
@pytest.mark.parametrize("page", [64, 128])
def test_paged_decode_equals_contiguous_at_cluster_boundaries(page, g):
    """Both decode kernels spread a sequence's blocks over a cluster of 8
    CTAs and fold their partials in order - the paged one over a page
    pool, the contiguous one over a strided cache; the contiguous
    source's sequential walk folds the same rows one block after another.
    All three bit for bit equal at 1, 7, 8, 9, 16, 17 and 33 live blocks
    (full and ragged last blocks), at both policies, PASA and
    FlashAttention-2, for groups of up to 8 and of up to 16 rows (the
    kernels' two register layouts)."""
    dev = _card()
    rng = np.random.default_rng(15)
    kvh, d = 4, 128
    n_pages = [1, 7, 8, 9, 16, 17, 33]
    kv_lens = [n * page - (i % 2) * (page // 3) for i, n in enumerate(n_pages)]
    kp, vp, table = _pool(rng, kv_lens, kvh, page, dev)
    n = table.shape[1] * page
    kc = kp[table.long()].reshape(len(kv_lens), n, kvh, d)
    vc = vp[table.long()].reshape(len(kv_lens), n, kvh, d)
    q = _randn(rng, (len(kv_lens), kvh, g, d), 0.0, dev)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    for policy in (FP16, FP16_FP32):
        for beta in (0.0, BETA):
            paged = ops.pasa_paged_decode(q, kp, vp, table, kvl, beta=beta,
                                          policy=policy)
            contiguous = ops.pasa_decode(q, kc.transpose(1, 2),
                                         vc.transpose(1, 2), kvl, beta=beta,
                                         policy=policy, block_kv=page)
            walk = cmod._walk_call(q, kc.transpose(1, 2), vc.transpose(1, 2),
                                   kvl, beta=beta, policy=policy,
                                   block_kv=page)
            assert torch.isfinite(paged.float()).all()
            assert torch.equal(contiguous, walk), (policy.name, beta)
            assert torch.equal(paged, walk), (policy.name, beta)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "fp8_e4m3"])
def test_quantized_paged_decode_is_invariant_to_page_placement(dtype):
    """The same quantized pages (codes and sidecars) at other physical
    places, the page table rewritten to match: the same bits."""
    dev = _card()
    rng = np.random.default_rng(16)
    kvh, g, page = 4, 7, 128
    kv_len = [17 * 128 + 5, 300, 1, 1000]
    kp, vp, table = _pool(rng, kv_len, kvh, page, dev)
    kq, vq, quant, _ = _quantized(kp, vp, table, kv_len, dtype)
    perm = torch.from_numpy(rng.permutation(kp.shape[0])).to(dev)

    def moved(x):          # page p of x at perm[p] (fp8 moved as bytes)
        y = x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else x
        return torch.empty_like(y).index_copy_(0, perm, y).view(x.dtype)

    kq2, vq2 = moved(kq), moved(vq)
    quant2 = {n: moved(x) for n, x in quant.items()}
    table2 = perm[table.long()].to(torch.int32)
    q = _randn(rng, (len(kv_len), kvh, g, 128), 0.0, dev)
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    for policy in (FP16, FP16_FP32):
        a = ops.pasa_paged_decode(q, kq, vq, table, kvl, beta=BETA,
                                  policy=policy, **quant)
        b = ops.pasa_paged_decode(q, kq2, vq2, table2, kvl, beta=BETA,
                                  policy=policy, **quant2)
        assert torch.isfinite(a.float()).all()
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [(128, 128), (64, 64), (128, 64)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("group", [1, 7])
@pytest.mark.parametrize("s", [128, 1024])
def test_attention_kernel_matches_plain_version(s, group, causal, blocks):
    """PASA and FlashAttention-2 from the attention kernel against the
    plain version: one key tile (S = 128) and the dense prefill's 1024,
    GQA groups 1 and 7, each supported (block_q, block_kv)."""
    dev = _card()
    rng = np.random.default_rng(17)
    bq, bkv = blocks
    b, kvh, d = 2, 2, 128
    q = _randn(rng, (b, kvh * group, s, d), 0.0, dev)
    k = _randn(rng, (b, kvh, s, d), 2.0, dev)
    v = _randn(rng, (b, kvh, s, d), 0.0, dev)
    for beta, policy in ((BETA, FP16), (0.0, FP16_FP32)):
        fn = ops.flash_attention if beta == 0.0 else functools.partial(
            ops.pasa_attention, beta=BETA)
        got = fn(q, k, v, policy=policy, causal=causal, block_q=bq,
                 block_kv=bkv)
        want = amod.attention_plain(q, k, v, beta=beta, policy=policy,
                                    block_kv=bkv, causal=causal)
        torch.testing.assert_close(got.float(), want.float(),
                                   **ATTN_TOL[causal])


@pytest.mark.cuda
def test_attention_kernel_overflow_headline():
    """Inputs near 30: FlashAttention-2's fp16 score store overflows in
    the kernel, PASA at the all-fp16 policy stays finite."""
    dev = _card()
    rng = np.random.default_rng(18)
    u = lambda shape: torch.from_numpy(
        rng.uniform(29.5, 30.5, shape).astype(np.float32)).to(dev, torch.half)
    q, k, v = u((1, 7, 256, 128)), u((1, 1, 256, 128)), u((1, 1, 256, 128))
    bad = ops.flash_attention(q, k, v, policy=FP16_FP32)
    good = ops.pasa_attention(q, k, v, beta=BETA, policy=FP16)
    assert not torch.isfinite(bad.float()).all()
    assert torch.isfinite(good.float()).all()


def _prefill_pool(rng, seq_lens, kvh, page, dev, pool):
    """A shuffled pool for prefill rows (NaN past each length), raw bf16
    or quantized per page to ``pool``; returns (k, v, table, sidecars)."""
    kp, vp, table = _pool(rng, seq_lens, kvh, page, dev)
    if pool == "bf16":
        return kp, vp, table, {}
    kq, vq, quant, _ = _quantized(kp, vp, table, seq_lens, pool)
    return kq, vq, table, quant


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["bf16", "int8", "fp8_e4m3"])
@pytest.mark.parametrize("group", [1, 7])
@pytest.mark.parametrize("page", [16, 64, 128])
def test_prefill_kernel_matches_plain_version(page, group, pool):
    """The paged prefill kernel against its plain version at pages 16, 64
    and 128 (wgmma at N = 64 and 128, surplus columns masked), GQA
    groups 1 and 7, raw and 8-bit pools, both policies, PASA and
    FlashAttention-2, with chunks that start off the kernel's 128-row
    query tiles (37, 130), a chunk of 100 queries and a pad row.  Keys
    have mean 2; PASA is held at queries of mean 1, FlashAttention-2 at
    mean 0: it stores the raw scores (~256 at mean 1, fp16 ulp 0.25) at
    fp16 before the 1/sqrt(d) scale, and two summation orders then part
    by more than the tolerance on rows that see a few keys."""
    dev = _card()
    rng = np.random.default_rng(19)
    kvh = 2
    start, plen = [0, 37, 130, 0], [100, 137, 230, 0]
    kp, vp, table, quant = _prefill_pool(rng, plen, kvh, page, dev, pool)
    table[3] = 0
    qs = {BETA: _randn(rng, (4, kvh * group, 100, 128), 1.0, dev),
          0.0: _randn(rng, (4, kvh * group, 100, 128), 0.0, dev)}
    st = torch.tensor(start, dtype=torch.int32, device=dev)
    pl = torch.tensor(plen, dtype=torch.int32, device=dev)
    for policy in (FP16, FP16_FP32):
        for beta, q in qs.items():
            got = ops.pasa_paged_prefill(q, kp, vp, table, st, pl, beta=beta,
                                         policy=policy, **quant)
            want = pmod.paged_prefill_plain(q, kp, vp, table, st, pl,
                                            beta=beta, policy=policy, **quant)
            assert torch.isfinite(got.float()).all()
            torch.testing.assert_close(got.float(), want.float(),
                                       **PREFILL_TOL)
            assert not got[3].any()


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("page", [16, 64, 128])
def test_prefill_kernel_is_chunk_schedule_and_batch_invariant(page, pool):
    """A 300-query prompt (290 valid) prefilled in one chunk, or as two
    chunks split at a page-aligned cut or at 37 / 130 (off the kernel's
    query tiles and, for pages over 1, inside a page): the second chunk's
    rows are bit-identical to the same rows of the single chunk, and at a
    page-aligned cut the first chunk's too.  The prompt's output is also
    the same whether it is prefilled alone or beside other rows."""
    dev = _card()
    rng = np.random.default_rng(20)
    kvh, g, n = 2, 7, 290
    kp, vp, table, quant = _prefill_pool(rng, [n, 200], kvh, page, dev, pool)
    q = _randn(rng, (2, kvh * g, 300, 128), 1.0, dev)
    run = lambda qq, rows, s0, kvl: ops.pasa_paged_prefill(
        qq, kp, vp, table[rows],
        torch.tensor(s0, dtype=torch.int32, device=dev),
        torch.tensor(kvl, dtype=torch.int32, device=dev), beta=BETA,
        **quant)
    one = run(q[:1], [0], [0], [n])
    both = run(q, [0, 1], [0, 0], [n, 200])
    assert torch.isfinite(one.float()).all()
    assert torch.equal(both[:1], one)
    for cut in (37, 130, 2 * page):
        first = run(q[:1, :, :cut], [0], [0], [cut])
        second = run(q[:1, :, cut:], [0], [cut], [n])
        assert torch.equal(second, one[:, :, cut:]), cut
        if cut % page == 0:
            assert torch.equal(first, one[:, :, :cut]), cut


# ---- the fp32 and bf16_fp32 policy modes of the four attention kernels --
#
# fp32: fp16 operands, scores, statistics and accumulator fp32, fp16
# output; bf16_fp32: bf16 operands and output, the rest fp32.  Each kernel
# against its plain version at the reference's bars and within relative
# RMSE 0.02 (attention) / 0.03 (decode, prefill) of float64 attention.

NEW_MODES = [FP32, BF16_FP32]
# tests/test_kv_quant.py RMSE_BOUND: the 8-bit pools vs float64 attention
# on the unquantized K/V at the FP32 policy
QUANT_RMSE_BOUND = {"int8": 0.03, "fp8_e4m3": 0.09}


def _rel_rmse(got, gold) -> float:
    return float((got.double() - gold).norm() / gold.norm())


def _paged_gold(q, kp, vp, table, starts, kv_lens, causal):
    """float64 attention of each row of q (B, H, S, D) (or a decode's (B,
    KVH, G, D)) over its first kv_len positions of the pool; ``causal``
    with the rows' chunk starts."""
    golds = []
    for i, n in enumerate(kv_lens):
        flat = lambda x: x[table[i].long()].reshape(-1, *x.shape[2:])[:n]
        kk = flat(kp).movedim(0, 1).double()            # (KVH, n, D)
        vv = flat(vp).movedim(0, 1).double()
        g = q.shape[1] // kk.shape[0] if causal else 1
        kk, vv = kk.repeat_interleave(g, 0), vv.repeat_interleave(g, 0)
        sc = q[i].double() @ kk.transpose(-1, -2) / math.sqrt(q.shape[-1])
        if causal:
            qpos = starts[i] + torch.arange(q.shape[2], device=q.device)
            sc = sc.masked_fill(
                qpos[:, None] < torch.arange(n, device=q.device)[None, :],
                -math.inf)
        golds.append(torch.softmax(sc, -1) @ vv)
    return torch.stack(golds)


@pytest.mark.cuda
@pytest.mark.parametrize("page", [64, 128])
@pytest.mark.parametrize("policy", NEW_MODES, ids=lambda p: p.name)
def test_paged_kernels_in_new_modes(policy, page):
    """Paged decode and prefill at fp32 and bf16_fp32 from a bf16 pool,
    PASA and FlashAttention-2: output at the policy's dtype, within the
    decode / prefill bars of the plain version and relative RMSE 0.03 of
    float64 attention."""
    dev = _card()
    rng = np.random.default_rng(21)
    kvh, g = 4, 7
    kv_len = [300, page, 1, 1000]
    kp, vp, table = _pool(rng, kv_len, kvh, page, dev)
    q = _randn(rng, (4, kvh, g, 128), 0.0, dev)
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    for beta in (0.0, BETA):
        got = ops.pasa_paged_decode(q, kp, vp, table, kvl, beta=beta,
                                    policy=policy)
        want = dmod.paged_decode_plain(q, kp, vp, table, kvl, beta=beta,
                                       policy=policy, block_kv=page)
        assert got.dtype == policy.out_dtype
        torch.testing.assert_close(got.float(), want.float(), **DECODE_TOL)
        gold = _paged_gold(q, kp, vp, table, None, kv_len, False)
        assert _rel_rmse(got, gold) < 0.03

    start, plen = [0, 37, 130, 0], [100, 137, 230, 0]
    kp, vp, table = _pool(rng, plen, kvh, page, dev)
    table[3] = 0
    st = torch.tensor(start, dtype=torch.int32, device=dev)
    pl = torch.tensor(plen, dtype=torch.int32, device=dev)
    for beta, q_mean in ((0.0, 0.0), (BETA, 1.0)):
        q = _randn(rng, (4, kvh * g, 100, 128), q_mean, dev)
        got = ops.pasa_paged_prefill(q, kp, vp, table, st, pl, beta=beta,
                                     policy=policy)
        want = pmod.paged_prefill_plain(q, kp, vp, table, st, pl, beta=beta,
                                        policy=policy)
        assert got.dtype == policy.out_dtype
        torch.testing.assert_close(got.float(), want.float(), **PREFILL_TOL)
        assert not got[3].any()
        gold = _paged_gold(q[:3], kp, vp, table, start, plen[:3], True)
        assert _rel_rmse(got[:3], gold) < 0.03


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("policy", NEW_MODES, ids=lambda p: p.name)
def test_quantized_kernels_in_new_modes(policy, dtype):
    """The quantized mode of both paged kernels at fp32 and bf16_fp32 (the
    codes dequantized once to the input dtype): within the bars of the
    plain version, and at fp32 within the reference's per-pool RMSE
    bound of float64 attention on the unquantized K/V."""
    dev = _card()
    rng = np.random.default_rng(22)
    kvh, g, page = 4, 7, 128
    kv_len = [300, 128, 1, 1000]
    kp, vp, table = _pool(rng, kv_len, kvh, page, dev)
    kq, vq, quant, _ = _quantized(kp, vp, table, kv_len, dtype)
    q = _randn(rng, (4, kvh, g, 128), 0.0, dev)
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    got = ops.pasa_paged_decode(q, kq, vq, table, kvl, beta=BETA,
                                policy=policy, **quant)
    want = dmod.paged_decode_plain(q, kq, vq, table, kvl, beta=BETA,
                                   policy=policy, block_kv=page, **quant)
    assert got.dtype == policy.out_dtype
    torch.testing.assert_close(got.float(), want.float(), **DECODE_TOL)
    if policy is FP32:
        gold = _paged_gold(q, kp, vp, table, None, kv_len, False)
        assert _rel_rmse(got, gold) < QUANT_RMSE_BOUND[dtype]

    start, plen = [0, 37, 0], [100, 137, 0]
    kp, vp, table = _pool(rng, plen, kvh, page, dev)
    table[2] = 0
    kq, vq, quant, _ = _quantized(kp, vp, table, plen, dtype)
    q = _randn(rng, (3, kvh * g, 100, 128), 1.0, dev)
    st = torch.tensor(start, dtype=torch.int32, device=dev)
    pl = torch.tensor(plen, dtype=torch.int32, device=dev)
    got = ops.pasa_paged_prefill(q, kq, vq, table, st, pl, beta=BETA,
                                 policy=policy, **quant)
    want = pmod.paged_prefill_plain(q, kq, vq, table, st, pl, beta=BETA,
                                    policy=policy, **quant)
    assert got.dtype == policy.out_dtype
    torch.testing.assert_close(got.float(), want.float(), **PREFILL_TOL)
    assert not got[2].any()
    if policy is FP32:
        gold = _paged_gold(q[:2], kp, vp, table, start, plen[:2], True)
        assert _rel_rmse(got[:2], gold) < QUANT_RMSE_BOUND[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("cache", [torch.bfloat16, torch.float16],
                         ids=["bf16_cache", "fp16_cache"])
@pytest.mark.parametrize("policy", NEW_MODES, ids=lambda p: p.name)
def test_contiguous_decode_in_new_modes(policy, cache):
    """Contiguous decode at fp32 and bf16_fp32, blocks 128 and 256, from a
    bf16 or fp16 cache read through strides (NaN past kv_len): within the
    decode bar of the plain version and relative RMSE 0.03 of float64."""
    dev = _card()
    rng = np.random.default_rng(23)
    kvh, g, d = 4, 7, 128
    kv_lens = [1, 300, 1000]
    kc = _randn(rng, (3, 1024, kvh, d), 2.0, dev, cache)
    vc = _randn(rng, (3, 1024, kvh, d), 0.0, dev, cache)
    for i, n in enumerate(kv_lens):
        kc[i, n:] = float("nan")
        vc[i, n:] = float("nan")
    kview, vview = kc.transpose(1, 2), vc.transpose(1, 2)
    q = _randn(rng, (3, kvh, g, d), 0.0, dev)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    gold = _decode_gold(q, kc, vc, kv_lens)
    for block in (128, 256):
        for beta in (0.0, BETA):
            got = ops.pasa_decode(q, kview, vview, kvl, beta=beta,
                                  policy=policy, block_kv=block)
            want = cmod.decode_plain(q, kview, vview, kvl, beta=beta,
                                     policy=policy, block_kv=block)
            assert got.dtype == policy.out_dtype
            torch.testing.assert_close(got.float(), want.float(),
                                       **DECODE_TOL)
            assert _rel_rmse(got, gold) < 0.03


@pytest.mark.cuda
@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("policy", NEW_MODES, ids=lambda p: p.name)
def test_decodes_bit_equal_in_new_modes(policy, block):
    """Contiguous decode == its sequential walk bit for bit at fp32 and
    bf16_fp32, and at block 128 == paged decode over the same rows, at
    kv_len 1, 255, 256, 257 and 4095, PASA and FlashAttention-2."""
    dev = _card()
    rng = np.random.default_rng(24)
    kvh, g, d = 4, 7, 128
    kv_lens = [1, 255, 256, 257, 4095]
    page = 128
    kp, vp, table = _pool(rng, kv_lens, kvh, page, dev)
    n = table.shape[1] * page
    kc = kp[table.long()].reshape(len(kv_lens), n, kvh, d)
    vc = vp[table.long()].reshape(len(kv_lens), n, kvh, d)
    kview, vview = kc.transpose(1, 2), vc.transpose(1, 2)
    q = _randn(rng, (len(kv_lens), kvh, g, d), 0.0, dev)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    for beta in (0.0, BETA):
        contiguous = ops.pasa_decode(q, kview, vview, kvl, beta=beta,
                                     policy=policy, block_kv=block)
        walk = cmod._walk_call(q.to(policy.input_dtype), kview, vview, kvl,
                               beta=beta, policy=policy, block_kv=block)
        assert torch.isfinite(contiguous.float()).all()
        assert torch.equal(contiguous, walk), beta
        if block == page:
            paged = ops.pasa_paged_decode(q, kp, vp, table, kvl, beta=beta,
                                          policy=policy)
            assert torch.equal(contiguous, paged), beta


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [(128, 128), (64, 64), (128, 64)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("policy", NEW_MODES, ids=lambda p: p.name)
def test_attention_kernel_in_new_modes(policy, causal, blocks):
    """PASA (queries of mean 0, keys of mean 2) and FlashAttention-2 at
    fp32 and bf16_fp32 at the dense prefill's S = 1024, GQA group 7: the
    output at the policy's dtype, within the reference's bars of the plain
    version (P enters the P V product rounded to the operand type) and
    relative RMSE 0.02 of float64 attention."""
    dev = _card()
    rng = np.random.default_rng(25)
    bq, bkv = blocks
    b, kvh, group, s, d = 2, 2, 7, 1024, 128
    q = _randn(rng, (b, kvh * group, s, d), 0.0, dev)
    k = _randn(rng, (b, kvh, s, d), 2.0, dev, torch.bfloat16)
    v = _randn(rng, (b, kvh, s, d), 0.0, dev, torch.bfloat16)
    kk = k.double().repeat_interleave(group, 1)
    sc = q.double() @ kk.transpose(-1, -2) / math.sqrt(d)
    if causal:
        sc = sc.masked_fill(torch.ones(s, s, dtype=torch.bool,
                                       device=dev).triu(1), -math.inf)
    gold = torch.softmax(sc, -1) @ v.double().repeat_interleave(group, 1)
    for beta in (BETA, 0.0):
        fn = ops.flash_attention if beta == 0.0 else functools.partial(
            ops.pasa_attention, beta=BETA)
        got = fn(q, k, v, policy=policy, causal=causal, block_q=bq,
                 block_kv=bkv)
        want = amod.attention_plain(q, k, v, beta=beta, policy=policy,
                                    block_kv=bkv, causal=causal)
        assert got.dtype == policy.out_dtype
        torch.testing.assert_close(got.float(), want.float(),
                                   **ATTN_TOL[causal or beta == 0.0])
        assert _rel_rmse(got, gold) < 0.02


@pytest.mark.cuda
def test_overflow_ordering_across_policies():
    """The paper's Table 4 ordering on the card, inputs uniform around
    x0 = 30: FlashAttention-2 at fp16_fp32 overflows its fp16 score store,
    at fp32 and bf16_fp32 (scores kept in fp32) it stays finite, and so
    does PASA at the all-fp16 policy; each launch reaches its kernel."""
    dev = _card()
    rng = np.random.default_rng(26)
    u = lambda shape: torch.from_numpy(
        rng.uniform(29.5, 30.5, shape).astype(np.float32)).to(dev, torch.half)
    q, k, v = u((1, 7, 256, 128)), u((1, 1, 256, 128)), u((1, 1, 256, 128))
    ops.reset_launches()
    assert not torch.isfinite(
        ops.flash_attention(q, k, v, policy=FP16_FP32).float()).all()
    for policy in (FP32, BF16_FP32):
        out = ops.flash_attention(q, k, v, policy=policy)
        assert out.dtype == policy.out_dtype
        assert torch.isfinite(out.float()).all(), policy.name
    assert torch.isfinite(
        ops.pasa_attention(q, k, v, beta=BETA, policy=FP16).float()).all()
    assert ops.flash_attention.launches_by_mode == {
        "fp16_fp32/float16": 1, "fp32/float16": 1, "bf16_fp32/float16": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["dense", "paged"])
def test_flash_serve_on_card_batched_equals_one_at_a_time(route):
    """impl="flash" at the bf16_fp32 policy on a two-layer model at head
    dim 128: the dense route launches FlashAttention-2 once per prefill
    and contiguous decode once per step, the engine both paged kernels
    once per call, each kernel only in its bf16_fp32 mode (no shift-KV);
    every prompt's stream in the batch equals its stream served alone."""
    dev = _card()
    base = get_config("qwen2-7b")
    cfg = dataclasses.replace(
        base, n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=128,
        d_ff=512, vocab_size=512,
        attention=dataclasses.replace(base.attention, impl="flash",
                                      block_kv=64),
    )
    bundle = build(cfg)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(27)
    gen = 6
    mode = "bf16_fp32/bfloat16"
    ops.reset_launches()
    if route == "dense":
        step = make_serve_step(bundle)
        prompts = torch.from_numpy(
            rng.integers(0, 512, (3, 200), dtype=np.int32)).to(dev)

        def run(tokens):
            b, s = tokens.shape
            cache = bundle.init_cache(b, s + gen + 8, device=dev)
            logits, cache = bundle.prefill(params, tokens, cache)
            tok = torch.argmax(logits, -1).to(torch.int32)
            out = [tok]
            for i in range(s, s + gen - 1):
                pos = torch.full((b,), i, dtype=torch.int32, device=dev)
                tok, logits, cache = step(params, tok, pos, cache)
                assert torch.isfinite(logits).all()
                out.append(tok)
            return torch.stack(out, 1)

        streams = run(prompts)
        assert ops.flash_attention.launches_by_mode == {mode: cfg.n_layers}
        assert ops.pasa_decode.launches_by_mode == {
            mode: cfg.n_layers * (gen - 1)}
        assert ops.shift_kv.launches == ops.pasa_attention.launches == 0
        for i in range(prompts.shape[0]):
            assert torch.equal(run(prompts[i:i + 1])[0], streams[i])
        return
    kw = dict(max_batch=3, num_pages=24, page_size=64, prefill_chunk=128,
              prefill_batch=2)
    prompts = [rng.integers(0, 512, n).tolist() for n in (150, 40, 260)]
    eng = ServeEngine(bundle, params, **kw)
    reqs = [eng.submit(p, gen) for p in prompts]
    eng.run_to_completion()
    assert ops.pasa_paged_prefill.launches_by_mode == {
        mode: cfg.n_layers * eng.prefill_calls}
    assert ops.pasa_paged_decode.launches_by_mode == {
        mode: cfg.n_layers * eng.decode_calls}
    for p, r in zip(prompts, reqs):
        alone = ServeEngine(bundle, params, **kw)
        solo = alone.submit(p, gen)
        alone.run_to_completion()
        assert solo.generated == r.generated


# head_dim 64 (zamba2-1.2b's shared attention block): both decode kernels,
# every policy mode, at zamba2's shape (KVH 32, G 1) and a GQA group (KVH
# 4, G 8)
HD64_SHAPES = [(32, 1), (4, 8)]
ALL_MODES = [FP16, FP16_FP32, FP32, BF16_FP32]


@pytest.mark.cuda
@pytest.mark.parametrize("kvh,g", HD64_SHAPES, ids=["kvh32_g1", "kvh4_g8"])
@pytest.mark.parametrize("policy", ALL_MODES, ids=lambda p: p.name)
def test_decodes_at_head_dim_64(policy, kvh, g):
    """At head_dim 64 paged decode == contiguous decode == the walk, bit
    for bit, at block 128 (and contiguous == walk at 256), each within the
    decode bar of its plain version and relative RMSE 0.03 of float64, at
    kv_len 1, 127, 128, 1000 and 4095 (NaN past kv_len), PASA and
    FlashAttention-2; launches counted under the d64 mode."""
    dev = _card()
    rng = np.random.default_rng(31)
    d, page = 64, 128
    kv_lens = [1, 127, 128, 1000, 4095]
    kp, vp, table = _pool(rng, kv_lens, kvh, page, dev, d=d)
    n = table.shape[1] * page
    kc = kp[table.long()].reshape(len(kv_lens), n, kvh, d)
    vc = vp[table.long()].reshape(len(kv_lens), n, kvh, d)
    kview, vview = kc.transpose(1, 2), vc.transpose(1, 2)
    q = _randn(rng, (len(kv_lens), kvh, g, d), 0.0, dev)
    qp = q.to(policy.input_dtype)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    gold = _decode_gold(q, kc, vc, kv_lens)
    ops.reset_launches()
    for beta in (0.0, BETA):
        paged = ops.pasa_paged_decode(q, kp, vp, table, kvl, beta=beta,
                                      policy=policy)
        assert paged.dtype == policy.out_dtype
        assert torch.isfinite(paged.float()).all()
        for block in (page, 256):
            contiguous = ops.pasa_decode(q, kview, vview, kvl, beta=beta,
                                         policy=policy, block_kv=block)
            walk = cmod._walk_call(qp, kview, vview, kvl, beta=beta,
                                   policy=policy, block_kv=block)
            assert torch.equal(contiguous, walk), (beta, block)
            if block == page:
                assert torch.equal(contiguous, paged), beta
            plain = cmod.decode_plain(q, kview, vview, kvl, beta=beta,
                                      policy=policy, block_kv=block)
            torch.testing.assert_close(contiguous.float(), plain.float(),
                                       **DECODE_TOL)
            assert _rel_rmse(contiguous, gold) < 0.03
        plain = dmod.paged_decode_plain(q, kp, vp, table, kvl, beta=beta,
                                        policy=policy, block_kv=page)
        torch.testing.assert_close(paged.float(), plain.float(), **DECODE_TOL)
    mode = dmod.mode_name(policy, torch.bfloat16, d)
    assert mode.endswith("/d64")
    assert ops.pasa_paged_decode.launches_by_mode == {mode: 2}
    assert ops.pasa_decode.launches_by_mode == {mode: 4}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("policy", ALL_MODES, ids=lambda p: p.name)
def test_quantized_paged_decode_at_head_dim_64(policy, dtype):
    """The quantized mode of paged decode at head_dim 64 (KVH 32, G 1):
    within the decode bar of its plain version on the same codes and
    sidecars, within the dtype's RMSE bound of float64 attention on the
    unquantized K/V (fp16: within max(2 x the raw pool's, the bound)), and
    NaN debris past kv_len and NaN sidecars on dead pages inert bit for
    bit."""
    dev = _card()
    rng = np.random.default_rng(32)
    kvh, g, d, page = 32, 1, 64, 128
    kv_len = [1, 300, 1000]
    kp, vp, table = _pool(rng, kv_len, kvh, page, dev, d=d)
    kq, vq, quant, valid = _quantized(kp, vp, table, kv_len, dtype)
    q = _randn(rng, (3, kvh, g, d), 0.0, dev)
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    gold = _paged_gold(q, kp, vp, table, [0] * 3, kv_len, causal=False)
    raw = ops.pasa_paged_decode(q, kp, vp, table, kvl, beta=BETA, policy=FP16)
    got = ops.pasa_paged_decode(q, kq, vq, table, kvl, beta=BETA,
                                policy=policy, **quant)
    want = dmod.paged_decode_plain(q, kq, vq, table, kvl, beta=BETA,
                                   policy=policy, block_kv=page, **quant)
    torch.testing.assert_close(got.float(), want.float(), **DECODE_TOL)
    bound = QUANT_RMSE_BOUND[dtype]
    if policy is FP16:
        bound = max(2.0 * _rel_rmse(raw, gold), bound)
    assert _rel_rmse(got, gold) <= bound
    assert _rel_rmse(want, gold) <= bound
    bad = float("nan") if dtype == "fp8_e4m3" else 127.0
    stale = ~valid[..., None, None]
    kq2, vq2 = (torch.where(stale, bad, x.float()).to(x.dtype) for x in (kq, vq))
    dead = ~valid.any(1)
    quant2 = {n: torch.where(dead.reshape((-1,) + (1,) * (x.dim() - 1)),
                             float("nan"), x) for n, x in quant.items()}
    dirty = ops.pasa_paged_decode(q, kq2, vq2, table, kvl, beta=BETA,
                                  policy=policy, **quant2)
    assert torch.equal(got, dirty)


# head_dim 64 (whisper-large-v3: 20 / 20 heads of 64) of shift-KV and the
# attention kernel, and the attention kernel's column limit kv_valid


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fp16", "bf16_keys", "bf16_fp32"])
@pytest.mark.parametrize("block", [64, 128])
def test_shift_kernel_at_head_dim_64(block, mode):
    """The shift kernel at head_dim 64 (one warpgroup) against its plain
    version and the float64 product with the same M, keys read through
    the (B, S, KVH, D) strides of a projection, several grids; launches
    counted under the ``/d64`` mode."""
    dev = _card()
    rng = np.random.default_rng(41)
    policy = BF16_FP32 if mode == "bf16_fp32" else FP16
    kdt = torch.float16 if mode == "fp16" else torch.bfloat16
    op, d = policy.input_dtype, 64
    for b, kvh, s in ((4, 20, 1536), (1, 1, block), (2, 3, 3 * block)):
        k = _randn(rng, (b, s, kvh, d), 5.0, dev, kdt).transpose(1, 2)
        ops.reset_launches()
        got = ops.shift_kv(k, beta=BETA, block_kv=block, policy=policy)
        assert ops.shift_kv.launches_by_mode == {
            smod.mode_name(kdt, op, block, d): 1}
        assert got.dtype == op and got.is_contiguous()
        assert got.shape == (b, kvh, s, d)
        m = smod.device_matrix(block, d, BETA, op, dev)
        want = smod.shift_kv_plain(m, k.to(op), block, out_dtype=op)
        torch.testing.assert_close(got.float(), want.float(), **SHIFT_TOL)
        gold = torch.matmul(m.double(), k.to(op).double().reshape(
            b, kvh, s // block, block, d)).reshape(b, kvh, s, d)
        assert float((got.double() - gold).norm() / gold.norm()) \
            < SHIFT_RMSE_MAX


def _padded_rows(x, rows):
    """(B, H, S, D) -> zero rows appended up to ``rows``."""
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[2]))


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [(128, 128), (64, 64), (64, 128), (128, 64)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("policy", ALL_MODES, ids=lambda p: p.name)
def test_attention_kernel_at_head_dim_64(policy, causal, blocks):
    """The attention kernel at head_dim 64 (20 heads, GQA group 1 and a
    group of 5) against the plain version, PASA at BETA and
    FlashAttention-2, with the keys whole (kv_valid None) and zero-padded
    past kv_valid = S2 - block_kv + 1 and 1500 (the encoder's frames in
    1536 rows); launches counted under the ``/d64`` mode."""
    dev = _card()
    rng = np.random.default_rng(42)
    bq, bkv = blocks
    b, d = 2, 64
    for kvh, group in ((20, 1), (4, 5)):
        for valid in (None, 1536 - bkv + 1, 1500):
            n = 1536 if valid is None else valid
            q = _padded_rows(_randn(rng, (b, kvh * group, n, d), 0.0, dev),
                             1536)
            k = _padded_rows(_randn(rng, (b, kvh, n, d), 2.0, dev), 1536)
            v = _padded_rows(_randn(rng, (b, kvh, n, d), 0.0, dev), 1536)
            for beta in (0.0, BETA):
                ops.reset_launches()
                fn = ops.flash_attention if beta == 0.0 else \
                    functools.partial(ops.pasa_attention, beta=BETA)
                got = fn(q, k, v, policy=policy, causal=causal, block_q=bq,
                         block_kv=bkv, kv_valid=valid)
                want = amod.attention_plain(q, k, v, beta=beta, policy=policy,
                                            block_kv=bkv, causal=causal,
                                            kv_valid=valid)
                assert got.dtype == policy.out_dtype
                torch.testing.assert_close(got[:, :, :n].float(),
                                           want[:, :, :n].float(),
                                           **ATTN_TOL[causal or beta == 0.0])
                wrapper = ops.flash_attention if beta == 0.0 \
                    else ops.pasa_attention
                assert wrapper.launches_by_mode == {
                    dmod.mode_name(policy, torch.float16, d): 1}


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_attention_kernel_column_limit(d):
    """kv_valid on the card: values past it are never read (NaN there
    leaves the output unchanged, bit for bit), keys past it count in the
    row pseudo-average (K' rows mixed by the shift), kv_valid = S2 is the
    call without a limit, bit for bit; at head_dim 128 as at 64; the
    one-query cross-attention shape (1 row padded to block_q 64) against
    the plain version."""
    dev = _card()
    rng = np.random.default_rng(43)
    b, h, s2, valid = 2, 4, 512, 450
    q = _randn(rng, (b, h, 128, d), 0.0, dev)
    k = _padded_rows(_randn(rng, (b, h, valid, d), 2.0, dev), s2)
    v = _padded_rows(_randn(rng, (b, h, valid, d), 0.0, dev), s2)
    for causal in (False, True):
        kw = dict(beta=BETA, policy=FP16, causal=causal)
        got = ops.pasa_attention(q, k, v, kv_valid=valid, **kw)
        v_nan = v.clone()
        v_nan[:, :, valid:] = float("nan")
        assert torch.equal(ops.pasa_attention(q, k, v_nan, kv_valid=valid,
                                              **kw), got)
        want = amod.attention_plain(q, k, v, beta=BETA, policy=FP16,
                                    block_kv=128, causal=causal,
                                    kv_valid=valid)
        torch.testing.assert_close(got.float(), want.float(),
                                   **ATTN_TOL[causal])
        whole = ops.pasa_attention(q, k, v, **kw)
        assert torch.equal(ops.pasa_attention(q, k, v, kv_valid=s2, **kw),
                           whole)
    # the cross-attention's one query row, padded to 64 rows
    q1 = _padded_rows(_randn(rng, (b, h, 1, d), 0.0, dev), 64)
    got = ops.pasa_attention(q1, k, v, beta=BETA, policy=FP16, block_q=64,
                             kv_valid=valid)
    want = amod.attention_plain(q1, k, v, beta=BETA, policy=FP16,
                                block_kv=128, kv_valid=valid)
    torch.testing.assert_close(got[:, :, :1].float(), want[:, :, :1].float(),
                               **ATTN_TOL[False])


@pytest.mark.cuda
def test_whisper_on_card_batched_equals_one_at_a_time():
    """A two-layer Whisper at head_dim 64 (d 256, 4 / 4 heads, 200
    frames) on the card: the encoder (shift-KV + attention, not causal,
    kv_valid 200 of 256) and token-by-token decode (contiguous decode +
    the cross-attention's shift-KV and attention every layer); launches
    per step and per encode as the layers say, all in the d64 modes;
    each prompt served alone from its row of the encoder output gives its
    batched stream."""
    from repro_torch.launch.serve import token_by_token
    from repro_torch.models.multimodal import whisper_encode

    dev = _card()
    base = get_config("whisper-large-v3")
    cfg = dataclasses.replace(base, n_layers=2, n_encoder_layers=2,
                              d_model=256, n_heads=4, n_kv_heads=4,
                              head_dim=64, d_ff=512, n_audio_frames=200)
    bundle = build(cfg)
    params = bundle.init(torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(44)
    frames = _randn(rng, (3, 200, 256), 0.0, dev, torch.float32)
    ops.reset_launches()
    enc = whisper_encode(params, cfg, frames)
    assert ops.shift_kv.launches == ops.pasa_attention.launches == 2
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 10),
                                            dtype=np.int32)).to(dev)

    def run(rows, enc_rows):
        cache = bundle.init_cache(rows.shape[0], 24, device=dev)
        cache["enc_out"].copy_(enc_rows)
        out, _, _ = token_by_token(bundle, params, rows, 6, cache)
        return out

    ops.reset_launches()
    streams = run(prompts, enc)
    steps = 10 + 6 - 1
    mode = dmod.mode_name(FP16, torch.bfloat16, 64)
    assert ops.pasa_decode.launches_by_mode == {mode: 2 * steps}
    assert ops.pasa_attention.launches_by_mode == {mode: 2 * steps}
    assert ops.shift_kv.launches_by_mode == {
        smod.mode_name(torch.bfloat16, torch.float16, 128, 64): 2 * steps}
    for i in range(3):
        alone = run(prompts[i:i + 1], enc[i:i + 1])
        np.testing.assert_array_equal(alone[0], streams[i])
