"""The contiguous-path attention ops of repro_torch.kernels - shift-KV, PASA
attention and its FlashAttention-2 setting, contiguous decode - against
the reference's ``repro.kernels`` Pallas kernels in interpret mode (and
its oracles in ``repro.kernels.ref``), at the reference's own tolerances
(tests/test_kernels.py).  On the CPU the port's ops run their plain
PyTorch versions; tests/test_torch_cuda_kernels.py compares the CUDA
kernels with those plain versions on a card.

Inputs are drawn with numpy at explicit float32 and handed to both
packages.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as RK
from repro.core import BF16_FP32 as R_BF16_FP32
from repro.core import FP16 as R_FP16
from repro.core import FP16_FP32 as R_FP16_FP32
from repro.core import FP32 as R_FP32
from repro.kernels import ref as RREF
from repro_torch.core.naive import naive_attention
from repro_torch.core.precision import BF16_FP32, FP16, FP16_FP32, FP32
from repro_torch.kernels import ops

# the kernel module (the package binds the name to the op)
flash_mod = importlib.import_module("repro_torch.kernels.flash_attention")

torch.set_num_threads(1)

BETA = 0.984497
I = dict(interpret=True)
# tests/test_kernels.py: attention kernel vs oracle (non-causal, causal),
# flash vs oracle, shift-KV vs oracle, decode vs oracle
ATTN_TOL = dict(atol=8e-3, rtol=2e-2)
CAUSAL_TOL = dict(atol=2e-3, rtol=2e-2)
FLASH_TOL = dict(atol=2e-3, rtol=2e-2)
SHIFT_ATOL = 1e-2
DECODE_TOL = dict(atol=3e-3, rtol=3e-2)

# (B, H, KVH, S, D, block_q, block_kv): two of test_kernels.py's SWEEP
SWEEP = [(1, 2, 2, 128, 64, 64, 64), (2, 8, 4, 256, 64, 128, 128)]


def _mk(seed, b, h, kvh, s, d, mean=0.0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, h, s, d)) + mean).astype(np.float32)
    k = (rng.standard_normal((b, kvh, s, d)) + mean).astype(np.float32)
    v = rng.standard_normal((b, kvh, s, d)).astype(np.float32)
    return q, k, v


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,h,kvh,s,d,bq,bkv", SWEEP)
def test_pasa_attention_matches_reference_kernel(b, h, kvh, s, d, bq, bkv,
                                                 causal):
    # the reference's fixtures: mean 2 (non-causal), mean 1 (causal)
    q, k, v = _mk(0, b, h, kvh, s, d, mean=1.0 if causal else 2.0)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    want = RK.pasa_attention(jq, jk, jv, beta=BETA, policy=R_FP16,
                             block_q=bq, block_kv=bkv, causal=causal, **I)
    got = ops.pasa_attention(tq, tk, tv, beta=BETA, policy=FP16, block_q=bq,
                             block_kv=bkv, causal=causal)
    assert got.dtype == torch.float16 and got.shape == (b, h, s, d)
    np.testing.assert_allclose(_np(got), _np(want),
                               **(CAUSAL_TOL if causal else ATTN_TOL))
    oracle = RREF.attention_ref(jq, jk, jv, beta=BETA, policy=R_FP16,
                                block_kv=bkv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(oracle),
                               **(CAUSAL_TOL if causal else ATTN_TOL))


def _padded(x: np.ndarray, rows: int) -> np.ndarray:
    """x (B, H, S, D) with zero rows appended up to ``rows``."""
    out = np.zeros(x.shape[:2] + (rows,) + x.shape[3:], x.dtype)
    out[:, :, :x.shape[2]] = x
    return out


# (op, policy of the port, of the reference, beta): PASA at the paper's
# policy, FlashAttention-2 at its overflow-safe one
KV_VALID_OPS = {"pasa": (FP16, R_FP16, BETA), "flash": (FP16_FP32, R_FP16_FP32,
                                                        0.0)}


@pytest.mark.parametrize("op", ["pasa", "flash"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv_valid", [16, 200, 256])
@pytest.mark.parametrize("d", [16, 64])
def test_kv_valid_on_padded_keys_equals_reference_on_unpadded(d, kv_valid,
                                                              causal, op):
    """The ops' column limit: q / K / V padded with zero rows to whole
    blocks (128 key rows, 64 query rows), ``kv_valid`` = the real length,
    output cut back - against the reference's ``blocked_attention`` (the
    GEMM shift) on the unpadded rows, which pads with zeros and masks past
    them itself.  kv_valid 16 pads 112 key rows, 200 pads 56, 256 none."""
    from repro.core import blocked_attention as ref_blocked

    pol, rpol, beta = KV_VALID_OPS[op]
    h, kvh = 4, 2
    q, k, v = _mk(11, 1, h, kvh, kv_valid, d, mean=1.0)
    s2 = -(-kv_valid // 128) * 128
    s1 = -(-kv_valid // 64) * 64
    tq, tk, tv = (torch.from_numpy(_padded(x, n))
                  for x, n in ((q, s1), (k, s2), (v, s2)))
    fn = ops.pasa_attention if op == "pasa" else ops.flash_attention
    kw = dict(beta=beta) if op == "pasa" else {}
    got = fn(tq, tk, tv, policy=pol, block_q=64, block_kv=128, causal=causal,
             kv_valid=kv_valid, **kw)[:, :, :kv_valid]
    expand = lambda x: jnp.asarray(np.repeat(x, h // kvh, axis=1))
    want = ref_blocked(jnp.asarray(q), expand(k), expand(v), beta=beta,
                       policy=rpol, block_kv=128, causal=causal,
                       use_gemm_shift=True)
    tol = (FLASH_TOL if op == "flash" else
           CAUSAL_TOL if causal else ATTN_TOL)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_kv_valid_out_of_range_raises():
    """kv_valid must pad less than one block: S2 - block_kv < kv_valid <=
    S2, on every device (as _pad_to_multiple pads)."""
    q, k, v = (torch.from_numpy(x) for x in _mk(12, 1, 2, 2, 256, 64))
    for bad in (128, 0, 257):
        with pytest.raises(ValueError, match="kv_valid"):
            ops.pasa_attention(q, k, v, kv_valid=bad)
        with pytest.raises(ValueError, match="kv_valid"):
            ops.flash_attention(q, k, v, kv_valid=bad)
    out = ops.pasa_attention(q, k, v, kv_valid=129)
    assert torch.isfinite(out.float()).all()


@pytest.mark.parametrize("pols", [(FP16, R_FP16), (BF16_FP32, R_BF16_FP32)],
                         ids=["fp16", "bf16_fp32"])
@pytest.mark.parametrize("block", [64, 128])
def test_head_dim_64_kernels_match_reference_interpret(block, pols):
    """Whisper's head width (64, one query head per kv head) at aligned
    lengths: shift-KV and the attention op against the reference's
    ``shift_kv_kernel_call`` and ``attention_kernel_call`` in interpret
    mode (through ``repro.kernels``), at blocks 64 and 128, not causal."""
    pol, rpol = pols
    q, k, v = _mk(13, 2, 4, 4, 256, 64, mean=1.0)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    want = RK.shift_kv(jk, beta=BETA, block_kv=block, policy=rpol, **I)
    got = ops.shift_kv(tk, beta=BETA, block_kv=block, policy=pol)
    assert got.dtype == pol.input_dtype
    np.testing.assert_allclose(_np(got), _np(want), atol=SHIFT_ATOL)
    want = RK.pasa_attention(jq, jk, jv, beta=BETA, policy=rpol,
                             block_q=block, block_kv=block, **I)
    got = ops.pasa_attention(tq, tk, tv, beta=BETA, policy=pol,
                             block_q=block, block_kv=block)
    assert got.dtype == pol.out_dtype and got.shape == (2, 4, 256, 64)
    np.testing.assert_allclose(_np(got), _np(want), **ATTN_TOL)


def test_pasa_attention_against_fp64_gold():
    q, k, v = _mk(1, 1, 4, 4, 256, 64, mean=3.0)
    got = ops.pasa_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             beta=BETA, policy=FP16)
    gold = naive_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                           dtype=torch.float64)
    assert float((got.double() - gold).norm() / gold.norm()) < 0.02


@pytest.mark.parametrize("pols", [(FP16, R_FP16), (FP16_FP32, R_FP16_FP32),
                                  (FP32, R_FP32)],
                         ids=["fp16", "fp16_fp32", "fp32"])
def test_flash_attention_policies(pols):
    pol, rpol = pols
    q, k, v = _mk(2, 1, 4, 2, 256, 64)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    want = RK.flash_attention(jq, jk, jv, policy=rpol, **I)
    got = flash_mod.flash_attention(tq, tk, tv, policy=pol)
    np.testing.assert_allclose(_np(got), _np(want), **FLASH_TOL)


@pytest.mark.parametrize("pols", [(FP16, R_FP16), (BF16_FP32, R_BF16_FP32)],
                         ids=["fp16", "bf16_fp32"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_shift_kv_matches_reference_kernel(d, pols):
    """M and K' at the policy's input dtype: fp16, or bf16 under
    bf16_fp32 (the modes of the CUDA shift kernel), at each head width
    the kernel is built for."""
    pol, rpol = pols
    rng = np.random.default_rng(3)
    k = (rng.standard_normal((2, 4, 512, d)) + 5.0).astype(np.float32)
    want = RK.shift_kv(jnp.asarray(k), beta=BETA, block_kv=128,
                       policy=rpol, **I)
    got = ops.shift_kv(torch.from_numpy(k), beta=BETA, block_kv=128,
                       policy=pol)
    assert got.dtype == pol.input_dtype
    np.testing.assert_allclose(_np(got), _np(want), atol=SHIFT_ATOL)


def _decode_case(kv_lens, seed=4, stale=0.0, kvh=2, g=4, d=64):
    b, s2 = 2, 512
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, kvh, g, d)) + 1.0).astype(np.float32)
    k = (rng.standard_normal((b, kvh, s2, d)) + 2.0).astype(np.float32)
    v = rng.standard_normal((b, kvh, s2, d)).astype(np.float32)
    for i, n in enumerate(kv_lens):
        k[i, :, n:] = stale
        v[i, :, n:] = stale
    return q, k, v, np.asarray(kv_lens, np.int32)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("block_kv", [128, 256])
@pytest.mark.parametrize("kv_lens", [[300, 77], [512, 512]])
@pytest.mark.parametrize("beta", [0.0, 0.9375])
def test_pasa_decode_matches_reference(kv_lens, beta, block_kv, d):
    """At block 128 (the served block) and 256 (the op's default, as the
    reference's), at head widths 32 (the reference's kernel tests') and
    64."""
    q, k, v, kv_len = _decode_case(kv_lens, d=d)
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _both(q, k, v, kv_len)
    got = ops.pasa_decode(tq, tk, tv, tl, beta=beta, policy=FP16,
                          block_kv=block_kv)
    want = RK.pasa_decode(jq, jk, jv, jl, beta=beta, policy=R_FP16,
                          block_kv=block_kv, **I)
    np.testing.assert_allclose(_np(got), _np(want), **DECODE_TOL)
    oracle = RREF.decode_ref(jq.astype(jnp.float16), jk.astype(jnp.float16),
                             jv.astype(jnp.float16), jl, beta=beta,
                             policy=R_FP16, block_kv=block_kv)
    np.testing.assert_allclose(_np(got), _np(oracle), **DECODE_TOL)
    for i, n in enumerate(kv_lens):
        gold = naive_attention(tq[i:i + 1], tk[i:i + 1, :, :n],
                               tv[i:i + 1, :, :n], dtype=torch.float64)
        assert float((got[i:i + 1].double() - gold).norm() / gold.norm()) < 0.03


@pytest.mark.parametrize("block_kv", [128, 256])
@pytest.mark.parametrize("beta", [0.0, 0.9375])
def test_pasa_decode_matches_reference_at_zamba2_group(beta, block_kv):
    """head_dim 64 with one query head per kv head (zamba2-1.2b's shared
    attention block: 32 / 32 heads), 8 kv heads, a ragged and a full row,
    against the reference's interpret-mode Pallas decode and float64."""
    q, k, v, kv_len = _decode_case([300, 512], seed=6, kvh=8, g=1)
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _both(q, k, v, kv_len)
    got = ops.pasa_decode(tq, tk, tv, tl, beta=beta, policy=FP16,
                          block_kv=block_kv)
    want = RK.pasa_decode(jq, jk, jv, jl, beta=beta, policy=R_FP16,
                          block_kv=block_kv, **I)
    np.testing.assert_allclose(_np(got), _np(want), **DECODE_TOL)
    for i, n in enumerate([300, 512]):
        gold = naive_attention(tq[i:i + 1], tk[i:i + 1, :, :n],
                               tv[i:i + 1, :, :n], dtype=torch.float64)
        assert float((got[i:i + 1].double() - gold).norm() / gold.norm()) < 0.03


def test_pasa_decode_default_block_and_stale_rows_are_inert():
    """The op's default block (256, as the reference's) on the plain path,
    and NaN past kv_len changing nothing, bit for bit."""
    q, k, v, kv_len = _decode_case([300, 77])
    zero = ops.pasa_decode(*(torch.from_numpy(x) for x in (q, k, v, kv_len)),
                           beta=BETA)
    q, k, v, kv_len = _decode_case([300, 77], stale=np.nan)
    nan = ops.pasa_decode(*(torch.from_numpy(x) for x in (q, k, v, kv_len)),
                          beta=BETA)
    assert torch.isfinite(nan.float()).all()
    assert torch.equal(zero, nan)


def test_contiguous_decode_equals_paged_decode_bit_for_bit():
    """The same rows as a contiguous cache and as a shuffled page pool
    (page == block): the two plain versions agree bit for bit, as the two
    CUDA kernels do (they share decode_block_update)."""
    page, kvh, g, d = 16, 2, 3, 64
    kv_lens = [70, 33, 1]
    b, s2 = len(kv_lens), 80
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((b, kvh, g, d)).astype(np.float32))
    kc = torch.from_numpy(
        (rng.standard_normal((b, s2, kvh, d)) + 30.0).astype(np.float32)
    ).to(torch.bfloat16)
    vc = torch.from_numpy(
        rng.standard_normal((b, s2, kvh, d)).astype(np.float32)
    ).to(torch.bfloat16)
    for i, n in enumerate(kv_lens):
        kc[i, n:] = float("nan")
        vc[i, n:] = float("nan")
    n_pages = [math.ceil(n / page) for n in kv_lens]
    ids = rng.permutation(np.arange(1, 1 + sum(n_pages)))
    kp = torch.full((1 + sum(n_pages), page, kvh, d), float("nan"),
                    dtype=torch.bfloat16)
    vp = kp.clone()
    table = torch.zeros((b, max(n_pages)), dtype=torch.int32)
    nxt = 0
    for i, npg in enumerate(n_pages):
        for j in range(npg):
            pid = int(ids[nxt])
            nxt += 1
            table[i, j] = pid
            kp[pid] = kc[i, j * page:(j + 1) * page]
            vp[pid] = vc[i, j * page:(j + 1) * page]
    kv_len = torch.tensor(kv_lens, dtype=torch.int32)
    for beta in (0.0, BETA):
        contiguous = ops.pasa_decode(q, kc.transpose(1, 2), vc.transpose(1, 2),
                                     kv_len, beta=beta, block_kv=page)
        paged = ops.pasa_paged_decode(q, kp, vp, table, kv_len, beta=beta)
        assert torch.isfinite(contiguous.float()).all()
        assert torch.equal(contiguous, paged)


def test_shape_guards_raise_as_the_reference():
    q = torch.zeros((1, 4, 100, 64), dtype=torch.float16)  # 100 % 128 != 0
    k = torch.zeros((1, 2, 128, 64), dtype=torch.float16)
    with pytest.raises(ValueError):
        RK.pasa_attention(jnp.zeros((1, 4, 100, 64), jnp.float16),
                          jnp.zeros((1, 2, 128, 64), jnp.float16),
                          jnp.zeros((1, 2, 128, 64), jnp.float16), **I)
    with pytest.raises(ValueError):
        ops.pasa_attention(q, k, k)
    with pytest.raises(ValueError):
        ops.pasa_attention(torch.zeros((1, 3, 128, 64), dtype=torch.float16),
                           k, k)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, k)
    with pytest.raises(ValueError):
        ops.shift_kv(torch.zeros((1, 2, 100, 64)), block_kv=128)
    with pytest.raises(ValueError):
        ops.pasa_decode(torch.zeros((1, 3, 4, 64)), k, k,   # 3 kv heads vs 2
                        torch.tensor([1], dtype=torch.int32))


def test_overflow_headline_through_the_plain_versions():
    """The paper's headline: inputs near 30 overflow the fp16 score store
    of FlashAttention-2 (NaN), while PASA at the all-fp16 policy stays
    finite - in both packages."""
    rng = np.random.default_rng(6)
    shape = (1, 2, 256, 128)
    q, k, v = (rng.uniform(29.5, 30.5, shape).astype(np.float32)
               for _ in range(3))
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    bad = ops.flash_attention(tq, tk, tv, policy=FP16_FP32)
    good = ops.pasa_attention(tq, tk, tv, beta=BETA, policy=FP16)
    assert bool(torch.isnan(bad.float()).any())
    assert bool(torch.isfinite(good.float()).all())
    ref_bad = RK.flash_attention(jq, jk, jv, policy=R_FP16_FP32, **I)
    assert bool(jnp.isnan(ref_bad).any())


@pytest.mark.parametrize("name", ["flash_attention", "pasa_attention",
                                  "pasa_decode", "pasa_paged_decode",
                                  "pasa_paged_prefill", "shift_kv"])
def test_kernels_package_exports_the_ops(name):
    """repro_torch.kernels binds each name of its __all__ to the op, as
    repro.kernels does; the kernel module stays reachable by its path."""
    import repro_torch.kernels as kernels

    assert name in kernels.__all__ and name in RK.__all__
    assert getattr(kernels, name) is getattr(ops, name)
    assert callable(getattr(kernels, name))
    module = importlib.import_module(f"repro_torch.kernels.{name}")
    assert module.__name__ == f"repro_torch.kernels.{name}"


def test_quickstart_kernel_call_through_the_export():
    """examples/quickstart.py's kernel section through the port's export,
    at a small size: ``from repro_torch.kernels import pasa_attention`` on
    fp16 GQA inputs of mean 30 (4 query heads, 2 kv heads), against
    ``repro.kernels.pasa_attention(..., interpret=True)``."""
    from repro_torch.kernels import pasa_attention as kernel_attention

    rng = np.random.default_rng(8)
    q, k, v = (rng.uniform(29.5, 30.5, (1, h, 256, 64)).astype(np.float32)
               for h in (4, 2, 2))
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    want = RK.pasa_attention(*(x.astype(jnp.float16) for x in (jq, jk, jv)),
                             beta=BETA, policy=R_FP16, **I)
    got = kernel_attention(*(x.half() for x in (tq, tk, tv)), beta=BETA,
                           policy=FP16)
    assert got.dtype == torch.float16 and got.shape == (1, 4, 256, 64)
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(_np(got), _np(want), **ATTN_TOL)


def test_launch_counters_stay_zero_on_the_cpu():
    """The plain versions are not kernel launches."""
    ops.reset_launches()
    q, k, v = _mk(7, 1, 2, 2, 128, 64)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    ops.pasa_attention(*t)
    ops.flash_attention(*t)
    ops.shift_kv(t[1])
    for name in ("shift_kv", "pasa_attention", "flash_attention",
                 "pasa_decode", "pasa_paged_decode", "pasa_paged_prefill"):
        assert getattr(ops, name).launches == 0
    assert ops.shift_kv.launches_by_mode == {}


def test_shift_kernel_mode_names():
    """Each shift kernel mode has its own launch counter key."""
    smod = importlib.import_module("repro_torch.kernels.shift_kv")
    names = {smod.mode_name(kdt, op, block)
             for kdt, op in ((torch.float16, torch.float16),
                             (torch.bfloat16, torch.float16),
                             (torch.bfloat16, torch.bfloat16))
             for block in (64, 128)}
    assert len(names) == 6
    assert smod.mode_name(torch.bfloat16, torch.float16, 128) == \
        "bf16_keys/fp16_ops/block128"
    assert smod.mode_name(torch.bfloat16, torch.float16, 128, 64) == \
        "bf16_keys/fp16_ops/block128/d64"


def test_shift_kernel_matrix_must_be_symmetric(monkeypatch):
    """The kernel computes K'^T = K^T M, so device_matrix refuses an M that
    is not symmetric (and builds the shifting matrix, which is)."""
    smod = importlib.import_module("repro_torch.kernels.shift_kv")
    cpu = torch.device("cpu")
    for dtype in (torch.float16, torch.bfloat16):
        m = smod.device_matrix(64, 128, BETA, dtype, cpu)
        assert torch.equal(m, m.T)
    skew = torch.eye(64, dtype=torch.float16)
    skew[0, 1] = 1.0
    monkeypatch.setattr(smod, "shifting_matrix", lambda *a: skew)
    with pytest.raises(ValueError, match="symmetric"):
        smod.device_matrix.__wrapped__(64, 128, 0.5, torch.float16, cpu)
