"""Quantized KV pools in the port against the reference: the quantizer,
the quantized mode of the two paged ops, the properties the port's own
quantized path must keep, the engine at int8 and fp8_e4m3, and the CLI.

Fixtures come from the reference's generators (tests/adversarial_inputs
.py) at explicit float32 and reach both packages through numpy.  fp8
codes cross as bytes: ``ml_dtypes.float8_e4m3fn`` -> uint8 ->
``torch.float8_e4m3fn``.  On the CPU the port's ops run their plain
versions; tests/test_torch_cuda_kernels.py holds the CUDA kernels to them.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import adversarial_inputs as adv
import repro.kernels as RK
from repro.configs import get_config as ref_get_config
from repro.core import FP16 as REF_FP16
from repro.core import FP32 as REF_FP32
from repro.core import beta as ref_beta
from repro.core import numerics as ref_numerics
from repro.models import transformer as RT
from repro.models.model_zoo import build as ref_build
from repro.runtime import ServeEngine as RefEngine
from repro.runtime import paged_cache as RPC
from repro_torch.configs import get_config
from repro_torch.core import beta as tbeta
from repro_torch.core import numerics as tnum
from repro_torch.core.precision import FP16, FP32
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build
from repro_torch.runtime import ServeEngine, chunked_cold_reference
from repro_torch.runtime import paged_cache as TPC

torch.set_num_threads(1)

QDTYPES = ("int8", "fp8_e4m3")
MODES = ("absmax", "quantile")
BETA = 0.9375                 # the reference's quantized-pool tests
PAGE = 16
# the reference's per-pool-dtype bounds on relative RMSE vs float64 at
# the FP32 policy (tests/test_kv_quant.py)
RMSE_BOUND = {"bf16": 0.02, "int8": 0.03, "fp8_e4m3": 0.09}
# quantized mode vs the reference, on the same codes and sidecars: its own
# kernel-vs-fallback bars (tests/test_kv_quant.py)
DECODE_TOL = dict(atol=3e-3, rtol=3e-2)
PREFILL_TOL = dict(atol=5e-3, rtol=3e-2)


# ------------------------------------------------------------ bridging --

def _to_torch(x) -> torch.Tensor:
    """A reference array (codes included) as a CPU tensor of the same
    dtype; fp8 codes cross as bytes."""
    a = np.asarray(x)
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a))


def _to_np(x) -> np.ndarray:
    """A port tensor (codes included) as numpy; fp8 as ml_dtypes."""
    if x.dtype == torch.float8_e4m3fn:
        return x.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn)
    return x.numpy()


def _raw_pages(seed=0, n_pages=6, kvh=2, d=64):
    """Biased KV pages and a valid-row mask with full, partial, one-row
    and empty pages."""
    rng = np.random.default_rng(seed)
    raw = (rng.standard_normal((n_pages, PAGE, kvh, d)) * 2.0
           + rng.standard_normal((1, 1, kvh, d)) * 8.0 + 7.0).astype(np.float32)
    rows = np.array([16, 11, 1, 0, 16, 5])[:n_pages]
    valid = np.arange(PAGE)[None, :] < rows[:, None]
    return raw, valid


# ----------------------------------------------------------- quantizer --

@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", QDTYPES)
def test_quantizer_matches_reference(dtype, mode, center):
    raw, valid = _raw_pages()
    rc, rs, rh = RPC.quantize_kv_page(jnp.asarray(raw), jnp.asarray(valid),
                                      dtype, center=center, scale_mode=mode)
    tc, ts, th = TPC.quantize_kv_page(torch.from_numpy(raw),
                                      torch.from_numpy(valid), dtype,
                                      center=center, scale_mode=mode)
    assert tc.dtype == TPC.POOL_DTYPES[dtype]
    assert ts.dtype == th.dtype == torch.float32
    np.testing.assert_allclose(ts.numpy(), np.asarray(rs), rtol=1e-6, atol=0)
    np.testing.assert_allclose(th.numpy(), np.asarray(rh), rtol=1e-6, atol=1e-7)
    # summation order may move a tie between two codes: equal codes almost
    # everywhere, and the dequantized values within one code step
    codes_equal = np.mean(_to_np(tc).astype(np.float32)
                          == np.asarray(rc).astype(np.float32))
    assert codes_equal >= 0.999, codes_equal
    back_t = TPC.dequantize_kv_page(tc, ts, th).numpy()
    back_r = np.asarray(RPC.dequantize_kv_page(rc, rs, rh))
    step = np.asarray(rs)[:, None, :, None]
    vm = valid[..., None, None]
    assert (np.abs(np.where(vm, back_t - back_r, 0.0)) <= step).all()
    # invalid rows are coded 0 and never touch the statistics
    assert not np.asarray(_to_np(tc).astype(np.float32))[~valid].any()


@pytest.mark.parametrize("dtype", QDTYPES)
def test_dequantize_and_gather_match_reference_exactly(dtype):
    """On the reference's own codes the port's dequantization is bit for
    bit the reference's: a product and a sum, each rounded in f32."""
    raw, valid = _raw_pages(seed=1)
    codes, scale, shift = RPC.quantize_kv_page(
        jnp.asarray(raw), jnp.asarray(valid), dtype)
    want = np.asarray(RPC.dequantize_kv_page(codes, scale, shift))
    got = TPC.dequantize_kv_page(_to_torch(codes), _to_torch(scale),
                                 _to_torch(shift))
    np.testing.assert_array_equal(got.numpy(), want)
    n, page, kvh, d = raw.shape
    layer = np.asarray(codes).reshape(n, page, kvh * d)
    sh = np.asarray(shift).reshape(n, kvh * d)
    table = np.array([[4, 1, 2], [0, 5, 1]], np.int32)
    want = np.asarray(RPC.gather_pages_dequant(
        jnp.asarray(layer), scale, jnp.asarray(sh), jnp.asarray(table)))
    got = TPC.gather_pages_dequant(_to_torch(layer), _to_torch(scale),
                                   _to_torch(sh), torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), want)


def test_pool_plumbing():
    """Sidecar shapes, byte accounting and the guard rails, as the
    reference's tests/test_kv_quant.py checks its pool."""
    pool = TPC.init_paged_pool(2, 5, 4, 8, "int8", n_kv_heads=2, device="cpu")
    assert pool["k"].dtype == torch.int8
    assert pool["k_scale"].shape == (2, 5, 2)
    assert pool["k_shift"].shape == (2, 5, 8)
    base = 2 * 2 * 5 * 4 * 8 * 1
    side = 2 * 2 * (5 * 2 + 5 * 8) * 4
    assert TPC.paged_bytes(pool) == base + side
    ref = RPC.init_paged_pool(2, 5, 4, 8, "int8", n_kv_heads=2)
    assert TPC.paged_bytes(pool) == RPC.paged_bytes(ref)
    fp8 = TPC.init_paged_pool(2, 5, 4, 8, "fp8_e4m3", n_kv_heads=2,
                              device="cpu")
    assert fp8["v"].dtype == torch.float8_e4m3fn
    bf = TPC.init_paged_pool(2, 5, 4, 8, "bf16", device="cpu")
    assert set(bf) == {"k", "v"} and bf["k"].dtype == torch.bfloat16
    with pytest.raises(ValueError):
        TPC.init_paged_pool(2, 5, 4, 8, "int8", device="cpu")   # no n_kv_heads
    with pytest.raises(ValueError):
        TPC.init_paged_pool(2, 5, 4, 8, "float7", device="cpu")
    with pytest.raises(ValueError):
        TPC.quantize_kv_page(torch.zeros(1, 4, 1, 8), torch.ones(1, 4, dtype=bool),
                             "int8", scale_mode="median")
    for name in ("bf16", "fp8_e4m3", "int8"):
        assert TPC.pool_dtype_name(name) == RPC.pool_dtype_name(name) == name
        assert TPC.is_quantized_dtype(name) == RPC.is_quantized_dtype(name)
        assert TPC.pool_dtype_name(TPC.POOL_DTYPES[name]) == name
    assert TPC.QMAX[torch.int8] == 127.0 and TPC.QMAX[torch.float8_e4m3fn] == 448.0


# ------------------------------------------------- the quantized mode --

def _pool_from_contiguous(kc, vc, kv_lens, dtype, *, center=True,
                          extra_pages=2, shuffle_seed=0):
    """Pack a contiguous (B, KVH, S2, D) float32 cache into a shuffled page
    pool (page 0 reserved), quantized per page by the REFERENCE when
    ``dtype`` is 8-bit.  Returns numpy/jnp (k, v, table, sidecars, valid)."""
    b, kvh, s2, d = kc.shape
    mp = s2 // PAGE
    n_pages = 1 + b * mp + extra_pages
    rng = np.random.default_rng(shuffle_seed)
    ids = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((b, mp), np.int32)
    kp = np.zeros((n_pages, PAGE, kvh, d), np.float32)
    vp = np.zeros((n_pages, PAGE, kvh, d), np.float32)
    valid = np.zeros((n_pages, PAGE), bool)
    kcn, vcn = np.moveaxis(kc, 2, 1), np.moveaxis(vc, 2, 1)
    nxt = 0
    for bi in range(b):
        for j in range(math.ceil(kv_lens[bi] / PAGE)):
            pid = int(ids[nxt])
            nxt += 1
            table[bi, j] = pid
            kp[pid] = kcn[bi, j * PAGE:(j + 1) * PAGE]
            vp[pid] = vcn[bi, j * PAGE:(j + 1) * PAGE]
            valid[pid] = (j * PAGE + np.arange(PAGE)) < kv_lens[bi]
    if dtype == "bf16":
        return kp, vp, table, {}, valid
    kq, ks, kh = RPC.quantize_kv_page(jnp.asarray(kp), jnp.asarray(valid),
                                      dtype, center=center)
    vq, vs, vh = RPC.quantize_kv_page(jnp.asarray(vp), jnp.asarray(valid),
                                      dtype, center=center)
    return kq, vq, table, dict(k_scale=ks, k_shift=kh, v_scale=vs,
                               v_shift=vh), valid


def _decode_case(case="seq_bias", kv_lens=(100, 37), g=4, d=64, kvh=2, seed=0):
    b = len(kv_lens)
    mp = max(math.ceil(n / PAGE) for n in kv_lens) + 1
    s2 = mp * PAGE
    q, kc, vc = adv.make_adversarial(
        case, jax.random.PRNGKey(seed), q_shape=(b, kvh, g, d),
        kv_shape=(b, kvh, s2, d))
    q, kc, vc = (np.asarray(x, np.float32) for x in (q, kc, vc))
    mask = (np.arange(s2)[None, :] < np.asarray(kv_lens)[:, None])
    mask = mask[:, None, :, None]
    return (q, np.where(mask, kc, 0.0).astype(np.float32),
            np.where(mask, vc, 0.0).astype(np.float32),
            np.asarray(kv_lens, np.int32))


def _gold_decode(q, kc, vc, kv_len):
    """float64 softmax(q k^T / sqrt(d)) v per sequence over its kv_len."""
    outs = []
    for bi in range(q.shape[0]):
        n = int(kv_len[bi])
        qq, kk, vv = (x.astype(np.float64) for x in (q[bi], kc[bi, :, :n],
                                                     vc[bi, :, :n]))
        s = qq @ np.swapaxes(kk, -1, -2) / math.sqrt(q.shape[-1])
        p = np.exp(s - s.max(-1, keepdims=True))
        outs.append((p / p.sum(-1, keepdims=True)) @ vv)
    return np.stack(outs)


def _quant_t(quant):
    return {k: _to_torch(v) for k, v in quant.items()}


def _port_decode(q, kp, vp, table, kv_len, quant, policy):
    return ops.pasa_paged_decode(
        torch.from_numpy(q), _to_torch(kp), _to_torch(vp),
        torch.from_numpy(table), torch.from_numpy(kv_len), beta=BETA,
        policy=policy, **_quant_t(quant)).float().numpy()


@pytest.mark.parametrize("policy", ["fp32", "fp16"])
@pytest.mark.parametrize("dtype", QDTYPES)
def test_decode_quant_mode_matches_reference(dtype, policy):
    """Same codes and sidecars (the reference's): the port's decode op on
    the CPU against the reference's fallback and its Pallas kernel in
    interpret mode, and against float64 attention on the unquantized
    K/V.

    At the FP16 policy the reference holds its own kernel only to its
    fallback's neighbourhood: on the fp8 fixture its interpret kernel and
    its fallback differ by up to 9.3e-3 on 3 of 1024 outputs (one fp16 ulp
    of the page's pseudo-average, amplified by the recovery), while the
    port's plain version is within 1e-3 of the fallback.  There the port
    is held to the fallback at the tolerance and to the kernel within the
    reference's own kernel-fallback spread."""
    q, kc, vc, kv_len = _decode_case()
    kq, vq, table, quant, _ = _pool_from_contiguous(kc, vc, kv_len, dtype)
    pol, ref_pol = (FP32, REF_FP32) if policy == "fp32" else (FP16, REF_FP16)
    got = _port_decode(q, kq, vq, table, kv_len, quant, pol)
    assert np.isfinite(got).all()
    args = (jnp.asarray(q), kq, vq, jnp.asarray(table), jnp.asarray(kv_len))
    xla, kern = (np.asarray(RK.pasa_paged_decode(
        *args, beta=BETA, policy=ref_pol, **kw, **quant), np.float32)
        for kw in (dict(use_kernel=False), dict(interpret=True)))
    np.testing.assert_allclose(got, xla, **DECODE_TOL)
    if policy == "fp32":
        np.testing.assert_allclose(got, kern, **DECODE_TOL)
    else:
        spread = np.abs(kern - xla).max()
        assert np.abs(got - kern).max() <= spread + DECODE_TOL["atol"]
    gold = _gold_decode(q, kc, vc, kv_len)
    if policy == "fp32":
        for bi in range(len(kv_len)):
            assert tnum.rmse(got[bi], gold[bi]) < RMSE_BOUND[dtype]
    else:
        kb, vb, tb, _, _ = _pool_from_contiguous(kc, vc, kv_len, "bf16")
        raw = ops.pasa_paged_decode(
            torch.from_numpy(q), torch.from_numpy(kb).to(torch.bfloat16),
            torch.from_numpy(vb).to(torch.bfloat16), torch.from_numpy(tb),
            torch.from_numpy(kv_len), beta=BETA, policy=FP16).float().numpy()
        for bi in range(len(kv_len)):
            assert tnum.rmse(got[bi], gold[bi]) <= max(
                2.0 * tnum.rmse(raw[bi], gold[bi]), RMSE_BOUND[dtype])


def _prefill_case(dtype, seed=11):
    b, h, kvh, cs, d = 1, 4, 2, 48, 32
    q, kc, vc = adv.make_adversarial(
        "seq_bias", jax.random.PRNGKey(seed), q_shape=(b, h, cs, d),
        kv_shape=(b, kvh, cs, d))
    q, kc, vc = (np.asarray(x, np.float32) for x in (q, kc, vc))
    kq, vq, table, quant, valid = _pool_from_contiguous(kc, vc, [cs], dtype)
    start = np.zeros((b,), np.int32)
    kv_len = np.full((b,), cs, np.int32)
    return q, kc, vc, kq, vq, table, quant, valid, start, kv_len


def _gold_prefill(q, kc, vc):
    b, h, cs, d = q.shape
    g = h // kc.shape[1]
    kk = np.repeat(kc, g, 1).astype(np.float64)
    vv = np.repeat(vc, g, 1).astype(np.float64)
    s = q.astype(np.float64) @ np.swapaxes(kk, -1, -2) / math.sqrt(d)
    s = np.where(np.tril(np.ones((cs, cs), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)) @ vv


@pytest.mark.parametrize("policy", ["fp32", "fp16"])
@pytest.mark.parametrize("dtype", QDTYPES)
def test_prefill_quant_mode_matches_reference(dtype, policy):
    q, kc, vc, kq, vq, table, quant, _, start, kv_len = _prefill_case(dtype)
    pol, ref_pol = (FP32, REF_FP32) if policy == "fp32" else (FP16, REF_FP16)
    got = ops.pasa_paged_prefill(
        torch.from_numpy(q), _to_torch(kq), _to_torch(vq),
        torch.from_numpy(table), torch.from_numpy(start),
        torch.from_numpy(kv_len), beta=BETA, policy=pol,
        **_quant_t(quant)).float().numpy()
    assert np.isfinite(got).all()
    args = (jnp.asarray(q), kq, vq, jnp.asarray(table), jnp.asarray(start),
            jnp.asarray(kv_len))
    for kw in (dict(use_kernel=False), dict(interpret=True, block_q=16)):
        want = RK.pasa_paged_prefill(*args, beta=BETA, policy=ref_pol, **kw,
                                     **quant)
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   **PREFILL_TOL, err_msg=str(kw))
    gold = _gold_prefill(q, kc, vc)
    if policy == "fp32":
        assert tnum.rmse(got, gold) < RMSE_BOUND[dtype]
    else:
        kb, vb, tb, _, _ = _pool_from_contiguous(kc, vc, [q.shape[2]], "bf16")
        raw = ops.pasa_paged_prefill(
            torch.from_numpy(q), torch.from_numpy(kb).to(torch.bfloat16),
            torch.from_numpy(vb).to(torch.bfloat16), torch.from_numpy(tb),
            torch.from_numpy(start), torch.from_numpy(kv_len), beta=BETA,
            policy=FP16).float().numpy()
        assert tnum.rmse(got, gold) <= max(2.0 * tnum.rmse(raw, gold),
                                           RMSE_BOUND[dtype])


def test_three_of_four_sidecars_raise():
    """All four sidecars or none, as the reference's ``_check_quant``; a
    sidecar of the wrong shape raises too."""
    q, kc, vc, kv_len = _decode_case()
    kq, vq, table, quant, _ = _pool_from_contiguous(kc, vc, kv_len, "int8")
    qt = _quant_t(quant)
    args = (torch.from_numpy(q), _to_torch(kq), _to_torch(vq),
            torch.from_numpy(table), torch.from_numpy(kv_len))
    with pytest.raises(ValueError):
        ops.pasa_paged_decode(*args, k_scale=qt["k_scale"],
                              k_shift=qt["k_shift"], v_scale=qt["v_scale"])
    with pytest.raises(ValueError):
        ops.pasa_paged_decode(*args, **dict(qt, v_shift=qt["k_scale"]))


# ------------------------------------- properties of the port's path --

def _poisoned(kq, vq, quant, valid, dtype):
    """Codes past kv_len -> NaN (fp8) or 127 (int8); every sidecar of a
    page without a valid row -> NaN."""
    kq, vq = _to_torch(kq), _to_torch(vq)
    bad = float("nan") if dtype == "fp8_e4m3" else 127.0
    stale = torch.from_numpy(~valid)[..., None, None]
    kq2, vq2 = (torch.where(stale, bad, x.float()).to(x.dtype) for x in (kq, vq))
    dead = torch.from_numpy(~valid.any(1))
    q2 = {}
    for name, x in _quant_t(quant).items():
        q2[name] = torch.where(dead.reshape((-1,) + (1,) * (x.dim() - 1)),
                               float("nan"), x)
    return kq2, vq2, q2


@pytest.mark.parametrize("dtype", QDTYPES)
def test_stale_codes_and_dead_page_sidecars_are_inert(dtype):
    """Debris past kv_len (a partial tail page) and NaN sidecars on dead
    pages change no bit of the output, in decode and in prefill."""
    q, kc, vc, kv_len = _decode_case(kv_lens=(40, 7))
    kq, vq, table, quant, valid = _pool_from_contiguous(
        kc, vc, kv_len, dtype, extra_pages=3)
    kq2, vq2, q2 = _poisoned(kq, vq, quant, valid, dtype)
    args = (torch.from_numpy(table), torch.from_numpy(kv_len))
    clean = ops.pasa_paged_decode(torch.from_numpy(q), _to_torch(kq),
                                  _to_torch(vq), *args, beta=BETA,
                                  policy=FP16, **_quant_t(quant))
    dirty = ops.pasa_paged_decode(torch.from_numpy(q), kq2, vq2, *args,
                                  beta=BETA, policy=FP16, **q2)
    assert torch.isfinite(clean.float()).all()
    assert torch.equal(clean, dirty)

    q, _, _, kq, vq, table, quant, valid, start, kv_len = _prefill_case(dtype)
    kv_len = kv_len - 9                 # a partial tail page
    valid = valid.copy()
    valid[table[0, 2], PAGE - 9:] = False
    kq2, vq2, q2 = _poisoned(kq, vq, quant, valid, dtype)
    args = (torch.from_numpy(table), torch.from_numpy(start),
            torch.from_numpy(kv_len))
    clean = ops.pasa_paged_prefill(torch.from_numpy(q[:, :, :PAGE * 3 - 9]),
                                   _to_torch(kq), _to_torch(vq), *args,
                                   beta=BETA, policy=FP16, **_quant_t(quant))
    dirty = ops.pasa_paged_prefill(torch.from_numpy(q[:, :, :PAGE * 3 - 9]),
                                   kq2, vq2, *args, beta=BETA, policy=FP16,
                                   **q2)
    assert torch.isfinite(clean.float()).all()
    assert torch.equal(clean, dirty)


@pytest.mark.parametrize("dtype", QDTYPES)
def test_tail_page_requantization_drift_is_bounded(dtype):
    """Decode re-quantizes the tail page on every append (rounding earlier
    rows again).  Through the attention layer's own write path, a page
    filled one row at a time stays within page/2 one-shot errors of the
    raw values (tests/test_kv_quant.py's bound)."""
    from repro_torch.models import attention as attn_mod

    kvh, d = 2, 32
    rng = np.random.default_rng(3)
    raw = torch.from_numpy(
        (rng.standard_normal((PAGE, kvh, d)) * 1.5 + 4.0).astype(np.float32))
    pool = TPC.init_paged_pool(1, 2, PAGE, kvh * d, dtype, n_kv_heads=kvh,
                               device="cpu")
    layer = {name: leaf[0] for name, leaf in pool.items()}
    cfg = get_config("qwen2-7b").reduced()
    phys = torch.tensor([1])
    for t in range(PAGE):
        x = raw[t].reshape(1, 1, kvh, d)
        attn_mod._requantize_tail_pages(x, x, cfg, layer, phys,
                                        torch.tensor([t]))
    inc = TPC.dequantize_kv_page(
        layer["k"][1].reshape(PAGE, kvh, d), layer["k_scale"][1],
        layer["k_shift"][1].reshape(kvh, d))
    one = TPC.dequantize_kv_page(*TPC.quantize_kv_page(
        raw, torch.ones(PAGE, dtype=torch.bool), dtype))
    err_inc = float((inc - raw).abs().max())
    err_one = float((one - raw).abs().max())
    assert err_inc <= (PAGE / 2) * err_one + 1e-6, (err_inc, err_one)
    assert torch.equal(layer["k"][1].view(torch.uint8),
                       layer["v"][1].view(torch.uint8))


def _k_recon_rmse(kc, kv_lens, dtype, center):
    """Relative RMSE of the port's dequantized K pool against the raw K
    it was packed from (every table slot fully valid)."""
    kp, _, table, _, valid = _pool_from_contiguous(kc, kc, kv_lens, "bf16")
    codes, scale, shift = TPC.quantize_kv_page(
        torch.from_numpy(kp), torch.from_numpy(valid), dtype, center=center)
    back = TPC.dequantize_kv_page(codes, scale, shift).numpy()
    b, mp = table.shape
    got = back[table.reshape(-1)].reshape(b, mp * PAGE, *back.shape[2:])
    return tnum.rmse(np.moveaxis(got, 1, 2), kc)


@pytest.mark.parametrize("dtype", QDTYPES)
@pytest.mark.parametrize("case", ["seq_bias", "resonance_0"])
def test_shift_centered_pool_beats_unshifted_10x(case, dtype):
    """PASA's pseudo-average shift as a storage format: on the paper's
    biased and resonant keys the centred pool reconstructs K at least 10x
    better than the same quantizer without the shift."""
    _, kc, _, _ = _decode_case(case, kv_lens=(96,), seed=1)
    kc = kc[:, :, :96]
    centred = _k_recon_rmse(kc, [96], dtype, True)
    plain = _k_recon_rmse(kc, [96], dtype, False)
    assert plain >= 10 * centred, (plain, centred)


# ----------------------------------------------- engine, int8 and fp8 --

CHUNK = 32
GEN = 5
PROMPT_LENS = (40, 23, 9)
ENGINE_KW = dict(max_batch=3, num_pages=16, page_size=PAGE,
                 prefill_chunk=CHUNK, prefill_batch=2)
# Greedy streams of the two stacks may flip only at a near-tie: the
# prompts are picked so every top-2 margin of the reference's stream
# exceeds STREAM_MARGIN, which is checked first.
STREAM_MARGIN = 0.05
# prompts whose reference streams keep every margin above it at both
# dtypes (smallest 0.113 at int8, 0.108 at fp8_e4m3; the default prompts
# come within 0.03)
STREAM_SEED = 38
# Prefill and first decode step logits, port vs reference at the same pool
# dtype: bf16 layers on two stacks plus the dequant rounding (the
# reference's serving path rounds f32 -> bf16 -> fp16, the port f32 ->
# fp16).  Measured max on the first prompt 0.030 (int8) and 0.034
# (fp8_e4m3), held at LOGIT_ATOL; on all three prompts 0.030 and 0.053,
# held at the two stacks' logit bar of tests/test_torch_model.py.
LOGIT_ATOL = 0.05
MODEL_LOGIT_ATOL = 0.1


def _cfgs():
    rc = ref_get_config("qwen2-7b").reduced()
    rc = dataclasses.replace(
        rc, attention=dataclasses.replace(rc.attention, block_kv=PAGE))
    tc = get_config("qwen2-7b").reduced()
    tc = dataclasses.replace(
        tc, attention=dataclasses.replace(tc.attention, block_kv=PAGE))
    return rc, tc


@pytest.fixture(scope="module")
def models():
    rc, tc = _cfgs()
    rb = ref_build(rc)
    rp = rb.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.array(x, np.float32), rp)
    return rc, rb, rp, tc, build(tc), params_from_numpy(tree, tc, "cpu")


def _prompts(seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).tolist() for n in PROMPT_LENS]


def _serve(engine_cls, bundle, params, prompts, dtype, **kw):
    eng = engine_cls(bundle, params, cache_dtype=dtype, **dict(ENGINE_KW, **kw))
    reqs = [eng.submit(p, GEN) for p in prompts[:2]]
    eng.step()
    reqs += [eng.submit(p, GEN) for p in prompts[2:]]
    eng.run_to_completion()
    return eng, [r.generated for r in reqs]


@pytest.mark.parametrize("dtype", QDTYPES)
def test_engine_batched_equals_cold_reference_other_chunking(models, dtype):
    """Inside the port, bit for bit: each request served among staggered
    others equals the same request served alone under another chunk
    schedule (page-granular quantize-on-write keeps pages a function of
    the token prefix)."""
    _, _, _, tc, bundle, tp = models
    prompts = _prompts()
    eng, streams = _serve(ServeEngine, bundle, tp, prompts, dtype)
    assert eng.stats()["pool_dtype"] == dtype
    for p, s in zip(prompts, streams):
        assert s == chunked_cold_reference(bundle, tp, p, GEN, page_size=PAGE,
                                           prefill_chunk=PAGE,
                                           cache_dtype=dtype)


@pytest.mark.parametrize("dtype", QDTYPES)
def test_engine_page_reuse_is_clean(models, dtype):
    """No scrubbing: a request decoded on pages dirty with an earlier
    request's codes and sidecars equals a fresh-pool serve."""
    _, _, _, tc, bundle, tp = models
    rng = np.random.default_rng(6)
    pa, pb = rng.integers(0, 512, 9).tolist(), rng.integers(0, 512, 6).tolist()
    kw = dict(max_batch=1, num_pages=2, page_size=PAGE, cache_dtype=dtype)
    eng = ServeEngine(bundle, tp, **kw)
    eng.submit(pa, 5)
    eng.run_to_completion()
    assert eng.pool["k_scale"][:, 1].abs().sum() > 0    # page 1 is dirty
    rb = eng.submit(pb, 5)
    eng.run_to_completion()
    fresh = ServeEngine(bundle, tp, **kw)
    rf = fresh.submit(pb, 5)
    fresh.run_to_completion()
    assert rb.generated == rf.generated


def _ref_margins(rc, rp, prompt, stream, dtype):
    """The reference's logits along its own stream, replayed for one
    request on a fresh pool of ``dtype`` (prefill in CHUNK-token chunks,
    then decode), and the smallest top-2 margin of its decisions."""
    n_pages = math.ceil((len(prompt) + len(stream)) / PAGE)
    pool = RT.init_paged_cache(rc, n_pages + 1, PAGE, dtype=dtype)
    table = jnp.asarray([list(range(1, n_pages + 1))], jnp.int32)
    prefill = jax.jit(lambda *a: RT.prefill_step_paged(rp, rc, *a))
    decode = jax.jit(lambda *a: RT.serve_step_paged(rp, rc, *a))
    logits_all = []
    for c0 in range(0, len(prompt), CHUNK):
        real = min(CHUNK, len(prompt) - c0)
        toks = np.zeros((1, CHUNK), np.int32)
        toks[0, :real] = prompt[c0:c0 + real]
        logits, pool = prefill(
            jnp.asarray(toks), jnp.asarray([c0], jnp.int32),
            jnp.asarray([c0 + real], jnp.int32),
            jnp.asarray([real - 1], jnp.int32), pool, table)
    logits_all.append(np.asarray(logits[0]))
    for i, tok in enumerate(stream[:-1]):
        logits, pool = decode(jnp.asarray([tok], jnp.int32),
                              jnp.asarray([len(prompt) + i], jnp.int32),
                              pool, table)
        logits_all.append(np.asarray(logits[0]))
    top2 = np.sort(np.stack(logits_all), -1)[:, -2:]
    return logits_all, float((top2[:, 1] - top2[:, 0]).min())


def _port_logits(tc, tp, bundle, prompt, first_token, dtype):
    """The port's prefill logits and first decode step logits for one
    request on a fresh pool of ``dtype``."""
    n_pages = math.ceil((len(prompt) + 2) / PAGE)
    pool = bundle.init_paged_cache(n_pages + 1, PAGE, dtype, device="cpu")
    table = torch.arange(1, n_pages + 1, dtype=torch.int32)[None]
    for c0 in range(0, len(prompt), CHUNK):
        real = min(CHUNK, len(prompt) - c0)
        toks = torch.zeros((1, CHUNK), dtype=torch.int32)
        toks[0, :real] = torch.tensor(prompt[c0:c0 + real])
        logits, pool = bundle.paged_prefill_step(
            tp, toks, torch.tensor([c0], dtype=torch.int32),
            torch.tensor([c0 + real], dtype=torch.int32),
            torch.tensor([real - 1], dtype=torch.int32), pool, table)
    step, pool = bundle.paged_serve_step(
        tp, torch.tensor([first_token], dtype=torch.int32),
        torch.tensor([len(prompt)], dtype=torch.int32), pool, table)
    return logits[0].numpy(), step[0].numpy()


@pytest.mark.parametrize("dtype", QDTYPES)
def test_greedy_streams_and_logits_match_reference_engine(models, dtype):
    rc, rb, rp, tc, bundle, tp = models
    prompts = _prompts(STREAM_SEED)
    ref_eng, ref_streams = _serve(RefEngine, rb, rp, prompts, dtype)
    _, streams = _serve(ServeEngine, bundle, tp, prompts, dtype)
    for p, want in zip(prompts, ref_streams):
        _, margin = _ref_margins(rc, rp, p, want, dtype)
        assert margin > STREAM_MARGIN, margin
    assert streams == ref_streams
    # the logits of the prefill and of the first decode step
    for i, (p, want) in enumerate(zip(prompts, ref_streams)):
        ref_logits, _ = _ref_margins(rc, rp, p, want, dtype)
        pre, dec = _port_logits(tc, tp, bundle, p, want[0], dtype)
        atol = LOGIT_ATOL if i == 0 else MODEL_LOGIT_ATOL
        np.testing.assert_allclose(pre, ref_logits[0], atol=atol, rtol=0)
        np.testing.assert_allclose(dec, ref_logits[1], atol=atol, rtol=0)


# ----------------------------------------------------------------- CLI --

@pytest.mark.parametrize("flags", [["--kv-dtype", "int8"],
                                   ["--kv-dtype", "fp8_e4m3"],
                                   ["--kv-dtype", "int8",
                                    "--kv-quant-scale", "quantile"]],
                         ids=["int8", "fp8_e4m3", "int8_quantile"])
def test_serve_cli_quantized_pool(flags, capsys):
    out = serve.main(["--arch", "qwen2-7b", "--reduced", "--device", "cpu",
                      "--paged", "--page-size", "16", "--batch", "2",
                      "--prompt-len", "20", "--gen", "3"] + flags)
    assert out.shape == (2, 3) and ((out >= 0) & (out < 512)).all()
    text = capsys.readouterr().out
    assert "sample:" in text and flags[1] in text


def test_serve_cli_kv_dtype_needs_the_paged_route():
    with pytest.raises(SystemExit):
        serve.main(["--arch", "qwen2-7b", "--reduced", "--device", "cpu",
                    "--kv-dtype", "int8"])


# ---------------------------------------------- numerics and beta (A1) --

def test_numerics_instruments_match_reference():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((3, 5, 16)).astype(np.float32)
    b = (a + 0.01 * rng.standard_normal(a.shape)).astype(np.float32)
    assert tnum.rmse(torch.from_numpy(b), a) == ref_numerics.rmse(b, a)
    x = a.copy()
    x[0, 0, :3] = [np.nan, np.inf, -np.inf]
    assert tnum.overflow_stats(torch.from_numpy(x)) == \
        ref_numerics.overflow_stats(jnp.asarray(x))
    q, k = (300.0 * a).astype(np.float32), (300.0 * b).astype(np.float32)
    got = tnum.score_overflow_probe(torch.from_numpy(q), torch.from_numpy(k))
    want = ref_numerics.score_overflow_probe(jnp.asarray(q), jnp.asarray(k))
    assert got["would_overflow_fp16"] == want["would_overflow_fp16"]
    assert got["overflow_pct"] == want["overflow_pct"]
    np.testing.assert_allclose([got["smax"], got["smin"]],
                               [want["smax"], want["smin"]], rtol=1e-5)
    assert tnum.resonance_index(q, k) == pytest.approx(
        ref_numerics.resonance_index(q, k), rel=1e-12)
    rq, rk = tnum.make_resonant_qk(np.random.default_rng(0), (2, 8, 64),
                                   amplitude=70.0, anti=False)
    assert rq.dtype == rk.dtype == torch.float32
    assert tnum.resonance_index(rq, rk) > 0.9
    assert tnum.score_overflow_probe(rq, rk)["would_overflow_fp16"]


@pytest.mark.parametrize("tp", ["float16", "bfloat16"])
def test_beta_solve_matches_reference(tp):
    for beta in ref_beta.PAPER_BETAS + (0.9, 0.5):
        assert tbeta.practical_invariance(beta, 128, tp) == \
            ref_beta.practical_invariance(beta, 128, tp)
        assert tbeta.invariance_rel_err(beta, 128, tp) == \
            ref_beta.invariance_rel_err(beta, 128, tp)
        assert tbeta.optimal_beta(beta, 64, tp=tp) == \
            ref_beta.optimal_beta(beta, 64, tp=tp)
    assert tbeta.solve_paper_betas(tp=tp) == ref_beta.solve_paper_betas(tp=tp)
    assert tbeta.PAPER_BETAS == ref_beta.PAPER_BETAS
    # core.beta.effective_invariance is the reference's (beta, n, tp)
    # function; the package exports the GEMM-shift one, as the reference's
    # core/__init__ does
    for beta in ref_beta.PAPER_BETAS + (0.9, 0.5):
        assert tbeta.effective_invariance(beta, 128, tp) == \
            ref_beta.effective_invariance(beta, 128, tp)
    assert tbeta.effective_invariance(0.984497, 128) == pytest.approx(
        63.5039, abs=1e-4)
    from repro_torch import core
    from repro_torch.core import shifting
    assert core.effective_invariance is shifting.effective_invariance
