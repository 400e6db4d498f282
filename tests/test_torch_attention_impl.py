"""The port's attention switch against the reference's: the model's
``AttentionConfig.impl`` (pasa | flash | naive) and ``policy`` on both
serving routes, and the plain versions of the four attention ops at the
fp32 and bf16_fp32 policies (the modes the flash route serves with).

Model level: the reduced qwen2-7b with the reference's ``init_lm``
parameters carried across through numpy, ``block_kv == page_size`` on
both packages.  For every (impl, policy): the dense route (fused prefill
of an unaligned prompt, then greedy decode on the dense cache) and the
paged route (chunked prefill at chunk starts 0 and 32, then greedy
decode) from a bf16 and an int8 pool.  Prefill and first-decode logits
agree within the two stacks' logit bar; greedy streams agree on prompts
whose every top-2 margin in the reference's stream exceeds STREAM_MARGIN,
which is asserted first.

Op level: each op's plain version (what every CPU tensor takes) against
the reference's Pallas kernel in interpret mode at the reference's own
tolerances (tests/test_kernels.py, tests/test_paged.py,
tests/test_prefix_cache.py), the quantized paged modes within the
reference's per-pool RMSE bound of float64 attention at FP32
(tests/test_kv_quant.py).  tests/test_torch_cuda_kernels.py holds the
CUDA kernels to these plain versions on a card.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adversarial_inputs as adv
import repro.kernels as RK
from repro.configs import get_config as ref_get_config
from repro.core import BF16_FP32 as R_BF16_FP32
from repro.core import FP32 as R_FP32
from repro.core.naive import naive_attention as ref_naive
from repro.models import transformer as RT
from repro.models.model_zoo import build as ref_build
from repro.runtime import paged_cache as RPC
from repro_torch.configs import get_config
from repro_torch.core import numerics as tnum
from repro_torch.core.naive import naive_attention
from repro_torch.core.precision import BF16_FP32, FP32
from repro_torch.kernels import ops
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build

torch.set_num_threads(1)

BETA = 0.984497
PAGE = 16                     # == block_kv on both packages
CHUNK = 32                    # paged prefill chunks start at 0 and 32
PROMPT = 40                   # unaligned to the block
GEN = 5
# tests/test_torch_dense_route.py: the two stacks run the layers at bf16
# and round the same expressions at different places; logits agree
# within 0.1, and a greedy argmax can flip only at a near-tie
LOGIT_ATOL = 0.1
STREAM_MARGIN = 0.05
COMBOS = [(impl, policy) for impl in ("pasa", "flash", "naive")
          for policy in ("bf16_fp32", "fp32")]
# prompt seeds whose reference streams keep every top-2 margin above
# STREAM_MARGIN under every (impl, policy) on each route
DENSE_SEED = 3
PAGED_SEED = 10

# the reference's kernel-vs-oracle bars (tests/test_kernels.py: PASA,
# causal PASA and FlashAttention-2; tests/test_paged.py: decode;
# tests/test_prefix_cache.py: prefill)
ATTN_TOL = dict(atol=8e-3, rtol=2e-2)
FLASH_TOL = dict(atol=2e-3, rtol=2e-2)
DECODE_TOL = dict(atol=3e-3, rtol=3e-2)
PREFILL_TOL = dict(atol=1e-2, rtol=3e-2)
# tests/test_kv_quant.py: relative RMSE vs float64 at the FP32 policy
RMSE_BOUND = {"bf16": 0.02, "int8": 0.03, "fp8_e4m3": 0.09}
POLICIES = [(FP32, R_FP32), (BF16_FP32, R_BF16_FP32)]
I = dict(interpret=True)


# ------------------------------------------------------------ the switch --

def _with_attention(cfg, **kw):
    return dataclasses.replace(
        cfg, attention=dataclasses.replace(cfg.attention, **kw))


@pytest.fixture(scope="module")
def params():
    rc = ref_get_config("qwen2-7b").reduced()
    rp = ref_build(rc).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.array(x, np.float32), rp)
    tc = get_config("qwen2-7b").reduced()
    return rp, params_from_numpy(tree, tc, "cpu")


def _cfgs(impl, policy):
    kw = dict(impl=impl, policy=policy, block_kv=PAGE)
    return (_with_attention(ref_get_config("qwen2-7b").reduced(), **kw),
            _with_attention(get_config("qwen2-7b").reduced(), **kw))


def _top2_margin(logits) -> float:
    top2 = np.sort(np.asarray(logits, np.float32), -1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


def _ref_dense(rc, rp, tokens):
    """The reference's dense route: fused prefill, then greedy decode;
    returns (stream (B, GEN), [logits per call], smallest top-2 margin)."""
    b, s = tokens.shape
    cache = RT.init_cache(rc, b, s + GEN + 8)
    logits, cache = jax.jit(lambda p, t, c: RT.prefill_logits(p, rc, t, c))(
        rp, jnp.asarray(tokens), cache)
    step = jax.jit(lambda p, *a: RT.serve_step(p, rc, *a))
    out, all_logits = [], [np.asarray(logits, np.float32)]
    for i in range(s, s + GEN):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out.append(np.asarray(tok))
        if i < s + GEN - 1:
            logits, cache = step(rp, tok, jnp.full((b,), i, jnp.int32), cache)
            all_logits.append(np.asarray(logits, np.float32))
    return np.stack(out, 1), all_logits, _top2_margin(np.stack(all_logits))


def _port_dense(tc, tp, tokens):
    bundle = build(tc)
    b, s = tokens.shape
    cache = bundle.init_cache(b, s + GEN + 8, device="cpu")
    logits, cache = bundle.prefill(tp, torch.from_numpy(tokens), cache)
    out, all_logits = [], [logits.numpy()]
    for i in range(s, s + GEN):
        tok = torch.argmax(logits, -1).to(torch.int32)
        out.append(tok.numpy())
        if i < s + GEN - 1:
            logits, cache = bundle.serve_step(
                tp, tok, torch.full((b,), i, dtype=torch.int32), cache)
            all_logits.append(logits.float().numpy())
    return np.stack(out, 1), all_logits


@pytest.mark.parametrize("impl,policy", COMBOS)
def test_dense_route_matches_reference(params, impl, policy):
    rp, tp = params
    rc, tc = _cfgs(impl, policy)
    tokens = np.random.default_rng(DENSE_SEED).integers(
        0, 512, (2, PROMPT)).astype(np.int32)
    want, want_logits, margin = _ref_dense(rc, rp, tokens)
    assert margin > STREAM_MARGIN, margin
    ops.reset_launches()
    got, got_logits = _port_dense(tc, tp, tokens)
    np.testing.assert_array_equal(got, want)
    for call in (0, 1):          # the prefill and the first decode step
        assert np.isfinite(got_logits[call]).all()
        np.testing.assert_allclose(got_logits[call], want_logits[call],
                                   atol=LOGIT_ATOL, rtol=0)
    # the CPU takes the plain versions: no kernel launch is counted
    assert all(w.launches == 0 for w in ops.WRAPPERS)


def _ref_paged(rc, rp, prompt, dtype):
    """The reference's paged route for one request on a fresh pool:
    CHUNK-token chunks of prefill, then greedy decode.  Returns (stream,
    [logits per call], smallest top-2 margin)."""
    n_pages = math.ceil((len(prompt) + GEN) / PAGE)
    pool = RT.init_paged_cache(rc, n_pages + 1, PAGE, dtype=dtype)
    table = jnp.asarray([list(range(1, n_pages + 1))], jnp.int32)
    prefill = jax.jit(lambda *a: RT.prefill_step_paged(rp, rc, *a))
    decode = jax.jit(lambda *a: RT.serve_step_paged(rp, rc, *a))
    for c0 in range(0, len(prompt), CHUNK):
        real = min(CHUNK, len(prompt) - c0)
        toks = np.zeros((1, CHUNK), np.int32)
        toks[0, :real] = prompt[c0:c0 + real]
        logits, pool = prefill(
            jnp.asarray(toks), jnp.asarray([c0], jnp.int32),
            jnp.asarray([c0 + real], jnp.int32),
            jnp.asarray([real - 1], jnp.int32), pool, table)
    stream, all_logits = [], [np.asarray(logits[0], np.float32)]
    for i in range(GEN):
        tok = int(np.argmax(all_logits[-1]))
        stream.append(tok)
        if i < GEN - 1:
            logits, pool = decode(jnp.asarray([tok], jnp.int32),
                                  jnp.asarray([len(prompt) + i], jnp.int32),
                                  pool, table)
            all_logits.append(np.asarray(logits[0], np.float32))
    return stream, all_logits, _top2_margin(np.stack(all_logits))


def _port_paged(tc, tp, prompt, dtype):
    bundle = build(tc)
    n_pages = math.ceil((len(prompt) + GEN) / PAGE)
    pool = bundle.init_paged_cache(n_pages + 1, PAGE, dtype, device="cpu")
    table = torch.arange(1, n_pages + 1, dtype=torch.int32)[None]
    i32 = lambda *x: torch.tensor(x, dtype=torch.int32)
    for c0 in range(0, len(prompt), CHUNK):
        real = min(CHUNK, len(prompt) - c0)
        toks = torch.zeros((1, CHUNK), dtype=torch.int32)
        toks[0, :real] = torch.tensor(prompt[c0:c0 + real])
        logits, pool = bundle.paged_prefill_step(
            tp, toks, i32(c0), i32(c0 + real), i32(real - 1), pool, table)
    stream, all_logits = [], [logits[0].float().numpy()]
    for i in range(GEN):
        tok = int(np.argmax(all_logits[-1]))
        stream.append(tok)
        if i < GEN - 1:
            logits, pool = bundle.paged_serve_step(
                tp, i32(tok), i32(len(prompt) + i), pool, table)
            all_logits.append(logits[0].float().numpy())
    return stream, all_logits


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("impl,policy", COMBOS)
def test_paged_route_matches_reference(params, impl, policy, dtype):
    rp, tp = params
    rc, tc = _cfgs(impl, policy)
    prompt = np.random.default_rng(PAGED_SEED).integers(
        0, 512, PROMPT).tolist()
    want, want_logits, margin = _ref_paged(rc, rp, prompt, dtype)
    assert margin > STREAM_MARGIN, margin
    got, got_logits = _port_paged(tc, tp, prompt, dtype)
    assert got == want
    for call in (0, 1):          # the last prefill chunk, the first decode
        assert np.isfinite(got_logits[call]).all()
        np.testing.assert_allclose(got_logits[call], want_logits[call],
                                   atol=LOGIT_ATOL, rtol=0)


def test_flash_route_is_batch_invariant_on_the_engine(params):
    """Inside the port, bit for bit: impl="flash" requests served among
    staggered others by the engine (rows of one prefill call at different
    chunk starts) equal each request served alone."""
    from repro_torch.runtime import ServeEngine

    _, tp = params
    _, tc = _cfgs("flash", "bf16_fp32")
    bundle = build(tc)
    kw = dict(max_batch=3, num_pages=16, page_size=PAGE, prefill_chunk=CHUNK,
              prefill_batch=2)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 512, n).tolist() for n in (40, 23, 9)]
    eng = ServeEngine(bundle, tp, **kw)
    reqs = [eng.submit(p, GEN) for p in prompts[:2]]
    eng.step()
    reqs += [eng.submit(p, GEN) for p in prompts[2:]]
    eng.run_to_completion()
    for p, r in zip(prompts, reqs):
        alone = ServeEngine(bundle, tp, **kw)
        solo = alone.submit(p, GEN)
        alone.run_to_completion()
        assert solo.generated == r.generated


def test_validate_rejects_an_unknown_impl_and_policy():
    cfg = get_config("qwen2-7b").reduced()
    assert cfg.attention.impl == "pasa"
    assert cfg.attention.policy == "bf16_fp32"       # the reference's
    with pytest.raises(ValueError, match="impl"):
        _with_attention(cfg, impl="bogus").validate()
    with pytest.raises(ValueError, match="impl"):
        build(_with_attention(cfg, impl="bogus"))
    bundle = build(_with_attention(cfg, impl="flash", policy="bogus"))
    cache = bundle.init_cache(1, 24, device="cpu")
    with pytest.raises(ValueError, match="precision policy"):
        bundle.prefill(bundle.init(torch.Generator().manual_seed(0), "cpu"),
                       torch.zeros((1, 16), dtype=torch.int32), cache)


@pytest.mark.parametrize("starts", [(0, 0), (0, 32), (16, 48)])
def test_naive_per_row_q_offset(starts):
    """A (B, 1, 1, 1) q_offset masks each row at its own chunk start: the
    same as one call per row with an int offset, and as the reference's
    naive attention with the same per-row offsets."""
    rng = np.random.default_rng(13)
    b, h, s1, s2, d = len(starts), 2, 16, 64, 32
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((b, h, s1, d), (b, h, s2, d), (b, h, s2, d)))
    kv_len = np.asarray([s0 + s1 for s0 in starts], np.int32)
    off = np.asarray(starts, np.int32).reshape(b, 1, 1, 1)
    t = lambda x: torch.from_numpy(x)
    got = naive_attention(t(q), t(k), t(v), causal=True,
                          kv_len=t(kv_len).reshape(b, 1), q_offset=t(off))
    for i, s0 in enumerate(starts):
        row = naive_attention(t(q[i:i + 1]), t(k[i:i + 1]), t(v[i:i + 1]),
                              causal=True, kv_len=t(kv_len[i:i + 1]),
                              q_offset=s0)
        torch.testing.assert_close(got[i:i + 1], row, rtol=1e-6, atol=1e-6)
    want = ref_naive(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, kv_len=jnp.asarray(kv_len).reshape(b, 1),
                     q_offset=jnp.asarray(off))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------- the ops at fp32 and bf16_fp32 --

def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


@pytest.mark.parametrize("case", adv.ADVERSARIAL_CASES)
@pytest.mark.parametrize("pols", POLICIES, ids=["fp32", "bf16_fp32"])
def test_pasa_attention_on_adversarial_inputs(pols, case):
    """tests/test_kernels.py's adversarial sweep, at the two new modes."""
    pol, rpol = pols
    q, k, v = adv.make_adversarial(
        case, jax.random.PRNGKey(3), q_shape=(1, 4, 256, 64),
        kv_shape=(1, 2, 256, 64))
    (jq, jk, jv), (tq, tk, tv) = _both(
        *(np.asarray(x, np.float32) for x in (q, k, v)))
    want = RK.pasa_attention(jq, jk, jv, beta=BETA, policy=rpol, **I)
    got = ops.pasa_attention(tq, tk, tv, beta=BETA, policy=pol)
    assert got.dtype == pol.out_dtype
    np.testing.assert_allclose(_np(got), _np(want), **ATTN_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("pols", POLICIES, ids=["fp32", "bf16_fp32"])
def test_flash_attention_in_new_modes(pols, causal):
    pol, rpol = pols
    rng = np.random.default_rng(14)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((1, 4, 256, 64), (1, 2, 256, 64), (1, 2, 256, 64)))
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    want = RK.flash_attention(jq, jk, jv, policy=rpol, causal=causal, **I)
    got = ops.flash_attention(tq, tk, tv, policy=pol, causal=causal)
    assert got.dtype == pol.out_dtype
    np.testing.assert_allclose(_np(got), _np(want), **FLASH_TOL)
    gold = naive_attention(tq, tk.repeat_interleave(2, 1),
                           tv.repeat_interleave(2, 1), causal=causal,
                           dtype=torch.float64)
    assert float((got.double() - gold).norm() / gold.norm()) < 0.02


def _paged_pool(rng, seq_lens, kvh, d, k_mean=2.0):
    """Shuffled float32 page pool, NaN past each length and on unused
    pages; returns (k, v, table, valid (P, PAGE))."""
    n_pages = [max(1, math.ceil(n / PAGE)) for n in seq_lens]
    total = 1 + sum(n_pages) + 2
    ids = rng.permutation(np.arange(1, total))
    table = np.zeros((len(seq_lens), max(n_pages) + 1), np.int32)
    k = np.full((total, PAGE, kvh, d), np.nan, np.float32)
    v = np.full((total, PAGE, kvh, d), np.nan, np.float32)
    valid = np.zeros((total, PAGE), bool)
    nxt = 0
    for b, (n, npg) in enumerate(zip(seq_lens, n_pages)):
        for j in range(npg):
            pid = int(ids[nxt])
            nxt += 1
            table[b, j] = pid
            rows = max(0, min(PAGE, n - j * PAGE))
            k[pid, :rows] = rng.standard_normal((rows, kvh, d)) + k_mean
            v[pid, :rows] = rng.standard_normal((rows, kvh, d))
            valid[pid, :rows] = True
    return k, v, table, valid


def _quantized(k, v, valid, dtype):
    """The pool as both packages take it: at bf16, or quantized per page
    by the reference (fp8 codes cross as bytes).  Returns (jax k, v,
    sidecars), (torch k, v, sidecars)."""
    if dtype == "bf16":
        tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (k, v))
        return (jnp.asarray(tk.float().numpy()).astype(jnp.bfloat16),
                jnp.asarray(tv.float().numpy()).astype(jnp.bfloat16), {}), (
            tk, tv, {})
    kq, ks, kh = RPC.quantize_kv_page(jnp.asarray(np.nan_to_num(k)),
                                      jnp.asarray(valid), dtype)
    vq, vs, vh = RPC.quantize_kv_page(jnp.asarray(np.nan_to_num(v)),
                                      jnp.asarray(valid), dtype)
    side = dict(k_scale=ks, k_shift=kh, v_scale=vs, v_shift=vh)

    def to_t(x):
        a = np.asarray(x)
        if a.dtype.itemsize == 1 and a.dtype != np.int8:
            return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
        return torch.from_numpy(np.array(a))

    return (kq, vq, side), (to_t(kq), to_t(vq),
                            {n: to_t(x) for n, x in side.items()})


def _gold(q, k, v, table, kv_lens, starts=None):
    """float64 attention of each row of q over its first kv_len positions
    of the (unquantized) pool: decode q (B, KVH, G, D), prefill q (B, H,
    S, D) causal from the rows' chunk starts."""
    out = []
    for i, n in enumerate(kv_lens):
        kk = k[table[i]].reshape(-1, *k.shape[2:])[:n].swapaxes(0, 1)
        vv = v[table[i]].reshape(-1, *v.shape[2:])[:n].swapaxes(0, 1)
        kk, vv = kk.astype(np.float64), vv.astype(np.float64)
        qq = q[i].astype(np.float64)
        if starts is not None:
            g = qq.shape[0] // kk.shape[0]
            kk, vv = np.repeat(kk, g, 0), np.repeat(vv, g, 0)
        s = qq @ kk.swapaxes(-1, -2) / math.sqrt(q.shape[-1])
        if starts is not None:
            qpos = starts[i] + np.arange(q.shape[2])[:, None]
            s = np.where(qpos >= np.arange(n)[None, :], s, -np.inf)
        p = np.exp(s - s.max(-1, keepdims=True))
        out.append((p / p.sum(-1, keepdims=True)) @ vv)
    return np.stack(out)


@pytest.mark.parametrize("dtype", ["bf16", "int8", "fp8_e4m3"])
@pytest.mark.parametrize("pols", POLICIES, ids=["fp32", "bf16_fp32"])
def test_paged_ops_in_new_modes(pols, dtype):
    """Paged decode and prefill at fp32 and bf16_fp32, from raw and 8-bit
    pools, against the reference's interpret-mode kernels; at FP32 within
    the reference's per-pool RMSE bound of float64 attention on the
    unquantized K/V."""
    pol, rpol = pols
    rng = np.random.default_rng(15)
    kvh, g, d = 2, 3, 32
    kv_len = np.asarray([37, 16, 1], np.int32)
    k, v, table, valid = _paged_pool(rng, kv_len, kvh, d)
    q = rng.standard_normal((3, kvh, g, d)).astype(np.float32)
    (jk, jv, jside), (tk, tv, tside) = _quantized(k, v, valid, dtype)
    want = RK.pasa_paged_decode(jnp.asarray(q), jk, jv, jnp.asarray(table),
                                jnp.asarray(kv_len), beta=BETA, policy=rpol,
                                **jside, **I)
    got = ops.pasa_paged_decode(torch.from_numpy(q), tk, tv,
                                torch.from_numpy(table),
                                torch.from_numpy(kv_len), beta=BETA,
                                policy=pol, **tside)
    assert got.dtype == pol.out_dtype
    np.testing.assert_allclose(_np(got), _np(want), **DECODE_TOL)
    if pol is FP32:
        gold = _gold(q, k, v, table, kv_len)
        for i in range(len(kv_len)):
            assert tnum.rmse(_np(got)[i], gold[i]) < RMSE_BOUND[dtype]

    start = np.asarray([0, 16, 0], np.int32)
    plen = np.asarray([32, 41, 0], np.int32)
    k, v, table, valid = _paged_pool(rng, plen, kvh, d)
    table[2] = 0
    # 16-query chunks at starts 0 and 16, and a pad row
    qc = (rng.standard_normal((3, 2 * kvh, 16, d)) + 1.0).astype(np.float32)
    (jk, jv, jside), (tk, tv, tside) = _quantized(k, v, valid, dtype)
    args = (table, start, np.minimum(plen, start + 16))
    want = RK.pasa_paged_prefill(jnp.asarray(qc), jk, jv,
                                 *(jnp.asarray(a) for a in args), beta=BETA,
                                 policy=rpol, block_q=16, **jside, **I)
    got = ops.pasa_paged_prefill(torch.from_numpy(qc), tk, tv, *(torch.from_numpy(a) for a in args),
                                 beta=BETA, policy=pol, **tside)
    assert got.dtype == pol.out_dtype
    assert not got[2].any()
    np.testing.assert_allclose(_np(got), _np(want), **PREFILL_TOL)
    if pol is FP32:
        gold = _gold(qc[:2], k, v, table, args[2][:2], starts=start)
        assert tnum.rmse(_np(got)[:2], gold) < RMSE_BOUND[dtype]


@pytest.mark.parametrize("beta", [0.0, BETA])
@pytest.mark.parametrize("pols", POLICIES, ids=["fp32", "bf16_fp32"])
def test_contiguous_decode_in_new_modes(pols, beta):
    pol, rpol = pols
    rng = np.random.default_rng(16)
    b, kvh, g, d, s2 = 2, 2, 4, 64, 512
    q = rng.standard_normal((b, kvh, g, d)).astype(np.float32)
    k = (rng.standard_normal((b, kvh, s2, d)) + 2.0).astype(np.float32)
    v = rng.standard_normal((b, kvh, s2, d)).astype(np.float32)
    kv_len = np.asarray([300, 77], np.int32)
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _both(q, k, v, kv_len)
    want = RK.pasa_decode(jq, jk, jv, jl, beta=beta, policy=rpol,
                          block_kv=128, **I)
    got = ops.pasa_decode(tq, tk, tv, tl, beta=beta, policy=pol,
                          block_kv=128)
    assert got.dtype == pol.out_dtype
    np.testing.assert_allclose(_np(got), _np(want), **DECODE_TOL)
    for i, n in enumerate(kv_len):
        gold = naive_attention(tq[i:i + 1], tk[i:i + 1, :, :n],
                               tv[i:i + 1, :, :n], dtype=torch.float64)
        assert float((got[i:i + 1].double() - gold).norm() / gold.norm()) \
            < 0.03
