"""The rest of the dense family in the port: the qwen3-4b / -14b / -32b and
qwen1.5-32b configs, qk-norm attention, the grouped (``expand_kv=False``)
dense prefill, and ``core.shifting.shifting_matrix_inverse``, each held
against the reference.

Attention and model fixtures draw the qk-norm weights as 1 + 0.1 N(0, 1)
(the reference inits them to ones, where a dropped or transposed weight
would not show) and hand the same numpy values to both packages; models
are the reduced configs with the PASA block at 16 and the reference's
``init_lm`` parameters carried across through numpy."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import shifting as ref_shifting
from repro.models import attention as RA
from repro.models import transformer as RT
from repro.models.model_zoo import build as ref_build
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core import shifting_matrix, shifting_matrix_inverse
from repro_torch.models import transformer as TT
from repro_torch.models.attention import attention
from repro_torch.models.convert import init_lm, params_from_numpy
from repro_torch.models.model_zoo import build

torch.set_num_threads(1)

NEW_ARCHS = ("qwen3-4b", "qwen3-14b", "qwen3-32b", "qwen1.5-32b")
BLOCK = 16
BATCH = 3
GEN = 6
# as tests/test_torch_model.py and tests/test_torch_dense_route.py: both
# stacks run the layers at bf16 and round the same expressions at
# different places, so logits agree within 0.1 absolute
LOGIT_ATOL = 0.1
# one attention layer (its output projection included) at bf16: one bf16
# ulp of outputs of magnitude up to 4 (measured max 0.0039 over three
# seeds and the four branches)
ATTN_ATOL = 1.6e-2
# the greedy streams are compared only on prompts whose reference top-2
# margins clear this (tests/test_torch_dense_route.py: a 0.011 margin
# flipped a token between the stacks)
STREAM_MARGIN = 0.05


def _shared_fields(port_obj, ref_obj):
    """The port's fields of a config dataclass, from both packages."""
    names = [f.name for f in dataclasses.fields(port_obj)]
    pick = lambda o: {n: getattr(o, n) for n in names}
    mine, want = pick(port_obj), pick(ref_obj)
    for sub in names:
        if dataclasses.is_dataclass(mine[sub]):
            mine[sub], want[sub] = _shared_fields(mine[sub], want[sub])
    return mine, want


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_matches_reference(arch):
    assert arch in ALL_ARCHS
    mine, ref = get_config(arch), ref_get_config(arch)
    for got, want in ((mine, ref), (mine.reduced(), ref.reduced())):
        a, b = _shared_fields(got, want)
        assert a == b
        assert (got.q_dim, got.kv_dim, got.group) == (
            want.q_dim, want.kv_dim, want.group)
        got.validate()
    assert mine.qk_norm == (arch != "qwen1.5-32b")
    assert mine.qkv_bias == (arch == "qwen1.5-32b")
    build(mine)                                 # no qk-norm refusal left


def _with_norms(tree, cfg, rng, bk_mean=0.0):
    """The reference's numpy param tree with the qk-norm weights drawn as
    1 + 0.1 N(0, 1) (when the config has them) and, for ``bk_mean``, the
    K bias drawn as bk_mean + N(0, 1)."""
    attn = tree["blocks"]["attn"]
    for name in ("q_norm", "k_norm"):
        if name in attn:
            attn[name] = (1.0 + 0.1 * rng.standard_normal(
                attn[name].shape)).astype(np.float32)
    if bk_mean:
        attn["bk"] = (bk_mean + rng.standard_normal(attn["bk"].shape)).astype(
            np.float32)
    return tree


def _cfgs(arch, **attn):
    rc = ref_get_config(arch).reduced()
    tc = get_config(arch).reduced()
    kw = dict(block_kv=BLOCK, **attn)
    return (dataclasses.replace(rc, attention=dataclasses.replace(
                rc.attention, **kw)),
            dataclasses.replace(tc, attention=dataclasses.replace(
                tc.attention, **kw)))


def _models(arch, bk_mean=0.0, **attn):
    rc, tc = _cfgs(arch, **attn)
    rp = ref_build(rc).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.array(x, np.float32), rp)
    tree = _with_norms(tree, rc, np.random.default_rng(7), bk_mean)
    rp = jax.tree.map(jnp.asarray, tree)
    return rc, rp, tc, params_from_numpy(tree, tc, "cpu")


@pytest.fixture(scope="module")
def qwen3():
    return _models("qwen3-4b")


@pytest.fixture(scope="module")
def qwen15():
    return _models("qwen1.5-32b")


# --------------------------------------------------------- attention --

def _layer(cfg, rng, ones=False):
    """One layer's attention params as float32 numpy (projections
    N(0, 1/d_in), qk-norm weights 1 + 0.1 N(0, 1), or ones)."""
    d, hd = cfg.d_model, cfg.head_dim
    dense = lambda i, o: (rng.standard_normal((i, o)) / np.sqrt(i)).astype(
        np.float32)
    p = {"wq": dense(d, cfg.q_dim), "wk": dense(d, cfg.kv_dim),
         "wv": dense(d, cfg.kv_dim), "wo": dense(cfg.q_dim, d)}
    for name in ("q_norm", "k_norm"):
        w = 1.0 + 0.1 * rng.standard_normal(hd)
        p[name] = (np.ones(hd) if ones else w).astype(np.float32)
    return p


def _to(pkg, tree):
    if pkg == "ref":
        return {k: jnp.asarray(v) for k, v in tree.items()}
    return {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in tree.items()}


def _attn_case(case, cfg, rng):
    """Inputs of one attention call of each kind: (x, the call's cache
    arguments as numpy, the written cache's key or None)."""
    b, d = 2, cfg.d_model
    if case == "prefill":
        return rng.standard_normal((b, 24, d)).astype(np.float32), {}
    kv = cfg.kv_dim
    if case == "decode":
        cache = {n: rng.standard_normal((b, 40, kv)).astype(np.float32)
                 for n in ("k", "v")}
        pos = np.array([30, 17], np.int32)
        return rng.standard_normal((b, 1, d)).astype(np.float32), dict(
            cache=cache, pos=pos)
    pool = {n: rng.standard_normal((9, BLOCK, kv)).astype(np.float32)
            for n in ("k", "v")}
    table = np.array([[3, 1, 5, 0], [7, 2, 0, 0]], np.int32)
    if case == "paged_prefill":
        start = np.array([16, 0], np.int32)
        return rng.standard_normal((b, 16, d)).astype(np.float32), dict(
            cache=pool, pos=start, page_table=table, prefill_cache=True,
            prefill_len=np.array([32, 11], np.int32))
    pos = np.array([37, 20], np.int32)               # paged decode
    return rng.standard_normal((b, 1, d)).astype(np.float32), dict(
        cache=pool, pos=pos, page_table=table)


def _run_attention(pkg, cfg, p, x, args):
    if pkg == "ref":
        kw = {k: ({n: jnp.asarray(a).astype(jnp.bfloat16)
                   for n, a in v.items()} if k == "cache" else
                  v if isinstance(v, bool) else jnp.asarray(v))
              for k, v in args.items()}
        out, _ = RA.attention(jnp.asarray(x), _to("ref", p), cfg, **kw)
        return np.asarray(out, np.float32)
    kw = {k: ({n: torch.from_numpy(a).to(torch.bfloat16)
               for n, a in v.items()} if k == "cache" else
              v if isinstance(v, bool) else torch.from_numpy(v))
          for k, v in args.items()}
    return attention(torch.from_numpy(x), _to("port", p), cfg,
                     **kw).float().numpy()


@pytest.mark.parametrize("case", ["prefill", "decode", "paged_prefill",
                                  "paged_decode"])
def test_qk_norm_attention_matches_reference(case):
    """qk-norm (after the bias, before RoPE, per head over head_dim) in
    every branch of the attention layer: the port's output equals the
    reference's within ATTN_ATOL, and the norm weights matter: the same
    call with them at ones moves the output by much more than that."""
    rc, tc = _cfgs("qwen3-4b")
    rng = np.random.default_rng(3)
    p = _layer(tc, rng)
    x, args = _attn_case(case, tc, rng)
    want = _run_attention("ref", rc, p, x, args)
    got = _run_attention("port", tc, p, x, args)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATTN_ATOL, rtol=0)
    ones = dict(p, q_norm=np.ones_like(p["q_norm"]),
                k_norm=np.ones_like(p["k_norm"]))
    moved = np.abs(_run_attention("port", tc, ones, x, args) - got).max()
    assert moved > 2 * ATTN_ATOL


def test_init_lm_draws_qk_norm_weights_as_the_reference():
    """``init_lm`` has the reference's layout with the qk-norm leaves, (L,
    head_dim) ones at the compute dtype; ``params_from_numpy`` carries
    them over."""
    rc, tc = _cfgs("qwen3-4b")
    rp = ref_build(rc).init(jax.random.PRNGKey(0))
    mine = init_lm(tc, torch.Generator().manual_seed(0), "cpu")
    shapes = lambda t: jax.tree.map(lambda x: tuple(x.shape), t)
    assert shapes(mine) == shapes(jax.tree.map(np.asarray, rp))
    for name in ("q_norm", "k_norm"):
        w = mine["blocks"]["attn"][name]
        assert w.shape == (tc.n_layers, tc.head_dim)
        assert w.dtype == torch.bfloat16 and bool((w == 1).all())
    tree = jax.tree.map(lambda x: np.array(x, np.float32), rp)
    tree = _with_norms(tree, rc, np.random.default_rng(0))
    tp = params_from_numpy(tree, tc, "cpu")
    np.testing.assert_array_equal(
        tp["blocks"]["attn"]["k_norm"].float().numpy(),
        tree["blocks"]["attn"]["k_norm"].astype(np.float32).astype(
            jnp.bfloat16).astype(np.float32))


# ------------------------------------------------------------ models --

def _prompts(s, seed):
    return np.random.default_rng(seed).integers(0, 512, (BATCH, s)).astype(
        np.int32)


def _ref_dense(rc, rp, tokens):
    """The reference's dense route: prefill logits, greedy stream and the
    smallest top-2 margin of its decisions."""
    s = tokens.shape[1]
    fn = jax.jit(lambda p, t, c: RT.prefill_logits(p, rc, t, c))
    logits, cache = fn(rp, jnp.asarray(tokens),
                       RT.init_cache(rc, BATCH, s + GEN + 8))
    first = np.asarray(logits)
    step = jax.jit(lambda p, *a: RT.serve_step(p, rc, *a))
    out, margins = [], []
    for i in range(s, s + GEN):
        top2 = np.sort(np.asarray(logits), -1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out.append(np.asarray(tok))
        if i < s + GEN - 1:
            logits, cache = step(rp, tok, jnp.full((BATCH,), i, jnp.int32),
                                 cache)
        if i == s:
            second = np.asarray(logits)
    return first, second, np.stack(out, 1), float(np.min(margins))


def _port_dense(tc, tp, tokens):
    bundle = build(tc)
    s = tokens.shape[1]
    cache = bundle.init_cache(BATCH, s + GEN + 8, device="cpu")
    logits, cache = bundle.prefill(tp, torch.from_numpy(tokens), cache)
    first, out = logits.numpy(), []
    for i in range(s, s + GEN):
        tok = torch.argmax(logits, -1).to(torch.int32)
        out.append(tok.numpy())
        if i < s + GEN - 1:
            logits, cache = bundle.serve_step(
                tp, tok, torch.full((BATCH,), i, dtype=torch.int32), cache)
        if i == s:
            second = logits.numpy()
    return first, second, np.stack(out, 1)


def _paged_stream(pkg, cfg, params, tokens):
    """The paged route by hand: the whole prompt in one prefill chunk
    into a fresh pool, then GEN - 1 decode steps; prefill logits, the
    first decode's logits and the greedy stream (the reference's also its
    smallest top-2 margin)."""
    s = tokens.shape[1]
    pages = -(-(s + GEN) // BLOCK)
    table = np.arange(1, 1 + BATCH * pages, dtype=np.int32).reshape(
        BATCH, pages)
    start = np.zeros(BATCH, np.int32)
    kv_len = np.full(BATCH, s, np.int32)
    if pkg == "ref":
        conv, argmax = jnp.asarray, lambda x: jnp.argmax(x, -1).astype(
            jnp.int32)
        prefill = jax.jit(lambda p, *a: RT.prefill_step_paged(p, cfg, *a))
        step = jax.jit(lambda p, *a: RT.serve_step_paged(p, cfg, *a))
        pool = RT.init_paged_cache(cfg, 1 + BATCH * pages, BLOCK)
    else:
        conv, argmax = torch.from_numpy, lambda x: torch.argmax(x, -1).to(
            torch.int32)
        prefill = lambda p, *a: TT.prefill_step_paged(p, cfg, *a)
        step = lambda p, *a: TT.serve_step_paged(p, cfg, *a)
        pool = TT.init_paged_cache(cfg, 1 + BATCH * pages, BLOCK,
                                   device="cpu")
    logits, pool = prefill(params, conv(tokens), conv(start), conv(kv_len),
                           conv(kv_len - 1), pool, conv(table))
    first, out, margins = np.asarray(logits), [], []
    for i in range(s, s + GEN):
        top2 = np.sort(np.asarray(logits), -1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        tok = argmax(logits)
        out.append(np.asarray(tok))
        if i < s + GEN - 1:
            logits, pool = step(params, tok,
                                conv(np.full(BATCH, i, np.int32)), pool,
                                conv(table))
        if i == s:
            second = np.asarray(logits)
    return first, second, np.stack(out, 1), float(np.min(margins))


# (arch, prompt length, prompt seed): prompts whose reference margins
# clear STREAM_MARGIN on both routes (checked first)
MODEL_CASES = [("qwen3-4b", 40, 24), ("qwen1.5-32b", 32, 2)]


@pytest.mark.parametrize("arch,s,seed", MODEL_CASES,
                         ids=[c[0] for c in MODEL_CASES])
@pytest.mark.parametrize("route", ["dense", "paged"])
def test_model_matches_reference(qwen3, qwen15, arch, s, seed, route):
    """Both serving routes of the reduced model: prefill and first-decode
    logits within LOGIT_ATOL of the reference's, and greedy streams equal
    on prompts whose reference margins clear STREAM_MARGIN."""
    rc, rp, tc, tp = qwen3 if arch == "qwen3-4b" else qwen15
    tokens = _prompts(s, seed)
    if route == "dense":
        *want, margin = _ref_dense(rc, rp, tokens)
        got = _port_dense(tc, tp, tokens)
    else:
        *want, margin = _paged_stream("ref", rc, rp, tokens)
        got = _paged_stream("port", tc, tp, tokens)[:3]
    for g, w in zip(got[:2], want[:2]):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=LOGIT_ATOL, rtol=0)
    assert margin > STREAM_MARGIN
    np.testing.assert_array_equal(got[2], want[2])


def test_large_k_bias_stays_finite_and_close():
    """qwen1.5-32b's QKV bias is the paper's "large bias in K" case: with
    the K bias drawn at mean 30 the fp16 PASA stack (the dense route's
    GEMM shift and the paged route's chunk-exact shift) stays finite and
    within LOGIT_ATOL of the reference on both routes."""
    rc, rp, tc, tp = _models("qwen1.5-32b", bk_mean=30.0)
    tokens = _prompts(32, 2)
    for route, (ref_fn, port_fn) in {
            "dense": (lambda: _ref_dense(rc, rp, tokens),
                      lambda: _port_dense(tc, tp, tokens)),
            "paged": (lambda: _paged_stream("ref", rc, rp, tokens),
                      lambda: _paged_stream("port", tc, tp, tokens))}.items():
        want, got = ref_fn(), port_fn()
        for g, w in zip(got[:2], want[:2]):
            assert np.isfinite(g).all(), route
            np.testing.assert_allclose(g, w, atol=LOGIT_ATOL, rtol=0,
                                       err_msg=route)


def test_grouped_dense_prefill_matches_reference():
    """``expand_kv=False``: the port's dense prefill (one op call for
    either layout) against the reference's grouped (B, KVH, G, S, hd)
    layout (prefill logits and the dense cache it writes)."""
    rc, rp, tc, tp = _models("qwen3-4b", expand_kv=False)
    tokens = _prompts(40, 1)
    want, second, _, _ = _ref_dense(rc, rp, tokens)
    got = _port_dense(tc, tp, tokens)
    np.testing.assert_allclose(got[0], want, atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(got[1], second, atol=LOGIT_ATOL, rtol=0)


def test_algebraic_shift_dense_prefill_still_raises():
    """No kernel of either package computes the algebraic-shift dense
    prefill; the port refuses it, naming ROADMAP A12b."""
    _, tc = _cfgs("qwen3-4b", use_gemm_shift=False)
    bundle = build(tc)
    params = bundle.init(torch.Generator().manual_seed(0), "cpu")
    cache = bundle.init_cache(1, 24, device="cpu")
    with pytest.raises(NotImplementedError, match="A12b"):
        bundle.prefill(params, torch.zeros((1, 16), dtype=torch.int32), cache)


# ----------------------------------------------------------- shifting --

@pytest.mark.parametrize("s2,d,beta", [(64, 128, 0.9375), (128, 64, 0.984497),
                                       (16, 16, 0.5)])
def test_shifting_matrix_inverse_matches_reference(s2, d, beta):
    minv = shifting_matrix_inverse(s2, d, beta)
    assert minv.dtype == torch.float64 and minv.shape == (s2, s2)
    np.testing.assert_allclose(
        minv.numpy(), np.asarray(ref_shifting.shifting_matrix_inverse(
            s2, d, beta)), rtol=1e-12, atol=0)
    # M M^-1 = I (the reference's tolerance, tests/test_shifting.py)
    m = shifting_matrix(s2, d, beta, torch.float64)
    np.testing.assert_allclose((m @ minv).numpy(), np.eye(s2), atol=1e-10)


def test_shifting_matrix_inverse_singular_at_beta_one():
    with pytest.raises(ValueError):
        shifting_matrix_inverse(64, 128, 1.0)
    with pytest.raises(ValueError):
        ref_shifting.shifting_matrix_inverse(64, 128, 1.0)
