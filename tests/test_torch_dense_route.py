"""The port's dense serving route against the reference's, on the reduced
qwen2-7b (PASA block 16) with the reference's ``init_lm`` parameters
carried across through numpy (``params_from_numpy``): the fused prefill
(the paper's GEMM shift, causal, over the fresh K/V) at an aligned and an
unaligned prompt length, the dense cache it writes, a decode step on the
dense cache, and the greedy streams of the whole loop."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import transformer as RT
from repro.models.model_zoo import build as ref_build
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.launch.steps import make_serve_step
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build

torch.set_num_threads(1)

BLOCK = 16
BATCH = 3
GEN = 6
# as tests/test_torch_model.py: both stacks run the layers at bf16 and
# round the same expressions at different places, so logits agree within
# 0.1 absolute
LOGIT_ATOL = 0.1


def _cfgs():
    rc = ref_get_config("qwen2-7b").reduced()
    rc = dataclasses.replace(
        rc, attention=dataclasses.replace(rc.attention, block_kv=BLOCK))
    tc = get_config("qwen2-7b").reduced()
    tc = dataclasses.replace(
        tc, attention=dataclasses.replace(tc.attention, block_kv=BLOCK))
    return rc, tc


@pytest.fixture(scope="module")
def models():
    rc, tc = _cfgs()
    rp = ref_build(rc).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.array(x, np.float32), rp)
    return rc, rp, tc, params_from_numpy(tree, tc, "cpu")


def _prompts(s, seed=None):
    rng = np.random.default_rng(s if seed is None else seed)
    return rng.integers(0, 512, (BATCH, s)).astype(np.int32)


def _ref_prefill(rc, rp, tokens, max_len):
    fn = jax.jit(lambda p, t, c: RT.prefill_logits(p, rc, t, c))
    return fn(rp, jnp.asarray(tokens), RT.init_cache(rc, BATCH, max_len))


def _bf16_ulp(x):
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("s", [32, 40], ids=["aligned", "unaligned"])
def test_prefill_logits_and_cache_match_reference(models, s):
    rc, rp, tc, tp = models
    tokens = _prompts(s)
    max_len = s + GEN + 8
    want, ref_cache = _ref_prefill(rc, rp, tokens, max_len)
    cache = build(tc).init_cache(BATCH, max_len, device="cpu")
    got, cache = build(tc).prefill(tp, torch.from_numpy(tokens), cache)
    assert got.dtype == torch.float32 and got.shape == (BATCH, tc.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)
    # rows [0, S) written, the rest untouched.  Layer 0's K/V depend only
    # on the embedding, the projections and RoPE: within one bf16 ulp;
    # deeper layers at the logits' bar (as tests/test_torch_model.py)
    for name in ("k", "v"):
        w = np.asarray(ref_cache[name], np.float32)
        g = cache[name].float().numpy()
        assert not g[:, :, s:].any()
        ulp = _bf16_ulp(np.maximum(np.abs(g[0]), np.abs(w[0])))
        assert (np.abs(g[0] - w[0]) <= ulp).all(), name
        np.testing.assert_allclose(g[1:], w[1:], atol=LOGIT_ATOL, rtol=0)


def test_decode_step_matches_reference_on_the_same_cache(models):
    rc, rp, tc, tp = models
    s = 40
    want_pf, ref_cache = _ref_prefill(rc, rp, _prompts(s), s + GEN + 8)
    token = np.argmax(np.asarray(want_pf), -1).astype(np.int32)
    pos = np.full(BATCH, s, np.int32)
    step = jax.jit(lambda p, *a: RT.serve_step(p, rc, *a))
    want, _ = step(rp, jnp.asarray(token), jnp.asarray(pos), ref_cache)
    cache = {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
             for k, v in ref_cache.items()}
    got, cache = build(tc).serve_step(tp, torch.from_numpy(token),
                                      torch.from_numpy(pos), cache)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)
    assert cache["k"][:, :, s].abs().sum() > 0      # row `pos` written


def _ref_stream(rc, rp, tokens):
    """The reference's greedy stream and the smallest top-2 logit margin
    of its decisions."""
    s = tokens.shape[1]
    logits, cache = _ref_prefill(rc, rp, tokens, s + GEN + 8)
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
    return np.stack(out, 1), float(np.min(margins))


def _port_stream(tc, tp, tokens):
    bundle = build(tc)
    s = tokens.shape[1]
    cache = bundle.init_cache(BATCH, s + GEN + 8, device="cpu")
    step = make_serve_step(bundle)
    logits, cache = bundle.prefill(tp, torch.from_numpy(tokens), cache)
    tok = torch.argmax(logits, -1).to(torch.int32)
    out = [tok]
    for i in range(s, s + GEN - 1):
        tok, _, cache = step(tp, tok, torch.full((BATCH,), i, dtype=torch.int32),
                             cache)
        out.append(tok)
    return torch.stack(out, 1).numpy()


# The two stacks' logits differ by a few 1e-2 (bf16 rounding, measured
# max 0.029), so a greedy argmax can flip only where the reference's top
# two logits lie closer than that: on prompt seed 40 at length 40 a 0.011
# margin flipped one token.  The prompts below keep every margin of the
# reference's stream above STREAM_MARGIN, which the test checks first.
STREAM_MARGIN = 0.05


@pytest.mark.parametrize("s,seed", [(32, 2), (40, 5)],
                         ids=["aligned", "unaligned"])
def test_greedy_streams_equal_reference(models, s, seed):
    rc, rp, tc, tp = models
    tokens = _prompts(s, seed)
    want, margin = _ref_stream(rc, rp, tokens)
    assert margin > STREAM_MARGIN
    np.testing.assert_array_equal(_port_stream(tc, tp, tokens), want)


def test_dense_prefill_raises_for_unported_layouts(models):
    """No layout of the dense prefill raises any more.  The algebraic
    shift (``use_gemm_shift=False``, ROADMAP A12b) runs: prefill logits
    and the dense cache against the reference's at the same flag.  The
    grouped layout (``expand_kv=False``) is the same op call as the
    expanded one, so the same logits (tests/test_torch_dense_configs.py
    holds it against the reference's grouped layout)."""
    rc, rp, tc, tp = models
    alg = lambda c: dataclasses.replace(c, attention=dataclasses.replace(
        c.attention, use_gemm_shift=False))
    s = 40
    tokens = _prompts(s)
    want, ref_cache = _ref_prefill(alg(rc), rp, tokens, s + 8)
    bundle = build(alg(tc))
    got, cache = bundle.prefill(tp, torch.from_numpy(tokens),
                                bundle.init_cache(BATCH, s + 8, device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].float().numpy(),
                                   np.asarray(ref_cache[name], np.float32),
                                   atol=LOGIT_ATOL, rtol=0, err_msg=name)
    tokens = torch.zeros((1, 16), dtype=torch.int32)
    logits = {}
    for expand in (True, False):
        cfg = dataclasses.replace(tc, attention=dataclasses.replace(
            tc.attention, expand_kv=expand))
        bundle = build(cfg)
        cache = bundle.init_cache(1, 24, device="cpu")
        logits[expand] = bundle.prefill(tp, tokens, cache)[0].float()
    assert torch.equal(logits[False], logits[True])


@pytest.mark.parametrize("route", [[], ["--paged", "--page-size", "16"]],
                         ids=["dense", "paged"])
def test_serve_cli_runs_both_routes_on_the_cpu(route):
    ops.reset_launches()
    out = serve.main(["--arch", "qwen2-7b", "--reduced", "--batch", "2",
                      "--prompt-len", "20", "--gen", "4", "--device", "cpu",
                      *route])
    assert out.shape == (2, 4)
    assert ((out >= 0) & (out < 512)).all()
    # the CPU takes the plain versions: no kernel launch is counted
    assert ops.pasa_attention.launches == ops.pasa_decode.launches == 0


def test_serve_cli_defaults_to_the_dense_route():
    args = serve.build_parser().parse_args(["--arch", "qwen2-7b"])
    assert not args.paged and args.max_len is None and args.device == "cuda"
