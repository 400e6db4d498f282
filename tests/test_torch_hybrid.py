"""The port's hybrid family (zamba2: Mamba-2 + a weight-shared PASA
attention block) against the reference's, on the reduced zamba2-1.2b
with the reference's ``init_hybrid`` parameters carried across through
numpy: the config, the weight carry and the random layout, the
whole-sequence forward, ``serve_step``'s logits and cache over 140 decode
steps past the attention block boundary, greedy streams, batched ==
one-at-a-time, and the CLI's token-by-token route."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import hybrid as RH
from repro.models.model_zoo import build as ref_build
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import hybrid
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build

torch.set_num_threads(1)

# Logits and caches of the two stacks.  At the compute dtype fp32 they
# differ only by the fp16 PASA attention's rounding (measured 6.0e-4 on
# logits, 6.1e-4 on the conv window over 140 steps).  At bf16 the two
# round bf16 elementwise steps differently (jax's bf16 silu differs from
# torch's in the last bit on about a third of inputs) and the Mamba state
# carries it: measured over 140 steps 0.096 on logits of magnitude 4, one
# to two bf16 ulps on the conv window (0.039) and 0.012 on the SSM state;
# the K/V caches were equal.
F32_ATOL = 5e-3
BF16_LOGIT_ATOL = 0.15
BF16_CACHE_ATOL = {"k": 0.0625, "v": 0.0625, "conv": 0.0625, "ssm": 0.03}
STEPS, MAX_LEN, BATCH = 140, 160, 2
# the leaves the reference reads in fp32 (ssm.mamba2_block casts conv_w
# and conv_b to fp32 and keeps a_log, dt_bias, d_skip fp32; serve_step
# casts lm_head to fp32); every other leaf is used at the compute dtype
FP32_LEAVES = {("lm_head",), ("mamba", "conv_w"), ("mamba", "conv_b"),
               ("mamba", "a_log"), ("mamba", "dt_bias"), ("mamba", "d_skip")}


def _cfgs(compute_dtype="bfloat16", **kw):
    """The reduced zamba2 of both packages (one shared-block application:
    2 layers, attn_every 2), with ``kw`` replaced in both."""
    rc = dataclasses.replace(ref_get_config("zamba2-1.2b").reduced(),
                             compute_dtype=compute_dtype, **kw)
    tc = dataclasses.replace(get_config("zamba2-1.2b").reduced(),
                             compute_dtype=compute_dtype, **kw)
    return rc, tc


def _params(rc, tc):
    rp = ref_build(rc).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.array(x, np.float32), rp)
    return rp, tree, params_from_numpy(tree, tc, "cpu")


@pytest.fixture(scope="module")
def models():
    rc, tc = _cfgs()
    rp, tree, tp = _params(rc, tc)
    return rc, rp, tree, tc, tp


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_matches_reference(reduced):
    rc, tc = ref_get_config("zamba2-1.2b"), get_config("zamba2-1.2b")
    if reduced:
        rc, tc = rc.reduced(), tc.reduced()
    for f in dataclasses.fields(tc):
        if f.name in ("attention", "ssm", "moe"):
            assert dataclasses.asdict(getattr(tc, f.name)) == \
                dataclasses.asdict(getattr(rc, f.name)), f.name
        else:
            assert getattr(tc, f.name) == getattr(rc, f.name), f.name
    assert hybrid.n_shared_apps(tc) == RH.n_shared_apps(rc)
    assert hybrid._segments(tc) == RH._segments(rc)
    if not reduced:
        assert (tc.head_dim, hybrid.n_shared_apps(tc)) == (64, 7)


def test_bundle_has_no_prefill_and_no_paged_interface():
    b = build(get_config("zamba2-1.2b").reduced())
    ref = ref_build(ref_get_config("zamba2-1.2b").reduced())
    assert b.prefill is None and ref.prefill is None
    assert not b.supports_paged and not b.supports_chunked_prefill
    assert (ref.supports_paged, ref.supports_chunked_prefill) == (False, False)
    dense = build(get_config("qwen2-7b").reduced())
    assert dense.supports_paged and dense.supports_chunked_prefill


def test_weights_carried_across(models):
    """Every leaf of init_hybrid arrives with its shape, at the dtype the
    reference casts it to before use (fp32 for the head and the Mamba
    weights it reads in fp32, bf16 otherwise), equal to the reference's
    value rounded once."""
    _, _, tree, tc, tp = models

    def walk(ref, got, path=()):
        if isinstance(ref, dict):
            assert set(ref) == set(got), path
            for k in ref:
                walk(ref[k], got[k], path + (k,))
            return
        want_dt = torch.float32 if path in FP32_LEAVES else torch.bfloat16
        assert got.dtype == want_dt, path
        assert tuple(got.shape) == ref.shape, path
        np.testing.assert_array_equal(
            got.float().numpy(),
            torch.from_numpy(ref).to(want_dt).float().numpy(), err_msg=str(path))

    walk(tree, tp)
    assert tp["mamba"]["a_log"].dtype == torch.float32


def test_random_init_has_the_reference_layout():
    rc, tc = _cfgs()
    shapes = jax.eval_shape(lambda: ref_build(rc).init(jax.random.PRNGKey(0)))
    got = build(tc).init(torch.Generator().manual_seed(0), "cpu")

    def walk(ref, g, path=()):
        if isinstance(ref, dict):
            assert set(ref) == set(g), path
            for k in ref:
                walk(ref[k], g[k], path + (k,))
            return
        assert tuple(g.shape) == ref.shape, path
        want = torch.float32 if path in FP32_LEAVES else torch.bfloat16
        assert g.dtype == want, path

    walk(shapes, got)
    m = got["mamba"]
    assert (m["dt_bias"] == -4.0).all() and (m["d_skip"] == 1.0).all()
    assert (m["a_log"] == 0.0).all() and (m["conv_b"] == 0.0).all()


@pytest.mark.parametrize("compute_dtype,atol",
                         [("float32", F32_ATOL), ("bfloat16", BF16_LOGIT_ATOL)],
                         ids=["f32", "bf16"])
def test_forward_without_cache_matches_reference(compute_dtype, atol):
    """The whole-sequence walk (causal shared attention over the fresh
    K/V, chunked SSD) at a prompt of 40 tokens."""
    rc, tc = _cfgs(compute_dtype)
    rp, _, tp = _params(rc, tc)
    tokens = np.random.default_rng(1).integers(0, 512, (2, 40)).astype(np.int32)
    want, _ = RH.forward(rp, rc, jnp.asarray(tokens))
    got, cache = hybrid.forward(tp, tc, torch.from_numpy(tokens))
    assert cache is None
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def test_prefill_cache_is_not_ported(models):
    _, _, _, tc, tp = models
    cache = hybrid.init_cache(tc, 1, 32, device="cpu")
    with pytest.raises(NotImplementedError, match="Mamba state"):
        hybrid.forward(tp, tc, torch.zeros((1, 16), dtype=torch.int32),
                       cache=cache, prefill_cache=True)


# 5 layers at attn_every 2: three applications of the shared block over
# runs of 2, 2 and 1 Mamba layers, each with its own K/V cache slice (at
# fp32, where the two stacks agree to the attention's rounding: at bf16
# their differences grow with depth, measured 0.158 at step 87 of 140)
LAYOUTS = {"1app": {}, "3apps": dict(n_layers=5)}


@pytest.mark.parametrize("compute_dtype,layout", [
    ("float32", "1app"), ("bfloat16", "1app"), ("float32", "3apps")],
    ids=["f32-1app", "bf16-1app", "f32-3apps"])
def test_serve_step_matches_reference_past_the_block(compute_dtype, layout):
    """140 decode steps at max_len 160 (the reference's
    test_zamba2_long_context_serve_reduced shape, past block_kv 128), the
    same teacher-forced tokens into both: logits at every step, then the
    attention K/V of every application and the conv / SSM state of every
    layer."""
    rc, tc = _cfgs(compute_dtype, **LAYOUTS[layout])
    assert hybrid.n_shared_apps(tc) == (3 if layout == "3apps" else 1)
    rp, _, tp = _params(rc, tc)
    rdt, tdt = jnp.dtype(compute_dtype), getattr(torch, compute_dtype)
    rcache = RH.init_cache(rc, BATCH, MAX_LEN, rdt)
    tcache = hybrid.init_cache(tc, BATCH, MAX_LEN, tdt, device="cpu")
    step = jax.jit(lambda p, t, pos, c: RH.serve_step(p, rc, t, pos, c))
    toks = np.random.default_rng(0).integers(0, 512, (BATCH, STEPS)).astype(
        np.int32)
    atol = F32_ATOL if compute_dtype == "float32" else BF16_LOGIT_ATOL
    for t in range(STEPS):
        pos = np.full(BATCH, t, np.int32)
        want, rcache = step(rp, jnp.asarray(toks[:, t]), jnp.asarray(pos),
                            rcache)
        got, tcache = hybrid.serve_step(tp, tc, torch.from_numpy(toks[:, t]),
                                        torch.from_numpy(pos), tcache)
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                                   rtol=0, err_msg=f"step {t}")
    pairs = {"k": (rcache["attn"]["k"], tcache["attn"]["k"]),
             "v": (rcache["attn"]["v"], tcache["attn"]["v"]),
             "conv": (rcache["mamba"]["conv"], tcache["mamba"]["conv"]),
             "ssm": (rcache["mamba"]["ssm"], tcache["mamba"]["ssm"])}
    for name, (want, got) in pairs.items():
        assert tuple(got.shape) == want.shape, name
        tol = F32_ATOL if compute_dtype == "float32" else BF16_CACHE_ATOL[name]
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0,
                                   err_msg=name)
    assert not tcache["attn"]["k"][:, :, STEPS:].any()     # rows past pos


def _ref_stream(rc, rp, prompts, gen):
    """The reference's token-by-token greedy stream (launch/serve.py's
    family-generic route) and the smallest top-2 logit margin of its
    decisions."""
    b, s = prompts.shape
    cache = RH.init_cache(rc, b, s + gen + 8)
    step = jax.jit(lambda p, t, pos, c: RH.serve_step(p, rc, t, pos, c))
    tok, out, margins = jnp.asarray(prompts[:, 0]), [], []
    for i in range(s + gen - 1):
        logits, cache = step(rp, tok, jnp.full((b,), i, jnp.int32), cache)
        if i + 1 < s:
            tok = jnp.asarray(prompts[:, i + 1])
        else:
            top2 = np.sort(np.asarray(logits), -1)[:, -2:]
            margins.append(top2[:, 1] - top2[:, 0])
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            out.append(np.asarray(tok))
    return np.stack(out, 1), float(np.min(margins))


def _port_stream(tc, tp, prompts, gen):
    """The port's token-by-token route (``launch.serve.token_by_token``);
    returns the stream and the logits of every step."""
    from repro_torch.launch.steps import make_serve_step

    bundle = build(tc)
    b, s = prompts.shape
    cache = bundle.init_cache(b, s + gen + 8, device="cpu")
    serve_step, logits_all = make_serve_step(bundle), []

    def step(*args):
        out = serve_step(*args)
        logits_all.append(out[1])
        return out

    out, _, _ = serve.token_by_token(bundle, tp, torch.from_numpy(prompts),
                                     gen, cache, step=step)
    return out, torch.stack(logits_all, 1)


# The two stacks' bf16 logits differ by up to ~0.1 (above), so a greedy
# argmax can flip only where the reference's top two logits lie closer
# than twice that; random weights give near-tied logits, so the prompts
# below (one row each) keep every margin of the reference's stream above
# STREAM_MARGIN, which the test checks first (as
# tests/test_torch_dense_route.py).
STREAM_MARGIN = 0.2


@pytest.mark.parametrize("s,seed", [(12, 11), (30, 58)])
def test_greedy_streams_equal_reference(models, s, seed):
    rc, rp, _, tc, tp = models
    prompts = np.random.default_rng(seed).integers(0, 512, (1, s)).astype(
        np.int32)
    want, margin = _ref_stream(rc, rp, prompts, 6)
    assert margin > STREAM_MARGIN
    got, _ = _port_stream(tc, tp, prompts, 6)
    np.testing.assert_array_equal(got, want)


def test_batched_equals_one_at_a_time(models):
    """Three prompts served together, and each alone: the same logits bit
    for bit at every step (norms, GEMMs, the SSM readout and its
    transcendental steps run on rows padded to MIN_ROWS)."""
    _, _, _, tc, tp = models
    prompts = np.random.default_rng(3).integers(0, 512, (3, 20)).astype(np.int32)
    streams, logits = _port_stream(tc, tp, prompts, 5)
    for i in range(3):
        alone, alone_logits = _port_stream(tc, tp, prompts[i:i + 1], 5)
        np.testing.assert_array_equal(alone[0], streams[i])
        assert torch.equal(alone_logits[0], logits[i])


def test_serve_cli_token_by_token_route_on_the_cpu(capsys):
    ops.reset_launches()
    out = serve.main(["--arch", "zamba2-1.2b", "--reduced", "--batch", "2",
                      "--prompt-len", "12", "--gen", "4", "--device", "cpu"])
    assert out.shape == (2, 4)
    assert ((out >= 0) & (out < 512)).all()
    printed = capsys.readouterr().out
    assert "[dense/token-by-token]" in printed and "over 15 steps" in printed
    # the CPU takes the plain versions: no kernel launch is counted
    assert ops.pasa_decode.launches == ops.pasa_paged_decode.launches == 0
    # the CLI's stream is the port's token-by-token stream of its prompts
    prompts = np.random.default_rng(0).integers(0, 512, (2, 12), dtype=np.int32)
    bundle = build(get_config("zamba2-1.2b").reduced())
    params = bundle.init(torch.Generator(device="cpu").manual_seed(0), "cpu")
    want, _ = _port_stream(bundle.cfg, params, prompts, 4)
    np.testing.assert_array_equal(out, want)


def test_serve_cli_paged_route_refuses_the_hybrid_family():
    with pytest.raises(ValueError, match="no paged serving path"):
        serve.main(["--arch", "zamba2-1.2b", "--reduced", "--paged",
                    "--batch", "2", "--prompt-len", "12", "--gen", "4",
                    "--device", "cpu"])
