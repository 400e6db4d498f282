"""The port's vlm family (Llama-3.2-Vision: causal self-attention layers
on the dense KV cache and, every ``cross_attn_every`` layers, an image
cross-attention layer with tanh-gated residuals) against the
reference's, on the reduced llama-3.2-vision-90b (4 layers in 2 groups of
one cross and one self layer, d 64, 4 / 2 heads of 16, 16 image tokens of
width 32) with the reference's ``init_vlm`` parameters carried across
through numpy.  The reference's init sets both gates to 0, and tanh(0) =
0 keeps every cross layer out of the logits, so the parity tests first
set the gates non-zero in the reference's tree (``GATES``).  Held: the
config, the weight carry (the gates kept at fp32) and the random layout,
``_cross_block`` at impl pasa / flash / naive, ``vlm_serve_step``'s
logits and self K/V over 20 teacher-forced steps at fp32 and bf16, greedy
streams, batched == one-at-a-time, zero gates keeping the image out of
the logits in both packages, and the CLI's token-by-token route beside
the reference's CLI.  All through the plain versions (CPU tensors)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import multimodal as RM
from repro.models.model_zoo import build as ref_build
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import multimodal
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build

torch.set_num_threads(1)

ARCH = "llama-3.2-vision-90b"
# At the compute dtype fp32 the two stacks differ by the fp16 PASA
# attention's rounding only: measured 3.0e-3 on logits of magnitude 4 over
# 20 steps; the K/V caches are bf16 and differ by one bf16 ulp where the
# two fp32 values round apart (0.0156 at magnitudes in [2, 4)).  At bf16
# they round bf16 elementwise steps at different places: measured 0.045
# on logits (held at the bar of tests/test_torch_dense_route.py, 0.1) and
# 0.031 on the caches.
F32_ATOL = 5e-3
F32_CACHE_ATOL = 0.0313
BF16_LOGIT_ATOL = 0.1
BF16_CACHE_ATOL = 0.0625
STEPS, MAX_LEN, BATCH = 20, 24, 2
# non-zero gates of the two cross layers (0.3 and 0.7 are not bf16 values)
GATES = {"gate_attn": [0.5, -0.3], "gate_mlp": [0.7, 0.4]}
FP32_LEAVES = {("lm_head",), ("cross", "gate_attn"), ("cross", "gate_mlp")}


def _cfgs(compute_dtype="bfloat16", **kw):
    rc = dataclasses.replace(ref_get_config(ARCH).reduced(),
                             compute_dtype=compute_dtype, **kw)
    tc = dataclasses.replace(get_config(ARCH).reduced(),
                             compute_dtype=compute_dtype, **kw)
    return rc, tc


def _params(rc, tc, gates=True):
    """The reference's init_vlm (its gates replaced by GATES unless
    ``gates`` is False) and the port's parameters carried across."""
    rp = ref_build(rc).init(jax.random.PRNGKey(0))
    if gates:
        for name, vals in GATES.items():
            rp["cross"][name] = jnp.asarray(vals, jnp.float32)
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


def _vis(b, cfg, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.n_image_tokens, cfg.vision_dim)).astype(np.float32)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_matches_reference(reduced):
    rc, tc = ref_get_config(ARCH), get_config(ARCH)
    if reduced:
        rc, tc = rc.reduced(), tc.reduced()
    for f in dataclasses.fields(tc):
        if f.name in ("attention", "ssm", "moe"):
            assert dataclasses.asdict(getattr(tc, f.name)) == \
                dataclasses.asdict(getattr(rc, f.name)), f.name
        else:
            assert getattr(tc, f.name) == getattr(rc, f.name), f.name
    if reduced:
        assert (tc.n_layers, tc.cross_attn_every, tc.n_image_tokens,
                tc.vision_dim) == (4, 2, 16, 32)
    else:
        assert (tc.n_layers, tc.d_model, tc.n_heads, tc.n_kv_heads, tc.group,
                tc.cross_attn_every, tc.n_image_tokens, tc.vision_dim) == \
            (100, 8192, 64, 8, 8, 5, 1601, 1280)


def test_vlm_family_needs_cross_layers():
    tc = get_config(ARCH)
    with pytest.raises(ValueError, match="cross_attn_every"):
        dataclasses.replace(tc, cross_attn_every=0).validate()


def test_bundle_has_no_prefill_and_no_paged_interface():
    b = build(get_config(ARCH).reduced())
    ref = ref_build(ref_get_config(ARCH).reduced())
    assert b.prefill is None and ref.prefill is None
    assert not b.supports_paged and not b.supports_chunked_prefill
    assert (ref.supports_paged, ref.supports_chunked_prefill) == (False, False)
    assert set(ref.extra_serve_inputs) == {"vision_embeds"}


def test_weights_carried_across(models):
    """Every leaf of init_vlm (self blocks stacked (G, per, ...), cross
    blocks (G, ...)) arrives with its shape, at the dtype the reference
    casts it to before use, equal to the reference's value rounded once;
    the gates are fp32 and keep their values (0.3 rounded to bf16 would
    be 0.30078)."""
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
    assert tp["self"]["attn"]["wq"].shape == (2, 1, 64, 64)
    for name, vals in GATES.items():
        np.testing.assert_array_equal(tp["cross"][name].numpy(),
                                      np.asarray(vals, np.float32))


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
    for name in GATES:
        assert got["cross"][name].dtype == torch.float32
        assert not got["cross"][name].any()          # zeros, as the reference
    assert (got["self"]["ln1"] == 1.0).all() and (got["cross"]["ln2"] == 1.0).all()
    std = float(got["vision_proj"].float().std())
    assert 0.8 / np.sqrt(32) < std < 1.2 / np.sqrt(32)   # N(0, 1/vision_dim)


@pytest.mark.parametrize("impl", ["pasa", "flash", "naive"])
@pytest.mark.parametrize("n_image", [16, 200])
def test_cross_block_matches_reference(impl, n_image):
    """One query row per sequence through the first cross layer (gates
    0.5 / 0.7) over ``n_image`` projected image tokens, at fp32: the
    query padded to 64 rows, the keys to whole blocks of 128 with
    kv_valid n_image (200: a full block and a ragged one)."""
    rc, tc = _cfgs("float32", n_image_tokens=n_image)
    rc = dataclasses.replace(rc, attention=dataclasses.replace(
        rc.attention, impl=impl))
    tc = dataclasses.replace(tc, attention=dataclasses.replace(
        tc.attention, impl=impl))
    rp, _, tp = _params(rc, tc)
    lp = jax.tree.map(lambda a: a[0], rp["cross"])
    tlp = multimodal._layer(tp["cross"], 0)
    x = np.random.default_rng(3).standard_normal((2, 1, tc.d_model)).astype(
        np.float32)
    vis = np.random.default_rng(4).standard_normal(
        (2, n_image, tc.d_model)).astype(np.float32)
    want = RM._cross_block(jnp.asarray(x), lp, rc, jnp.asarray(vis))
    got = multimodal._cross_block(torch.from_numpy(x), tlp, tc,
                                  torch.from_numpy(vis))
    assert tuple(got.shape) == (2, 1, tc.d_model)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL, rtol=0)
    # the gated residuals reach the output
    assert float(np.abs(_np(got) - x).max()) > 0.1


def test_vision_projection_is_per_sequence(models):
    """``project_vision`` equals the reference's batched product; each
    sequence's rows are the same bits alone as in the batch."""
    rc, rp, _, tc, tp = models
    vis = _vis(3, tc)
    got = multimodal.project_vision(tp, tc, torch.from_numpy(vis))
    want = jnp.asarray(vis).astype(jnp.bfloat16) @ rp["vision_proj"].astype(
        jnp.bfloat16)
    np.testing.assert_allclose(_np(got), _np(want), atol=BF16_CACHE_ATOL,
                               rtol=0)
    for i in range(3):
        alone = multimodal.project_vision(tp, tc, torch.from_numpy(vis[i:i + 1]))
        assert torch.equal(alone[0], got[i])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"],
                         ids=["f32", "bf16"])
def test_serve_step_matches_reference(compute_dtype):
    """20 decode steps from the same image input, the same teacher-forced
    tokens into both: logits at every step, then the self layers' K/V
    (G, per, B, max_len, kv_dim); rows past the last step stay zero."""
    rc, tc = _cfgs(compute_dtype)
    rp, _, tp = _params(rc, tc)
    vis = _vis(BATCH, tc)
    rcache = RM.vlm_init_cache(rc, BATCH, MAX_LEN)
    tcache = multimodal.vlm_init_cache(tc, BATCH, MAX_LEN, device="cpu")
    assert tuple(tcache["k"].shape) == rcache["k"].shape == (2, 1, 2, 24, 32)
    step = jax.jit(lambda p, t, pos, c, v: RM.vlm_serve_step(p, rc, t, pos, c,
                                                             v))
    toks = np.random.default_rng(0).integers(0, 512, (BATCH, STEPS)).astype(
        np.int32)
    f32 = compute_dtype == "float32"
    for t in range(STEPS):
        pos = np.full(BATCH, t, np.int32)
        want, rcache = step(rp, jnp.asarray(toks[:, t]), jnp.asarray(pos),
                            rcache, jnp.asarray(vis))
        got, tcache = multimodal.vlm_serve_step(
            tp, tc, torch.from_numpy(toks[:, t]), torch.from_numpy(pos), tcache,
            torch.from_numpy(vis))
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=F32_ATOL if f32 else BF16_LOGIT_ATOL,
                                   rtol=0, err_msg=f"step {t}")
    for name in ("k", "v"):
        np.testing.assert_allclose(
            _np(tcache[name]), _np(rcache[name]), rtol=0, err_msg=name,
            atol=F32_CACHE_ATOL if f32 else BF16_CACHE_ATOL)
    assert not tcache["k"][:, :, :, STEPS:].any()


def _logits_after(tc, tp, toks, vis, bundle_step=None):
    """The port's logits after feeding ``toks`` (B, S) token by token from
    image input ``vis``."""
    bundle = build(tc)
    b, s = toks.shape
    cache = bundle.init_cache(b, s + 1, device="cpu")
    for t in range(s):
        logits, cache = bundle.serve_step(
            tp, torch.from_numpy(toks[:, t]),
            torch.full((b,), t, dtype=torch.int32), cache,
            vision_embeds=torch.from_numpy(vis))
    return logits


def _ref_logits_after(rc, rp, toks, vis):
    b, s = toks.shape
    cache = RM.vlm_init_cache(rc, b, s + 1)
    for t in range(s):
        logits, cache = RM.vlm_serve_step(
            rp, rc, jnp.asarray(toks[:, t]), jnp.full((b,), t, jnp.int32),
            cache, jnp.asarray(vis))
    return np.asarray(logits)


def test_zero_gates_keep_the_image_out_of_the_logits():
    """At the reference's init (gates 0) another image leaves the logits
    unchanged bit for bit in both packages; with the gates of GATES it
    moves them."""
    rc, tc = _cfgs()
    toks = np.random.default_rng(7).integers(0, 512, (BATCH, 6)).astype(
        np.int32)
    vis_a, vis_b = _vis(BATCH, tc, seed=1), _vis(BATCH, tc, seed=2)
    for gates in (False, True):
        rp, _, tp = _params(rc, tc, gates=gates)
        port = [_logits_after(tc, tp, toks, v) for v in (vis_a, vis_b)]
        ref = [_ref_logits_after(rc, rp, toks, v) for v in (vis_a, vis_b)]
        if gates:
            assert float((port[0] - port[1]).abs().max()) > 0.1
            assert float(np.abs(ref[0] - ref[1]).max()) > 0.1
        else:
            assert torch.equal(port[0], port[1])
            np.testing.assert_array_equal(ref[0], ref[1])


def _ref_stream(rc, rp, prompts, gen, vis):
    """The reference's token-by-token greedy stream (launch/serve.py's
    family-generic route) from image input ``vis`` and the smallest top-2
    logit margin of its decisions."""
    b, s = prompts.shape
    cache = RM.vlm_init_cache(rc, b, s + gen + 8)
    step = jax.jit(lambda p, t, pos, c, v: RM.vlm_serve_step(p, rc, t, pos, c,
                                                             v))
    tok, out, margins = jnp.asarray(prompts[:, 0]), [], []
    for i in range(s + gen - 1):
        logits, cache = step(rp, tok, jnp.full((b,), i, jnp.int32), cache,
                             jnp.asarray(vis))
        if i + 1 < s:
            tok = jnp.asarray(prompts[:, i + 1])
        else:
            top2 = np.sort(np.asarray(logits), -1)[:, -2:]
            margins.append(top2[:, 1] - top2[:, 0])
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            out.append(np.asarray(tok))
    return np.stack(out, 1), float(np.min(margins))


def _port_stream(tc, tp, prompts, gen, vis):
    """The port's token-by-token route (``launch.serve.token_by_token``)
    from image input ``vis``; returns the stream and the logits of every
    step."""
    from repro_torch.launch.steps import make_serve_step

    bundle = build(tc)
    b, s = prompts.shape
    cache = bundle.init_cache(b, s + gen + 8, device="cpu")
    serve_step, logits_all = make_serve_step(bundle), []

    def step(*args, **extras):
        out = serve_step(*args, **extras)
        logits_all.append(out[1])
        return out

    out, _, _ = serve.token_by_token(
        bundle, tp, torch.from_numpy(prompts), gen, cache, step=step,
        vision_embeds=torch.from_numpy(vis))
    return out, torch.stack(logits_all, 1)


# The two stacks' bf16 logits differ by up to 0.045 (above), so a greedy
# argmax can flip only where the reference's top two logits lie closer
# than twice that; random weights give near-tied logits, so the prompts
# below (one row each, with its image) keep every margin of the
# reference's stream above STREAM_MARGIN, which the test checks first (as
# tests/test_torch_dense_route.py).
STREAM_MARGIN = 0.1


@pytest.mark.parametrize("s,seed", [(12, 1), (20, 9)])
def test_greedy_streams_equal_reference(models, s, seed):
    rc, rp, _, tc, tp = models
    prompts = np.random.default_rng(seed).integers(0, 512, (1, s)).astype(
        np.int32)
    vis = _vis(1, tc, seed=seed + 10)
    want, margin = _ref_stream(rc, rp, prompts, 6, vis)
    assert margin > STREAM_MARGIN
    got, _ = _port_stream(tc, tp, prompts, 6, vis)
    np.testing.assert_array_equal(got, want)


def test_batched_equals_one_at_a_time(models):
    """Three prompts served together, each with its own image, and each
    alone from its row: the same logits bit for bit at every step (the
    image and the cross K/V are projected one sequence at a time; norms
    and GEMMs over few rows run on rows padded to MIN_ROWS)."""
    _, _, _, tc, tp = models
    prompts = np.random.default_rng(3).integers(0, 512, (3, 10)).astype(np.int32)
    vis = _vis(3, tc, seed=5)
    streams, logits = _port_stream(tc, tp, prompts, 5, vis)
    for i in range(3):
        alone, alone_logits = _port_stream(tc, tp, prompts[i:i + 1], 5,
                                           vis[i:i + 1])
        np.testing.assert_array_equal(alone[0], streams[i])
        assert torch.equal(alone_logits[0], logits[i])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"],
                         ids=["f32", "bf16"])
def test_prefill_cache_matches_reference(compute_dtype):
    """``vlm_forward(..., prefill_cache=True)``: the whole 10-token prompt
    in one pass into a fresh cache, beside the reference's same call -
    the final hidden states of every position and the self layers' K/V
    rows [0, 10) within the serve step's bars; rows past the prompt stay
    zero (measured at bf16: 0.039 on the hidden states, 0.027 on the
    caches; at fp32 1e-6)."""
    rc, tc = _cfgs(compute_dtype)
    rp, _, tp = _params(rc, tc)
    toks = np.random.default_rng(0).integers(0, 512, (BATCH, 10)).astype(
        np.int32)
    vis = _vis(BATCH, tc)
    want, rcache = RM.vlm_forward(
        rp, rc, jnp.asarray(toks), jnp.asarray(vis),
        cache=RM.vlm_init_cache(rc, BATCH, MAX_LEN), prefill_cache=True)
    got, tcache = multimodal.vlm_forward(
        tp, tc, torch.from_numpy(toks), torch.from_numpy(vis),
        cache=multimodal.vlm_init_cache(tc, BATCH, MAX_LEN, device="cpu"),
        prefill_cache=True)
    f32 = compute_dtype == "float32"
    assert tuple(got.shape) == (BATCH, 10, tc.d_model)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=F32_ATOL if f32 else BF16_LOGIT_ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            _np(tcache[name]), _np(rcache[name]), rtol=0, err_msg=name,
            atol=F32_CACHE_ATOL if f32 else BF16_CACHE_ATOL)
    assert tcache["k"][:, :, :, :10].any()
    assert not tcache["k"][:, :, :, 10:].any()


def _fused_stream(tc, tp, prompts, gen, vis):
    """The prompt in one ``prefill_cache`` pass, then ``gen - 1`` decode
    steps from its cache: the greedy stream."""
    from repro_torch.models import layers as L

    b, s = prompts.shape
    vis_t = torch.from_numpy(vis)
    cache = multimodal.vlm_init_cache(tc, b, s + gen + 8, device="cpu")
    h, cache = multimodal.vlm_forward(tp, tc, torch.from_numpy(prompts),
                                      vis_t, cache=cache, prefill_cache=True)
    logits = L.matmuls(h[:, -1].float(), tp["lm_head"].float())[0]
    out = []
    for i in range(gen):
        tok = logits.argmax(-1).to(torch.int32)
        out.append(tok)
        if i + 1 < gen:
            logits, cache = multimodal.vlm_serve_step(
                tp, tc, tok, torch.full((b,), s + i, dtype=torch.int32),
                cache, vis_t)
    return torch.stack(out, 1).numpy()


@pytest.mark.parametrize("s,seed", [(12, 1), (20, 9)])
def test_fused_prompt_pass_then_decode_equals_token_by_token(models, s, seed):
    """A fused prompt pass (``prefill_cache``, the dense prefill's
    attention) and then decode give the token-by-token stream (the decode
    convention at every prompt position) on prompts whose decisions keep
    a top-2 margin above STREAM_MARGIN: the two conventions differ by
    rounding only."""
    _, _, _, tc, tp = models
    prompts = np.random.default_rng(seed).integers(0, 512, (1, s)).astype(
        np.int32)
    vis = _vis(1, tc, seed=seed + 10)
    want, logits = _port_stream(tc, tp, prompts, 6, vis)
    top2 = torch.topk(logits[:, s - 1:].float(), 2, -1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > STREAM_MARGIN
    np.testing.assert_array_equal(_fused_stream(tc, tp, prompts, 6, vis),
                                  want)


def test_serve_cli_token_by_token_route_beside_the_reference_cli(capsys):
    """``--arch llama-3.2-vision-90b --reduced`` on both CLIs: the
    family-generic token-by-token route from zero ``vision_embeds`` (the
    reference's CLI), ``prompt_len + gen - 1`` steps, greedy tokens of the
    same shape (the weights differ: jax's and torch's generators); the
    port's stream is its token-by-token stream of its prompts."""
    from repro.launch import serve as ref_serve

    argv = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "12",
            "--gen", "4"]
    ops.reset_launches()
    out = serve.main(argv + ["--device", "cpu"])
    printed = capsys.readouterr().out
    ref_out = np.asarray(ref_serve.main(argv + ["--mesh", "1x1"]))
    ref_printed = capsys.readouterr().out
    assert out.shape == ref_out.shape == (2, 4)
    assert ((out >= 0) & (out < 512)).all()
    assert "[dense/token-by-token]" in printed and "over 15 steps" in printed
    assert "generated (2, 4) tokens" in ref_printed
    # the CPU takes the plain versions: no kernel launch is counted
    for wrapper in ops.WRAPPERS:
        assert wrapper.launches == 0
    cfg = get_config(ARCH).reduced()
    prompts = np.random.default_rng(0).integers(0, 512, (2, 12), dtype=np.int32)
    bundle = build(cfg)
    params = bundle.init(torch.Generator(device="cpu").manual_seed(0), "cpu")
    zeros = np.zeros((2, cfg.n_image_tokens, cfg.vision_dim), np.float32)
    want, _ = _port_stream(cfg, params, prompts, 4, zeros)
    np.testing.assert_array_equal(out, want)


def test_serve_cli_paged_route_refuses_the_vlm_family():
    with pytest.raises(ValueError, match="no paged serving path"):
        serve.main(["--arch", ARCH, "--reduced", "--paged", "--batch", "2",
                    "--prompt-len", "12", "--gen", "4", "--device", "cpu"])
