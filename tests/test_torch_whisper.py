"""The port's audio family (Whisper: a bidirectional encoder, a decoder
with cached self-attention and cross-attention over the encoder output)
against the reference's, on the reduced whisper-large-v3 (2 + 2 layers,
d 64, 4 / 2 heads of 16, 16 frames) with the reference's
``init_whisper`` parameters carried across through numpy: the config, the
weight carry and the random layout, the encoder at 16 and 200 frames
(200: two blocks of 128, the second ragged), one cross-attention layer
over 200 frames, ``whisper_serve_step``'s logits and cache over 24 steps
from the same ``enc_out``, greedy streams, batched == one-at-a-time, and
the CLI's token-by-token route beside the reference's CLI.  All through
the plain versions (CPU tensors)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as RA
from repro.models import multimodal as RM
from repro.models.model_zoo import build as ref_build
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import attention as attn_mod
from repro_torch.models import multimodal
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build

torch.set_num_threads(1)

# At the compute dtype fp32 the two stacks differ by the fp16 PASA
# attention's rounding only: measured 9.4e-4 on the 200-frame encoder
# output (magnitude 4).  At bf16 they round bf16 elementwise steps at
# different places: measured 0.047 on the encoder output (one to two bf16
# ulps at 4), 0.035 on logits of magnitude 3 over 24 steps (held at the
# bar of tests/test_torch_dense_route.py, 0.1) and 0.020 on the K/V
# caches; at fp32, 8.7e-4 on logits and 2.0e-3 on the caches.
F32_ATOL = 5e-3
BF16_ENC_ATOL = 0.1
BF16_LOGIT_ATOL = 0.1
BF16_CACHE_ATOL = 0.0625
STEPS, MAX_LEN, BATCH = 24, 32, 2
FP32_LEAVES = {("lm_head",)}


def _cfgs(compute_dtype="bfloat16", **kw):
    rc = dataclasses.replace(ref_get_config("whisper-large-v3").reduced(),
                             compute_dtype=compute_dtype, **kw)
    tc = dataclasses.replace(get_config("whisper-large-v3").reduced(),
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


def _frames(b, n, d, seed=1):
    return np.random.default_rng(seed).standard_normal((b, n, d)).astype(
        np.float32)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_matches_reference(reduced):
    rc = ref_get_config("whisper-large-v3")
    tc = get_config("whisper-large-v3")
    if reduced:
        rc, tc = rc.reduced(), tc.reduced()
    for f in dataclasses.fields(tc):
        if f.name in ("attention", "ssm", "moe"):
            assert dataclasses.asdict(getattr(tc, f.name)) == \
                dataclasses.asdict(getattr(rc, f.name)), f.name
        else:
            assert getattr(tc, f.name) == getattr(rc, f.name), f.name
    if reduced:
        assert (tc.n_encoder_layers, tc.n_audio_frames, tc.head_dim) == \
            (2, 16, 16)
    else:
        assert (tc.head_dim, tc.n_audio_frames, tc.family) == \
            (64, 1500, "audio")


def test_bundle_has_no_prefill_and_no_paged_interface():
    b = build(get_config("whisper-large-v3").reduced())
    ref = ref_build(ref_get_config("whisper-large-v3").reduced())
    assert b.prefill is None and ref.prefill is None
    assert not b.supports_paged and not b.supports_chunked_prefill
    assert (ref.supports_paged, ref.supports_chunked_prefill) == (False, False)


def test_weights_carried_across(models):
    """Every leaf of init_whisper arrives with its shape, at the dtype the
    reference casts it to before use (fp32 for the head, bf16 otherwise),
    equal to the reference's value rounded once."""
    _, _, tree, _, tp = models

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
    assert (got["dec"]["ln_x"] == 1.0).all() and (got["enc_norm"] == 1.0).all()
    assert 0.005 < float(got["pos_embed"].float().std()) < 0.02


@pytest.mark.parametrize("compute_dtype,frames", [
    ("float32", 16), ("float32", 200), ("bfloat16", 16), ("bfloat16", 200)],
    ids=["f32-16", "f32-200", "bf16-16", "bf16-200"])
def test_encode_matches_reference(compute_dtype, frames):
    """The bidirectional encoder: 16 frames (one block of 128, 112 pad
    columns) and 200 (a full block and a ragged one), each padded with
    zero rows and masked past the frames by the op's kv_valid, as the
    reference's blocked_attention pads and masks."""
    rc, tc = _cfgs(compute_dtype, n_audio_frames=frames)
    rp, _, tp = _params(rc, tc)
    fr = _frames(2, frames, tc.d_model)
    want = RM.whisper_encode(rp, rc, jnp.asarray(fr))
    got = multimodal.whisper_encode(tp, tc, torch.from_numpy(fr))
    assert got.dtype == getattr(torch, compute_dtype)
    assert tuple(got.shape) == (2, frames, tc.d_model)
    atol = F32_ATOL if compute_dtype == "float32" else BF16_ENC_ATOL
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"],
                         ids=["f32", "bf16"])
def test_encode_with_the_algebraic_shift_matches_reference(compute_dtype):
    """The bidirectional encoder with ``use_gemm_shift=False`` (ROADMAP
    A12b) on 200 frames (a full block and a ragged one, padded with zero
    rows that count in the block means of both packages) against the
    reference's at the same flag, at the bars of
    test_encode_matches_reference."""
    rc, tc = _cfgs(compute_dtype, n_audio_frames=200)
    alg = lambda c: dataclasses.replace(c, attention=dataclasses.replace(
        c.attention, use_gemm_shift=False))
    rc, tc = alg(rc), alg(tc)
    rp, _, tp = _params(rc, tc)
    fr = _frames(2, 200, tc.d_model)
    want = RM.whisper_encode(rp, rc, jnp.asarray(fr))
    got = multimodal.whisper_encode(tp, tc, torch.from_numpy(fr))
    atol = F32_ATOL if compute_dtype == "float32" else BF16_ENC_ATOL
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


@pytest.mark.parametrize("impl", ["pasa", "flash", "naive"])
def test_cross_attention_layer_matches_reference(impl):
    """One decoder query row per sequence attending over 200 encoder
    frames (``cross_x``, no RoPE, not causal), at fp32: the query padded
    to 64 rows, the keys to 256 with kv_valid 200."""
    rc, tc = _cfgs("float32", n_audio_frames=200)
    rc = dataclasses.replace(rc, attention=dataclasses.replace(
        rc.attention, impl=impl))
    tc = dataclasses.replace(tc, attention=dataclasses.replace(
        tc.attention, impl=impl))
    rp, _, tp = _params(rc, tc)
    lp = jax.tree.map(lambda a: a[0], rp["dec"]["cross_attn"])
    tlp = {k: v[0] for k, v in tp["dec"]["cross_attn"].items()}
    x = _frames(2, 1, tc.d_model, seed=2)
    enc = _frames(2, 200, tc.d_model, seed=3)
    want, _ = RA.attention(jnp.asarray(x), lp, rc, causal=False,
                           cross_x=jnp.asarray(enc), use_rope=False)
    got = attn_mod.attention(torch.from_numpy(x), tlp, tc, causal=False,
                             cross_x=torch.from_numpy(enc), use_rope=False)
    assert tuple(got.shape) == (2, 1, tc.d_model)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL, rtol=0)


def _ref_cache(rc, enc_out, b, max_len):
    cache = RM.whisper_init_cache(rc, b, max_len)
    cache["enc_out"] = jnp.asarray(enc_out).astype(cache["enc_out"].dtype)
    return cache


def _port_cache(tc, enc_out, b, max_len):
    cache = multimodal.whisper_init_cache(tc, b, max_len, device="cpu")
    cache["enc_out"].copy_(torch.from_numpy(np.array(enc_out)))
    return cache


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"],
                         ids=["f32", "bf16"])
def test_serve_step_matches_reference(compute_dtype):
    """24 decode steps from the same enc_out (the reference's encoder
    output on the same frames, in a bf16 cache), the same teacher-forced
    tokens into both: logits at every step, then the self-attention K/V
    of every layer; enc_out is left as it was."""
    rc, tc = _cfgs(compute_dtype)
    rp, _, tp = _params(rc, tc)
    enc = np.asarray(RM.whisper_encode(
        rp, rc, jnp.asarray(_frames(BATCH, 16, tc.d_model))), np.float32)
    rcache = _ref_cache(rc, enc, BATCH, MAX_LEN)
    tcache = _port_cache(tc, enc, BATCH, MAX_LEN)
    enc_before = tcache["enc_out"].clone()
    step = jax.jit(lambda p, t, pos, c: RM.whisper_serve_step(p, rc, t, pos, c))
    toks = np.random.default_rng(0).integers(0, 512, (BATCH, STEPS)).astype(
        np.int32)
    atol = F32_ATOL if compute_dtype == "float32" else BF16_LOGIT_ATOL
    for t in range(STEPS):
        pos = np.full(BATCH, t, np.int32)
        want, rcache = step(rp, jnp.asarray(toks[:, t]), jnp.asarray(pos),
                            rcache)
        got, tcache = multimodal.whisper_serve_step(
            tp, tc, torch.from_numpy(toks[:, t]), torch.from_numpy(pos), tcache)
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                                   rtol=0, err_msg=f"step {t}")
    for name in ("k", "v"):
        tol = F32_ATOL if compute_dtype == "float32" else BF16_CACHE_ATOL
        np.testing.assert_allclose(_np(tcache[name]), _np(rcache[name]),
                                   atol=tol, rtol=0, err_msg=name)
    assert not tcache["k"][:, :, STEPS:].any()
    assert torch.equal(tcache["enc_out"], enc_before)


def _ref_stream(rc, rp, prompts, gen, enc):
    """The reference's token-by-token greedy stream (launch/serve.py's
    family-generic route) from ``enc`` and the smallest top-2 logit margin
    of its decisions."""
    b, s = prompts.shape
    cache = _ref_cache(rc, enc, b, s + gen + 8)
    step = jax.jit(lambda p, t, pos, c: RM.whisper_serve_step(p, rc, t, pos, c))
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


def _port_stream(tc, tp, prompts, gen, enc=None):
    """The port's token-by-token route (``launch.serve.token_by_token``)
    from ``enc`` (None: the zero enc_out of the CLI); returns the stream
    and the logits of every step."""
    from repro_torch.launch.steps import make_serve_step

    bundle = build(tc)
    b, s = prompts.shape
    cache = bundle.init_cache(b, s + gen + 8, device="cpu")
    if enc is not None:
        cache["enc_out"].copy_(torch.from_numpy(np.array(enc)))
    serve_step, logits_all = make_serve_step(bundle), []

    def step(*args):
        out = serve_step(*args)
        logits_all.append(out[1])
        return out

    out, _, _ = serve.token_by_token(bundle, tp, torch.from_numpy(prompts),
                                     gen, cache, step=step)
    return out, torch.stack(logits_all, 1)


# The two stacks' bf16 logits differ by up to 0.035 (above), so a greedy
# argmax can flip only where the reference's top two logits lie closer
# than twice that; random weights give near-tied logits, so the prompts
# below (one row each, with their frames) keep every margin of the
# reference's stream above STREAM_MARGIN, which the test checks first (as
# tests/test_torch_dense_route.py).
STREAM_MARGIN = 0.1


@pytest.mark.parametrize("s,seed", [(12, 22), (20, 7)])
def test_greedy_streams_equal_reference(models, s, seed):
    rc, rp, _, tc, tp = models
    prompts = np.random.default_rng(seed).integers(0, 512, (1, s)).astype(
        np.int32)
    enc = np.asarray(RM.whisper_encode(
        rp, rc, jnp.asarray(_frames(1, 16, tc.d_model, seed=seed))),
        np.float32)
    want, margin = _ref_stream(rc, rp, prompts, 6, enc)
    assert margin > STREAM_MARGIN
    got, _ = _port_stream(tc, tp, prompts, 6, enc)
    np.testing.assert_array_equal(got, want)


def test_batched_equals_one_at_a_time(models):
    """Three prompts served together from their encoder outputs, and each
    alone from its own row: the same logits bit for bit at every step
    (the cross K/V are projected one sequence at a time; norms and GEMMs
    over few rows run on rows padded to MIN_ROWS)."""
    _, _, _, tc, tp = models
    prompts = np.random.default_rng(3).integers(0, 512, (3, 10)).astype(np.int32)
    enc = multimodal.whisper_encode(
        tp, tc, torch.from_numpy(_frames(3, 16, tc.d_model))).float().numpy()
    streams, logits = _port_stream(tc, tp, prompts, 5, enc)
    for i in range(3):
        alone, alone_logits = _port_stream(tc, tp, prompts[i:i + 1], 5,
                                           enc[i:i + 1])
        np.testing.assert_array_equal(alone[0], streams[i])
        assert torch.equal(alone_logits[0], logits[i])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"],
                         ids=["f32", "bf16"])
def test_prefill_cache_matches_reference(compute_dtype):
    """``whisper_decode_fwd(..., prefill_cache=True)``: the whole 10-token
    prompt in one pass into a fresh cache from the reference's encoder
    output, beside the reference's same call - the final hidden states
    of every position and every layer's K/V rows [0, 10) within the serve
    step's bars; rows past the prompt stay zero (measured at bf16: 0.031
    on the hidden states and the caches; at fp32 1e-6)."""
    rc, tc = _cfgs(compute_dtype)
    rp, _, tp = _params(rc, tc)
    enc = np.asarray(RM.whisper_encode(
        rp, rc, jnp.asarray(_frames(BATCH, 16, tc.d_model))), np.float32)
    toks = np.random.default_rng(0).integers(0, 512, (BATCH, 10)).astype(
        np.int32)
    rcache = RM.whisper_init_cache(rc, BATCH, MAX_LEN)
    want, rnew = RM.whisper_decode_fwd(
        rp, rc, jnp.asarray(toks), jnp.asarray(enc).astype(
            rc.jnp_compute_dtype()),
        cache={"k": rcache["k"], "v": rcache["v"]}, prefill_cache=True)
    tcache = _port_cache(tc, enc, BATCH, MAX_LEN)
    got, tcache = multimodal.whisper_decode_fwd(
        tp, tc, torch.from_numpy(toks),
        torch.from_numpy(np.array(enc)).to(tc.torch_compute_dtype()),
        cache=tcache,
        prefill_cache=True)
    f32 = compute_dtype == "float32"
    assert tuple(got.shape) == (BATCH, 10, tc.d_model)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=F32_ATOL if f32 else BF16_LOGIT_ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            _np(tcache[name]), _np(rnew[name]), rtol=0, err_msg=name,
            atol=F32_ATOL if f32 else BF16_CACHE_ATOL)
    assert tcache["k"][:, :, :10].any()
    assert not tcache["k"][:, :, 10:].any()


def _fused_stream(tc, tp, prompts, gen, enc):
    """The prompt in one ``prefill_cache`` pass from ``enc``, then ``gen -
    1`` decode steps from its cache: the greedy stream."""
    from repro_torch.models import layers as L

    b, s = prompts.shape
    cache = _port_cache(tc, enc, b, s + gen + 8)
    enc_out = cache["enc_out"].to(tc.torch_compute_dtype())
    h, cache = multimodal.whisper_decode_fwd(
        tp, tc, torch.from_numpy(prompts), enc_out, cache=cache,
        prefill_cache=True)
    logits = L.matmuls(h[:, -1].float(), tp["lm_head"].float())[0]
    out = []
    for i in range(gen):
        tok = logits.argmax(-1).to(torch.int32)
        out.append(tok)
        if i + 1 < gen:
            logits, cache = multimodal.whisper_serve_step(
                tp, tc, tok, torch.full((b,), s + i, dtype=torch.int32),
                cache)
    return torch.stack(out, 1).numpy()


@pytest.mark.parametrize("s,seed", [(12, 22), (20, 7)])
def test_fused_prompt_pass_then_decode_equals_token_by_token(models, s, seed):
    """A fused prompt pass (``prefill_cache``, the dense prefill's
    attention) and then decode give the token-by-token stream on prompts
    whose decisions keep a top-2 margin above STREAM_MARGIN: the two
    conventions differ by rounding only."""
    _, _, _, tc, tp = models
    prompts = np.random.default_rng(seed).integers(0, 512, (1, s)).astype(
        np.int32)
    enc = multimodal.whisper_encode(
        tp, tc, torch.from_numpy(_frames(1, 16, tc.d_model, seed=seed))
    ).float().numpy()
    want, logits = _port_stream(tc, tp, prompts, 6, enc)
    top2 = torch.topk(logits[:, s - 1:].float(), 2, -1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > STREAM_MARGIN
    np.testing.assert_array_equal(_fused_stream(tc, tp, prompts, 6, enc),
                                  want)


def test_serve_cli_token_by_token_route_beside_the_reference_cli(capsys):
    """``--arch whisper-large-v3 --reduced`` on both CLIs: the
    family-generic token-by-token route from the zero enc_out of
    ``whisper_init_cache``, ``prompt_len + gen - 1`` steps, greedy tokens
    of the same shape (the weights differ: jax's and torch's generators);
    the port's stream is its token-by-token stream of its prompts."""
    from repro.launch import serve as ref_serve

    argv = ["--arch", "whisper-large-v3", "--reduced", "--batch", "2",
            "--prompt-len", "12", "--gen", "4"]
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
    for name in ("pasa_decode", "pasa_attention", "shift_kv"):
        assert getattr(ops, name).launches == 0
    prompts = np.random.default_rng(0).integers(0, 512, (2, 12), dtype=np.int32)
    bundle = build(get_config("whisper-large-v3").reduced())
    params = bundle.init(torch.Generator(device="cpu").manual_seed(0), "cpu")
    want, _ = _port_stream(bundle.cfg, params, prompts, 4)
    np.testing.assert_array_equal(out, want)


def test_serve_cli_paged_route_refuses_the_audio_family():
    with pytest.raises(ValueError, match="no paged serving path"):
        serve.main(["--arch", "whisper-large-v3", "--reduced", "--paged",
                    "--batch", "2", "--prompt-len", "12", "--gen", "4",
                    "--device", "cpu"])
