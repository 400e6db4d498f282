"""The port's ssm family (falcon-mamba: a pure Mamba-1 LM, attention-free)
against the reference's, on the reduced falcon-mamba-7b (2 layers, d 64,
d_inner 128, state 8, dt rank 4) with the reference's ``_ssm_init``
parameters carried across through numpy: the config, the weight carry
(``dt_proj`` kept at fp32) and the random layout, ``mamba1_block`` with
no cache and in decode, decode == the whole-sequence forward, the
decode's batch invariance, the cache layout, ``_ssm_serve_step``'s
logits and state over 40 steps, greedy streams, batched ==
one-at-a-time, and the CLI's token-by-token route beside the reference's
CLI.  All through the plain PyTorch path (CPU tensors)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import model_zoo as RZ
from repro.models import ssm as RS
from repro.models.model_zoo import build as ref_build
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import model_zoo, ssm
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build

torch.set_num_threads(1)

ARCH = "falcon-mamba-7b"
# At the compute dtype fp32 with fp32 caches the two stacks run the same
# arithmetic in another summation order: measured 1.4e-6 on logits over
# 40 steps, 1.2e-6 on the conv window.  At bf16 they round bf16
# elementwise steps differently (jax's bf16 silu differs from torch's in
# the last bit on about a third of inputs) and the state carries it:
# measured 0.027 on logits of magnitude 4.3 over 40 steps, one bf16 ulp
# (0.0156) on the conv window and 0.0018 on the SSM state.
F32_ATOL = 1e-4
BF16_ATOL = 0.0625
BF16_LOGIT_ATOL = 0.1
BF16_CACHE_ATOL = {"conv": 0.0625, "ssm": 0.01}
STEPS, BATCH = 40, 2
# the leaves the reference reads in fp32 (mamba1_block casts conv_w,
# conv_b, dt_proj and dt_bias to fp32 and keeps a_log, d_skip fp32;
# _ssm_serve_step casts lm_head to fp32); every other leaf is used at the
# compute dtype
FP32_LEAVES = {("lm_head",), ("mamba", "conv_w"), ("mamba", "conv_b"),
               ("mamba", "dt_proj"), ("mamba", "dt_bias"), ("mamba", "a_log"),
               ("mamba", "d_skip")}


def _cfgs(compute_dtype="bfloat16"):
    rc = dataclasses.replace(ref_get_config(ARCH).reduced(),
                             compute_dtype=compute_dtype)
    tc = dataclasses.replace(get_config(ARCH).reduced(),
                             compute_dtype=compute_dtype)
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


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


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
    assert tc.family == "ssm" and tc.ssm.version == 1
    assert ssm._dt_rank(tc) == RS._dt_rank(rc)
    assert ssm.d_inner(tc) == RS.d_inner(rc)
    if not reduced:
        assert (tc.n_layers, tc.d_model, ssm.d_inner(tc), ssm._dt_rank(tc),
                tc.ssm.state) == (64, 4096, 8192, 256, 16)


def test_ssm_family_takes_only_mamba1():
    tc = get_config(ARCH)
    with pytest.raises(ValueError, match="Mamba-1"):
        dataclasses.replace(tc, ssm=dataclasses.replace(
            tc.ssm, version=2)).validate()


def test_bundle_has_no_prefill_and_no_paged_interface():
    b = build(get_config(ARCH).reduced())
    ref = ref_build(ref_get_config(ARCH).reduced())
    assert b.prefill is None and ref.prefill is None
    assert not b.supports_paged and not b.supports_chunked_prefill
    assert (ref.supports_paged, ref.supports_chunked_prefill) == (False, False)


def test_weights_carried_across(models):
    """Every leaf of _ssm_init arrives with its shape, at the dtype the
    reference casts it to before use, equal to the reference's value
    rounded once; ``dt_proj`` is not rounded to bf16 (a bf16 round at
    load would move dt and, through exp(dt a), every state)."""
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
    dt_proj = tree["mamba"]["dt_proj"]
    np.testing.assert_array_equal(tp["mamba"]["dt_proj"].numpy(), dt_proj)
    assert not np.array_equal(
        torch.from_numpy(dt_proj).bfloat16().float().numpy(), dt_proj)


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
    want_a = np.log(np.arange(1, tc.ssm.state + 1, dtype=np.float32))
    np.testing.assert_allclose(m["a_log"][0, 0].numpy(), want_a, rtol=1e-6)
    assert (m["dt_bias"] == -4.0).all() and (m["d_skip"] == 1.0).all()
    assert (m["conv_b"] == 0.0).all() and (got["ln"] == 1.0).all()
    assert 0.4 < float(m["conv_w"].std()) < 0.6       # N(0, 1/d_conv)


def _block_params(rc, tc):
    p = RS.init_mamba1(jax.random.PRNGKey(0), rc, jnp.float32)
    tree = jax.tree.map(lambda x: np.array(x, np.float32), p)
    return p, params_from_numpy({"mamba": tree}, tc, "cpu")["mamba"]


@pytest.mark.parametrize("compute_dtype,atol",
                         [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s", [1, 24])
def test_mamba1_block_no_cache_matches_reference(compute_dtype, atol, s):
    rc, tc = _cfgs(compute_dtype)
    p, tp = _block_params(rc, tc)
    x = _x((2, s, rc.d_model), 1)
    want, _ = RS.mamba1_block(jnp.asarray(x), p, rc)
    got, cache = ssm.mamba1_block(torch.from_numpy(x), tp, tc)
    assert cache is None and got.dtype == tc.torch_compute_dtype()
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


@pytest.mark.parametrize("compute_dtype,atol",
                         [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)],
                         ids=["f32", "bf16"])
def test_mamba1_block_decode_matches_reference(compute_dtype, atol):
    """24 decode steps from the same state: outputs and the conv / SSM
    state at every step (the conv window at the compute dtype, as the
    reference's decode concatenates it with the new row)."""
    rc, tc = _cfgs(compute_dtype)
    p, tp = _block_params(rc, tc)
    x = _x((3, 24, rc.d_model), 2)
    one = lambda c: {k: v[0] for k, v in c.items()}
    rcache = one(RS.mamba1_cache(dataclasses.replace(rc, n_layers=1), 3,
                                 jnp.dtype(compute_dtype)))
    tcache = one(ssm.mamba1_cache(dataclasses.replace(tc, n_layers=1), 3,
                                  tc.torch_compute_dtype(), device="cpu"))
    views = (tcache["conv"], tcache["ssm"])
    for t in range(24):
        want, rcache = RS.mamba1_block(jnp.asarray(x[:, t:t + 1]), p, rc,
                                       cache=rcache)
        got, tcache = ssm.mamba1_block(torch.from_numpy(x[:, t:t + 1]), tp,
                                       tc, cache=tcache)
        np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0,
                                   err_msg=f"step {t}")
        for name in ("conv", "ssm"):
            np.testing.assert_allclose(_np(tcache[name]), _np(rcache[name]),
                                       atol=atol, rtol=0, err_msg=name)
    # written in place: the caller's views hold the state
    assert tcache["conv"] is views[0] and tcache["ssm"] is views[1]
    assert tcache["ssm"].dtype == torch.float32


@pytest.mark.parametrize("s", [1, 12, 40])
def test_mamba1_decode_matches_forward(s):
    """The decode step by step equals the whole-sequence scan (the
    reference's test_ssm_decode_matches_forward, at fp32 with an fp32
    conv window)."""
    rc, tc = _cfgs("float32")
    _, tp = _block_params(rc, tc)
    x = torch.from_numpy(_x((2, s, tc.d_model), 3))
    y_full, _ = ssm.mamba1_block(x, tp, tc)
    cache = {k: v[0] for k, v in ssm.mamba1_cache(
        dataclasses.replace(tc, n_layers=1), 2, torch.float32,
        device="cpu").items()}
    ys = [ssm.mamba1_block(x[:, t:t + 1], tp, tc, cache=cache)[0]
          for t in range(s)]
    torch.testing.assert_close(torch.cat(ys, 1), y_full, atol=F32_ATOL, rtol=0)


def test_mamba1_decode_is_batch_invariant():
    """Each row of a decode step equals the row served alone, bit for bit
    (the readout and the transcendental steps run on a batch padded to
    MIN_ROWS)."""
    rc, tc = _cfgs("bfloat16")
    _, tp = _block_params(rc, tc)
    x = torch.from_numpy(_x((3, 6, tc.d_model), 4))
    one_layer = dataclasses.replace(tc, n_layers=1)

    def run(rows):
        cache = {k: v[0] for k, v in ssm.mamba1_cache(
            one_layer, rows.shape[0], device="cpu").items()}
        return torch.cat([ssm.mamba1_block(rows[:, t:t + 1], tp, tc,
                                           cache=cache)[0]
                          for t in range(rows.shape[1])], 1), cache

    batched, bc = run(x)
    for i in range(3):
        alone, ac = run(x[i:i + 1])
        assert torch.equal(alone[0], batched[i])
        assert torch.equal(ac["ssm"][0], bc["ssm"][i])
        assert torch.equal(ac["conv"][0], bc["conv"][i])


def test_mamba1_cache_layout():
    tc, rc = get_config(ARCH), ref_get_config(ARCH)
    c = ssm.mamba1_cache(tc, 4, device="meta")
    want = jax.eval_shape(lambda: RS.mamba1_cache(rc, 4))
    for name in ("conv", "ssm"):
        assert tuple(c[name].shape) == want[name].shape, name
    assert c["conv"].shape == (64, 4, 3, 8192) and c["conv"].dtype == torch.bfloat16
    assert c["ssm"].shape == (64, 4, 8192, 16) and c["ssm"].dtype == torch.float32
    bundle = build(tc)
    assert bundle.init_cache(4, 4096, device="meta")["ssm"].shape == \
        (64, 4, 8192, 16)                   # O(1) in the sequence length


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"],
                         ids=["f32", "bf16"])
def test_serve_step_matches_reference(compute_dtype):
    """40 decode steps, the same teacher-forced tokens into both: logits
    at every step, then the conv window and the SSM state of every layer
    (the caches at the compute dtype)."""
    rc, tc = _cfgs(compute_dtype)
    rp, _, tp = _params(rc, tc)
    rcache = RS.mamba1_cache(rc, BATCH, jnp.dtype(compute_dtype))
    tcache = build(tc).init_cache(BATCH, 0, tc.torch_compute_dtype(),
                                  device="cpu")
    step = jax.jit(lambda p, t, pos, c: RZ._ssm_serve_step(p, rc, t, pos, c))
    toks = np.random.default_rng(0).integers(0, 512, (BATCH, STEPS)).astype(
        np.int32)
    f32 = compute_dtype == "float32"
    for t in range(STEPS):
        pos = np.full(BATCH, t, np.int32)
        want, rcache = step(rp, jnp.asarray(toks[:, t]), jnp.asarray(pos),
                            rcache)
        got, tcache = model_zoo._ssm_serve_step(
            tp, tc, torch.from_numpy(toks[:, t]), torch.from_numpy(pos), tcache)
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=F32_ATOL if f32 else BF16_LOGIT_ATOL,
                                   rtol=0, err_msg=f"step {t}")
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(
            _np(tcache[name]), _np(rcache[name]), rtol=0, err_msg=name,
            atol=F32_ATOL if f32 else BF16_CACHE_ATOL[name])


def test_decode_logits_match_forward(models):
    """The last prompt step's logits through the decode equal those of
    ``_ssm_forward`` on the whole prompt (the check chip_smoke.py makes on
    the card), and the reference's forward agrees."""
    rc, rp, _, tc, tp = models
    toks = np.random.default_rng(5).integers(0, 512, (BATCH, 24)).astype(
        np.int32)
    h, _ = model_zoo._ssm_forward(tp, tc, torch.from_numpy(toks))
    fwd = h[:, -1].float() @ tp["lm_head"].float()
    cache = build(tc).init_cache(BATCH, 0, device="cpu")
    for t in range(toks.shape[1]):
        dec, cache = model_zoo._ssm_serve_step(
            tp, tc, torch.from_numpy(toks[:, t]), None, cache)
    np.testing.assert_allclose(dec.numpy(), fwd.numpy(), atol=BF16_ATOL,
                               rtol=0)
    hr, _ = RZ._ssm_forward(rp, rc, jnp.asarray(toks))
    np.testing.assert_allclose(_np(h), _np(hr), atol=BF16_ATOL, rtol=0)


def _ref_stream(rc, rp, prompts, gen):
    """The reference's token-by-token greedy stream and the smallest top-2
    logit margin of its decisions."""
    b, s = prompts.shape
    cache = RS.mamba1_cache(rc, b)
    step = jax.jit(lambda p, t, pos, c: RZ._ssm_serve_step(p, rc, t, pos, c))
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


# The two stacks' bf16 logits differ by up to 0.027 (above), so a greedy
# argmax can flip only where the reference's top two logits lie closer
# than twice that; random weights give near-tied logits, so the prompts
# below keep every margin of the reference's stream above STREAM_MARGIN,
# which the test checks first.
STREAM_MARGIN = 0.1


@pytest.mark.parametrize("s,seed", [(12, 6), (20, 1)])
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
    for bit at every step."""
    _, _, _, tc, tp = models
    prompts = np.random.default_rng(3).integers(0, 512, (3, 10)).astype(np.int32)
    streams, logits = _port_stream(tc, tp, prompts, 5)
    for i in range(3):
        alone, alone_logits = _port_stream(tc, tp, prompts[i:i + 1], 5)
        np.testing.assert_array_equal(alone[0], streams[i])
        assert torch.equal(alone_logits[0], logits[i])


def test_serve_cli_token_by_token_route_beside_the_reference_cli(capsys):
    """``--arch falcon-mamba-7b --reduced`` on both CLIs: the
    family-generic token-by-token route, ``prompt_len + gen - 1`` steps,
    greedy tokens of the same shape (the weights differ: jax's and torch's
    generators); no kernel launch; the port's stream is its token-by-token
    stream of its prompts."""
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
    for wrapper in ops.WRAPPERS:
        assert wrapper.launches == 0
    prompts = np.random.default_rng(0).integers(0, 512, (2, 12), dtype=np.int32)
    bundle = build(get_config(ARCH).reduced())
    params = bundle.init(torch.Generator(device="cpu").manual_seed(0), "cpu")
    want, _ = _port_stream(bundle.cfg, params, prompts, 4)
    np.testing.assert_array_equal(out, want)


def test_serve_cli_paged_route_refuses_the_ssm_family():
    with pytest.raises(ValueError, match="no paged serving path"):
        serve.main(["--arch", ARCH, "--reduced", "--paged", "--batch", "2",
                    "--prompt-len", "12", "--gen", "4", "--device", "cpu"])
