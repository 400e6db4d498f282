"""The port's train step and trainer (``repro_torch.launch.steps``,
``repro_torch.launch.train``) against the reference's, and the
training path's bit-contracts inside the port:

  * one whole ``make_train_step`` step against the reference's from the
    same state and batch (loss, ``grad_norm``, lr, updated parameters and
    moments), at fp32 compute with the fp32 PASA policy;
  * ``microbatches=2`` against 1 and against the reference's 2;
  * remat on == off, bit for bit, for every family's loss and gradients;
  * ``kernels.train_attention.KernelAttention``: forward == the op and
    gradients == autograd of ``attention_plain``, bit for bit, causal and
    with the column limit, at beta 0.984497 and 0; the dense prefill
    takes it under autograd only;
  * restart == straight, bit for bit (the reference's
    ``test_checkpoint_restart_bit_exact``);
  * the CLI on the CPU, and ``--mesh`` other than 1x1 raising.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch.steps import TrainHyper as RefHyper
from repro.launch.steps import init_train_state as ref_init_state
from repro.launch.steps import make_train_step as ref_make_step
from repro.models.model_zoo import build as ref_build
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.precision import FP16, FP32
from repro_torch.data import DataPipeline, synthetic_batch
from repro_torch.kernels import ops
from repro_torch.kernels.pasa_attention import attention_plain
from repro_torch.kernels.train_attention import (KernelAttention,
                                                 kernel_attention)
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import (TrainHyper, init_train_state,
                                      make_train_step)
from repro_torch.models.convert import train_state_from_numpy
from repro_torch.models.model_zoo import build
from repro_torch.optim.adamw import tree_leaves

torch.set_num_threads(1)

BETA = 0.984497
HYPER = dict(peak_lr=1e-3, warmup_steps=1, total_steps=4)
# one step at fp32 from the same state and batch: the loss as in
# tests/test_torch_train_loss.py, the updated parameters and moments
# (AdamW normalizes the gradient, so a parameter moves by about lr
# whatever its gradient's size, and an element whose gradient is within
# rounding of 0 may move differently: the bar is a tenth of lr = 1e-3 on
# any element, measured 6.0e-5 on one element of 16,384 of a leaf, and
# 1e-6 on a leaf's mean)
STEP_LOSS_ATOL = 1e-4
STEP_PARAM_ATOL = 1e-4
STEP_PARAM_MEAN = 1e-6
# the moments, each leaf's max error over its largest reference element
# (the gradients' bar of tests/test_torch_train_loss.py; nu squares them)
STEP_MOMENT_REL = {"mu": 5e-3, "nu": 1e-2}


def _f32(c):
    return dataclasses.replace(
        c, compute_dtype="float32",
        attention=dataclasses.replace(c.attention, pasa_policy="fp32"))


def _pair(arch="qwen3-4b"):
    rc, tc = (_f32(ref_get_config(arch).reduced()),
              _f32(get_config(arch).reduced()))
    rb, tb = ref_build(rc), build(tc)
    rs = ref_init_state(rb, jax.random.PRNGKey(1))
    ts = train_state_from_numpy(jax.tree.map(np.asarray, rs), tc, "cpu")
    return rc, rb, rs, tc, tb, ts


def _close_params(got, want):
    for a, b in zip(got, want):
        err = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
        assert err.max() <= STEP_PARAM_ATOL and err.mean() <= STEP_PARAM_MEAN


def _check_state(ts, rs):
    _close_params([a.detach().numpy() for a in tree_leaves(ts["params"])],
                  jax.tree.leaves(rs["params"]))
    for part, rel in STEP_MOMENT_REL.items():
        for a, b in zip(tree_leaves(getattr(ts["opt"], part)),
                        jax.tree.leaves(getattr(rs["opt"], part))):
            b = np.asarray(b)
            err = np.abs(a.numpy() - b).max()
            assert err <= rel * max(np.abs(b).max(), 1e-30), (part, err)
    assert int(ts["opt"].step) == int(rs["opt"].step)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    rc, rb, rs, tc, tb, ts = _pair()
    hyper = dict(HYPER, microbatches=microbatches)
    rstep = jax.jit(ref_make_step(rb, RefHyper(**hyper)))
    tstep = make_train_step(tb, TrainHyper(**hyper))
    for i in range(2):      # lr 0 at step 0, then the warmup's peak
        b = synthetic_batch(2, i, 4, 24, rc.vocab_size)
        rs, rm = rstep(rs, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, b)
        assert abs(float(tm["loss"]) - float(rm["loss"])) <= STEP_LOSS_ATOL
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-3)
        np.testing.assert_allclose(float(tm["lr"]), float(rm["lr"]),
                                   rtol=1e-7)
        _check_state(ts, rs)


def test_microbatches_two_equal_one():
    """The same global batch in two microbatches: the mean of the two
    losses and of the two gradients, equal to one batch's up to fp32
    rounding (the loss is a mean of equal-sized halves)."""
    tc = _f32(get_config("qwen3-4b").reduced())
    tb = build(tc)
    b = synthetic_batch(3, 0, 4, 24, tc.vocab_size)
    out = {}
    for mb in (1, 2):
        ts = init_train_state(tb, torch.Generator().manual_seed(0), "cpu")
        step = make_train_step(tb, TrainHyper(**HYPER, microbatches=mb))
        ts, m = step(ts, b)
        ts, m2 = step(ts, synthetic_batch(3, 1, 4, 24, tc.vocab_size))
        out[mb] = (m, m2, ts)
    for k in ("loss", "grad_norm"):
        for i in (0, 1):
            np.testing.assert_allclose(float(out[1][i][k]),
                                       float(out[2][i][k]), rtol=1e-5)
    _close_params(*([a.detach().numpy() for a in tree_leaves(
        out[mb][2]["params"])] for mb in (1, 2)))
    with pytest.raises(ValueError):
        make_train_step(tb, TrainHyper(microbatches=3))(out[1][2], b)


@pytest.mark.parametrize("arch", ["qwen3-4b", "olmoe-1b-7b", "zamba2-1.2b",
                                  "whisper-large-v3", "llama-3.2-vision-90b",
                                  "falcon-mamba-7b"])
def test_remat_on_equals_off_bit_for_bit(arch):
    base = get_config(arch).reduced()
    assert base.remat is False
    extras = {}
    if base.family == "vlm":
        extras["vision_embeds"] = ((2, base.n_image_tokens, base.vision_dim),
                                   np.float32)
    if base.family == "audio":
        extras["frame_embeds"] = ((2, base.n_audio_frames, base.d_model),
                                  np.float32)
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(
        0, 0, 2, 40, base.vocab_size, extras=extras or None).items()}
    got = []
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        bundle = build(cfg)
        params = bundle.init(torch.Generator().manual_seed(0), "cpu",
                             dtype=torch.float32)
        if cfg.family == "vlm":
            for g in ("gate_attn", "gate_mlp"):
                params["cross"][g].fill_(0.5)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = bundle.loss_fn(params, batch)
        got.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert torch.equal(got[0][0], got[1][0])
    for a, b in zip(got[0][1], got[1][1]):
        assert torch.equal(a, b)


def _qkv(seed, b=2, h=4, kvh=2, s=256, d=16, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    draw = lambda *shape, mean=0.0: torch.from_numpy(
        (rng.standard_normal(shape) + mean).astype(np.float32)).to(dtype)
    return draw(b, h, s, d), draw(b, kvh, s, d, mean=2.0), draw(b, kvh, s, d)


@pytest.mark.parametrize("beta,policy,flash", [
    (BETA, FP16, False), (0.0, FP16, True), (BETA, FP32, False),
], ids=["pasa_fp16", "flash_fp16", "pasa_fp32"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "kv_valid"])
def test_kernel_attention_is_the_op_forward_and_the_plain_backward(
        beta, policy, flash, causal):
    q, k, v = _qkv(0)
    kv_valid = None if causal else 200
    ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = kernel_attention(*ins, flash=flash, beta=beta, policy=policy,
                           causal=causal, kv_valid=kv_valid)
    op = ops.flash_attention if flash else ops.pasa_attention
    kw = {} if flash else {"beta": beta}
    assert torch.equal(out.detach(), op(q, k, v, policy=policy,
                                        causal=causal, kv_valid=kv_valid,
                                        **kw))
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)
                    ).to(out.dtype)
    got = torch.autograd.grad(out, ins, g)
    pins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    plain = attention_plain(*pins, beta=beta, policy=policy, block_kv=128,
                            causal=causal, kv_valid=kv_valid)
    want = torch.autograd.grad(plain, pins, g)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a.float()).all()
        assert torch.equal(a, b)
    # only the inputs that require grad get one
    q2 = q.clone().requires_grad_(True)
    (gq,) = torch.autograd.grad(kernel_attention(
        q2, k, v, flash=flash, beta=beta, policy=policy, causal=causal,
        kv_valid=kv_valid), [q2], g)
    assert torch.equal(gq, got[0])


def test_kernel_attention_refuses_flash_at_nonzero_beta():
    q, k, v = _qkv(1)
    with pytest.raises(ValueError):
        kernel_attention(q, k, v, flash=True, beta=BETA, policy=FP16)


def test_dense_prefill_takes_the_function_under_autograd_only():
    from repro_torch.models import attention as attn_mod

    cfg = get_config("qwen3-4b").reduced()
    q, k, v = (x.movedim(1, 2) for x in _qkv(2, s=40))
    out = attn_mod._dense_prefill(q, k, v, cfg, None)
    assert out.grad_fn is None
    qg = q.clone().requires_grad_(True)
    out_g = attn_mod._dense_prefill(qg, k, v, cfg, None)
    assert type(out_g.grad_fn).__name__ != "NoneType"
    seen = []
    node = out_g.grad_fn
    while node is not None and not seen:
        if "KernelAttention" in type(node).__name__:
            seen.append(node)
        node = node.next_functions[0][0] if node.next_functions else None
    assert seen, "the training forward did not go through KernelAttention"
    assert torch.equal(out, out_g.detach())
    with torch.no_grad():
        assert attn_mod._dense_prefill(qg, k, v, cfg, None).grad_fn is None
    assert issubclass(KernelAttention, torch.autograd.Function)


def test_checkpoint_restart_bit_exact(tmp_path):
    """Train 10 steps straight vs 5 + checkpoint + restore + 5: same
    state, bit for bit (tests/test_system.py's contract)."""
    cfg = get_config("qwen3-4b").reduced()
    bundle = build(cfg)
    step = make_train_step(bundle, TrainHyper(peak_lr=1e-3, warmup_steps=2,
                                              total_steps=10))
    pipe = DataPipeline(batch=4, seq=16, vocab=cfg.vocab_size, seed=1)
    bs = [next(pipe) for _ in range(10)]
    pipe.close()

    init = lambda: init_train_state(bundle, torch.Generator().manual_seed(7),
                                    "cpu")
    s_direct = init()
    for b in bs:
        s_direct, _ = step(s_direct, b)
    cm = CheckpointManager(str(tmp_path))
    s = init()
    for b in bs[:5]:
        s, _ = step(s, b)
    cm.save(5, s, blocking=True)
    _, s2 = cm.restore(init())
    for b in bs[5:]:
        s2, _ = step(s2, b)
    from repro_torch.checkpoint.manager import _flatten_with_paths

    a, b = _flatten_with_paths(s_direct), _flatten_with_paths(s2)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (key, x), (_, y) in zip(a, b):
        assert torch.equal(x.detach(), y.detach()), key


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    losses = train_cli.main([
        "--arch", "qwen3-4b", "--reduced", "--device", "cpu", "--steps", "6",
        "--batch", "4", "--seq", "32", "--ckpt-dir", str(tmp_path),
        "--ckpt-every", "3", "--log-every", "2"])
    assert len(losses) == 6 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert "step     6" in out and "done: 6 steps" in out
    assert CheckpointManager(str(tmp_path)).available_steps() == [3, 6]
    # the same directory again: restored at 6, nothing left to run
    assert train_cli.main([
        "--arch", "qwen3-4b", "--reduced", "--device", "cpu", "--steps", "6",
        "--batch", "4", "--seq", "32", "--ckpt-dir", str(tmp_path)]) == []


def test_train_cli_equals_the_reference_cli_first_steps(tmp_path):
    """The CLI's logged losses at the reference's defaults equal the
    reference CLI's within the step bar (different draws of the same
    distributions: only the first loss, at lr 0, is compared loosely)."""
    losses = train_cli.main([
        "--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu", "--steps",
        "3", "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
        "--log-every", "100"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert abs(losses[0] - np.log(512)) < 1.0


@pytest.mark.parametrize("mesh", ["2x1", "1x2", "prod"])
def test_train_cli_mesh_raises(mesh, tmp_path):
    """A mesh of several processes outside torchrun raises, naming
    torchrun (the group is tests/test_torch_data_parallel.py's); the
    production mesh raises too, naming its 256 processes."""
    err, match = ((RuntimeError, "256 processes under torchrun")
                  if mesh == "prod" else (RuntimeError, "torchrun"))
    with pytest.raises(err, match=match):
        train_cli.main(["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
                        "--mesh", mesh, "--ckpt-dir", str(tmp_path)])


def test_train_cli_refuses_the_kernels_below_their_head_width(monkeypatch,
                                                              tmp_path):
    """On the card ``--reduced`` (head_dim 16) with the pasa or flash impl
    raises before any work, naming the naive impl; the check reads only
    the device's type, so a CUDA device object stands in for the card."""
    import repro_torch

    monkeypatch.setattr(repro_torch, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    for impl in (None, "flash"):
        argv = ["--arch", "qwen3-4b", "--reduced", "--ckpt-dir",
                str(tmp_path)] + (["--attention-impl", impl] if impl else [])
        with pytest.raises(NotImplementedError, match="naive"):
            train_cli.main(argv)
