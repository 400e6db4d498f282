"""Loss and gradients of the port's ``bundle.loss_fn`` against
``jax.value_and_grad`` of the reference's, family by family, at
``reduced()`` from the reference's ``init_train_state`` parameters
carried across through numpy and one drawn batch (labels with ignored
positions, a remainder chunk of the chunked cross-entropy): the dense
(qwen3-4b), moe (olmoe-1b-7b) and ssm (falcon-mamba-7b) families here,
the hybrid, audio and vlm families in tests/test_torch_train_families.py.

Each family twice: at ``compute_dtype="float32"`` with the fp32 PASA
policy, where the two stacks differ only in the order of fp32 sums
(bars ``F32``), and at the defaults (bf16 compute, fp16 PASA), where they
round bf16 elementwise steps and the fp16 attention differently (bars
``DEFAULT``; measured worst: |dloss| 0.0024, a leaf's cosine 0.9944 on
the vlm's two-element gate, 0.9988 elsewhere)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data import synthetic_batch
from repro.launch.steps import init_train_state as ref_init_state
from repro.models.model_zoo import build as ref_build
from repro_torch.configs import get_config
from repro_torch.models.convert import train_state_from_numpy
from repro_torch.models.model_zoo import build
from repro_torch.optim.adamw import tree_leaves

torch.set_num_threads(1)

BATCH, SEQ = 2, 40          # loss_chunk 32 at reduced(): one chunk + 8
# fp32: |dloss|, each leaf's max error over its largest reference
# element, each leaf's cosine (measured: 1.1e-5, 2.1e-3 on the vlm's
# gate, <= 7.1e-4 elsewhere)
F32 = dict(loss=1e-4, leaf_rel=5e-3, cos=0.99999)
# defaults: |dloss|, the global gradient norms' relative gap, each leaf's
# cosine, the cosine of all gradients together
DEFAULT = dict(loss=0.01, norm_rel=0.01, cos=0.99, all_cos=0.9995)


def cfgs(arch, precision):
    def fix(c):
        c = c.reduced()
        if precision == "f32":
            c = dataclasses.replace(
                c, compute_dtype="float32",
                attention=dataclasses.replace(c.attention, pasa_policy="fp32"))
        return c
    return fix(ref_get_config(arch)), fix(get_config(arch))


def batch_for(rc, seed=0):
    extras = {}
    if rc.family == "vlm":
        extras["vision_embeds"] = ((BATCH, rc.n_image_tokens, rc.vision_dim),
                                   np.float32)
    if rc.family == "audio":
        extras["frame_embeds"] = ((BATCH, rc.n_audio_frames, rc.d_model),
                                  np.float32)
    b = synthetic_batch(seed, 0, BATCH, SEQ, rc.vocab_size,
                        extras=extras or None)
    labels = b["tokens"][:, 1:].copy()
    labels[0, :5] = -1
    labels[1, -3:] = -1
    b["labels"] = labels
    return b


def ref_state(rc, rb):
    rs = ref_init_state(rb, jax.random.PRNGKey(0))
    if rc.family == "vlm":
        # at the reference's init both gates are 0: no cross layer would
        # reach the loss
        cross = rs["params"]["cross"]
        for g in ("gate_attn", "gate_mlp"):
            cross[g] = jnp.full_like(cross[g], 0.5)
    return rs


def loss_and_grads(arch, precision):
    """((ref loss, [ref grads]), (port loss, [port grads]), leaf names)."""
    from repro.checkpoint.manager import _flatten_with_paths

    rc, tc = cfgs(arch, precision)
    rb, tb = ref_build(rc), build(tc)
    rs = ref_state(rc, rb)
    b = batch_for(rc)
    rl, rg = jax.jit(jax.value_and_grad(rb.loss_fn))(
        rs["params"], {k: jnp.asarray(v) for k, v in b.items()})
    ts = train_state_from_numpy(jax.tree.map(np.asarray, rs), tc, "cpu")
    leaves = tree_leaves(ts["params"])
    for p in leaves:
        p.requires_grad_(True)
    tl = tb.loss_fn(ts["params"], {k: torch.from_numpy(v)
                                   for k, v in b.items()})
    tg = torch.autograd.grad(tl, leaves, allow_unused=True)
    names = [k for k, _ in _flatten_with_paths(rg)[0]]
    ref = [np.asarray(x, np.float64) for x in jax.tree.leaves(rg)]
    port = [np.zeros_like(r) if g is None else g.double().numpy()
            for r, g in zip(ref, tg)]
    return (float(rl), ref), (float(tl.detach()), port), names


def _cos(a, b):
    return float((a * b).sum() / max(np.linalg.norm(a) * np.linalg.norm(b),
                                     1e-300))


def check(arch, precision):
    (rl, ref), (tl, port), names = loss_and_grads(arch, precision)
    assert np.isfinite(tl)
    assert len(ref) == len(port)
    if precision == "f32":
        assert abs(rl - tl) <= F32["loss"], (rl, tl)
        for name, r, p in zip(names, ref, port):
            rel = np.abs(r - p).max() / max(np.abs(r).max(), 1e-30)
            assert rel <= F32["leaf_rel"], (name, rel)
            assert _cos(r, p) >= F32["cos"], (name, _cos(r, p))
        return
    assert abs(rl - tl) <= DEFAULT["loss"], (rl, tl)
    rn = np.sqrt(sum((r ** 2).sum() for r in ref))
    pn = np.sqrt(sum((p ** 2).sum() for p in port))
    assert abs(rn - pn) <= DEFAULT["norm_rel"] * rn, (rn, pn)
    for name, r, p in zip(names, ref, port):
        assert _cos(r, p) >= DEFAULT["cos"], (name, _cos(r, p))
    flat = lambda xs: np.concatenate([x.ravel() for x in xs])
    assert _cos(flat(ref), flat(port)) >= DEFAULT["all_cos"]


@pytest.mark.parametrize("precision", ["f32", "default"])
@pytest.mark.parametrize("arch", ["qwen3-4b", "olmoe-1b-7b",
                                  "falcon-mamba-7b"])
def test_loss_and_grads_match_reference(arch, precision):
    check(arch, precision)


def _same_dtype(t, j) -> bool:
    return str(t.dtype).split(".")[-1] == str(j.dtype)


def test_train_state_carries_the_reference_dtypes():
    """fp32 parameters and moments; kimi-k2's bf16 (its param and
    optimizer dtype), its router at fp32 as the reference's init keeps it."""
    for arch, want in (("qwen3-4b", torch.float32),
                       ("kimi-k2-1t-a32b", torch.bfloat16)):
        rc, tc = ref_get_config(arch).reduced(), get_config(arch).reduced()
        rs = ref_init_state(ref_build(rc), jax.random.PRNGKey(0))
        ts = train_state_from_numpy(jax.tree.map(np.asarray, rs), tc, "cpu")
        for leaf in tree_leaves(ts["opt"].mu) + tree_leaves(ts["opt"].nu):
            assert leaf.dtype == want
        assert ts["opt"].step.dtype == torch.int32 and int(ts["opt"].step) == 0
        for a, b in zip(tree_leaves(ts["params"]),
                        jax.tree.leaves(rs["params"])):
            assert tuple(a.shape) == tuple(b.shape) and _same_dtype(a, b)
            np.testing.assert_array_equal(
                a.float().numpy(), np.asarray(jnp.asarray(b, jnp.float32)))


@pytest.mark.parametrize("arch", ["qwen3-4b", "kimi-k2-1t-a32b",
                                  "zamba2-1.2b", "whisper-large-v3",
                                  "llama-3.2-vision-90b", "falcon-mamba-7b"])
def test_init_train_state_layout_and_dtypes(arch):
    """The port's own draw: the reference's tree and shapes, every leaf
    at param_dtype, moments at optimizer_dtype; the training inputs the
    reference's bundle names."""
    from repro_torch.launch.steps import init_train_state

    rc, tc = ref_get_config(arch).reduced(), get_config(arch).reduced()
    rb, tb = ref_build(rc), build(tc)
    shapes = jax.eval_shape(lambda: ref_init_state(rb, jax.random.PRNGKey(0)))
    ts = init_train_state(tb, torch.Generator().manual_seed(0), "cpu")
    for a, b in zip(tree_leaves(ts["params"]), jax.tree.leaves(
            shapes["params"])):
        assert tuple(a.shape) == tuple(b.shape) and _same_dtype(a, b)
    for a in tree_leaves(ts["opt"].mu) + tree_leaves(ts["opt"].nu):
        assert a.dtype == tc.torch_optimizer_dtype()
    want = {k: v.shape for k, v in rb.train_inputs(3, 7).items()}
    assert {k: s for k, (s, _) in tb.train_inputs(3, 7).items()} == want
