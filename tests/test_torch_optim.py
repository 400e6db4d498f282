"""The port's AdamW and learning-rate schedule (``repro_torch.optim``)
against the reference's ``repro.optim`` on the same parameters, gradients
and state, bridged through numpy: several AdamW steps chained (with and
without clipping, fp32 and bf16 moments, the learning rate from the
cosine warmup), ``clip_by_global_norm`` and ``global_norm``, and the
schedule at every step; and the port's versions of the reference's
optimizer tests (tests/test_substrate.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw_init as ref_init
from repro.optim import adamw_update as ref_update
from repro.optim import cosine_warmup as ref_cosine
from repro.optim.adamw import clip_by_global_norm as ref_clip
from repro.optim.adamw import global_norm as ref_global_norm
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               cosine_warmup, global_norm)
from repro_torch.optim.adamw import tree_leaves

# Both packages run the same fp32 operations in the same order; they may
# round a product or a sum differently (XLA fuses), so a leaf is held to
# 1e-6 after every step of a chain.
ATOL = RTOL = 1e-6
SHAPES = {"w": (8, 16), "blocks": {"a": (3, 5), "b": (4,)}, "z": (2, 3, 2)}


def _draw(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _draw(rng, v, scale) for k, v in shapes.items()}
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _torch(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _torch(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32)).to(dtype)


def _jnp(tree, dtype=jnp.float32):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype), tree)


def _assert_trees(port, ref, atol=ATOL, rtol=RTOL):
    got = [np.asarray(x.float(), np.float64) for x in tree_leaves(port)]
    want = [np.asarray(jnp.asarray(x, jnp.float32), np.float64)
            for x in jax.tree.leaves(ref)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol)


@pytest.mark.parametrize("max_grad_norm", [1.0, None, 100.0],
                         ids=["clip", "no_clip", "loose_clip"])
@pytest.mark.parametrize("weight_decay", [0.1, 0.0])
def test_adamw_chain_matches_reference(max_grad_norm, weight_decay):
    rng = np.random.default_rng(0)
    params = _draw(rng, SHAPES)
    tp, rp = _torch(params), _jnp(params)
    ts, rs = adamw_init(tp), ref_init(rp)
    hyper = dict(peak_lr=3e-2, warmup_steps=2, total_steps=6)
    for step in range(6):
        grads = _draw(rng, SHAPES, scale=0.5 + step)
        lr_t = cosine_warmup(ts.step, **hyper)
        lr_r = ref_cosine(rs.step, **hyper)
        np.testing.assert_allclose(float(lr_t), float(lr_r), rtol=1e-7)
        kw = dict(b1=0.9, b2=0.95, weight_decay=weight_decay,
                  max_grad_norm=max_grad_norm)
        tp, ts, tm = adamw_update(tp, _torch(grads), ts, lr=lr_t, **kw)
        rp, rs, rm = ref_update(rp, _jnp(grads), rs, lr=lr_r, **kw)
        assert int(ts.step) == int(rs.step) == step + 1
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        _assert_trees(tp, rp)
        _assert_trees(ts.mu, rs.mu)
        _assert_trees(ts.nu, rs.nu)


def test_adamw_bf16_moments_match_reference():
    """kimi-k2's optimizer dtype: moments stored at bf16 (within one bf16
    ulp of the reference's), the arithmetic in fp32."""
    rng = np.random.default_rng(1)
    params = _draw(rng, SHAPES)
    tp, rp = _torch(params), _jnp(params)
    ts, rs = adamw_init(tp, torch.bfloat16), ref_init(rp, jnp.bfloat16)
    for step in range(4):
        grads = _draw(rng, SHAPES)
        tp, ts, _ = adamw_update(tp, _torch(grads), ts, lr=1e-2)
        rp, rs, _ = ref_update(rp, _jnp(grads), rs, lr=1e-2)
        assert all(x.dtype == torch.bfloat16 for x in tree_leaves(ts.mu))
        _assert_trees(tp, rp, atol=1e-5, rtol=1e-5)
        _assert_trees(ts.mu, rs.mu, atol=1e-6, rtol=2 ** -7)
        _assert_trees(ts.nu, rs.nu, atol=1e-6, rtol=2 ** -7)


def test_adamw_updates_in_place():
    """The state is donated: parameters and fp32 moments are the same
    tensors after the step, written in place."""
    params = _torch(_draw(np.random.default_rng(2), SHAPES))
    state = adamw_init(params)
    ids = [id(x) for x in tree_leaves(params) + tree_leaves(state.mu)]
    before = [x.clone() for x in tree_leaves(params)]
    grads = _torch(_draw(np.random.default_rng(3), SHAPES))
    out, state2, _ = adamw_update(params, grads, state, lr=0.1)
    assert [id(x) for x in tree_leaves(out) + tree_leaves(state2.mu)] == ids
    assert all(not torch.equal(a, b) for a, b in zip(before, tree_leaves(out)))


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_and_global_norm_match_reference(max_norm):
    rng = np.random.default_rng(4)
    grads = _draw(rng, SHAPES, scale=3.0)
    np.testing.assert_allclose(float(global_norm(_torch(grads))),
                               float(ref_global_norm(_jnp(grads))), rtol=1e-6)
    got, gn = clip_by_global_norm(_torch(grads), max_norm)
    want, rn = ref_clip(_jnp(grads), max_norm)
    np.testing.assert_allclose(float(gn), float(rn), rtol=1e-6)
    _assert_trees(got, want)


@pytest.mark.parametrize("hyper", [
    dict(peak_lr=3e-4, warmup_steps=20, total_steps=100),
    dict(peak_lr=1.0, warmup_steps=0, total_steps=10, min_ratio=0.0),
    dict(peak_lr=2e-3, warmup_steps=5, total_steps=5),
], ids=["default", "no_warmup", "warmup_is_total"])
def test_cosine_warmup_matches_reference(hyper):
    for s in range(0, 130):
        np.testing.assert_allclose(
            float(cosine_warmup(s, **hyper)), float(ref_cosine(s, **hyper)),
            rtol=1e-6, atol=1e-12)
    on_tensor = cosine_warmup(torch.tensor(7, dtype=torch.int32), **hyper)
    assert on_tensor.dtype == torch.float32 and on_tensor.dim() == 0


# ---------------------------------------------- tests/test_substrate.py --

def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    st = adamw_init(params)
    for _ in range(300):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(w ** 2), [w])
        params, st, _ = adamw_update(params, {"w": g}, st, lr=0.05,
                                     weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.05


def test_grad_clip_metric():
    params = {"w": torch.ones(4)}
    st = adamw_init(params)
    g = {"w": torch.full((4,), 100.0)}
    _, _, m = adamw_update(params, g, st, lr=0.0, max_grad_norm=1.0)
    assert float(m["grad_norm"]) == pytest.approx(200.0)


def test_cosine_warmup_shape():
    lrs = [float(cosine_warmup(s, peak_lr=1.0, warmup_steps=10,
                               total_steps=100)) for s in range(100)]
    assert lrs[0] == 0.0
    assert max(lrs) == pytest.approx(1.0, abs=0.02)
    assert lrs[99] < 0.2
    assert np.argmax(lrs) == 10


def test_state_is_a_dataclass_like_the_reference():
    import repro.optim.adamw as R
    import repro_torch.optim.adamw as T

    assert [f.name for f in dataclasses.fields(T.AdamWState)] == \
        [f.name for f in dataclasses.fields(R.AdamWState)]
