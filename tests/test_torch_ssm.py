"""The port's Mamba-2 block (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``): the causal conv, the chunked SSD
against the sequential recurrence and the reference's own, and
``mamba2_block`` in its no-cache and decode branches - both packages fed
the same numpy arrays (weights from the reference's ``init_mamba2``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import ssm as RS
from repro_torch.configs import get_config
from repro_torch.models import ssm
from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(1)

# fp32 paths: the same arithmetic in another summation order
F32_ATOL = 1e-4
# the block at the compute dtype bf16: the two stacks round bf16
# elementwise steps differently (jax's bf16 silu differs from torch's in
# the last bit on about a third of inputs), measured up to two bf16 ulps
# (0.031) on outputs of magnitude 3.4
BF16_ATOL = 0.0625


def _ssd_sequential(x, dt, bmat, cmat, a):
    """Reference O(S) recurrence for mamba2: h = exp(dt*a) h + dt B x^T
    (tests/test_models_ssm.py)."""
    bb, s, nh, p = x.shape
    n = bmat.shape[-1]
    h = np.zeros((bb, nh, n, p))
    ys = []
    for t in range(s):
        da = np.exp(dt[:, t, :, None, None] * a[None, :, None, None])
        upd = (dt[:, t, :, None, None] * bmat[:, t, None, :, None]
               * x[:, t, :, None, :])
        h = da * h + upd
        ys.append(np.einsum("bn,bhnp->bhp", cmat[:, t], h))
    return np.stack(ys, 1).reshape(bb, s, nh, p), h


def _ssd_inputs(s, seed):
    rng = np.random.default_rng(seed)
    bb, nh, p, n = 2, 3, 4, 5
    return (rng.standard_normal((bb, s, nh, p)),
            rng.uniform(0.01, 0.2, (bb, s, nh)),
            rng.standard_normal((bb, s, n)),
            rng.standard_normal((bb, s, n)),
            -rng.uniform(0.1, 1.0, (nh,)))


# 200 and 300 are not multiples of 128: the chunk halves to 8 and 4
@pytest.mark.parametrize("s", [16, 48, 128, 200, 256, 300])
@pytest.mark.parametrize("seed", [0, 7])
def test_ssd_chunked_equals_sequential_and_reference(s, seed):
    args = _ssd_inputs(s, seed)
    got_y, got_h = ssm._ssd_chunked(*(torch.from_numpy(a) for a in args))
    want_y, want_h = _ssd_sequential(*args)
    np.testing.assert_allclose(got_y.numpy(), want_y, atol=F32_ATOL)
    np.testing.assert_allclose(got_h.numpy(), want_h, atol=F32_ATOL)
    ref_y, ref_h = RS._ssd_chunked(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(ref_y), atol=F32_ATOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(ref_h), atol=F32_ATOL)


def test_ssd_chunked_continues_from_a_state():
    """h0: two halves chained through the state equal the whole."""
    x, dt, b, c, a = (torch.from_numpy(v) for v in _ssd_inputs(96, 3))
    y, h = ssm._ssd_chunked(x, dt, b, c, a)
    y1, h1 = ssm._ssd_chunked(x[:, :40], dt[:, :40], b[:, :40], c[:, :40], a)
    y2, h2 = ssm._ssd_chunked(x[:, 40:], dt[:, 40:], b[:, 40:], c[:, 40:], a,
                              h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, atol=F32_ATOL, rtol=0)
    torch.testing.assert_close(h2, h, atol=F32_ATOL, rtol=0)


def test_causal_conv_matches_numpy_and_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 6)).astype(np.float32)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    got = ssm._causal_conv(*(torch.from_numpy(v) for v in (x, w, b))).numpy()
    pad = np.concatenate([np.zeros((2, 3, 6), np.float32), x], axis=1)
    want = np.stack([sum(pad[:, t + i, :] * w[:, i] for i in range(4)) + b
                     for t in range(16)], axis=1)
    np.testing.assert_allclose(got, want, atol=1e-5)
    ref = RS._causal_conv(*(jnp.asarray(v) for v in (x, w, b)))
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5)


def _cfgs(compute_dtype):
    rc = dataclasses.replace(ref_get_config("zamba2-1.2b").reduced(),
                             compute_dtype=compute_dtype)
    tc = dataclasses.replace(get_config("zamba2-1.2b").reduced(),
                             compute_dtype=compute_dtype)
    return rc, tc


def _block_params(rc, tc, seed=0):
    p = RS.init_mamba2(jax.random.PRNGKey(seed), rc, jnp.float32)
    tree = jax.tree.map(lambda x: np.array(x, np.float32), p)
    return p, params_from_numpy({"mamba": tree}, tc, "cpu")["mamba"]


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("compute_dtype,atol",
                         [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s", [40, 200])
def test_mamba2_block_no_cache_matches_reference(compute_dtype, atol, s):
    rc, tc = _cfgs(compute_dtype)
    p, tp = _block_params(rc, tc)
    x = np.random.default_rng(1).standard_normal((2, s, rc.d_model)).astype(
        np.float32)
    want, _ = RS.mamba2_block(jnp.asarray(x), p, rc)
    got, cache = ssm.mamba2_block(torch.from_numpy(x), tp, tc)
    assert cache is None and got.dtype == tc.torch_compute_dtype()
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


@pytest.mark.parametrize("compute_dtype,atol",
                         [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)],
                         ids=["f32", "bf16"])
def test_mamba2_block_decode_matches_reference(compute_dtype, atol):
    """24 decode steps from the same state: outputs and the conv / SSM
    state at every step (the caches at the compute dtype, as the
    reference's decode concatenates them with the new row)."""
    rc, tc = _cfgs(compute_dtype)
    p, tp = _block_params(rc, tc)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 24, rc.d_model)).astype(np.float32)
    dt = jnp.dtype(compute_dtype)
    rcache = {k: v[0] for k, v in RS.mamba2_cache(rc, 1, 3, dt).items()}
    tcache = {k: v[0] for k, v in ssm.mamba2_cache(
        tc, 1, 3, tc.torch_compute_dtype(), device="cpu").items()}
    conv_view = tcache["conv"]
    for t in range(24):
        want, rcache = RS.mamba2_block(jnp.asarray(x[:, t:t + 1]), p, rc,
                                       cache=rcache)
        got, tcache = ssm.mamba2_block(torch.from_numpy(x[:, t:t + 1]), tp,
                                       tc, cache=tcache)
        np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)
        np.testing.assert_allclose(_np(tcache["conv"]), _np(rcache["conv"]),
                                   atol=atol, rtol=0)
        np.testing.assert_allclose(_np(tcache["ssm"]), _np(rcache["ssm"]),
                                   atol=atol, rtol=0)
    # written in place: the caller's views hold the state
    assert tcache["conv"] is conv_view
    assert tcache["ssm"].dtype == torch.float32


@pytest.mark.parametrize("s", [12, 200])
def test_mamba2_decode_matches_forward(s):
    """The decode recurrence step by step equals the chunked forward
    (tests/test_models_ssm.py:93 at fp32), also at an S whose chunk is not
    128."""
    _, tc = _cfgs("float32")
    rc, _ = _cfgs("float32")
    _, tp = _block_params(rc, tc)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, s, tc.d_model)).astype(np.float32))
    y_full, _ = ssm.mamba2_block(x, tp, tc)
    cache = {k: v[0] for k, v in ssm.mamba2_cache(
        tc, 1, 2, torch.float32, device="cpu").items()}
    ys = []
    for t in range(s):
        yt, cache = ssm.mamba2_block(x[:, t:t + 1], tp, tc, cache=cache)
        ys.append(yt)
    torch.testing.assert_close(torch.cat(ys, 1), y_full, atol=F32_ATOL, rtol=0)


def test_mamba2_decode_is_batch_invariant():
    """Each row of a decode step equals the row served alone, bit for bit
    (the readout runs on a batch padded to MIN_ROWS)."""
    _, tc = _cfgs("bfloat16")
    rc, _ = _cfgs("bfloat16")
    _, tp = _block_params(rc, tc)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 6, tc.d_model)).astype(np.float32))

    def run(rows):
        cache = {k: v[0] for k, v in ssm.mamba2_cache(
            tc, 1, rows.shape[0], device="cpu").items()}
        return torch.cat([ssm.mamba2_block(rows[:, t:t + 1], tp, tc,
                                           cache=cache)[0]
                          for t in range(rows.shape[1])], 1), cache

    batched, bc = run(x)
    for i in range(3):
        alone, ac = run(x[i:i + 1])
        assert torch.equal(alone[0], batched[i])
        assert torch.equal(ac["ssm"][0], bc["ssm"][i])


def test_mamba2_cache_layout():
    tc = get_config("zamba2-1.2b")
    c = ssm.mamba2_cache(tc, 38, 4, device="meta")
    assert ssm.d_inner(tc) == 4096 and ssm.mamba2_heads(tc) == 64
    assert c["conv"].shape == (38, 4, 3, 4096) and c["conv"].dtype == torch.bfloat16
    assert c["ssm"].shape == (38, 4, 64, 64, 64) and c["ssm"].dtype == torch.float32
