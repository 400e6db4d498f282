"""The algebraic-shift PASA attention (``AttentionConfig.use_gemm_shift =
False``) in the port against the reference: the port's plain
``ops.pasa_attention(gemm_shift=False)`` and its gradient (through
``kernels.train_attention.kernel_attention``, the training forward)
against the reference's ``blocked_attention(use_gemm_shift=False)`` and
``jax.grad`` of it, at the fp16, bf16_fp32 and fp32 policies, causal and
with a column limit ``kv_valid``, head widths 32 / 64 / 128 and blocks
64 / 128; and ``ops.shift_kv(gemm_shift=False)`` against the reference's
algebraic shift written out.  tests/test_torch_algebraic_shift_cuda.py
holds the CUDA kernels to these plain versions on a card.

Inputs are drawn with numpy at explicit float32 (keys of mean 2, where
the shift matters) and handed to both packages.  The port pads the keys
with zero rows to whole blocks and passes ``kv_valid``, as its dense
layer does; the reference gets the unpadded keys (expanded to the query
heads) and pads and masks itself - the block means count the zero rows
in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BF16_FP32 as R_BF16_FP32
from repro.core import FP16 as R_FP16
from repro.core import FP32 as R_FP32
from repro.core import blocked_attention as ref_blocked
from repro_torch.core.precision import BF16_FP32, FP16, FP32
from repro_torch.kernels import ops
from repro_torch.kernels.train_attention import kernel_attention

torch.set_num_threads(1)

BETA = 0.984497
# the reference's kernel-vs-oracle bars (tests/test_kernels.py): attention
# non-causal, causal; shift-KV
ATTN_TOL = dict(atol=8e-3, rtol=2e-2)
CAUSAL_TOL = dict(atol=2e-3, rtol=2e-2)
SHIFT_ATOL = 1e-2
# gradients: the two stacks differentiate the same expressions but sum
# the backward's products in other orders at the policy's dtypes; max
# |difference| over max |gradient| (measured at most 5.7e-3 over these
# cases, K's at bf16_fp32; 4.8e-3 at fp16, 1.1e-3 at fp32)
GRAD_RTOL = 2e-2
POLICIES = {"fp16": (FP16, R_FP16), "bf16_fp32": (BF16_FP32, R_BF16_FP32),
            "fp32": (FP32, R_FP32)}
H, KVH = 4, 2
S_CAUSAL = 256
S1, KV = 64, 200      # the column-limit calls: 64 queries over 200 keys


def _draw(seed, s1, s2, d):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((1, H, s1, d)) + 1.0).astype(np.float32)
    k = (rng.standard_normal((1, KVH, s2, d)) + 2.0).astype(np.float32)
    v = rng.standard_normal((1, KVH, s2, d)).astype(np.float32)
    return q, k, v


def _port_args(q, k, v, block, causal):
    """The port's tensors (keys padded with zero rows to whole blocks) and
    the op's keyword arguments."""
    s2 = k.shape[2]
    pad = -s2 % block
    tk, tv = (torch.from_numpy(np.pad(x, ((0, 0), (0, 0), (0, pad), (0, 0))))
              for x in (k, v))
    kw = dict(beta=BETA, block_q=64, block_kv=block, causal=causal,
              kv_valid=None if causal else s2, gemm_shift=False)
    return torch.from_numpy(q), tk, tv, kw


def _ref(q, k, v, rpol, block, causal):
    expand = lambda x: jnp.repeat(x, H // KVH, axis=1)
    return ref_blocked(q, expand(k), expand(v), beta=BETA, policy=rpol,
                       block_kv=block, causal=causal, use_gemm_shift=False)


def _case(causal, d, seed=0):
    return _draw(seed, S_CAUSAL if causal else S1,
                 S_CAUSAL if causal else KV, d)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "kv_valid"])
@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("policy", POLICIES)
def test_forward_matches_reference(policy, d, block, causal):
    pol, rpol = POLICIES[policy]
    q, k, v = _case(causal, d)
    tq, tk, tv, kw = _port_args(q, k, v, block, causal)
    got = ops.pasa_attention(tq, tk, tv, policy=pol, **kw)
    assert got.dtype == pol.out_dtype and got.shape == tq.shape
    want = _ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), rpol, block,
                causal)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(CAUSAL_TOL if causal else ATTN_TOL))
    # the algebraic shift is not the GEMM one: its own arithmetic
    gemm = ops.pasa_attention(tq, tk, tv, policy=pol,
                              **dict(kw, gemm_shift=True))
    assert not torch.equal(got, gemm)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "kv_valid"])
@pytest.mark.parametrize("d,block", [(64, 64), (128, 128)])
@pytest.mark.parametrize("policy", POLICIES)
def test_gradient_matches_reference(policy, d, block, causal):
    """The training forward's gradient (the plain version's autograd
    through the algebraic shift and its block mean) against jax.grad of
    the reference's ``blocked_attention(use_gemm_shift=False)``, for the
    loss sum(out * g) with a fixed random g."""
    pol, rpol = POLICIES[policy]
    q, k, v = _case(causal, d, seed=1)
    g = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    tq, tk, tv, kw = _port_args(q, k, v, block, causal)
    ins = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    out = kernel_attention(*ins, policy=pol, **kw)
    got = torch.autograd.grad(out.float(), ins, torch.from_numpy(g))
    loss = lambda a, b, c: jnp.sum(
        _ref(a, b, c, rpol, block, causal).astype(jnp.float32) * g)
    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    s2 = k.shape[2]
    for name, a, b in zip("qkv", got, want):
        a = a.numpy()[:, :, :s2] if name != "q" else a.numpy()
        b = np.asarray(b, np.float32)
        assert np.isfinite(a).all(), name
        scale = float(np.abs(b).max())
        assert scale > 0.0, name
        assert float(np.abs(a - b).max()) <= GRAD_RTOL * scale, name
    # the pad rows' key gradients: the block mean spreads the real rows'
    # gradient over them
    if not causal:
        assert torch.isfinite(got[1][:, :, s2:]).all()


@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("policy", POLICIES)
def test_shift_kv_matches_reference_algebra(policy, d, block):
    """``ops.shift_kv(gemm_shift=False)`` against the reference's
    algebraic branch written out in jax (core/pasa.py: the mean of the
    block at the wide dtype, (k - beta * mean) * (1 / sqrt(d)) rounded
    once to the input dtype)."""
    pol, rpol = POLICIES[policy]
    _, k, _ = _draw(3, 1, 256, d)
    got = ops.shift_kv(torch.from_numpy(k), beta=BETA, block_kv=block,
                       policy=pol, gemm_shift=False)
    assert got.dtype == pol.input_dtype
    kb = jnp.asarray(k).astype(rpol.input_dtype).astype(jnp.float32)
    kb = kb.reshape(1, KVH, 256 // block, block, d)
    mean = jnp.mean(kb, axis=-2, keepdims=True)
    want = ((kb - jnp.float32(BETA) * mean)
            * jnp.float32(1.0 / np.sqrt(d))).astype(rpol.input_dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32).reshape(k.shape),
                               atol=SHIFT_ATOL, rtol=0)
