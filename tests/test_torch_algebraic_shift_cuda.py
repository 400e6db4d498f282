"""The algebraic-shift kernels on a CUDA card (``gemm_shift=False``, the
reference's ``use_gemm_shift=False``): the shift kernel's algebraic mode
against its plain version and the float64 algebraic shift, and the
attention kernel on its K' against the plain
``blocked_attention(use_gemm_shift=False)``, each launch counted in its
mode.  tests/test_torch_algebraic_shift.py holds the plain versions to
the reference on the CPU.  Every test is marked ``cuda`` and skips without
a card; the file imports neither jax nor the reference package:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \\
        -m cuda tests/test_torch_algebraic_shift_cuda.py
"""

import importlib

import numpy as np
import pytest
import torch

from repro_torch.core.precision import BF16_FP32, FP16, FP16_FP32, FP32
from repro_torch.core.shifting import shift_kv_reference
from repro_torch.kernels import ops

# the kernel modules (the package binds these names to the ops)
amod, smod = (importlib.import_module(f"repro_torch.kernels.{name}")
              for name in ("pasa_attention", "shift_kv"))

BETA = 0.984497
# the reference's kernel-vs-oracle bars (tests/test_kernels.py): shift-KV;
# attention causal / not; shift-KV vs float64 (chip_smoke.py's bar)
SHIFT_TOL = dict(atol=1e-2, rtol=0.0)
SHIFT_RMSE_MAX = 1e-2
ATTN_TOL = {True: dict(atol=2e-3, rtol=2e-2), False: dict(atol=8e-3, rtol=2e-2)}
# (key dtype, policy) of each mode of the shift kernel
SHIFT_MODES = {"bf16_keys": (torch.bfloat16, FP16),
               "fp16_keys": (torch.float16, FP16),
               "bf16_fp32": (torch.bfloat16, BF16_FP32)}
POLICIES = {"fp16": FP16, "fp16_fp32": FP16_FP32, "fp32": FP32,
            "bf16_fp32": BF16_FP32}


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _randn(rng, shape, mean, dev, dtype=torch.float16):
    x = rng.standard_normal(shape).astype(np.float32) + mean
    return torch.from_numpy(x).to(device=dev, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", SHIFT_MODES)
@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_algebraic_shift_kernel_matches_plain_version(d, block, mode):
    """Keys of mean 5 as (B, S, KVH, D) read through strides, the last
    block's rows past 300 zero (a padded block's zero rows count in its
    mean): one launch in the algebraic mode, within SHIFT_TOL of the plain
    version and relative RMSE SHIFT_RMSE_MAX of float64."""
    dev = _card()
    kdt, policy = SHIFT_MODES[mode]
    op = policy.input_dtype
    rng = np.random.default_rng(40)
    keys = _randn(rng, (2, 384, 4, d), 5.0, dev, torch.float32)
    keys[:, 300:] = 0.0
    k = keys.to(kdt).transpose(1, 2)
    ops.reset_launches()
    got = ops.shift_kv(k, beta=BETA, block_kv=block, policy=policy,
                       gemm_shift=False)
    assert ops.shift_kv.launches_by_mode == {
        smod.mode_name(kdt, op, block, d, gemm_shift=False): 1}
    assert got.dtype == op and got.is_contiguous()
    want = smod.shift_kv_mean_plain(k, BETA, block, policy)
    torch.testing.assert_close(got.float(), want.float(), **SHIFT_TOL)
    gold = shift_kv_reference(k.to(op), d, BETA, block)
    rmse = float(((got.double() - gold).norm() / gold.norm()))
    assert rmse < SHIFT_RMSE_MAX


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "kv_valid"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_attention_kernel_on_algebraic_shift_matches_plain_version(
        d, causal, policy):
    """``ops.pasa_attention(..., gemm_shift=False)``: one launch of the
    shift kernel in its algebraic mode and one of the attention kernel,
    within the reference's attention bars of the plain
    ``blocked_attention(use_gemm_shift=False)`` on the real rows, causal
    or with 200 of 256 key rows valid (the rest zero); queries of mean 0,
    keys of mean 2."""
    dev = _card()
    pol = POLICIES[policy]
    rng = np.random.default_rng(41)
    q = _randn(rng, (2, 8, 256, d), 0.0, dev)
    k = _randn(rng, (2, 2, 256, d), 2.0, dev)
    v = _randn(rng, (2, 2, 256, d), 0.0, dev)
    valid = None if causal else 200
    if valid:
        k[:, :, valid:] = 0.0
        v[:, :, valid:] = 0.0
    kw = dict(beta=BETA, policy=pol, causal=causal, kv_valid=valid,
              gemm_shift=False)
    ops.reset_launches()
    got = ops.pasa_attention(q, k, v, **kw)
    assert ops.pasa_attention.launches == 1
    op = pol.input_dtype          # fp16 keys under bf16 operands are cast
    assert ops.shift_kv.launches_by_mode == {
        smod.mode_name(op, op, 128, d, gemm_shift=False): 1}
    assert got.dtype == pol.out_dtype
    want = amod.attention_plain(q, k, v, block_kv=128, **kw)
    n = 256 if causal else valid
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got[:, :, :n].float(), want[:, :, :n].float(),
                               **ATTN_TOL[causal])
