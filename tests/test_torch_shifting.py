"""repro_torch.core.shifting against the reference's repro.core.shifting:
the stored shifting matrix bit for bit, the invariance it realizes as the
same float, and the GEMM shift of K.

Inputs are drawn with numpy at explicit float32 and handed to both
packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import shifting as ref_shift
from repro_torch.core import shifting as pt_shift

torch.set_num_threads(1)

BETA = 0.984497
DTYPES = [(jnp.float16, torch.float16), (jnp.bfloat16, torch.bfloat16),
          (jnp.float32, torch.float32)]


@pytest.mark.parametrize("dtypes", DTYPES, ids=["fp16", "bf16", "fp32"])
@pytest.mark.parametrize("s2,d,beta", [(128, 128, BETA), (64, 64, 0.9375),
                                       (16, 32, BETA), (128, 128, 0.0)])
def test_shifting_matrix_bit_equal(dtypes, s2, d, beta):
    jdt, tdt = dtypes
    ref = ref_shift.shifting_matrix(s2, d, beta, jdt)
    got = pt_shift.shifting_matrix(s2, d, beta, tdt)
    assert got.dtype == tdt and tuple(got.shape) == (s2, s2)
    # bit for bit: compare the raw storage
    want = np.asarray(ref).view(np.uint16 if jdt != jnp.float32 else np.uint32)
    have = got.view(torch.int16 if tdt != torch.float32 else torch.int32)
    np.testing.assert_array_equal(have.numpy().view(want.dtype), want)


@pytest.mark.parametrize("dtypes", DTYPES + [(jnp.float64, torch.float64)],
                         ids=["fp16", "bf16", "fp32", "f64"])
@pytest.mark.parametrize("s2,d,beta", [(128, 128, BETA), (64, 64, 0.9375),
                                       (16, 32, 0.5)])
def test_effective_invariance_equal(dtypes, s2, d, beta):
    jdt, tdt = dtypes
    assert pt_shift.effective_invariance(s2, d, beta, tdt) == \
        ref_shift.effective_invariance(s2, d, beta, jdt)


def test_effective_invariance_is_not_the_ideal_one_at_fp16():
    """The rounded M realizes another invariance than beta/(1-beta) - the
    reason the recovery must use it (Appendix A)."""
    eff = pt_shift.effective_invariance(128, 128, BETA, torch.float16)
    assert eff != BETA / (1.0 - BETA)
    assert abs(eff / (BETA / (1.0 - BETA)) - 1.0) < 0.05


@pytest.mark.parametrize("dtypes", [(jnp.float16, torch.float16),
                                    (jnp.float64, torch.float64)],
                         ids=["fp16", "f64"])
def test_shift_kv_blocks_matches_reference(dtypes):
    """fp16 M: operands at fp16, an fp32 sum and one store in both - equal
    within one fp16 ulp (the two sums may run in another order); f64 M:
    within 1e-12."""
    jdt, tdt = dtypes
    rng = np.random.default_rng(0)
    k = (rng.standard_normal((2, 3, 256, 64)) + 5.0).astype(np.float32)
    ref = ref_shift.shift_kv_blocks(
        jnp.asarray(k), ref_shift.shifting_matrix(128, 64, BETA, jdt), 128)
    got = pt_shift.shift_kv_blocks(
        torch.from_numpy(k), pt_shift.shifting_matrix(128, 64, BETA, tdt), 128)
    assert got.dtype == tdt
    want = np.asarray(ref, np.float64)
    have = got.double().numpy()
    if tdt == torch.float64:
        np.testing.assert_allclose(have, want, atol=1e-12, rtol=0)
    else:
        ulp = np.spacing(np.abs(want).astype(np.float16)).astype(np.float64)
        assert (np.abs(have - want) <= ulp).all()


def test_shift_kv_reference_matches_and_bounds_the_gemm_shift():
    rng = np.random.default_rng(1)
    k = (rng.standard_normal((2, 2, 256, 64)) + 5.0).astype(np.float32)
    ref = np.asarray(ref_shift.shift_kv_reference(jnp.asarray(k), 64, BETA, 128))
    gold = pt_shift.shift_kv_reference(torch.from_numpy(k), 64, BETA, 128)
    assert gold.dtype == torch.float64
    np.testing.assert_allclose(gold.numpy(), ref, atol=1e-12, rtol=0)
    m = pt_shift.shifting_matrix(128, 64, BETA, torch.float16)
    got = pt_shift.shift_kv_blocks(torch.from_numpy(k), m, 128).double()
    # the rounded M and the fp16 store: relative RMSE of a few 1e-4
    rel = float((got - gold).norm() / gold.norm())
    assert rel < 1e-2


def test_shift_kv_blocks_rejects_ragged_length():
    m = pt_shift.shifting_matrix(16, 8, BETA, torch.float16)
    with pytest.raises(ValueError):
        pt_shift.shift_kv_blocks(torch.zeros(1, 20, 8), m, 16)
