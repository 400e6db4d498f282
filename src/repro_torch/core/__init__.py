"""Numerics core: precision policies, beta, blocked PASA attention."""

from repro_torch.core.beta import DEFAULT_BETA, ideal_invariance
from repro_torch.core.naive import naive_attention
from repro_torch.core.pasa import (
    NEG_BIG,
    AttnState,
    blocked_attention,
    finalize_state,
    flash_attention,
    init_state,
    pasa_attention,
    update_state,
)
from repro_torch.core.precision import (
    BF16_FP32,
    F64,
    FP16,
    FP16_FP32,
    FP32,
    POLICIES,
    PrecisionPolicy,
    get_policy,
    reduce_dtype,
)
from repro_torch.core.shifting import (
    effective_invariance,
    shift_kv_blocks,
    shift_kv_reference,
    shifting_matrix,
)

__all__ = [
    "AttnState", "BF16_FP32", "DEFAULT_BETA", "F64", "FP16", "FP16_FP32",
    "FP32", "NEG_BIG", "POLICIES", "PrecisionPolicy", "blocked_attention",
    "effective_invariance", "finalize_state", "flash_attention",
    "get_policy", "ideal_invariance", "init_state", "naive_attention",
    "pasa_attention", "reduce_dtype", "shift_kv_blocks",
    "shift_kv_reference", "shifting_matrix", "update_state",
]
