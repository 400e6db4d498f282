"""Numerics core: precision policies, beta, blocked PASA attention."""

from repro_torch.core.beta import DEFAULT_BETA, ideal_invariance
from repro_torch.core.pasa import (
    NEG_BIG,
    AttnState,
    blocked_attention,
    finalize_state,
    init_state,
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

__all__ = [
    "AttnState", "BF16_FP32", "DEFAULT_BETA", "F64", "FP16", "FP16_FP32",
    "FP32", "NEG_BIG", "POLICIES", "PrecisionPolicy", "blocked_attention",
    "finalize_state", "get_policy", "ideal_invariance", "init_state",
    "reduce_dtype", "update_state",
]
