"""Numerics core: precision policies, beta, blocked PASA attention, ring
PASA over a process group, numerical-quality instruments."""

from repro_torch.core.beta import (
    DEFAULT_BETA,
    PAPER_BETAS,
    ideal_invariance,
    invariance_rel_err,
    optimal_beta,
    practical_invariance,
    solve_paper_betas,
)
from repro_torch.core.naive import naive_attention
from repro_torch.core.numerics import (
    FP16_MAX,
    make_resonant_qk,
    overflow_stats,
    resonance_index,
    rmse,
    score_overflow_probe,
)
from repro_torch.core.pasa import (
    NEG_BIG,
    AttnState,
    BlockedProblem,
    BlockPartials,
    block_partials,
    blocked_attention,
    finalize_state,
    flash_attention,
    fold_partials,
    init_state,
    pasa_attention,
    prepare_blocks,
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
from repro_torch.core.ring import make_ring_attention, ring_pasa_attention
from repro_torch.core.shifting import (
    effective_invariance,
    shift_kv_blocks,
    shift_kv_reference,
    shifting_matrix,
    shifting_matrix_inverse,
)

__all__ = [
    "AttnState", "BF16_FP32", "BlockPartials", "BlockedProblem",
    "DEFAULT_BETA", "F64", "FP16", "FP16_FP32", "FP16_MAX", "FP32",
    "NEG_BIG", "PAPER_BETAS", "POLICIES", "PrecisionPolicy",
    "block_partials", "blocked_attention", "effective_invariance",
    "finalize_state", "flash_attention", "fold_partials", "get_policy",
    "ideal_invariance", "init_state", "invariance_rel_err",
    "make_resonant_qk", "make_ring_attention", "naive_attention",
    "optimal_beta", "overflow_stats", "pasa_attention",
    "practical_invariance", "prepare_blocks", "reduce_dtype",
    "resonance_index", "ring_pasa_attention", "rmse", "score_overflow_probe",
    "shift_kv_blocks", "shift_kv_reference", "shifting_matrix",
    "shifting_matrix_inverse", "solve_paper_betas", "update_state",
]
