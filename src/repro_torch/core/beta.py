"""The PASA shifting fraction beta (counterpart of ``repro.core.beta``).

This slice serves with the algebraic key shift, whose recovery multiplier
is the ideal invariance beta/(1-beta); the rounded-matrix invariance of
Appendix A belongs to the GEMM-shift path, which is not ported yet.
"""

from __future__ import annotations

# Paper Section 2.3: the optimal-accuracy beta at block length 128 in fp16
# (the value the paper adopts for validation).
DEFAULT_BETA: float = 0.984497


def ideal_invariance(beta: float) -> float:
    """Inva = beta / (1 - beta); 0 for plain FlashAttention (beta = 0)."""
    if not 0.0 <= beta < 1.0:
        raise ValueError(f"beta must be in [0, 1), got {beta}")
    return beta / (1.0 - beta) if beta > 0.0 else 0.0
