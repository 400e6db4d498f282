"""The PASA shifting fraction beta and its optimal-accuracy condition
(Appendix A-C; counterpart of ``repro.core.beta``).

When the shifting matrix M is stored in a low precision ``tp``, its two
distinct entries ``1 - beta/n`` and ``-beta/n`` are rounded, so the matrix
applied realizes a different invariance than the ideal beta/(1-beta) of
the recovery step.  Appendix B solves ``argmin_beta |f(beta) -
beta/(1-beta)|`` by the fixed-point iteration beta <- f(beta)/(1+f(beta))
in float64 (Eq. 22).  The invariance of the port's stored M, with the
1/sqrt(d) fold-in, is ``repro_torch.core.shifting.effective_invariance``,
re-exported here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.shifting import effective_invariance  # noqa: F401

# Paper Section 2.3: initial values 1-2^-4, 1-2^-5, 1-2^-6 at n = 128
# converge to these; the paper adopts the last one for validation.
PAPER_BETAS: Tuple[float, ...] = (0.937500, 0.968994, 0.984497)
DEFAULT_BETA: float = 0.984497
DEFAULT_BLOCK_N: int = 128


def _round_to(x: float, tp: str) -> float:
    """Round a float64 scalar to ``tp`` ("float16" or "bfloat16") and back."""
    if tp == "float16":
        return float(np.float64(np.float16(x)))
    if tp == "bfloat16":
        # round-to-nearest-even on the top 16 bits of the fp32
        u = int(np.float32(x).view(np.uint32))
        rounded = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
        return float(np.uint32(rounded & 0xFFFFFFFF).view(np.float32))
    raise ValueError(f"unsupported low precision {tp!r}")


def ideal_invariance(beta: float) -> float:
    """Inva = beta / (1 - beta); 0 for plain FlashAttention (beta = 0)."""
    if not 0.0 <= beta < 1.0:
        raise ValueError(f"beta must be in [0, 1), got {beta}")
    return beta / (1.0 - beta) if beta > 0.0 else 0.0


def practical_invariance(beta: float, n: int, tp: str = "float16") -> float:
    """Inva_1 = f(beta): the invariance the rounded matrix realizes (Eq. 20)."""
    m0 = _round_to(1.0 - beta / n, tp)
    m1 = _round_to(-beta / n, tp)
    b = -m1
    a = m0 + b
    return b * n / (a * (a - b * n)) + (1.0 - a) / a


def invariance_rel_err(beta: float, n: int, tp: str = "float16") -> float:
    """|Inva - Inva_1| / |Inva| (Table 3)."""
    ideal = beta / (1.0 - beta)
    return abs(ideal - practical_invariance(beta, n, tp)) / abs(ideal)


def optimal_beta(beta0: float, n: int, tol: float = 1.0e-8,
                 tp: str = "float16", max_iter: int = 1000) -> float:
    """Fixed-point iteration (Eq. 22): beta <- f(beta) / (1 + f(beta))."""
    beta = float(beta0)
    for _ in range(max_iter):
        inv = practical_invariance(beta, n, tp)
        new = inv / (1.0 + inv)
        err = abs(new - beta) / abs(beta)
        beta = new
        if err <= tol:
            break
    return beta


def solve_paper_betas(n: int = DEFAULT_BLOCK_N, tp: str = "float16"):
    """The paper's Section 2.3 / Appendix C solve from 1 - 2^-(4, 5, 6)."""
    inits = [1.0 - 2.0 ** (-(i + 4)) for i in range(3)]
    return [optimal_beta(b0, n, tp=tp) for b0 in inits]
