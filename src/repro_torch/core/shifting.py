"""The PASA shifting matrix (paper Eq. 10) and the GEMM shift of K.

Counterpart of ``repro.core.shifting``.  ``M = (I - (beta/s2) J) / sqrt(d)``
applied per key block subtracts ``beta x`` the block's key mean and folds
in the static ``1/sqrt(d)`` scale as one matrix-engine pass
(Algorithm 1 lines 5-7):

    K'_j = M K_j  =  (K_j - beta * mean_s2(K_j)) / sqrt(d)

M is stored at the input dtype (fp16 in the paper); the rounding of its two
distinct entries is why the recovery must use :func:`effective_invariance`
and not the ideal beta/(1-beta).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _round_from_f64(x: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """float64 numpy -> ``dtype`` with ONE rounding.  numpy rounds
    float64 -> float16 directly; torch goes through float32 and can round
    twice, so fp16 takes numpy's cast (the reference's numpy/JAX cast)."""
    if dtype == torch.float16:
        return torch.from_numpy(np.ascontiguousarray(x.astype(np.float16)))
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _entries(s2: int, d: int, beta: float):
    alpha = math.sqrt(d)
    return (np.float64((1.0 - beta / s2) / alpha),
            np.float64((-beta / s2) / alpha))


def shifting_matrix(s2: int, d: int, beta: float,
                    dtype: torch.dtype = torch.float16) -> torch.Tensor:
    """M (s2 x s2) built in float64 and rounded once to ``dtype`` (on the
    CPU; callers move it)."""
    if beta >= 1.0:
        raise ValueError(f"beta must be < 1 for M to be invertible, got {beta}")
    diag, off = _entries(s2, d, beta)
    m = np.full((s2, s2), off, np.float64)
    np.fill_diagonal(m, diag)
    return _round_from_f64(m, dtype)


def shifting_matrix_inverse(s2: int, d: int, beta: float,
                            dtype: torch.dtype = torch.float64
                            ) -> torch.Tensor:
    """Closed-form inverse of M (Theorem 2.1): M = (I - lam J) / alpha with
    lam = beta / s2 gives M^-1 = alpha (I + lam / (1 - lam s2) J).
    Raises ValueError at beta == 1, where M is singular."""
    if beta == 1.0:
        raise ValueError("M is singular at beta == 1 (Theorem 2.1)")
    lam = beta / s2
    alpha = math.sqrt(d)
    eye = torch.eye(s2, dtype=dtype)
    ones = torch.ones((s2, s2), dtype=dtype)
    return alpha * (eye + (lam / (1.0 - lam * s2)) * ones)


def effective_invariance(s2: int, d: int, beta: float,
                         dtype: torch.dtype = torch.float16) -> float:
    """The invariance the STORED M realizes, alpha fold-in included.

    After rounding, M = a I - b J entrywise; the shift it subtracts per row
    is ``b n / (a - b n)`` times the row mean of the shifted block - the
    multiplier the recovery step must use.  fp32 and f64 keep the ideal
    beta/(1-beta), as the reference does."""
    if dtype in (torch.float32, torch.float64):
        return float(beta / (1.0 - beta))
    diag, off = (float(_round_from_f64(np.asarray(x), dtype))
                 for x in _entries(s2, d, beta))
    b = -off
    a = diag + b
    return float(b * s2 / (a - b * s2))


def shift_kv_blocks(k: torch.Tensor, m: torch.Tensor,
                    block_kv: int) -> torch.Tensor:
    """K'_j = M K_j per block of ``block_kv`` rows of k (..., S2, D).

    The contraction takes operands at M's dtype, accumulates one level
    wider (fp32; f64 for an f64 M) and rounds ONCE on the store - the
    matrix-engine semantics of the reference and of the shift kernel.
    Returns (..., S2, D) at M's dtype."""
    *lead, s2, d = k.shape
    if s2 % block_kv:
        raise ValueError(f"S2={s2} not divisible by block_kv={block_kv}")
    acc = torch.float64 if m.dtype == torch.float64 else torch.float32
    kb = k.reshape(*lead, s2 // block_kv, block_kv, d).to(m.dtype)
    out = torch.matmul(m.to(device=k.device, dtype=acc), kb.to(acc))
    return out.to(m.dtype).reshape(*lead, s2, d)


def shift_kv_reference(k: torch.Tensor, d: int, beta: float,
                       block_kv: int) -> torch.Tensor:
    """Algebraic float64 oracle of :func:`shift_kv_blocks`:
    (K - beta * blockmean(K)) / sqrt(d)."""
    *lead, s2, dd = k.shape
    kb = k.to(torch.float64).reshape(*lead, s2 // block_kv, block_kv, dd)
    mean = kb.mean(-2, keepdim=True)
    return ((kb - beta * mean) / math.sqrt(d)).reshape(*lead, s2, dd)
