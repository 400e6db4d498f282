"""Numerical-quality instruments: relative RMSE (Eq. 19), overflow census,
the fp16 score-overflow probe and Q/K resonance (counterpart of
``repro.core.numerics``).

Reductions run in float64 through numpy.  :func:`make_resonant_qk` draws
from a ``numpy.random.Generator`` (the reference draws from a jax key; the
two give different numbers from one seed, so tests hand both packages the
same numpy arrays).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

FP16_MAX = 65504.0


def _np64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


def rmse(computed, golden) -> float:
    """Relative RMSE, Eq. 19: ||O_c - O_g||_2 / ||O_g||_2 (fp64 reduction)."""
    c, g = _np64(computed), _np64(golden)
    return float(np.linalg.norm(c - g) / np.linalg.norm(g))


def overflow_stats(x) -> Dict[str, float]:
    """NaN/Inf census of an output tensor (Table 4 columns)."""
    a = _np64(x)
    n = a.size
    nan = int(np.isnan(a).sum())
    inf = int(np.isinf(a).sum())
    return {
        "nan_pct": 100.0 * nan / n,
        "inf_pct": 100.0 * inf / n,
        "overflow": bool(nan or inf),
        "max_abs_finite": float(np.nanmax(np.where(np.isfinite(a), np.abs(a), 0.0)))
        if n
        else 0.0,
    }


def score_overflow_probe(q, k) -> Dict[str, float]:
    """Does the RAW q k^T exceed the fp16 range?  (Section 3.3.2: the
    static 1/sqrt(d) scale follows the score store, so the raw product is
    what overflows.)  q (..., S, D), k (..., T, D)."""
    q32 = torch.as_tensor(_np64(q)).float()
    k32 = torch.as_tensor(_np64(k)).float()
    s = torch.einsum("...sd,...td->...st", q32, k32).numpy()
    return {
        "smax": float(s.max()),
        "smin": float(s.min()),
        "would_overflow_fp16": bool((np.abs(s) > FP16_MAX).any()),
        "overflow_pct": float(100.0 * (np.abs(s) > FP16_MAX).mean()),
    }


def resonance_index(q, k) -> float:
    """The paper's Q/K resonance along the head dim: mean |cosine| between
    the query rows and the mean key row (1.0 = perfectly (anti-)aligned)."""
    qf = _np64(q).reshape(-1, np.shape(q)[-1])
    kf = _np64(k).reshape(-1, np.shape(k)[-1])
    kbar = kf.mean(0)
    kn = kbar / (np.linalg.norm(kbar) + 1e-30)
    qn = qf / (np.linalg.norm(qf, axis=1, keepdims=True) + 1e-30)
    return float(np.abs(qn @ kn).mean())


def make_resonant_qk(
    rng: np.random.Generator,
    shape: Tuple[int, ...],
    *,
    amplitude: float = 50.0,
    bias: float = 0.0,
    anti: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Q/K pairs with the paper's resonance: a shared waveform along the
    head dim (4 periods), K in phase (category 2, large positive scores)
    or 180 degrees out of phase (category 1, ``anti``), plus unit noise.
    Returns float32 tensors."""
    d = shape[-1]
    t = np.arange(d, dtype=np.float32)
    wave = np.sin(np.float32(2.0 * np.pi) * t * np.float32(4.0) / np.float32(d))
    q = amplitude * wave + rng.standard_normal(shape, np.float32) + bias
    phase = -1.0 if anti else 1.0
    k = (phase * amplitude * wave + rng.standard_normal(shape, np.float32)
         + bias)
    return (torch.from_numpy(np.asarray(q, np.float32)),
            torch.from_numpy(np.asarray(k, np.float32)))
