"""Precision-allocation policies for blocked attention (paper Figures 1-3),
as torch dtypes.  Counterpart of ``repro.core.precision``.

  * ``FP32``      - score matrix, softmax statistics and accumulator fp32;
  * ``FP16_FP32`` - the score matrix is stored fp16, statistics stay fp32;
  * ``FP16``      - every intermediate (S, m, l, O-acc) is fp16; the paper's
                    setting, unusable without PASA;
  * ``BF16_FP32`` - bf16 inputs, fp32 intermediates (the non-PASA path);
  * ``F64``       - exactness oracle for tests.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Where each intermediate of blocked attention lives.

    input_dtype: Q/K/V before the matrix engine; score_dtype: the score
    matrix as it leaves the first GEMM (the GEMM accumulates wider; the
    *store* is what overflows); stat_dtype: m, l and F-bar; acc_dtype: the
    output accumulator; out_dtype: the returned output.
    """

    name: str
    input_dtype: torch.dtype
    score_dtype: torch.dtype
    stat_dtype: torch.dtype
    acc_dtype: torch.dtype
    out_dtype: torch.dtype


def reduce_dtype(stat_dtype: torch.dtype) -> torch.dtype:
    """Wide accumulator dtype for reductions feeding cross-block state.

    Sums (block key mean, row pseudo-average, softmax sum) accumulate one
    level wider than ``stat_dtype`` and round ONCE on the store, so the
    result does not depend on the summation order of the backend; the max
    is exact and stays at ``stat_dtype`` (see the reference's
    ``repro.core.precision.reduce_dtype``)."""
    return torch.float64 if stat_dtype == torch.float64 else torch.float32


FP32 = PrecisionPolicy(
    "fp32", torch.float16, torch.float32, torch.float32, torch.float32,
    torch.float16,
)
FP16_FP32 = PrecisionPolicy(
    "fp16_fp32", torch.float16, torch.float16, torch.float32, torch.float32,
    torch.float16,
)
FP16 = PrecisionPolicy(
    "fp16", torch.float16, torch.float16, torch.float16, torch.float16,
    torch.float16,
)
BF16_FP32 = PrecisionPolicy(
    "bf16_fp32", torch.bfloat16, torch.float32, torch.float32, torch.float32,
    torch.bfloat16,
)
F64 = PrecisionPolicy(
    "f64", torch.float64, torch.float64, torch.float64, torch.float64,
    torch.float64,
)

POLICIES = {p.name: p for p in (FP32, FP16_FP32, FP16, BF16_FP32, F64)}


def get_policy(name: str) -> PrecisionPolicy:
    try:
        return POLICIES[name]
    except KeyError as e:
        raise ValueError(
            f"unknown precision policy {name!r}; have {sorted(POLICIES)}"
        ) from e
