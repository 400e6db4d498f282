"""Materialized softmax(QK^T/sqrt(d))V gold (counterpart of
``repro.core.naive``; tests and ``chip_smoke.py`` only)."""

from __future__ import annotations

import math
from typing import Optional, Union

import torch


def naive_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_len: Optional[torch.Tensor] = None,
    q_offset: Union[int, torch.Tensor] = 0,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """O(S1*S2)-memory exact attention; ``dtype=torch.float64`` is the
    oracle of every equivalence test.  q (..., S1, D), k/v (..., S2, D).

    ``q_offset`` is the absolute position of query row 0 under ``causal``:
    an int, or a tensor that broadcasts as (..., S1, 1) against the
    column ids - per-row chunk starts of a chunked prefill, e.g. (B, 1, 1,
    1) for q (B, H, S1, D), as the reference's attention layer passes
    them."""
    d = q.shape[-1]
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
    s1, s2 = s.shape[-2], s.shape[-1]
    dev = s.device
    neg = torch.tensor(-3e4 if dtype == torch.float16 else -1e30, dtype=dtype,
                       device=dev)
    if causal:
        qp = torch.arange(s1, device=dev)[:, None] + q_offset
        cp = torch.arange(s2, device=dev)[None, :]
        s = torch.where(qp >= cp, s, neg)
    if kv_len is not None:
        ok = torch.arange(s2, device=dev) < kv_len.reshape(
            kv_len.shape + (1, 1))
        s = torch.where(ok, s, neg)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v)
