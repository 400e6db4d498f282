"""What one attention-op call costs, and its count under
``launch.op_analysis.count()``.

:func:`bound` is the least time of a call on one H100 SXM: the larger of
its bytes over the HBM3 rate and its FLOPs over the dense bf16 / fp16
tensor-core peak, both NVIDIA's published figures at the full 700 W
limit (a card set below it runs slower).  One FLOP / byte formula per op
of ``kernels.ops`` (paged decode, paged prefill, contiguous decode,
shift-KV, attention), each input byte read once and each output byte
written once, over this call's data.  ``launch.roofline`` re-exports
them; ``chip_smoke.py`` reads them for its kernel bounds.

:func:`run_op` runs an op's body; inside an open count it first adds
the op's formula and counts nothing that runs inside, so the count
reads the same work whatever implements the op.  Outside a count it is
one test and the body's call.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

PEAK_FLOPS = 989e12        # bf16 / fp16 dense tensor-core FLOP/s, H100 SXM
HBM_BW = 3.35e12           # bytes/s, HBM3, H100 SXM

# the counts (``launch.op_analysis.OpCount``) open now, innermost last
ACTIVE: list = []


def bound(nbytes: int, flops: int) -> dict:
    """The least time of a call that moves ``nbytes`` and does ``flops``
    on one H100: the larger of bytes / HBM_BW and flops / PEAK_FLOPS, in
    ms, and which one it is."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = flops / PEAK_FLOPS * 1e3
    return dict(
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=nbytes, flops=flops,
    )


def _sidecar_bytes(kv_lens: Sequence[int], page: int, kvh: int,
                   d: int) -> int:
    """The f32 scale (per kv head) and shift (per kv-head column) sidecars
    of the K and V pages that hold ``kv_lens`` rows."""
    pages = sum(math.ceil(n / page) for n in kv_lens)
    return 2 * pages * kvh * (1 + d) * 4


def paged_decode_cost(b: int, kvh: int, g: int, d: int,
                      kv_lens: Sequence[int], table_numel: int, *,
                      kv_itemsize: int = 2, q_itemsize: int = 2,
                      page: Optional[int] = None) -> tuple:
    """(bytes, flops) of one paged decode call: the live K and V rows
    (codes and their sidecars when ``page`` is given for a quantized
    pool), q in and out, the page table and the lengths; the two
    products over the live rows."""
    live = sum(kv_lens)
    nbytes = (2 * live * kvh * d * kv_itemsize + 2 * b * kvh * g * d
              * q_itemsize + table_numel * 4 + b * 4)
    if page is not None:
        nbytes += _sidecar_bytes(kv_lens, page, kvh, d)
    return nbytes, 4 * g * d * live * kvh


def visible_pairs(starts: Sequence[int], kv_lens: Sequence[int],
                  rows: int) -> int:
    """The causally visible (query, key) pairs of a chunk of ``rows``
    queries at each row's start, keys up to its length (a pad row, length
    0, has none)."""
    return sum(sum(min(s0 + i + 1, n) for i in range(rows))
               for s0, n in zip(starts, kv_lens) if n > 0)


def paged_prefill_cost(b: int, h: int, cs: int, d: int, kvh: int,
                       starts: Sequence[int], kv_lens: Sequence[int],
                       table_numel: int, *, kv_itemsize: int = 2,
                       q_itemsize: int = 2,
                       page: Optional[int] = None) -> tuple:
    """(bytes, flops) of one paged prefill call of ``cs`` query rows a
    row: every row's K and V up to its length (and sidecars, as
    :func:`paged_decode_cost`), q in and out, the table, starts and
    lengths; both products over the visible pairs."""
    live = sum(kv_lens)
    nbytes = (2 * live * kvh * d * kv_itemsize + 2 * b * h * cs * d
              * q_itemsize + table_numel * 4 + 2 * b * 4)
    if page is not None:
        nbytes += _sidecar_bytes(kv_lens, page, kvh, d)
    return nbytes, 4 * d * h * visible_pairs(starts, kv_lens, cs)


def decode_cost(b: int, kvh: int, g: int, d: int, kv_lens: Sequence[int],
                *, kv_itemsize: int = 2, q_itemsize: int = 2) -> tuple:
    """(bytes, flops) of one contiguous-cache decode call: the live K and
    V rows, q in and out, the lengths; both products."""
    live = sum(kv_lens)
    nbytes = (2 * live * kvh * d * kv_itemsize + 2 * b * kvh * g * d
              * q_itemsize + b * 4)
    return nbytes, 4 * g * d * live * kvh


def shift_kv_cost(k_numel: int, k_itemsize: int, block: int, *,
                  out_itemsize: int = 2) -> tuple:
    """(bytes, flops) of one shift-KV call: the keys in, K' out at the
    operand dtype, the (block, block) shifting matrix; one product per
    block."""
    nbytes = k_numel * k_itemsize + k_numel * out_itemsize \
        + block * block * out_itemsize
    return nbytes, 2 * block * k_numel


def attention_cost(b: int, h: int, s1: int, kvh: int, s2: int, d: int, *,
                   causal: bool, kv_valid: Optional[int] = None,
                   itemsize: int = 2) -> tuple:
    """(bytes, flops) of one attention sweep over K' (the shifted keys)
    and V: q in and out, the ``kv_valid`` (else S2) valid key and value
    rows; both products over the causally visible pairs (S1 == S2) or
    every query against the valid keys."""
    valid = s2 if kv_valid is None else kv_valid
    nbytes = 2 * b * h * s1 * d * itemsize + 2 * b * kvh * valid * d * itemsize
    pairs = s1 * (s1 + 1) // 2 if causal else s1 * valid
    return nbytes, 4 * d * b * h * pairs


# the plain version's backward of the attention sweep: dV, dP, dS, dQ
# and dK - five products against the forward's two
BACKWARD_FACTOR = 2.5


# ------------------------------------------------------------ the count --

def run_op(name: str, cost, body, *args, **kwargs):
    """``body(*args, **kwargs)``.  Inside an open count (and not inside
    another attention op) it first adds ``cost(*args, **kwargs)``, a
    (bytes, flops) pair, under ``name``, and counts nothing that runs in
    the body."""
    if not ACTIVE or ACTIVE[-1]._inside:
        return body(*args, **kwargs)
    counter = ACTIVE[-1]
    nbytes, flops = cost(*args, **kwargs)
    counter.add(name, int(flops), int(nbytes))
    counter._inside += 1
    try:
        return body(*args, **kwargs)
    finally:
        counter._inside -= 1


def host_lengths(name: str, t: torch.Tensor) -> list:
    """The values of the length tensor ``t`` (``kv_len``, ``chunk_start``)
    as host ints: read from ``t`` (a readback on the card, made only
    inside a count), or on ``meta`` the open count's ``lengths[name]``."""
    if t.device.type != "meta":
        return [int(x) for x in t.reshape(-1).tolist()]
    lengths = ACTIVE[-1].lengths if ACTIVE else {}
    if name not in lengths:
        raise ValueError(
            f"an attention op on meta needs its {name!r}: pass "
            f"count(lengths={{{name!r}: [...]}})")
    vals = [int(x) for x in lengths[name]]
    if len(vals) != t.numel():
        raise ValueError(f"{len(vals)} {name} for a batch of {t.numel()}")
    return vals
