"""Ring (sequence-parallel) PASA over a process group (counterpart of
``repro.core.ring``).

The paper notes PASA "is able to be integrated into ... ring attention
(RA) for multiple devices".  K/V shards rotate around a ring of ranks
while each rank folds the visiting shard into its local PASA state with
the same :func:`~repro_torch.core.pasa.update_state` as the one-device
path: the global pseudo-average F-bar update is a weighted running mean,
so it composes across ranks in ring order as it does across blocks.

Each ring step posts the exchange of the NEXT shard
(``core.collectives.RingShift``, ``dist.batch_isend_irecv``) before it
folds the current one, so the transfer runs behind the fold (the
reference's ``ppermute``-before-sweep schedule).  There is no kernel
here, in either package: the fold is plain PyTorch, as the reference's
is jnp.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import pasa as pasa_lib
from repro_torch.core.collectives import (
    RingShift,
    all_gather,
    group_rank,
    group_size,
    shard,
)
from repro_torch.core.precision import FP16, PrecisionPolicy
from repro_torch.core.shifting import (
    effective_invariance,
    shift_kv_blocks,
    shifting_matrix,
)


def ring_pasa_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group=None,
    beta: float = 0.0,
    policy: PrecisionPolicy = FP16,
    block_kv: int = 128,
    causal: bool = False,
    kv_len: Optional[torch.Tensor] = None,
    q_offset: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sequence-parallel blocked attention: called on every rank of
    ``group`` (None: the default group) with its local shards.

    q: (..., S1_local, D); k, v: (..., S2_local, D), S2_local a multiple
    of ``block_kv``.  Rank r owns query rows [r*S1_local, (r+1)*S1_local)
    and key columns [r*S2_local, ...) of the global sequence.  ``causal``
    masks over global positions; ``kv_len`` (broadcastable against the
    lead dims with trailing (S1, s2), e.g. (B, 1, 1, 1) for (B, H, S, D))
    masks the global columns at or past it on every rank - K/V there must
    be zeroed by the caller so the GEMM-form shift stays finite;
    ``q_offset`` (same broadcast) is the global row of the local shard's
    row 0, for a query block at a dynamic position (chunked prefill).
    Returns the local output rows (..., S1_local, D)."""
    if not 0.0 <= beta < 1.0:
        raise ValueError(f"beta must be in [0,1), got {beta}")
    d = q.shape[-1]
    s1 = q.shape[-2]
    s2_loc = k.shape[-2]
    if s2_loc % block_kv:
        raise ValueError(f"local KV len {s2_loc} % block_kv {block_kv} != 0")
    n_dev, my = group_size(group), group_rank(group)

    dt = policy.input_dtype
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    post_scale = 1.0
    if beta > 0.0:
        inva = effective_invariance(block_kv, d, beta, dt)
        m_mat = shifting_matrix(block_kv, d, beta, dt)
        k = shift_kv_blocks(k, m_mat, block_kv).to(dt)
    else:
        inva = 0.0
        post_scale = 1.0 / math.sqrt(d)

    lead = torch.broadcast_shapes(q.shape[:-2], k.shape[:-2])
    qs = q.expand(lead + q.shape[-2:])
    state = pasa_lib.init_state(qs.shape[:-1], d, policy, device=q.device)

    masked = causal or kv_len is not None
    q_rows = None
    if masked:
        rows = torch.arange(s1, dtype=torch.int32, device=q.device) + my * s1
        q_rows = rows[:, None] if q_offset is None else (
            q_offset + rows[:, None])

    k_cur, v_cur = k, v
    for step in range(n_dev):
        # post the next shard's exchange before this one's fold
        nxt = RingShift((k_cur, v_cur), group) if step + 1 < n_dev else None
        src = (my - step) % n_dev                 # owner of k_cur
        state = _ring_sweep(
            state, qs, k_cur, v_cur, inva=inva, policy=policy,
            block_kv=block_kv, post_scale=post_scale, q_rows=q_rows,
            col_base=src * s2_loc, causal=causal, kv_len=kv_len,
        )
        if nxt is not None:
            k_cur, v_cur = nxt.wait()
    return pasa_lib.finalize_state(state, policy)


def _ring_sweep(state, q, k_sh, v, *, inva, policy, block_kv, post_scale,
                q_rows, col_base, causal, kv_len):
    """Fold one visiting shard, block by block, into ``state``."""
    for j in range(k_sh.shape[-2] // block_kv):
        cols = slice(j * block_kv, (j + 1) * block_kv)
        mask = None
        if q_rows is not None:
            c = col_base + j * block_kv + torch.arange(
                block_kv, dtype=torch.int32, device=q.device)
            if causal:
                mask = q_rows >= c[None, :]
            if kv_len is not None:
                valid = c[None, :] < kv_len
                mask = valid if mask is None else mask & valid
        state = pasa_lib.update_state(
            state, q, k_sh[..., cols, :], v[..., cols, :], inva=inva,
            policy=policy, mask=mask, post_scale=post_scale,
        )
    return state


def make_ring_attention(mesh, axis_name: str, **kw):
    """``ring_pasa_attention`` over ``mesh``'s ``axis_name`` for (B, H, S,
    D) inputs that every rank holds whole: each rank takes its sequence
    shard, runs the ring, and the output rows are all-gathered, so every
    rank returns the whole (B, H, S, D) output (the reference's
    ``shard_map`` in and out of global arrays)."""
    group = mesh.axis_group(axis_name)
    n, r = mesh.shape[axis_name], mesh.axis_rank(axis_name)

    def fn(q, k, v):
        out = ring_pasa_attention(
            shard(q, 2, n, r), shard(k, 2, n, r), shard(v, 2, n, r),
            group=group, **kw)
        return all_gather(out, 2, group)

    return fn
