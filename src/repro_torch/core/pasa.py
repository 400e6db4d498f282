"""Blocked online PASA / FlashAttention in plain PyTorch.

Counterpart of ``repro.core.pasa``: the paper's GEMM shift (Algorithm 1
lines 5-7, ``use_gemm_shift=True``, the default, as in the reference), the
algebraic-shift conventions the serving paths use - ``shift_mask_valid``
(decode) and ``chunk_exact`` (chunked prefill) - and beta = 0
(FlashAttention-2 with the 1/sqrt(d) scale applied after the fp16 score
store).  It is the plain version of every attention kernel in
``repro_torch.kernels`` and the path the models run on the CPU.

Each intermediate is stored at the dtype the policy names, one torch op
at a time, so an fp16 policy rounds after every elementwise step exactly
where the reference's expressions store.  GEMMs take fp16 operands into an
fp32 product (``q.float() @ k.float()``: products of two fp16 values are
exact in fp32), then round once to the score dtype - the store that
overflows in the paper.

Layout: q is (..., S1, D), k/v are (..., S2, D); leading dims broadcast
(models use (B, KVH, G, S, D) against (B, KVH, 1, S, D) for GQA).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core.beta import DEFAULT_BETA, ideal_invariance
from repro_torch.core.precision import FP16, FP32, PrecisionPolicy, reduce_dtype
from repro_torch.core.shifting import (
    effective_invariance,
    shift_kv_blocks,
    shifting_matrix,
)

# Finite stand-in for -inf that survives fp16 arithmetic (|x| < 65504) and
# underflows exp() to exactly 0 in every policy.
NEG_BIG = -30000.0


@dataclasses.dataclass
class AttnState:
    """Running softmax statistics carried across KV blocks (Algorithm 1).

    m, l, f: (..., S1, 1) at ``stat_dtype`` (running max, sum, F-bar);
    acc: (..., S1, D) at ``acc_dtype``; cnt: blocks folded so far - a
    0-dim int32 tensor, or (..., S1, 1) under the per-row convention.
    """

    m: torch.Tensor
    l: torch.Tensor
    acc: torch.Tensor
    f: torch.Tensor
    cnt: torch.Tensor


def init_state(lead, d: int, policy: PrecisionPolicy, *,
               per_row_cnt: bool = False, device=None) -> AttnState:
    """``lead`` is the query shape without the head dim: (..., S1).

    ``per_row_cnt=True`` makes the folded-block counter per query row (the
    chunk-exact prefill convention, where rows of one chunk fold different
    numbers of live blocks)."""
    lead = tuple(lead)
    st = policy.stat_dtype
    cnt = (
        torch.zeros(lead + (1,), dtype=torch.int32, device=device)
        if per_row_cnt else torch.zeros((), dtype=torch.int32, device=device)
    )
    return AttnState(
        m=torch.full(lead + (1,), NEG_BIG, dtype=st, device=device),
        l=torch.zeros(lead + (1,), dtype=st, device=device),
        acc=torch.zeros(lead + (d,), dtype=policy.acc_dtype, device=device),
        f=torch.zeros(lead + (1,), dtype=st, device=device),
        cnt=cnt,
    )


def _gemm_dtype(policy: PrecisionPolicy) -> torch.dtype:
    # The matrix engine accumulates wider than its operands; the narrow
    # STORE of the result is what the policy controls.
    return torch.float64 if policy.score_dtype == torch.float64 else torch.float32


def _scalar(x: float, dtype, device) -> torch.Tensor:
    return torch.tensor(x, dtype=dtype, device=device)


@dataclasses.dataclass
class BlockPartials:
    """What one KV block contributes before the running state is read
    (Algorithm 1 lines 11-13 and the block's P V of line 20).

    sbar, m_loc, l_loc: (..., S1, 1) at ``stat_dtype`` (row pseudo-average,
    local max, local sum); pv: (..., S1, D) at ``acc_dtype``; row_live:
    (..., S1, 1) bool, rows with a live column (None without a mask).
    Blocks can be reduced to partials in any order or in parallel; the
    order-dependent F-bar recurrence lives in :func:`fold_partials` alone.
    """

    sbar: torch.Tensor
    m_loc: torch.Tensor
    l_loc: torch.Tensor
    pv: torch.Tensor
    row_live: Optional[torch.Tensor] = None


def block_partials(
    q: torch.Tensor,
    k_shifted: torch.Tensor,
    v: torch.Tensor,
    *,
    policy: PrecisionPolicy,
    mask: Optional[torch.Tensor],
    post_scale: float = 1.0,
    sbar_over_mask: bool = False,
    sbar_mask: Optional[torch.Tensor] = None,
) -> BlockPartials:
    """The state-free part of :func:`update_state`: scores, the row
    pseudo-average, the local softmax statistics and P V of one block."""
    st = policy.stat_dtype
    gemm_t = _gemm_dtype(policy)
    dev = q.device

    # line 11: S'_ij = Q_i K'_j^T, stored at score precision.
    s = torch.matmul(
        q.to(gemm_t), k_shifted.to(gemm_t).transpose(-1, -2)
    ).to(policy.score_dtype)
    if post_scale != 1.0:
        # plain-FA path (Eq. 2): the static scale lands after the store, so
        # the raw QK^T overflow is reproduced at fp16 score precision
        s = s * _scalar(post_scale, s.dtype, dev)

    # line 13: row pseudo-average of the shifted block.
    smask = sbar_mask if sbar_mask is not None else (
        mask if sbar_over_mask else None
    )
    wide = reduce_dtype(st)
    if smask is not None:
        cnt_cols = torch.clamp(
            smask.to(wide).sum(-1, keepdim=True), min=1.0
        )
        sbar = (
            torch.where(smask, s.to(wide), 0.0).sum(-1, keepdim=True)
            / cnt_cols
        ).to(st)
    else:
        sbar = s.to(wide).mean(-1, keepdim=True).to(st)

    if mask is not None:
        s = torch.where(mask, s, _scalar(NEG_BIG, s.dtype, dev))

    # line 12: local (uncorrected) softmax stats.
    m_loc = s.to(st).amax(-1, keepdim=True)
    p = torch.exp(s.to(st) - m_loc).to(policy.score_dtype)
    if mask is not None:
        # exact zeros at masked columns: in a fully-masked block m_loc ==
        # NEG_BIG makes p == 1, and 1 * NaN stale values would poison acc
        p = torch.where(mask, p, _scalar(0.0, p.dtype, dev))
    l_loc = p.to(wide).sum(-1, keepdim=True).to(st)

    # lines 19-20: zero v at invalid columns before the PV GEMM (p is 0
    # there, but 0 * NaN = NaN inside the contraction).
    if sbar_mask is not None:
        v = torch.where(
            sbar_mask.transpose(-1, -2), v, _scalar(0.0, v.dtype, dev)
        )
    elif sbar_over_mask and mask is not None:
        col_live = mask.any(-2, keepdim=True)
        v = torch.where(
            col_live.transpose(-1, -2), v, _scalar(0.0, v.dtype, dev)
        )
    pv = torch.matmul(
        p.to(gemm_t), v.to(p.dtype).to(gemm_t)
    ).to(policy.acc_dtype)
    row_live = None if mask is None else mask.any(-1, keepdim=True)
    return BlockPartials(sbar=sbar, m_loc=m_loc, l_loc=l_loc, pv=pv,
                         row_live=row_live)


def fold_partials(
    state: AttnState,
    parts: BlockPartials,
    *,
    inva: float,
    policy: PrecisionPolicy,
    dead_rows_noop: bool = False,
) -> AttnState:
    """Fold one block's partials into the running state (Algorithm 1 lines
    14-20): the online recovery of m, l, F-bar and the accumulator.
    Folding every block's partials in block order performs the operations
    of the sequential :func:`update_state` walk, so it gives the same bits."""
    st = policy.stat_dtype
    dev = state.m.device
    sbar, m_loc = parts.sbar, parts.m_loc

    first = state.cnt == 0
    if inva != 0.0:
        # line 14: global pseudo-average F-bar (running mean of sbar).
        cntf = state.cnt.to(st)
        f_new = (cntf * state.f + sbar) / (cntf + 1.0)
        # line 15: correction terms of the maximum.
        inva_t = _scalar(inva, st, dev)
        dm_prev_c = inva_t * (state.f - f_new)
        dm_cur_c = inva_t * (sbar - f_new)
    else:
        f_new = state.f
        dm_prev_c = torch.zeros_like(state.m)
        dm_cur_c = torch.zeros_like(m_loc)

    # line 16: corrected running max, guarding the empty history.
    cand_prev = torch.where(
        first, _scalar(NEG_BIG, st, dev), state.m + dm_prev_c
    )
    m_new = torch.maximum(cand_prev, m_loc + dm_cur_c)
    # line 17: rescaling exponents (both <= 0 by construction).
    e_prev = torch.exp(cand_prev - m_new)
    e_cur = torch.exp(m_loc + dm_cur_c - m_new)
    # line 18: corrected running sum.
    l_new = e_prev * state.l + e_cur * parts.l_loc
    # line 20: accumulate the block's P V.
    acc_new = (
        e_prev.to(policy.acc_dtype) * state.acc
        + e_cur.to(policy.acc_dtype) * parts.pv
    )

    if dead_rows_noop:
        if parts.row_live is None:
            raise ValueError("dead_rows_noop needs a mask")
        if state.cnt.dim() == 0:
            raise ValueError(
                "dead_rows_noop needs a per-row cnt "
                "(init_state(per_row_cnt=True))"
            )
        row_live = parts.row_live
        return AttnState(
            m=torch.where(row_live, m_new, state.m),
            l=torch.where(row_live, l_new, state.l),
            acc=torch.where(row_live, acc_new, state.acc),
            f=torch.where(row_live, f_new, state.f),
            cnt=state.cnt + row_live.to(torch.int32),
        )
    return AttnState(m=m_new, l=l_new, acc=acc_new, f=f_new, cnt=state.cnt + 1)


def update_state(
    state: AttnState,
    q: torch.Tensor,
    k_shifted: torch.Tensor,
    v: torch.Tensor,
    *,
    inva: float,
    policy: PrecisionPolicy,
    mask: Optional[torch.Tensor],
    post_scale: float = 1.0,
    sbar_over_mask: bool = False,
    sbar_mask: Optional[torch.Tensor] = None,
    dead_rows_noop: bool = False,
) -> AttnState:
    """Fold one KV block into the running state (Algorithm 1 lines 11-20):
    :func:`block_partials` then :func:`fold_partials`.

    Same arguments and conventions as the reference's ``update_state``:
    ``mask`` (..., S1, s2) is True where a query attends; the row
    pseudo-average is over all columns, over ``mask`` (``sbar_over_mask``,
    the decode convention) or over the row-uniform ``sbar_mask`` (the
    chunk-exact convention, whose causal structure lives in ``mask`` only);
    ``dead_rows_noop`` keeps rows with no live column bit-unchanged and
    uncounted (needs a per-row ``cnt``).
    """
    if dead_rows_noop and mask is None:
        raise ValueError("dead_rows_noop needs a mask")
    parts = block_partials(
        q, k_shifted, v, policy=policy, mask=mask, post_scale=post_scale,
        sbar_over_mask=sbar_over_mask, sbar_mask=sbar_mask,
    )
    return fold_partials(state, parts, inva=inva, policy=policy,
                         dead_rows_noop=dead_rows_noop)


def finalize_state(state: AttnState, policy: PrecisionPolicy, *,
                   zero_empty_rows: bool = False) -> torch.Tensor:
    """Algorithm 1 line 22: O = acc / l.  ``zero_empty_rows`` emits 0 for
    rows that never folded a live block (dead pad rows of a batched
    prefill) instead of 0/0."""
    l = state.l.to(policy.acc_dtype)
    if zero_empty_rows:
        l = torch.where(l > 0.0, l, _scalar(1.0, l.dtype, l.device))
    return (state.acc / l).to(policy.out_dtype)


def _pad_to_multiple(x: torch.Tensor, block: int, dim: int):
    n = x.shape[dim]
    pad = (-n) % block
    if pad == 0:
        return x, n
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim), n


@dataclasses.dataclass
class BlockedProblem:
    """:func:`blocked_attention`'s inputs after the shift, cut into KV
    blocks: what :func:`block_partials` / :func:`update_state` take for
    block j is :meth:`block_args` (j)."""

    q: torch.Tensor                  # (..., S1, D), broadcast to K's lead
    kb: torch.Tensor                 # (..., n_blocks, block_kv, D) shifted
    vb: torch.Tensor
    inva: float
    post_scale: float
    causal: bool
    need_mask: bool
    shift_mask_valid: bool
    chunk_exact: bool
    q_pos: Optional[torch.Tensor]    # (..., S1, 1) under causal
    limit_b: torch.Tensor            # valid-column limit, (..., 1, 1)

    @property
    def n_blocks(self) -> int:
        return self.kb.shape[-3]

    def init_state(self, policy: PrecisionPolicy) -> AttnState:
        return init_state(self.q.shape[:-1], self.q.shape[-1], policy,
                          per_row_cnt=self.chunk_exact, device=self.q.device)

    def block_args(self, j: int) -> dict:
        dev = self.q.device
        s1, block_kv = self.q.shape[-2], self.kb.shape[-2]
        mask = None
        sbar_mask = None
        if self.need_mask:
            col = j * block_kv + torch.arange(
                block_kv, dtype=torch.int32, device=dev
            )
            mask = torch.ones((s1, block_kv), dtype=torch.bool, device=dev)
            if self.causal:
                mask = self.q_pos >= col
            col_ok = col < self.limit_b
            mask = mask & col_ok
            if self.chunk_exact:
                # shift/sbar column set = valid columns (row-uniform); the
                # causal structure lives only in the softmax mask
                sbar_mask = col_ok
        return dict(
            q=self.q, k_shifted=self.kb[..., j, :, :],
            v=self.vb[..., j, :, :], mask=mask, post_scale=self.post_scale,
            sbar_over_mask=self.shift_mask_valid and not self.chunk_exact,
            sbar_mask=sbar_mask,
        )


def algebraic_shift(k: torch.Tensor, beta: float, block_kv: int,
                    policy: PrecisionPolicy,
                    limit_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The algebraic key shift (the reference's ``use_gemm_shift=False``)
    of k (..., S2, D) at the policy's input dtype, S2 a multiple of
    ``block_kv``: per block, ``(k - beta * mean) / sqrt(d)`` one level
    wide (``reduce_dtype``), rounded once to the input dtype.  The mean
    is over all the block's rows, or with ``limit_b`` (the valid-column
    limit, (..., 1, 1)) over its rows below it (``shift_mask_valid``)."""
    *lead, s2, d = k.shape
    dev = k.device
    n_blocks = s2 // block_kv
    wide = reduce_dtype(policy.stat_dtype)
    scale = _scalar(1.0 / math.sqrt(d), wide, dev)
    kb = k.reshape(*lead, n_blocks, block_kv, d).to(wide)
    if limit_b is not None:
        cols = torch.arange(
            s2, dtype=torch.int32, device=dev
        ).reshape(n_blocks, block_kv)
        vmask = (cols < limit_b)[..., None]              # (..., nb, bkv, 1)
        cnt = torch.clamp(vmask.to(wide).sum(-2, keepdim=True), min=1.0)
        mean = torch.where(vmask, kb, 0.0).sum(-2, keepdim=True) / cnt
    else:
        mean = kb.mean(-2, keepdim=True)
    kb = (kb - _scalar(beta, wide, dev) * mean) * scale
    return kb.reshape(k.shape).to(policy.input_dtype)


def prepare_blocks(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    beta: float = 0.0,
    policy: PrecisionPolicy = FP32,
    block_kv: int = 128,
    causal: bool = False,
    kv_len: Optional[torch.Tensor] = None,
    q_offset: Optional[torch.Tensor] = None,
    use_gemm_shift: bool = True,
    shift_mask_valid: bool = False,
    chunk_exact: bool = False,
) -> BlockedProblem:
    """The shift and the block cut of :func:`blocked_attention` (same
    arguments); the blocks are then folded in order."""
    if not 0.0 <= beta < 1.0:
        raise ValueError(f"beta must be in [0, 1), got {beta}")
    if chunk_exact:
        shift_mask_valid = True
    if shift_mask_valid and use_gemm_shift and beta > 0.0:
        raise ValueError(
            "shift_mask_valid needs the algebraic shift (use_gemm_shift=False)"
        )
    if shift_mask_valid and causal and not chunk_exact:
        raise ValueError("shift_mask_valid is decode-only (causal=False)")
    dev = q.device
    d = q.shape[-1]
    s1 = q.shape[-2]
    q = q.to(policy.input_dtype)
    k = k.to(policy.input_dtype)
    v = v.to(policy.input_dtype)

    k, s2_orig = _pad_to_multiple(k, block_kv, -2)
    v, _ = _pad_to_multiple(v, block_kv, -2)
    s2_pad = k.shape[-2]
    n_blocks = s2_pad // block_kv

    # valid-column limit shared by the mask and (optionally) the shift
    limit = torch.tensor(s2_orig, dtype=torch.int32, device=dev)
    if kv_len is not None:
        limit = torch.minimum(limit, kv_len.to(torch.int32))
    limit_b = limit.reshape(limit.shape + (1, 1))

    post_scale = 1.0
    inva = ideal_invariance(beta)
    if beta > 0.0 and use_gemm_shift:
        inva = effective_invariance(block_kv, d, beta, policy.input_dtype)
        m_mat = shifting_matrix(block_kv, d, beta, policy.input_dtype)
        k = shift_kv_blocks(k, m_mat.to(dev), block_kv).to(policy.input_dtype)
    elif beta > 0.0:
        k = algebraic_shift(k, beta, block_kv, policy,
                            limit_b if shift_mask_valid else None)
    else:
        # faithful plain-FA allocation: raw QK^T at score precision, the
        # 1/sqrt(d) applied after (Eqs. 1-2)
        post_scale = 1.0 / math.sqrt(d)

    kb = k.reshape(*k.shape[:-2], n_blocks, block_kv, d)
    vb = v.reshape(*v.shape[:-2], n_blocks, block_kv, d)

    need_mask = (
        causal or kv_len is not None or s2_pad != s2_orig or shift_mask_valid
    )
    q_pos = None
    if causal:
        qp = torch.arange(s1, dtype=torch.int32, device=dev)
        if q_offset is not None:
            qp = qp + q_offset.to(torch.int32)
        q_pos = qp[..., :, None]                         # (..., S1, 1)

    lead = torch.broadcast_shapes(q.shape[:-2], k.shape[:-2])
    return BlockedProblem(
        q=q.expand(lead + q.shape[-2:]), kb=kb, vb=vb, inva=inva,
        post_scale=post_scale, causal=causal, need_mask=need_mask,
        shift_mask_valid=shift_mask_valid, chunk_exact=chunk_exact,
        q_pos=q_pos, limit_b=limit_b,
    )


def blocked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    beta: float = 0.0,
    policy: PrecisionPolicy = FP32,
    block_kv: int = 128,
    causal: bool = False,
    kv_len: Optional[torch.Tensor] = None,
    q_offset: Optional[torch.Tensor] = None,
    use_gemm_shift: bool = True,
    shift_mask_valid: bool = False,
    chunk_exact: bool = False,
) -> torch.Tensor:
    """PASA (beta > 0) or FlashAttention-2 (beta == 0) over KV blocks.

    Arguments as in the reference's ``blocked_attention``.
    ``use_gemm_shift=True`` shifts K by the rounded shifting matrix M per
    block (the paper's batched GEMM) and recovers with the invariance M
    realizes (:func:`~repro_torch.core.shifting.effective_invariance`);
    ``False`` is the algebraic ``(k - beta * blockmean) / sqrt(d)`` with
    the ideal beta/(1-beta).  ``shift_mask_valid`` takes the block mean
    and row pseudo-average over the valid (col < kv_len) columns only
    (decode), and ``chunk_exact`` extends that to causal query chunks with
    per-row dead-block no-ops (chunked prefill); both need the algebraic
    shift when beta > 0 (a fixed M cannot mask) and raise ValueError with
    the GEMM shift, as the reference does.

    Returns (..., S1, D) at ``policy.out_dtype``.
    """
    prob = prepare_blocks(
        q, k, v, beta=beta, policy=policy, block_kv=block_kv, causal=causal,
        kv_len=kv_len, q_offset=q_offset, use_gemm_shift=use_gemm_shift,
        shift_mask_valid=shift_mask_valid, chunk_exact=chunk_exact,
    )
    state = prob.init_state(policy)
    for j in range(prob.n_blocks):
        state = update_state(
            state, **prob.block_args(j), inva=prob.inva, policy=policy,
            dead_rows_noop=prob.chunk_exact,
        )
    return finalize_state(state, policy, zero_empty_rows=prob.chunk_exact)


def pasa_attention(q, k, v, *, beta: float = DEFAULT_BETA,
                   policy: PrecisionPolicy = FP16, block_kv: int = 128,
                   **kw) -> torch.Tensor:
    """The paper's headline configuration: PASA at the fully-fp16 policy."""
    return blocked_attention(q, k, v, beta=beta, policy=policy,
                             block_kv=block_kv, **kw)


def flash_attention(q, k, v, *, policy: PrecisionPolicy = FP32,
                    block_kv: int = 128, **kw) -> torch.Tensor:
    """FlashAttention-2 baseline (PASA with beta = 0)."""
    return blocked_attention(q, k, v, beta=0.0, policy=policy,
                             block_kv=block_kv, **kw)
