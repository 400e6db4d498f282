"""Blocked online PASA / FlashAttention in plain PyTorch.

Counterpart of ``repro.core.pasa``, ported for the algebraic-shift
conventions the paged serving path uses: ``shift_mask_valid`` (decode),
``chunk_exact`` (chunked prefill) and beta = 0 (FlashAttention-2 with the
1/sqrt(d) scale applied after the fp16 score store).  It is the plain
version of every attention kernel in ``repro_torch.kernels`` and the path
the engine runs on the CPU.  The paper's GEMM-shift preprocessing
(``use_gemm_shift``, Algorithm 1 lines 5-7) is not ported yet.

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

from repro_torch.core.beta import ideal_invariance
from repro_torch.core.precision import FP32, PrecisionPolicy, reduce_dtype

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
    """Fold one KV block into the running state (Algorithm 1 lines 11-20).

    Same arguments and conventions as the reference's ``update_state``:
    ``mask`` (..., S1, s2) is True where a query attends; the row
    pseudo-average is over all columns, over ``mask`` (``sbar_over_mask``,
    the decode convention) or over the row-uniform ``sbar_mask`` (the
    chunk-exact convention, whose causal structure lives in ``mask`` only);
    ``dead_rows_noop`` keeps rows with no live column bit-unchanged and
    uncounted (needs a per-row ``cnt``).
    """
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
    l_new = e_prev * state.l + e_cur * l_loc

    # lines 19-20: zero v at invalid columns before the PV GEMM (p is 0
    # there, but 0 * NaN = NaN inside the contraction), then accumulate.
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
    acc_new = (
        e_prev.to(policy.acc_dtype) * state.acc
        + e_cur.to(policy.acc_dtype) * pv
    )

    if dead_rows_noop:
        if mask is None:
            raise ValueError("dead_rows_noop needs a mask")
        if state.cnt.dim() == 0:
            raise ValueError(
                "dead_rows_noop needs a per-row cnt "
                "(init_state(per_row_cnt=True))"
            )
        row_live = mask.any(-1, keepdim=True)
        return AttnState(
            m=torch.where(row_live, m_new, state.m),
            l=torch.where(row_live, l_new, state.l),
            acc=torch.where(row_live, acc_new, state.acc),
            f=torch.where(row_live, f_new, state.f),
            cnt=state.cnt + row_live.to(torch.int32),
        )
    return AttnState(m=m_new, l=l_new, acc=acc_new, f=f_new, cnt=state.cnt + 1)


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
    use_gemm_shift: bool = False,
    shift_mask_valid: bool = False,
    chunk_exact: bool = False,
) -> torch.Tensor:
    """PASA (beta > 0) or FlashAttention-2 (beta == 0) over KV blocks.

    Arguments as in the reference's ``blocked_attention``.  The key shift
    is the algebraic one, ``(k - beta * blockmean) / sqrt(d)`` with the
    ideal invariance beta/(1-beta); ``shift_mask_valid`` takes the block
    mean and row pseudo-average over the valid (col < kv_len) columns only
    (decode), and ``chunk_exact`` extends that to causal query chunks with
    per-row dead-block no-ops (chunked prefill).  ``use_gemm_shift=True``
    with beta > 0 (the paper's batched-GEMM preprocessing) is not ported
    yet and raises NotImplementedError.

    Returns (..., S1, D) at ``policy.out_dtype``.
    """
    if not 0.0 <= beta < 1.0:
        raise ValueError(f"beta must be in [0, 1), got {beta}")
    if chunk_exact:
        shift_mask_valid = True
    if use_gemm_shift and beta > 0.0:
        raise NotImplementedError(
            "the GEMM shift (Algorithm 1 lines 5-7) is not ported yet; "
            "pass use_gemm_shift=False for the algebraic shift"
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
    if beta > 0.0:
        wide = reduce_dtype(policy.stat_dtype)
        scale = _scalar(1.0 / math.sqrt(d), wide, dev)
        kb = k.reshape(*k.shape[:-2], n_blocks, block_kv, d).to(wide)
        if shift_mask_valid:
            cols = torch.arange(
                s2_pad, dtype=torch.int32, device=dev
            ).reshape(n_blocks, block_kv)
            vmask = (cols < limit_b)[..., None]          # (..., nb, bkv, 1)
            cnt = torch.clamp(vmask.to(wide).sum(-2, keepdim=True), min=1.0)
            mean = torch.where(vmask, kb, 0.0).sum(-2, keepdim=True) / cnt
        else:
            mean = kb.mean(-2, keepdim=True)
        kb = (kb - _scalar(beta, wide, dev) * mean) * scale
        k = kb.reshape(k.shape).to(policy.input_dtype)
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
    qs = q.expand(lead + q.shape[-2:])
    state = init_state(
        qs.shape[:-1], d, policy, per_row_cnt=chunk_exact, device=dev
    )
    for j in range(n_blocks):
        mask = None
        sbar_mask = None
        if need_mask:
            col = j * block_kv + torch.arange(
                block_kv, dtype=torch.int32, device=dev
            )
            mask = torch.ones((s1, block_kv), dtype=torch.bool, device=dev)
            if causal:
                mask = q_pos >= col
            col_ok = col < limit_b
            mask = mask & col_ok
            if chunk_exact:
                # shift/sbar column set = valid columns (row-uniform); the
                # causal structure lives only in the softmax mask
                sbar_mask = col_ok
        state = update_state(
            state, qs, kb[..., j, :, :], vb[..., j, :, :], inva=inva,
            policy=policy, mask=mask, post_scale=post_scale,
            sbar_over_mask=shift_mask_valid and not chunk_exact,
            sbar_mask=sbar_mask, dead_rows_noop=chunk_exact,
        )
    return finalize_state(state, policy, zero_empty_rows=chunk_exact)
