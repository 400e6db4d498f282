"""GQA attention: dense-cache and paged serving branches, and the
no-cache branch (whole sequences, self- or cross-attention).

Counterpart of ``repro.models.attention.attention``, with its ``causal``,
``use_rope`` and ``cross_x`` arguments: K/V come from ``cross_x`` when it
is given (cross-attention, no RoPE), from ``x`` otherwise; RoPE is skipped
when ``use_rope`` is False.  With ``cfg.qk_norm`` (qwen3) q and k are
RMS-normalized per head (``q_norm`` / ``k_norm``, width head_dim) after
the QKV bias and before RoPE, as in the reference.  Every cache branch
writes the step's K/V into the layer's cache IN PLACE first and then
attends with a kernel op - a cache is never gathered, cast or copied on
the card:

  * dense prefill (``prefill_cache=True``, no page table): the prompt's
    K/V go to cache rows ``[0, S)``; attention is over the fresh K/V,
    causal, with the paper's GEMM shift (``ops.pasa_attention``: the shift
    kernel, then the attention kernel).  The op takes whole blocks, so q,
    k and v get zero rows up to the next multiple of ``block_kv`` and the
    output is cut back to S rows - the reference pads K/V the same way
    inside ``blocked_attention``, and under the causal mask no row below
    S sees a pad column.
  * dense decode: one token per row written at ``pos``; the grouped
    (B, KVH, G, D) query attends over the cache with ``kv_len = pos + 1``
    at the ``shift_mask_valid`` convention (``ops.pasa_decode``, reading
    the cache through a strided view).
  * paged prefill (``prefill_cache=True`` with a page table): a prompt
    chunk per row at absolute positions ``pos + [0, S)``; positions at or
    past ``prefill_len`` write to the null page.  Chunk-exact convention
    with one shift block a page, whatever ``block_kv`` is
    (``ops.pasa_paged_prefill``), as the reference's ``chunk_block =
    page``.
  * paged decode: one token per row written at ``pos``, attending over
    ``pos + 1`` positions, shifted in blocks of ``block_kv`` rows of the
    page-table view whatever the page size (``ops.pasa_paged_decode``).
  * no cache (``cache=None``: the hybrid family's whole-sequence forward,
    the Whisper encoder, every cross-attention): the dense prefill's
    attention over the fresh K/V with nothing written, causal or not as
    asked.  Not causal, nothing hides the pad rows: the op gets
    ``kv_valid = S2`` and masks the pad columns after the row
    pseudo-average, which counts them, as the reference's
    ``blocked_attention`` does with its own zero pad.  The op runs
    inside ``kernels.train_attention.KernelAttention``: the same kernels
    forward; under autograd (training) the plain version's gradient
    backward.  One query row (a
    decode step's cross-attention) is padded to 64 rows only; the rows do
    not interact.  Cross K/V are projected one sequence at a time (1,500
    rows each for Whisper), so that a sequence's K/V do not depend on how
    many sequences share the call.

On a quantized pool (int8 / fp8_e4m3 codes with scale/shift sidecars,
``runtime/paged_cache.py``) the writes quantize, as the reference's
attention layer does with XLA ops (plain PyTorch ops here):

  * prefill quantizes whole pages: the chunk is a page multiple starting
    on a page boundary, so every page of it has all its valid rows in
    hand, and its codes and sidecars are a function of the token prefix;
    all-pad pages write to the null page;
  * decode re-quantizes the tail page: dequantize it, splice the new row
    in, quantize again over rows ``0..slot``;

then the paged ops read the codes and dequantize in the kernels.

``cfg.attention.impl`` picks the attention of every branch, as the
reference's ``_attend`` does (:func:`_policy_beta`):

  * ``"pasa"`` (the default): PASA at ``pasa_policy`` and ``beta`` (the
    paper's fp16 allocation);
  * ``"flash"``: FlashAttention-2 at ``policy`` (bf16_fp32 by default),
    beta 0 - ``ops.flash_attention`` on the dense prefill (no shift pass),
    the decode and paged ops at beta 0;
  * ``"naive"``: the materialized softmax of ``core.naive`` at f32 over
    the K/V the branch attends to (for a paged branch the gathered, and
    dequantized, pages at the compute dtype), in plain PyTorch on every
    device, as the reference's naive branch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as C
from repro_torch.core.naive import naive_attention
from repro_torch.core.precision import PrecisionPolicy, get_policy
from repro_torch.kernels import ops
from repro_torch.kernels.train_attention import kernel_attention
from repro_torch.launch.sharding import get_mesh
from repro_torch.models.layers import apply_rope, matmuls, rms_norm, rope_angles
from repro_torch.runtime.paged_cache import (
    NULL_PAGE,
    dequantize_kv_page,
    gather_pages,
    gather_pages_dequant,
    quantize_kv_page,
)


def heads_sharded(cfg: ModelConfig, mesh) -> bool:
    """True when ``mesh`` (or None) splits the attention's kv heads over
    its "model" axis: M > 1 divides KVH, so each model rank holds the
    ``wq`` / ``wk`` / ``wv`` columns and ``wo`` rows of KVH / M kv heads
    and their query heads at rest, and attends them column-parallel."""
    m = 1 if mesh is None else mesh.shape.get("model", 1)
    return m > 1 and cfg.n_kv_heads > 0 and cfg.n_kv_heads % m == 0


def attention(
    x: torch.Tensor,              # (B, S, D)
    p: dict,                      # one layer's attention params
    cfg: ModelConfig,
    *,
    causal: bool = True,
    use_rope: bool = True,
    cross_x: Optional[torch.Tensor] = None,   # (B, S_kv, D) for cross-attn
    cache: Optional[dict] = None,  # {"k", "v"}: this layer's (B, max_len,
                                  # kv_dim) dense cache or (P, page, kv_dim)
                                  # page pool (+ the sidecars of a
                                  # quantized pool); None: attention over
                                  # the fresh K/V
    pos: Optional[torch.Tensor] = None,   # (B,) write position / chunk
                                          # start (None: dense prefill at 0)
    page_table: Optional[torch.Tensor] = None,    # (B, max_pages) -> paged
    prefill_cache: bool = False,
    prefill_len: Optional[torch.Tensor] = None,   # (B,) valid KV after chunk
) -> torch.Tensor:
    cd = cfg.torch_compute_dtype()
    b, s, _ = x.shape
    hd = cfg.head_dim
    x = x.to(cd)

    wq, wk, wv = (p[name].to(cd) for name in ("wq", "wk", "wv"))
    # column-parallel on the model axis (a training mesh's placement,
    # ``models.convert.gather_params``): this rank's kv heads and their
    # query heads, the input's gradient summed over the model group and
    # ``wo`` row-parallel over the heads
    split = wq.shape[-1] != cfg.q_dim
    if split:
        group = get_mesh().axis_group("model")
        x = C.sum_grad(x, group)
        if cross_x is not None:
            cross_x = C.sum_grad(cross_x.to(cd), group)
    h, kvh = wq.shape[-1] // hd, wk.shape[-1] // hd
    if cross_x is None:
        q, k, v = matmuls(x, wq, wk, wv)
    else:
        (q,) = matmuls(x, wq)
        src = cross_x.to(cd)
        kv = [matmuls(src[i], wk, wv) for i in range(b)]
        k, v = (torch.stack([t[n] for t in kv]) for n in (0, 1))
    s_kv = k.shape[1]
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s_kv, kvh, hd)
    v = v.reshape(b, s_kv, kvh, hd)
    if cfg.qk_norm:
        q_norm, k_norm = p["q_norm"], p["k_norm"]
        if split:   # replicated weights used on this rank's heads only
            q_norm, k_norm = (C.sum_grad(w, group) for w in (q_norm, k_norm))
        q = rms_norm(q, q_norm, cfg.norm_eps)
        k = rms_norm(k, k_norm, cfg.norm_eps)

    # RoPE at per-row absolute positions pos + [0, S)
    if pos is None:
        pos = torch.zeros(b, dtype=torch.int32, device=x.device)
    pos = pos.to(torch.int32)
    if use_rope and cross_x is None:
        cos, sin = rope_angles(pos, s, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    if page_table is not None:
        out = _paged(q, k, v, cfg, cache, pos, page_table, prefill_cache,
                     prefill_len)
    elif cache is None:
        out = _dense_prefill(q, k, v, cfg, None, causal=causal)
    elif prefill_cache:
        out = _dense_prefill(q, k, v, cfg, cache)
    else:
        out = _dense_decode(q, k, v, cfg, cache, pos)
    y = matmuls(out.to(cd), p["wo"].to(cd))[0]
    return C.sum_replicated(y, group) if split else y


def _policy_beta(cfg: ModelConfig) -> tuple[PrecisionPolicy, float]:
    """The precision policy and beta of ``cfg.attention.impl`` (the
    reference's ``_attend``): PASA at ``pasa_policy`` and ``beta``,
    FlashAttention-2 at ``policy`` and beta 0."""
    ac = cfg.attention
    if ac.impl == "pasa":
        return get_policy(ac.pasa_policy), ac.beta
    return get_policy(ac.policy), 0.0


def _naive(q, k, v, *, causal: bool, kv_len=None, q_offset=0) -> torch.Tensor:
    """The naive impl: ``core.naive_attention`` at f32 on K/V expanded to
    the query heads, returned at q's dtype.  q (B, S1, H, hd), k/v (B, S2,
    KVH, hd); ``kv_len`` (B,) valid columns, ``q_offset`` (B,) absolute
    position of query row 0 (causal).  Returns (B, S1, H * hd)."""
    b, s1, h, hd = q.shape
    g = h // k.shape[2]
    heads = lambda x: x.repeat_interleave(g, 2).movedim(2, 1)
    if isinstance(q_offset, torch.Tensor):
        q_offset = q_offset.reshape(b, 1, 1, 1)    # (..., S1, 1) per row
    out = naive_attention(
        q.movedim(2, 1), heads(k), heads(v), causal=causal,
        kv_len=None if kv_len is None else kv_len.reshape(b, 1),
        q_offset=q_offset,
    )                                                  # (B, H, S1, hd) f32
    return out.to(q.dtype).movedim(1, 2).reshape(b, s1, h * hd)


def _dense_prefill(q, k, v, cfg: ModelConfig, cache: Optional[dict], *,
                   causal: bool = True) -> torch.Tensor:
    """Write rows [0, S) of the dense cache (if any), then attention over
    the fresh K/V, causal or not: GEMM-shift PASA, FlashAttention-2 or
    naive.  q (B, S1, H, hd), k/v (B, S2, KVH, hd) (S2 != S1 only for
    cross-attention, without a cache).  ``expand_kv`` (the reference's
    K/V layout flag) changes nothing here: the op reads K/V at KVH heads
    and maps query head h to kv head h // G in either layout."""
    ac = cfg.attention
    if not ac.use_gemm_shift:
        raise NotImplementedError(
            "the algebraic-shift dense prefill (use_gemm_shift=False) is not "
            "ported: no kernel computes it (ROADMAP A12b)"
        )
    b, s, h, hd = q.shape
    s2, kvh = k.shape[1], k.shape[2]
    if cache is not None:
        cache["k"][:, :s].copy_(k.reshape(b, s, kvh * hd))
        cache["v"][:, :s].copy_(v.reshape(b, s, kvh * hd))
    if ac.impl == "naive":
        return _naive(q, k, v, causal=causal)
    policy, beta = _policy_beta(cfg)
    # zero rows up to whole blocks (one query row: up to 64 rows)
    block_q = min(ac.block_kv, 64) if s == 1 and not causal else ac.block_kv
    pad_rows = lambda t, n: F.pad(t, (0, 0, 0, 0, 0, n)) if n else t
    q = pad_rows(q, (-s) % block_q)
    k, v = (pad_rows(t, (-s2) % ac.block_kv) for t in (k, v))
    args = (q.movedim(2, 1), k.movedim(2, 1), v.movedim(2, 1))
    # causal, no real row sees a pad column; otherwise the op masks them
    blocks = dict(block_q=block_q, block_kv=ac.block_kv, causal=causal,
                  kv_valid=None if causal else s2)
    # the kernels forward; under autograd the plain version's gradient
    out = kernel_attention(*args, flash=ac.impl == "flash", beta=beta,
                           policy=policy, **blocks)    # (B, H, S_pad, hd)
    return out[:, :, :s].movedim(1, 2).reshape(b, s, h * hd)


def _dense_decode(q, k, v, cfg: ModelConfig, cache: dict,
                  pos: torch.Tensor) -> torch.Tensor:
    """Write row ``pos`` of the dense cache, then decode over ``pos + 1``
    rows.  q (B, 1, H, hd), k/v (B, 1, KVH, hd)."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    if s != 1:
        raise ValueError(f"dense decode takes one token per row, got {s}")
    ck, cv = cache["k"], cache["v"]
    rows = torch.arange(b, device=q.device)
    ck.index_put_((rows, pos.long()), k.reshape(b, kvh * hd).to(ck.dtype))
    cv.index_put_((rows, pos.long()), v.reshape(b, kvh * hd).to(cv.dtype))
    s2 = ck.shape[1]
    if cfg.attention.impl == "naive":
        cd = q.dtype
        return _naive(q, ck.view(b, s2, kvh, hd).to(cd),
                      cv.view(b, s2, kvh, hd).to(cd), causal=False,
                      kv_len=pos + 1)
    policy, beta = _policy_beta(cfg)
    out = ops.pasa_decode(
        q.reshape(b, kvh, h // kvh, hd),
        ck.view(b, s2, kvh, hd).transpose(1, 2),
        cv.view(b, s2, kvh, hd).transpose(1, 2),
        pos + 1, beta=beta, policy=policy, block_kv=cfg.attention.block_kv,
    )                                                  # (B, KVH, G, hd)
    return out.reshape(b, 1, h * hd)


def _paged(q, k, v, cfg: ModelConfig, cache: dict, pos, page_table,
           prefill_cache: bool, prefill_len) -> torch.Tensor:
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    ck, cv = cache["k"], cache["v"]
    n_pages, page = ck.shape[0], ck.shape[1]
    k_pages = ck.view(n_pages, page, kvh, hd)
    v_pages = cv.view(n_pages, page, kvh, hd)
    naive = cfg.attention.impl == "naive"
    if not naive:
        policy, beta = _policy_beta(cfg)
    quantized = "k_scale" in cache
    sidecars = {}
    if quantized:
        sidecars = dict(
            k_scale=cache["k_scale"],
            k_shift=cache["k_shift"].view(n_pages, kvh, hd),
            v_scale=cache["v_scale"],
            v_shift=cache["v_shift"].view(n_pages, kvh, hd),
        )
    if prefill_cache:
        if prefill_len is None:
            raise ValueError("paged prefill needs prefill_len")
        mp = page_table.shape[1]
        positions = pos[:, None] + torch.arange(
            s, dtype=torch.int32, device=q.device
        )[None, :]                                     # (B, S)
        limit = prefill_len.to(torch.int32)
        valid = positions < limit[:, None]
        if quantized:
            _write_pages_quantized(k, v, cfg, cache, pos, page_table, valid)
        else:
            pidx = torch.clamp(positions // page, max=mp - 1).long()
            slot = (positions % page).long()
            phys = torch.gather(page_table.long(), 1, pidx)
            # pad positions (past the real chunk) land in the null write sink
            phys = torch.where(valid, phys, NULL_PAGE)
            idx = (phys.reshape(-1), slot.reshape(-1))
            ck.index_put_(idx, k.reshape(b * s, kvh * hd).to(ck.dtype))
            cv.index_put_(idx, v.reshape(b * s, kvh * hd).to(cv.dtype))
        if naive:
            kg, vg = _gathered(cache, page_table, kvh, hd, q.dtype)
            return _naive(q, kg, vg, causal=True, kv_len=limit, q_offset=pos)
        out = ops.pasa_paged_prefill(
            q.movedim(2, 1), k_pages, v_pages, page_table, pos, limit,
            beta=beta, policy=policy, **sidecars,
        )                                              # (B, H, S, hd)
        return out.movedim(1, 2).reshape(b, s, h * hd)
    if s != 1:
        raise ValueError(f"paged decode takes one token per row, got {s}")
    rows = torch.arange(b, device=q.device)
    phys = page_table[rows, (pos // page).long()].long()
    slot = (pos % page).long()
    if quantized:
        _requantize_tail_pages(k, v, cfg, cache, phys, slot)
    else:
        ck.index_put_((phys, slot), k.reshape(b, kvh * hd).to(ck.dtype))
        cv.index_put_((phys, slot), v.reshape(b, kvh * hd).to(cv.dtype))
    if naive:
        kg, vg = _gathered(cache, page_table, kvh, hd, q.dtype)
        return _naive(q, kg, vg, causal=False, kv_len=pos + 1)
    out = ops.pasa_paged_decode(
        q.reshape(b, kvh, h // kvh, hd), k_pages, v_pages, page_table,
        pos + 1, beta=beta, policy=policy, block_kv=cfg.attention.block_kv,
        **sidecars,
    )                                                  # (B, KVH, G, hd)
    return out.reshape(b, 1, h * hd)


def _gathered(cache: dict, page_table, kvh: int, hd: int, dtype):
    """The pages of each row's table gathered in order (dequantized in
    f32 for a quantized pool) at ``dtype``: (B, max_pages * page, KVH, hd)
    K and V, as the reference's paged branches gather them."""
    out = []
    for side in ("k", "v"):
        if f"{side}_scale" in cache:
            x = gather_pages_dequant(cache[side], cache[f"{side}_scale"],
                                     cache[f"{side}_shift"], page_table)
        else:
            x = gather_pages(cache[side], page_table)
        out.append(x.reshape(*x.shape[:2], kvh, hd).to(dtype))
    return out


def _write_pages_quantized(k, v, cfg: ModelConfig, cache: dict, pos,
                           page_table, valid) -> None:
    """Quantize a prefill chunk's K/V per page and write codes and
    sidecars into the pool in place.  k/v (B, S, KVH, hd); valid (B, S).
    The chunk start ``pos`` must be page-aligned (the engine's chunks are
    page multiples starting from 0); it is a device tensor and is not
    checked here."""
    b, s, kvh, hd = k.shape
    page = cache["k"].shape[1]
    mp = page_table.shape[1]
    if s % page:
        raise ValueError(
            f"quantized pool needs page-multiple chunks ({s} % {page})"
        )
    n_cp = s // page
    validp = valid.reshape(b, n_cp, page)
    page_idx = (pos[:, None] // page + torch.arange(
        n_cp, dtype=torch.int32, device=k.device)[None, :]).long()
    phys = torch.gather(page_table.long(), 1, torch.clamp(page_idx, max=mp - 1))
    # all-pad pages (past the real chunk) land in the null write sink
    phys = torch.where(validp.any(-1), phys, NULL_PAGE).reshape(-1)
    for side, x in (("k", k), ("v", v)):
        codes, scale, shift = quantize_kv_page(
            x.float().reshape(b, n_cp, page, kvh, hd), validp,
            cache[side].dtype, scale_mode=cfg.attention.kv_quant_scale,
        )
        cache[side].index_put_((phys,), codes.reshape(b * n_cp, page, kvh * hd))
        cache[f"{side}_scale"].index_put_((phys,), scale.reshape(-1, kvh))
        cache[f"{side}_shift"].index_put_((phys,), shift.reshape(-1, kvh * hd))


def _requantize_tail_pages(k, v, cfg: ModelConfig, cache: dict, phys,
                           slot) -> None:
    """Append one decode row per sequence to its tail page ``phys`` at
    ``slot``: dequantize the page, splice the row in, re-quantize over rows
    0..slot and write codes and sidecars back in place.  Earlier rows of
    the tail page are rounded again (bounded drift); full pages written by
    prefill never pass through here.  k/v (B, 1, KVH, hd)."""
    b, _, kvh, hd = k.shape
    page = cache["k"].shape[1]
    sl = torch.arange(page, device=k.device)[None, :]          # (1, page)
    is_new = (sl == slot[:, None])[..., None, None]            # (B, page, 1, 1)
    valid_rows = sl <= slot[:, None]                           # (B, page)
    for side, x in (("k", k), ("v", v)):
        codes, scale, shift = (cache[side], cache[f"{side}_scale"],
                               cache[f"{side}_shift"])
        old = dequantize_kv_page(
            codes[phys].reshape(b, page, kvh, hd),
            scale[phys], shift[phys].reshape(b, kvh, hd),
        )
        raw = torch.where(is_new, x.float().reshape(b, 1, kvh, hd), old)
        qc, qs, qh = quantize_kv_page(
            raw, valid_rows, codes.dtype,
            scale_mode=cfg.attention.kv_quant_scale,
        )
        codes.index_put_((phys,), qc.reshape(b, page, kvh * hd))
        scale.index_put_((phys,), qs)
        shift.index_put_((phys,), qh.reshape(b, kvh * hd))
