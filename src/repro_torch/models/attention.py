"""GQA attention of the dense family: dense-cache and paged serving branches.

Counterpart of the cache branches of ``repro.models.attention.attention``
(raw caches).  Every branch writes the step's K/V into the layer's cache
IN PLACE first and then attends with a kernel op - a cache is never
gathered, cast or copied on the card:

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
    with shift blocks == pages (``ops.pasa_paged_prefill``).
  * paged decode: one token per row written at ``pos``, attending over
    ``pos + 1`` positions (``ops.pasa_paged_decode``).

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

The attention runs PASA at the policy and beta of ``cfg.attention`` (the
paper's fp16 allocation by default).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import get_policy
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, matmuls, rope_angles
from repro_torch.runtime.paged_cache import (
    NULL_PAGE,
    dequantize_kv_page,
    quantize_kv_page,
)


def attention(
    x: torch.Tensor,              # (B, S, D)
    p: dict,                      # one layer's attention params
    cfg: ModelConfig,
    *,
    cache: dict,                  # {"k", "v"}: this layer's (B, max_len,
                                  # kv_dim) dense cache or (P, page, kv_dim)
                                  # page pool (+ the sidecars of a
                                  # quantized pool)
    pos: Optional[torch.Tensor] = None,   # (B,) write position / chunk
                                          # start (None: dense prefill at 0)
    page_table: Optional[torch.Tensor] = None,    # (B, max_pages) -> paged
    prefill_cache: bool = False,
    prefill_len: Optional[torch.Tensor] = None,   # (B,) valid KV after chunk
) -> torch.Tensor:
    cd = cfg.torch_compute_dtype()
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = x.to(cd)

    q, k, v = matmuls(x, p["wq"].to(cd), p["wk"].to(cd), p["wv"].to(cd))
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kvh, hd)
    v = v.reshape(b, s, kvh, hd)

    # RoPE at per-row absolute positions pos + [0, S)
    if pos is None:
        pos = torch.zeros(b, dtype=torch.int32, device=x.device)
    pos = pos.to(torch.int32)
    cos, sin = rope_angles(pos, s, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if page_table is not None:
        out = _paged(q, k, v, cfg, cache, pos, page_table, prefill_cache,
                     prefill_len)
    elif prefill_cache:
        out = _dense_prefill(q, k, v, cfg, cache)
    else:
        out = _dense_decode(q, k, v, cfg, cache, pos)
    return matmuls(out.to(cd), p["wo"].to(cd))[0]


def _dense_prefill(q, k, v, cfg: ModelConfig, cache: dict) -> torch.Tensor:
    """Write rows [0, S) of the dense cache, then causal GEMM-shift PASA
    over the fresh K/V.  q (B, S, H, hd), k/v (B, S, KVH, hd)."""
    ac = cfg.attention
    if not (ac.use_gemm_shift and ac.expand_kv):
        raise NotImplementedError(
            "the dense prefill is ported for use_gemm_shift=True, "
            "expand_kv=True (the reference's defaults) only"
        )
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    cache["k"][:, :s].copy_(k.reshape(b, s, kvh * hd))
    cache["v"][:, :s].copy_(v.reshape(b, s, kvh * hd))
    pad = (-s) % ac.block_kv
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    out = ops.pasa_attention(
        q.movedim(2, 1), k.movedim(2, 1), v.movedim(2, 1),
        beta=ac.beta, policy=get_policy(ac.pasa_policy),
        block_q=ac.block_kv, block_kv=ac.block_kv, causal=True,
    )                                                  # (B, H, S_pad, hd)
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
    out = ops.pasa_decode(
        q.reshape(b, kvh, h // kvh, hd),
        ck.view(b, s2, kvh, hd).transpose(1, 2),
        cv.view(b, s2, kvh, hd).transpose(1, 2),
        pos + 1, beta=cfg.attention.beta,
        policy=get_policy(cfg.attention.pasa_policy),
        block_kv=cfg.attention.block_kv,
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
    policy, beta = get_policy(cfg.attention.pasa_policy), cfg.attention.beta
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
    out = ops.pasa_paged_decode(
        q.reshape(b, kvh, h // kvh, hd), k_pages, v_pages, page_table,
        pos + 1, beta=beta, policy=policy, block_kv=cfg.attention.block_kv,
        **sidecars,
    )                                                  # (B, KVH, G, hd)
    return out.reshape(b, 1, h * hd)


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
