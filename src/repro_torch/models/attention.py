"""GQA attention of the dense family, paged serving branches.

Counterpart of the paged-prefill and paged-decode branches of
``repro.models.attention.attention`` (raw pools).  Both write the step's
K/V into the layer's page pool IN PLACE first and then attend through the
page table with a kernel op - the pool is never gathered on the card:

  * prefill (``prefill_cache=True``): a prompt chunk per row at absolute
    positions ``pos + [0, S)``; positions at or past ``prefill_len`` write
    to the null page.  Queries keep the reference's full-head (B, H, S, D)
    layout and attend at the chunk-exact convention with shift blocks ==
    pages (``ops.pasa_paged_prefill``).
  * decode: one token per row written at ``pos``; the grouped (B, KVH, G,
    D) query attends over ``pos + 1`` positions at the ``shift_mask_valid``
    convention (``ops.pasa_paged_decode``).

The attention runs PASA at the policy and beta of ``cfg.attention`` (the
paper's fp16 allocation by default).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import get_policy
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, rope_angles
from repro_torch.runtime.paged_cache import NULL_PAGE


def attention(
    x: torch.Tensor,              # (B, S, D)
    p: dict,                      # one layer's attention params
    cfg: ModelConfig,
    *,
    cache: dict,                  # {"k", "v": (P, page, kv_dim)} this layer
    pos: torch.Tensor,            # (B,) write position / chunk start
    page_table: torch.Tensor,     # (B, max_pages) int32
    prefill_cache: bool = False,
    prefill_len: Optional[torch.Tensor] = None,   # (B,) valid KV after chunk
) -> torch.Tensor:
    cd = cfg.torch_compute_dtype()
    b, s, _ = x.shape
    h, kvh, hd, g = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.group
    x = x.to(cd)

    q = x @ p["wq"].to(cd)
    k = x @ p["wk"].to(cd)
    v = x @ p["wv"].to(cd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kvh, hd)
    v = v.reshape(b, s, kvh, hd)

    # RoPE at per-row absolute positions pos + [0, S)
    cos, sin = rope_angles(pos, s, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    ck, cv = cache["k"], cache["v"]
    n_pages, page = ck.shape[0], ck.shape[1]
    k_pages = ck.view(n_pages, page, kvh, hd)
    v_pages = cv.view(n_pages, page, kvh, hd)
    policy, beta = get_policy(cfg.attention.pasa_policy), cfg.attention.beta
    pos = pos.to(torch.int32)
    if prefill_cache:
        if prefill_len is None:
            raise ValueError("paged prefill needs prefill_len")
        mp = page_table.shape[1]
        positions = pos[:, None] + torch.arange(
            s, dtype=torch.int32, device=x.device
        )[None, :]                                     # (B, S)
        limit = prefill_len.to(torch.int32)
        valid = positions < limit[:, None]
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
            beta=beta, policy=policy,
        )                                              # (B, H, S, hd)
        out = out.movedim(1, 2).reshape(b, s, h * hd)
    else:
        if s != 1:
            raise ValueError(f"paged decode takes one token per row, got {s}")
        rows = torch.arange(b, device=x.device)
        phys = page_table[rows, (pos // page).long()].long()
        slot = (pos % page).long()
        ck.index_put_((phys, slot), k.reshape(b, kvh * hd).to(ck.dtype))
        cv.index_put_((phys, slot), v.reshape(b, kvh * hd).to(cv.dtype))
        out = ops.pasa_paged_decode(
            q.reshape(b, kvh, g, hd), k_pages, v_pages, page_table, pos + 1,
            beta=beta, policy=policy, block_kv=cfg.attention.block_kv,
        )                                              # (B, KVH, G, hd)
        out = out.reshape(b, 1, h * hd)
    return out.to(cd) @ p["wo"].to(cd)
