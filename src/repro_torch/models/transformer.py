"""Dense decoder-only transformer, paged serving interface.

Counterpart of ``repro.models.transformer``: the parameter layout of
``init_lm`` (stacked ``(L, ...)`` leaves, ``y = x @ W`` orientation),
``init_paged_cache``, ``serve_step_paged`` and ``prefill_step_paged``,
with fp32 ``lm_head`` logits.  The reference scans the stacked layers;
here a Python loop indexes layer ``i`` of every stacked leaf (a view).
Both steps write the page pool in place and return it.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.runtime.paged_cache import init_paged_pool


def _layer(tree: dict, i: int) -> dict:
    return {
        k: _layer(v, i) if isinstance(v, dict) else v[i]
        for k, v in tree.items()
    }


def _blocks(x, blocks: dict, cfg: ModelConfig, *, pool: dict, pos,
            page_table, prefill_cache=False, prefill_len=None):
    cd = cfg.torch_compute_dtype()
    for i in range(cfg.n_layers):
        lp = _layer(blocks, i)
        h = attn_mod.attention(
            L.rms_norm(x, lp["ln1"], cfg.norm_eps), lp["attn"], cfg,
            cache={"k": pool["k"][i], "v": pool["v"][i]}, pos=pos,
            page_table=page_table, prefill_cache=prefill_cache,
            prefill_len=prefill_len,
        )
        x = x + h.to(x.dtype)
        ff = L.mlp(L.rms_norm(x, lp["ln2"], cfg.norm_eps), lp["mlp"], cd)
        x = x + ff.to(x.dtype)
    return x


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     dtype=torch.bfloat16, *, device) -> dict:
    """Physical page pool for all layers: (L, num_pages, page_size, kv_dim).
    Keep ``page_size == cfg.attention.block_kv`` (one page = one PASA
    shift block; the CUDA decode kernel requires it)."""
    return init_paged_pool(
        cfg.n_layers, num_pages, page_size, cfg.kv_dim, dtype, device=device
    )


def _logits(h: torch.Tensor, params: dict) -> torch.Tensor:
    return h.float() @ params["lm_head"].float()


def serve_step_paged(params, cfg: ModelConfig, token, pos, cache: dict,
                     page_table):
    """One decode step against the paged pool: token (B,), pos (B,),
    page_table (B, max_pages) -> (logits (B, V) fp32, pool)."""
    cd = cfg.torch_compute_dtype()
    x = L.embed(token[:, None], params["embed"], cd)   # (B, 1, D)
    x = _blocks(x, params["blocks"], cfg, pool=cache, pos=pos,
                page_table=page_table)
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(h[:, 0], params), cache


def prefill_step_paged(params, cfg: ModelConfig, tokens, start, kv_len,
                       last_idx, cache: dict, page_table):
    """One chunked-prefill step against the paged pool.

    tokens (B, CS): one prompt chunk per row, right-padded (pad positions
    write to the null page); start (B,): absolute position of each row's
    first token; kv_len (B,): valid KV length after the chunk (0 for a
    dead pad row); last_idx (B,): the row of the chunk whose logits are
    returned.  Returns (logits (B, V) fp32, pool)."""
    cd = cfg.torch_compute_dtype()
    x = L.embed(tokens, params["embed"], cd)           # (B, CS, D)
    x = _blocks(x, params["blocks"], cfg, pool=cache, pos=start,
                page_table=page_table, prefill_cache=True, prefill_len=kv_len)
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    rows = torch.arange(h.shape[0], device=h.device)
    return _logits(h[rows, last_idx.long()], params), cache
