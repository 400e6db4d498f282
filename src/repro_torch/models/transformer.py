"""Decoder-only transformer (the dense and moe families): dense-cache and
paged serving interfaces.

Counterpart of ``repro.models.transformer``: the parameter layout of
``init_lm`` (stacked ``(L, ...)`` leaves, ``y = x @ W`` orientation);
``init_cache``, ``forward``, ``prefill``, ``prefill_logits`` and
``serve_step`` on the dense cache; ``init_paged_cache``,
``serve_step_paged`` and ``prefill_step_paged`` on the page pool; fp32
``lm_head`` logits.  The reference scans the stacked layers; here a Python
loop indexes layer ``i`` of every stacked leaf (a view).  Every step
writes its cache in place and returns it.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.runtime.paged_cache import init_paged_pool


def _layer(tree: dict, i: int) -> dict:
    return {
        k: _layer(v, i) if isinstance(v, dict) else v[i]
        for k, v in tree.items()
    }


def _blocks(x, blocks: dict, cfg: ModelConfig, *, cache: dict, pos=None,
            page_table=None, prefill_cache=False, prefill_len=None):
    cd = cfg.torch_compute_dtype()
    for i in range(cfg.n_layers):
        lp = _layer(blocks, i)
        h = attn_mod.attention(
            L.rms_norm(x, lp["ln1"], cfg.norm_eps), lp["attn"], cfg,
            cache={name: leaf[i] for name, leaf in cache.items()}, pos=pos,
            page_table=page_table, prefill_cache=prefill_cache,
            prefill_len=prefill_len,
        )
        x = x + h.to(x.dtype)
        ff_in = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        if cfg.family == "moe":
            ff = moe_mod.moe_ffn(ff_in, lp["moe"], cfg)
        else:
            ff = L.mlp(ff_in, lp["mlp"], cd)
        x = x + ff.to(x.dtype)
    return x


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device) -> dict:
    """Dense KV cache for all layers: k, v of (L, batch, max_len, kv_dim)."""
    shape = (cfg.n_layers, batch, max_len, cfg.kv_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     dtype=torch.bfloat16, *, device) -> dict:
    """Physical page pool for all layers: (L, num_pages, page_size, kv_dim).
    Keep ``page_size == cfg.attention.block_kv`` (one page = one PASA
    shift block; the CUDA decode kernel requires it).  ``dtype`` may be a
    quantized pool dtype ("fp8_e4m3", "int8"): the pool then carries the
    per-(page, kv-head) scale/shift sidecars."""
    return init_paged_pool(
        cfg.n_layers, num_pages, page_size, cfg.kv_dim, dtype,
        n_kv_heads=cfg.n_kv_heads, device=device,
    )


def _logits(h: torch.Tensor, params: dict) -> torch.Tensor:
    return L.matmuls(h.float(), params["lm_head"].float())[0]


def forward(params, cfg: ModelConfig, tokens, *, cache: dict, pos=None,
            prefill_cache=False):
    """tokens (B, S) -> (final hidden states (B, S, D), cache) against the
    dense cache: a decode step at ``pos`` or, with ``prefill_cache``, the
    whole prompt written to rows [0, S)."""
    cd = cfg.torch_compute_dtype()
    x = L.embed(tokens, params["embed"], cd)
    x = _blocks(x, params["blocks"], cfg, cache=cache, pos=pos,
                prefill_cache=prefill_cache)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), cache


def serve_step(params, cfg: ModelConfig, token, pos, cache: dict):
    """One decode step: token (B,), pos (B,) -> (logits (B, V) fp32, cache)."""
    h, cache = forward(params, cfg, token[:, None], cache=cache, pos=pos)
    return _logits(h[:, 0], params), cache


def prefill(params, cfg: ModelConfig, tokens, cache: dict):
    """Prefill a dense cache; returns (hidden, filled cache)."""
    return forward(params, cfg, tokens, cache=cache, prefill_cache=True)


def prefill_logits(params, cfg: ModelConfig, tokens, cache: dict):
    """Fused whole-prompt prefill: (B, S) tokens -> (last-position logits
    (B, V) fp32, filled cache).  Its argmax is the first generated token;
    decode continues at pos == S."""
    h, cache = prefill(params, cfg, tokens, cache)
    return _logits(h[:, -1], params), cache


def serve_step_paged(params, cfg: ModelConfig, token, pos, cache: dict,
                     page_table):
    """One decode step against the paged pool: token (B,), pos (B,),
    page_table (B, max_pages) -> (logits (B, V) fp32, pool)."""
    cd = cfg.torch_compute_dtype()
    x = L.embed(token[:, None], params["embed"], cd)   # (B, 1, D)
    x = _blocks(x, params["blocks"], cfg, cache=cache, pos=pos,
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
    x = _blocks(x, params["blocks"], cfg, cache=cache, pos=start,
                page_table=page_table, prefill_cache=True, prefill_len=kv_len)
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    rows = torch.arange(h.shape[0], device=h.device)
    return _logits(h[rows, last_idx.long()], params), cache
