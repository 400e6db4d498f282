"""Decoder-only transformer (the dense and moe families): the training
forward and loss, and the dense-cache and paged serving interfaces.

Counterpart of ``repro.models.transformer``: the parameter layout of
``init_lm`` (stacked ``(L, ...)`` leaves, ``y = x @ W`` orientation);
``forward`` without a cache (whole sequences, causal) and ``loss_fn``;
``init_cache``, ``forward``, ``prefill``, ``prefill_logits`` and
``serve_step`` on the dense cache; ``init_paged_cache``,
``serve_step_paged`` and ``prefill_step_paged`` on the page pool; fp32
``lm_head`` logits.  The reference scans the stacked layers; here a Python
loop indexes layer ``i`` of every stacked leaf (a view).  Without a cache
each layer is recomputed in the backward when ``cfg.remat`` (the
reference's ``jax.checkpoint``).  Every step writes its cache in place and
returns it.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models.convert import gather_params
from repro_torch.runtime.paged_cache import init_paged_pool


def _layer(tree: dict, i: int) -> dict:
    return {
        k: _layer(v, i) if isinstance(v, dict) else v[i]
        for k, v in tree.items()
    }


def _unstack(tree: dict, n: int) -> list:
    """The n layers of a stacked tree, each a dict of (L, ...) -> (...)
    views.  One ``unbind`` per leaf: under autograd its backward stacks
    the layers' gradients once, where indexing layer by layer would
    scatter each into a zero tensor of the whole stack."""
    flat = {k: _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
            for k, v in tree.items()}
    return [{k: v[i] for k, v in flat.items()} for i in range(n)]


def _block(x, lp: dict, cfg: ModelConfig, *, cache=None, pos=None,
           page_table=None, prefill_cache=False, prefill_len=None):
    """One residual block: ln1 -> attention -> ln2 -> MLP or experts;
    ``lp`` is this process's blocks of the layer's parameters, gathered
    here (``convert.gather_params``)."""
    cd = cfg.torch_compute_dtype()
    lp = gather_params(lp, ("blocks",), cfg, lead=1)
    h = attn_mod.attention(
        L.rms_norm(x, lp["ln1"], cfg.norm_eps), lp["attn"], cfg,
        cache=cache, pos=pos, page_table=page_table,
        prefill_cache=prefill_cache, prefill_len=prefill_len,
    )
    x = x + h.to(x.dtype)
    ff_in = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        ff = moe_mod.moe_ffn(ff_in, lp["moe"], cfg)
    else:
        ff = L.mlp(ff_in, lp["mlp"], cd, cfg.d_ff)
    return x + ff.to(x.dtype)


def _blocks(x, blocks: dict, cfg: ModelConfig, *, cache=None, pos=None,
            page_table=None, prefill_cache=False, prefill_len=None):
    for i, lp in enumerate(_unstack(blocks, cfg.n_layers)):
        if cache is None:
            x = L.remat(cfg, _block, x, lp, cfg)
            continue
        x = _block(x, lp, cfg,
                   cache={name: leaf[i] for name, leaf in cache.items()},
                   pos=pos, page_table=page_table,
                   prefill_cache=prefill_cache, prefill_len=prefill_len)
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
    Any page size of 1 or more: paged decode shifts in blocks of
    ``cfg.attention.block_kv`` over the page-table view, paged prefill in
    one block a page (chunk-exact; the CUDA kernel takes pages of up to
    256 rows).  ``dtype`` may be a quantized pool dtype ("fp8_e4m3",
    "int8"): the pool then carries the per-(page, kv-head) scale/shift
    sidecars."""
    return init_paged_pool(
        cfg.n_layers, num_pages, page_size, cfg.kv_dim, dtype,
        n_kv_heads=cfg.n_kv_heads, device=device,
    )


def _logits(h: torch.Tensor, params: dict) -> torch.Tensor:
    return L.matmuls(h.float(), params["lm_head"].float())[0]


def forward(params, cfg: ModelConfig, tokens, *, cache: Optional[dict] = None,
            pos=None, prefill_cache=False):
    """tokens (B, S) -> (final hidden states (B, S, D), cache).  Without a
    cache the whole sequences, causal (training); against the dense cache
    a decode step at ``pos`` or, with ``prefill_cache``, the whole prompt
    written to rows [0, S)."""
    cd = cfg.torch_compute_dtype()
    x = L.embed(tokens, gather_params(params["embed"], ("embed",), cfg), cd,
                cfg.vocab_size)
    x = _blocks(x, params["blocks"], cfg, cache=cache, pos=pos,
                prefill_cache=prefill_cache)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), cache


def loss_fn(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` (B, S + 1)
    (``batch["labels"]`` (B, S), -1 ignored, if given)."""
    tokens = batch["tokens"]
    h, _ = forward(params, cfg, tokens[:, :-1])
    return L.lm_loss_chunked(
        h, gather_params(params["lm_head"], ("lm_head",), cfg),
        batch.get("labels", tokens[:, 1:]), chunk=cfg.loss_chunk,
        vocab=cfg.vocab_size,
    )


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
