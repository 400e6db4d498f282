"""Zamba2-style hybrid: Mamba-2 backbone + one weight-shared attention block.

Counterpart of ``repro.models.hybrid``.  A single (weight-tied)
transformer block (attention + MLP) is applied before layers 0,
attn_every, 2*attn_every, ... of the Mamba-2 stack (the per-occurrence
LoRA deltas of the real model are omitted, as in the reference).  PASA
applies to the shared attention block (``models.attention.attention``,
through ``cfg.attention.impl``); the mamba blocks are attention-free
(``models.ssm``).

Each shared-block *application* has its own KV cache (same weights,
different activations), so the serve cache carries (n_apps, B, max_len,
kv_dim); a decode step hands application ``a`` its (B, max_len, kv_dim)
slice, which the attention layer writes in place, as the dense family's
per-layer cache.  The Mamba state (conv window and SSM state per layer)
is written in place too.

Training (``loss_fn``) walks the whole sequence without a cache, each
Mamba layer recomputed in the backward when ``cfg.remat`` (the shared
block is not, as in the reference).  The family is served token by token
on the dense cache (``serve_step``).  The fused prefill
(``forward(..., prefill_cache=True)``) is the reference's branch as it
stands: the whole sequence through every layer, each shared-block
application writing the prompt's K/V rows into its cache slice, and the
incoming Mamba state handed back unchanged (ROADMAP C: the state after a
fused prefill is not the prompt's); nothing serves through it, as the
reference's bundle has no ``prefill``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.convert import gather_params
from repro_torch.models.transformer import _layer


def n_shared_apps(cfg: ModelConfig) -> int:
    return (cfg.n_layers + cfg.attn_every - 1) // cfg.attn_every


def _shared_block(x, p: dict, cfg: ModelConfig, *, cache=None, pos=None,
                  prefill_cache: bool = False):
    cd = cfg.torch_compute_dtype()
    h = attn_mod.attention(
        L.rms_norm(x, p["ln1"], cfg.norm_eps), p["attn"], cfg,
        cache=cache, pos=pos, prefill_cache=prefill_cache,
    )
    x = x + h.to(x.dtype)
    x = x + L.mlp(L.rms_norm(x, p["ln2"], cfg.norm_eps), p["mlp"], cd,
                  cfg.d_ff).to(x.dtype)
    return x


def _segments(cfg: ModelConfig):
    """Mamba-layer runs separated by shared-block applications."""
    bounds = list(range(0, cfg.n_layers, cfg.attn_every)) + [cfg.n_layers]
    return [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]


def _walk(params: dict, cfg: ModelConfig, x, *, cache=None, pos=None,
          prefill_cache: bool = False):
    """The layer walk: without a cache the whole sequence (causal
    attention over the fresh K/V, chunked SSD); with one, a decode step at
    ``pos`` that writes every application's K/V row and every layer's
    Mamba state in place, or (``prefill_cache``) the whole sequence
    writing every application's rows [0, S) and no Mamba state.  The
    shared block is gathered once (``convert.gather_params``), each Mamba
    layer inside its own call."""
    shared = gather_params(params["shared"], ("shared",), cfg)
    for app_idx, (lo, hi) in enumerate(_segments(cfg)):
        ac = None
        if cache is not None:
            ac = {"k": cache["attn"]["k"][app_idx],
                  "v": cache["attn"]["v"][app_idx]}
        x = _shared_block(x, shared, cfg, cache=ac, pos=pos,
                          prefill_cache=prefill_cache)
        for i in range(lo, hi):
            lp = _layer(params["mamba"], i)
            if cache is None:
                x = L.remat(cfg, _mamba_layer, x, lp, params["mamba_ln"][i],
                            cfg)
            elif prefill_cache:
                x = _mamba_layer(x, lp, params["mamba_ln"][i], cfg)
            else:
                lc = {"conv": cache["mamba"]["conv"][i],
                      "ssm": cache["mamba"]["ssm"][i]}
                x = _mamba_layer(x, lp, params["mamba_ln"][i], cfg, lc)
    return x


def _mamba_layer(x, lp: dict, ln, cfg: ModelConfig, cache=None):
    """One pre-norm residual Mamba-2 layer (``lp``: this process's blocks,
    gathered here)."""
    lp = gather_params(lp, ("mamba",), cfg, lead=1)
    y, _ = ssm.mamba2_block(L.rms_norm(x, ln, cfg.norm_eps), lp, cfg,
                            cache=cache)
    return x + y.to(x.dtype)


def forward(params: dict, cfg: ModelConfig, tokens, *, cache=None, pos=None,
            prefill_cache: bool = False):
    """tokens (B, S) -> (final hidden states (B, S, D), cache): the whole
    sequence without a cache, one decode step at ``pos`` against it, or
    (``prefill_cache``) the whole sequence writing the attention rows
    [0, S) of the cache, its Mamba state handed back as it came."""
    cd = cfg.torch_compute_dtype()
    x = L.embed(tokens, gather_params(params["embed"], ("embed",), cfg), cd,
                cfg.vocab_size)
    x = _walk(params, cfg, x, cache=cache, pos=pos,
              prefill_cache=prefill_cache)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), cache


def loss_fn(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` (B, S + 1)."""
    tokens = batch["tokens"]
    h, _ = forward(params, cfg, tokens[:, :-1])
    return L.lm_loss_chunked(
        h, gather_params(params["lm_head"], ("lm_head",), cfg),
        batch.get("labels", tokens[:, 1:]), chunk=cfg.loss_chunk,
        vocab=cfg.vocab_size,
    )


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device) -> dict:
    """The serve cache: per application k, v of (apps, B, max_len, kv_dim)
    at ``dtype``, and the Mamba state of every layer (``ssm.mamba2_cache``)."""
    shape = (n_shared_apps(cfg), batch, max_len, cfg.kv_dim)
    return {
        "attn": {"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device)},
        "mamba": ssm.mamba2_cache(cfg, cfg.n_layers, batch, dtype,
                                  device=device),
    }


def serve_step(params: dict, cfg: ModelConfig, token, pos, cache: dict):
    """One decode step: token (B,), pos (B,) -> (logits (B, V) fp32, cache)."""
    h, cache = forward(params, cfg, token[:, None], cache=cache, pos=pos)
    return L.matmuls(h[:, 0].float(), params["lm_head"].float())[0], cache
