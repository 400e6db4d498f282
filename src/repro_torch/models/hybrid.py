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

The family is served token by token on the dense cache (``serve_step``);
the fused prefill (``prefill_cache=True``) is not ported: the reference's
branch hands back the incoming Mamba state unchanged, so the state after
a fused prefill would be wrong, and it would run the attention kernel at
head_dim 64, which the card does not have.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.transformer import _layer


def n_shared_apps(cfg: ModelConfig) -> int:
    return (cfg.n_layers + cfg.attn_every - 1) // cfg.attn_every


def _shared_block(x, p: dict, cfg: ModelConfig, *, cache=None, pos=None):
    cd = cfg.torch_compute_dtype()
    h = attn_mod.attention(
        L.rms_norm(x, p["ln1"], cfg.norm_eps), p["attn"], cfg,
        cache=cache, pos=pos,
    )
    x = x + h.to(x.dtype)
    x = x + L.mlp(L.rms_norm(x, p["ln2"], cfg.norm_eps), p["mlp"], cd).to(
        x.dtype
    )
    return x


def _segments(cfg: ModelConfig):
    """Mamba-layer runs separated by shared-block applications."""
    bounds = list(range(0, cfg.n_layers, cfg.attn_every)) + [cfg.n_layers]
    return [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]


def _walk(params: dict, cfg: ModelConfig, x, *, cache=None, pos=None):
    """The layer walk: without a cache the whole sequence (causal
    attention over the fresh K/V, chunked SSD); with one, a decode step at
    ``pos`` that writes every application's K/V row and every layer's
    Mamba state in place."""
    for app_idx, (lo, hi) in enumerate(_segments(cfg)):
        ac = None
        if cache is not None:
            ac = {"k": cache["attn"]["k"][app_idx],
                  "v": cache["attn"]["v"][app_idx]}
        x = _shared_block(x, params["shared"], cfg, cache=ac, pos=pos)
        for i in range(lo, hi):
            lp = _layer(params["mamba"], i)
            lc = None
            if cache is not None:
                lc = {"conv": cache["mamba"]["conv"][i],
                      "ssm": cache["mamba"]["ssm"][i]}
            y, _ = ssm.mamba2_block(
                L.rms_norm(x, params["mamba_ln"][i], cfg.norm_eps), lp, cfg,
                cache=lc)
            x = x + y.to(x.dtype)
    return x


def forward(params: dict, cfg: ModelConfig, tokens, *, cache=None, pos=None,
            prefill_cache: bool = False):
    """tokens (B, S) -> (final hidden states (B, S, D), cache): the whole
    sequence without a cache, or one decode step at ``pos`` against it."""
    if prefill_cache:
        raise NotImplementedError(
            "the hybrid family's fused prefill is not ported (ROADMAP.md C: "
            "the reference's prefill_cache branch keeps the incoming Mamba "
            "state); serve it token by token through serve_step"
        )
    cd = cfg.torch_compute_dtype()
    x = L.embed(tokens, params["embed"], cd)
    x = _walk(params, cfg, x, cache=cache, pos=pos)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), cache


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
