"""Multi-modal backbones: Llama-3.2-Vision (vlm) and Whisper (audio
encoder-decoder), the reference's ``repro.models.multimodal``.

The modality front ends are stubs, as in the reference:
``vision_embeds`` (B, n_image_tokens, vision_dim) stand for the vision
tower's patch embeddings and ``frames`` (B, n_audio_frames, d_model) for
the conv front end's output; the transformer backbones are implemented.
Cross-attention (S1 != S2) is the paper's Stable-Video-Diffusion overflow
case, so the PASA switch covers it: ``models.attention.attention`` with
``cross_x`` (non-causal, no RoPE, the keys padded to whole blocks and
masked past them by the op's ``kv_valid``; the cross K/V projected one
sequence at a time).

Llama-3.2-Vision: ``n_layers`` decoder layers, layer i an image
cross-attention layer iff i % cross_attn_every == 0, walked in groups of
one cross layer and ``cross_attn_every - 1`` self layers (the
reference's scan over groups is a loop here).  The cross layers'
residuals are gated by tanh(``gate_attn``) and tanh(``gate_mlp``), taken
at fp32 and then cast to the activation dtype.  The serve cache holds
the self layers' K/V only, (G, per, B, max_len, kv_dim); as in the
reference, every step projects ``vision_embeds`` through ``vision_proj``
again, and every cross layer its K/V (nothing about the image is
cached).  ``vision_proj`` runs one sequence at a time, so that a
sequence's image tokens do not depend on how many sequences share the
call.

Whisper: the encoder is ``n_encoder_layers`` bidirectional
self-attention layers over the frames (no RoPE; learned positions
``pos_embed``); the decoder is ``n_layers`` layers of causal
self-attention on the dense KV cache and a cross-attention over the
encoder output (1,500 keys).  The serve cache is the reference's dict:
``k``, ``v`` of (L, B, max_len, kv_dim) and ``enc_out`` (B, frames,
d_model) at the cache dtype.  As in the reference, the cross K/V are
projected from ``enc_out`` again in every layer at every step, and
``whisper_init_cache`` leaves ``enc_out`` at zeros: a caller that wants
real audio encodes it with :func:`whisper_encode` and writes the result
into ``cache["enc_out"]``.

Each decode step writes the self-attention K/V rows in place, as the
dense family's.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models.transformer import _layer


# =============================================================================
# Llama-3.2-Vision
# =============================================================================

def _n_groups(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.cross_attn_every


def _self_block(x, p: dict, cfg: ModelConfig, *, cache=None, pos=None):
    cd = cfg.torch_compute_dtype()
    h = attn_mod.attention(
        L.rms_norm(x, p["ln1"], cfg.norm_eps), p["attn"], cfg,
        causal=True, cache=cache, pos=pos,
    )
    x = x + h.to(x.dtype)
    x = x + L.mlp(L.rms_norm(x, p["ln2"], cfg.norm_eps), p["mlp"], cd).to(
        x.dtype
    )
    return x


def _cross_block(x, p: dict, cfg: ModelConfig, vis: torch.Tensor):
    """One image cross-attention layer over ``vis`` (B, n_image_tokens,
    d_model), its attention and MLP residuals gated by tanh of the fp32
    gates."""
    cd = cfg.torch_compute_dtype()
    h = attn_mod.attention(
        L.rms_norm(x, p["ln1"], cfg.norm_eps), p["attn"], cfg,
        causal=False, cross_x=vis, use_rope=False,
    )
    x = x + torch.tanh(p["gate_attn"]).to(x.dtype) * h.to(x.dtype)
    ff = L.mlp(L.rms_norm(x, p["ln2"], cfg.norm_eps), p["mlp"], cd)
    return x + torch.tanh(p["gate_mlp"]).to(x.dtype) * ff.to(x.dtype)


def project_vision(params: dict, cfg: ModelConfig,
                   vision_embeds: torch.Tensor) -> torch.Tensor:
    """vision_embeds (B, n_image_tokens, vision_dim) @ vision_proj at the
    compute dtype, one sequence at a time -> (B, n_image_tokens, d_model)."""
    cd = cfg.torch_compute_dtype()
    w = params["vision_proj"].to(cd)
    return torch.stack([L.matmuls(v.to(cd), w)[0] for v in vision_embeds])


def vlm_forward(params: dict, cfg: ModelConfig, tokens, vision_embeds, *,
                cache=None, pos=None):
    """tokens (B, S), vision_embeds (B, n_image_tokens, vision_dim) ->
    (final hidden states (B, S, D), cache): the whole sequence without a
    cache (causal self-attention over the fresh K/V), or one decode step
    at ``pos`` that writes every self layer's K/V row of ``cache`` ({"k",
    "v"} of (G, per, B, max_len, kv_dim)) in place."""
    cd = cfg.torch_compute_dtype()
    x = L.embed(tokens, params["embed"], cd)
    vis = project_vision(params, cfg, vision_embeds)
    for gi in range(_n_groups(cfg)):
        x = _cross_block(x, _layer(params["cross"], gi), cfg, vis)
        sp = _layer(params["self"], gi)
        for j in range(cfg.cross_attn_every - 1):
            lc = None if cache is None else {"k": cache["k"][gi, j],
                                             "v": cache["v"][gi, j]}
            x = _self_block(x, _layer(sp, j), cfg, cache=lc, pos=pos)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), cache


def vlm_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, *, device) -> dict:
    """The serve cache: the self layers' k, v of (G, per, B, max_len,
    kv_dim), zeros at ``dtype`` (the cross layers cache nothing)."""
    shape = (_n_groups(cfg), cfg.cross_attn_every - 1, batch, max_len,
             cfg.kv_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def vlm_serve_step(params: dict, cfg: ModelConfig, token, pos, cache: dict,
                   vision_embeds: torch.Tensor):
    """One decode step: token (B,), pos (B,), vision_embeds (B,
    n_image_tokens, vision_dim) -> (logits (B, V) fp32, cache)."""
    h, _ = vlm_forward(params, cfg, token[:, None], vision_embeds,
                       cache=cache, pos=pos)
    return L.matmuls(h[:, 0].float(), params["lm_head"].float())[0], cache


# =============================================================================
# Whisper (encoder-decoder)
# =============================================================================


def whisper_encode(params: dict, cfg: ModelConfig,
                   frames: torch.Tensor) -> torch.Tensor:
    """frames (B, n_audio_frames, d_model) -> encoder output (B, frames,
    d_model) at the compute dtype."""
    cd = cfg.torch_compute_dtype()
    x = frames.to(cd) + params["pos_embed"].to(cd)[None]
    for i in range(cfg.n_encoder_layers):
        lp = _layer(params["enc"], i)
        h = attn_mod.attention(
            L.rms_norm(x, lp["ln1"], cfg.norm_eps), lp["attn"], cfg,
            causal=False, use_rope=False,
        )
        x = x + h.to(x.dtype)
        ff = L.mlp(L.rms_norm(x, lp["ln2"], cfg.norm_eps), lp["mlp"], cd)
        x = x + ff.to(x.dtype)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _dec_block(x, lp: dict, cfg: ModelConfig, enc_out, *, cache=None,
               pos=None):
    cd = cfg.torch_compute_dtype()
    h = attn_mod.attention(
        L.rms_norm(x, lp["ln1"], cfg.norm_eps), lp["self_attn"], cfg,
        causal=True, cache=cache, pos=pos,
    )
    x = x + h.to(x.dtype)
    h = attn_mod.attention(
        L.rms_norm(x, lp["ln_x"], cfg.norm_eps), lp["cross_attn"], cfg,
        causal=False, cross_x=enc_out, use_rope=False,
    )
    x = x + h.to(x.dtype)
    ff = L.mlp(L.rms_norm(x, lp["ln2"], cfg.norm_eps), lp["mlp"], cd)
    return x + ff.to(x.dtype)


def whisper_decode_fwd(params: dict, cfg: ModelConfig, tokens, enc_out, *,
                       cache=None, pos=None):
    """tokens (B, S) -> (final hidden states (B, S, D), cache): the whole
    sequence without a cache (causal self-attention over the fresh K/V),
    or one decode step at ``pos`` that writes every layer's K/V row of
    ``cache`` ({"k", "v"} of (L, B, max_len, kv_dim)) in place."""
    cd = cfg.torch_compute_dtype()
    x = L.embed(tokens, params["embed"], cd)
    for i in range(cfg.n_layers):
        lc = None if cache is None else {"k": cache["k"][i],
                                         "v": cache["v"][i]}
        x = _dec_block(x, _layer(params["dec"], i), cfg, enc_out, cache=lc,
                       pos=pos)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), cache


def whisper_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16, *, device) -> dict:
    """The serve cache: self-attention k, v of (L, B, max_len, kv_dim) and
    the encoder output ``enc_out`` (B, frames, d_model), all zeros at
    ``dtype``."""
    shape = (cfg.n_layers, batch, max_len, cfg.kv_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "enc_out": torch.zeros((batch, cfg.n_audio_frames, cfg.d_model),
                               dtype=dtype, device=device),
    }


def whisper_serve_step(params: dict, cfg: ModelConfig, token, pos,
                       cache: dict):
    """One decode step: token (B,), pos (B,) -> (logits (B, V) fp32,
    cache), attending over ``cache["enc_out"]`` at the compute dtype."""
    enc_out = cache["enc_out"].to(cfg.torch_compute_dtype())
    h, _ = whisper_decode_fwd(params, cfg, token[:, None], enc_out,
                              cache=cache, pos=pos)
    return L.matmuls(h[:, 0].float(), params["lm_head"].float())[0], cache
