"""Whisper (audio encoder-decoder): the Whisper half of the reference's
``repro.models.multimodal`` (Llama-3.2-Vision is not ported yet).

The modality front end is a stub, as in the reference: ``frames`` (B,
n_audio_frames, d_model) stand for the conv front end's output.  The
encoder is ``n_encoder_layers`` bidirectional self-attention layers over
the frames (no RoPE; learned positions ``pos_embed``); the decoder is
``n_layers`` layers of causal self-attention on the dense KV cache and a
cross-attention over the encoder output (``models.attention.attention``
with ``cross_x``: non-causal, no RoPE, 1,500 keys padded to whole blocks
and masked past them by the op's ``kv_valid``).

The serve cache is the reference's dict: ``k``, ``v`` of (L, B, max_len,
kv_dim) and ``enc_out`` (B, frames, d_model) at the cache dtype.  As in
the reference, the cross K/V are projected from ``enc_out`` again in
every layer at every step (they are not cached), and
``whisper_init_cache`` leaves ``enc_out`` at zeros: a caller that wants
real audio encodes it with :func:`whisper_encode` and writes the result
into ``cache["enc_out"]``.  Each step writes the self-attention K/V rows
in place, as the dense family's.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models.transformer import _layer


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
