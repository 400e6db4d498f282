"""build(cfg) -> ModelBundle (counterpart of ``repro.models.model_zoo``).

All six families are ported.  The dense family (qwen2-7b, the qwen3
configs with qk-norm, qwen1.5-32b) and the moe family (olmoe-1b-7b,
kimi-k2: the same bundle, each layer's FFN routed to experts) have both
serving routes: the dense route (``launch/serve.py``) needs
``init_cache``, ``serve_step`` and ``prefill``; the paged engine
``init_paged_cache``, ``paged_serve_step`` and ``paged_prefill_step``.
The hybrid family
(zamba2: Mamba-2 + a shared attention block) has the dense cache only,
served token by token: ``init_cache`` and ``serve_step``; its ``prefill``
and the three paged fields are None (its Mamba state is O(1) per
sequence, nothing to page), as in the reference.  The audio family
(Whisper) has the same two fields over its own cache (the decoder's
self-attention K/V and the encoder output ``enc_out``), and no prefill or
paged interface either, as in the reference.  The vlm family
(Llama-3.2-Vision) likewise, its ``serve_step`` taking the image input
as a keyword, ``serve_step(params, token, pos, cache, vision_embeds=...)``
(the reference's ``extra_serve_inputs``; ``launch.steps.make_serve_step``
passes such extras through).  The ssm family (falcon-mamba: Mamba-1, no
attention) serves from its O(1) state per sequence (``init_cache``
ignores ``max_len``), with no prefill or paged interface, as in the
reference; its layer walk, forward and serve step live here, as there.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import convert, hybrid, multimodal, ssm, transformer
from repro_torch.models import layers as L
from repro_torch.models.transformer import _layer


# =============================================================================
# Pure-SSM LM (falcon-mamba)
# =============================================================================

def _ssm_walk(params: dict, cfg: ModelConfig, x, cache=None):
    """The Mamba-1 layers, each a pre-norm residual block: without a cache
    the whole sequence; with one, a decode step that writes every layer's
    conv window and SSM state in place."""
    for i in range(cfg.n_layers):
        lc = None if cache is None else {"conv": cache["conv"][i],
                                         "ssm": cache["ssm"][i]}
        y, _ = ssm.mamba1_block(
            L.rms_norm(x, params["ln"][i], cfg.norm_eps),
            _layer(params["mamba"], i), cfg, cache=lc)
        x = x + y.to(x.dtype)
    return x


def _ssm_forward(params: dict, cfg: ModelConfig, tokens, *, cache=None):
    """tokens (B, S) -> (final hidden states (B, S, D), cache)."""
    x = L.embed(tokens, params["embed"], cfg.torch_compute_dtype())
    x = _ssm_walk(params, cfg, x, cache=cache)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), cache


def _ssm_serve_step(params: dict, cfg: ModelConfig, token, pos, cache: dict):
    """One decode step: token (B,) -> (logits (B, V) fp32, cache); ``pos``
    is not read (the state carries the position)."""
    h, cache = _ssm_forward(params, cfg, token[:, None], cache=cache)
    return L.matmuls(h[:, 0].float(), params["lm_head"].float())[0], cache


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    #   (generator, device) -> params
    init: Callable[..., dict]
    #   (batch, max_len, dtype=..., device=...) -> dense cache
    init_cache: Callable[..., dict]
    #   (params, token (B,), pos (B,), cache, **extras) -> (logits (B, V),
    #   cache); extras: the vlm's vision_embeds
    serve_step: Callable[..., tuple]
    #   (params, tokens (B, S), cache) -> (last-position logits (B, V), cache)
    #   Fused whole-prompt prefill on the dense cache; None: the dense
    #   route feeds the prompt token by token through serve_step.
    prefill: Optional[Callable[..., tuple]] = None
    #   (num_pages, page_size, dtype=..., device=...) -> pool (a quantized
    #   dtype adds the scale/shift sidecars)
    init_paged_cache: Optional[Callable[..., dict]] = None
    #   (params, token (B,), pos (B,), pool, page_table (B, mp))
    #   -> (logits (B, V), pool)
    paged_serve_step: Optional[Callable[..., tuple]] = None
    #   (params, tokens (B, CS), start (B,), kv_len (B,), last_idx (B,),
    #    pool, page_table (B, mp)) -> (logits (B, V), pool)
    paged_prefill_step: Optional[Callable[..., tuple]] = None

    @property
    def supports_paged(self) -> bool:
        return self.init_paged_cache is not None

    @property
    def supports_chunked_prefill(self) -> bool:
        return self.paged_prefill_step is not None


def build(cfg: ModelConfig) -> ModelBundle:
    cfg.validate()
    if cfg.family == "vlm":
        return ModelBundle(
            cfg=cfg,
            init=lambda generator, device=None: convert.init_vlm(
                cfg, generator, device
            ),
            init_cache=lambda batch, max_len, dtype=torch.bfloat16, *, device: (
                multimodal.vlm_init_cache(cfg, batch, max_len, dtype,
                                          device=device)
            ),
            serve_step=lambda p, t, pos, c, *, vision_embeds: (
                multimodal.vlm_serve_step(p, cfg, t, pos, c, vision_embeds)
            ),
        )
    if cfg.family == "ssm":
        return ModelBundle(
            cfg=cfg,
            init=lambda generator, device=None: convert.init_ssm(
                cfg, generator, device
            ),
            init_cache=lambda batch, max_len, dtype=torch.bfloat16, *, device: (
                ssm.mamba1_cache(cfg, batch, dtype, device=device)
            ),
            serve_step=lambda p, t, pos, c: _ssm_serve_step(p, cfg, t, pos, c),
        )
    if cfg.family == "hybrid":
        return ModelBundle(
            cfg=cfg,
            init=lambda generator, device=None: convert.init_hybrid(
                cfg, generator, device
            ),
            init_cache=lambda batch, max_len, dtype=torch.bfloat16, *, device: (
                hybrid.init_cache(cfg, batch, max_len, dtype, device=device)
            ),
            serve_step=lambda p, t, pos, c: hybrid.serve_step(
                p, cfg, t, pos, c
            ),
        )
    if cfg.family == "audio":
        return ModelBundle(
            cfg=cfg,
            init=lambda generator, device=None: convert.init_whisper(
                cfg, generator, device
            ),
            init_cache=lambda batch, max_len, dtype=torch.bfloat16, *, device: (
                multimodal.whisper_init_cache(cfg, batch, max_len, dtype,
                                              device=device)
            ),
            serve_step=lambda p, t, pos, c: multimodal.whisper_serve_step(
                p, cfg, t, pos, c
            ),
        )
    return ModelBundle(
        cfg=cfg,
        init=lambda generator, device=None: convert.init_lm(
            cfg, generator, device
        ),
        init_cache=lambda batch, max_len, dtype=torch.bfloat16, *, device: (
            transformer.init_cache(cfg, batch, max_len, dtype, device=device)
        ),
        serve_step=lambda p, t, pos, c: transformer.serve_step(
            p, cfg, t, pos, c
        ),
        prefill=lambda p, t, c: transformer.prefill_logits(p, cfg, t, c),
        init_paged_cache=lambda num_pages, page_size, dtype=torch.bfloat16, *,
        device: transformer.init_paged_cache(
            cfg, num_pages, page_size, dtype, device=device
        ),
        paged_serve_step=lambda p, t, pos, c, pt: transformer.serve_step_paged(
            p, cfg, t, pos, c, pt
        ),
        paged_prefill_step=lambda p, t, st, kvl, li, c, pt: (
            transformer.prefill_step_paged(p, cfg, t, st, kvl, li, c, pt)
        ),
    )
