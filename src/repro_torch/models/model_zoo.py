"""build(cfg) -> ModelBundle (counterpart of ``repro.models.model_zoo``).

All six families are ported, each with its training loss
(``loss_fn``; the vlm's and Whisper's batches carry the
``extra_train_inputs``) and its serving interface.  The dense family
(qwen2-7b, the qwen3 configs with qk-norm, qwen1.5-32b) and the moe
family (olmoe-1b-7b, kimi-k2: the same bundle, each layer's FFN routed
to experts) have both
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
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import convert, hybrid, multimodal, ssm, transformer
from repro_torch.models import layers as L
from repro_torch.models.convert import gather_params
from repro_torch.models.transformer import _layer


# =============================================================================
# Pure-SSM LM (falcon-mamba)
# =============================================================================

def _ssm_walk(params: dict, cfg: ModelConfig, x, cache=None):
    """The Mamba-1 layers, each a pre-norm residual block: without a cache
    the whole sequence (each layer recomputed in the backward when
    ``cfg.remat``); with one, a decode step that writes every layer's
    conv window and SSM state in place."""
    for i in range(cfg.n_layers):
        lp, ln = _layer(params["mamba"], i), params["ln"][i]
        if cache is None:
            x = L.remat(cfg, _ssm_layer, x, lp, ln, cfg)
        else:
            x = _ssm_layer(x, lp, ln, cfg, {"conv": cache["conv"][i],
                                            "ssm": cache["ssm"][i]})
    return x


def _ssm_layer(x, lp: dict, ln, cfg: ModelConfig, cache=None):
    lp = gather_params(lp, ("mamba",), cfg, lead=1)
    y, _ = ssm.mamba1_block(L.rms_norm(x, ln, cfg.norm_eps), lp, cfg,
                            cache=cache)
    return x + y.to(x.dtype)


def _ssm_forward(params: dict, cfg: ModelConfig, tokens, *, cache=None):
    """tokens (B, S) -> (final hidden states (B, S, D), cache)."""
    x = L.embed(tokens, gather_params(params["embed"], ("embed",), cfg),
                cfg.torch_compute_dtype(), cfg.vocab_size)
    x = _ssm_walk(params, cfg, x, cache=cache)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), cache


def _ssm_loss(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` (B, S + 1)."""
    tokens = batch["tokens"]
    h, _ = _ssm_forward(params, cfg, tokens[:, :-1])
    return L.lm_loss_chunked(
        h, gather_params(params["lm_head"], ("lm_head",), cfg),
        batch.get("labels", tokens[:, 1:]), chunk=cfg.loss_chunk,
        vocab=cfg.vocab_size,
    )


def _ssm_serve_step(params: dict, cfg: ModelConfig, token, pos, cache: dict):
    """One decode step: token (B,) -> (logits (B, V) fp32, cache); ``pos``
    is not read (the state carries the position)."""
    h, cache = _ssm_forward(params, cfg, token[:, None], cache=cache)
    return L.matmuls(h[:, 0].float(), params["lm_head"].float())[0], cache


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    #   (generator, device, dtype=None) -> params (every leaf at dtype
    #   when given: training's cfg.param_dtype)
    init: Callable[..., dict]
    #   (params, batch) -> () fp32 mean next-token cross-entropy; batch
    #   {"tokens": (B, S + 1)} and the family's extra_train_inputs
    loss_fn: Callable[[dict, dict], torch.Tensor]
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
    #   name -> ((batch, seq) -> shape, dtype): the training batch's inputs
    #   beside the tokens (the vlm's vision_embeds, Whisper's frame_embeds)
    extra_train_inputs: Dict[str, tuple] = dataclasses.field(
        default_factory=dict)

    def train_inputs(self, batch: int, seq: int) -> Dict[str, tuple]:
        """name -> (shape, dtype) of one training batch."""
        out = {"tokens": ((batch, seq + 1), torch.int32)}
        for name, (shape_fn, dt) in self.extra_train_inputs.items():
            out[name] = (shape_fn(batch, seq), dt)
        return out

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
            init=lambda generator, device=None, dtype=None: convert.init_vlm(
                cfg, generator, device, dtype
            ),
            loss_fn=lambda p, b: multimodal.vlm_loss_fn(p, cfg, b),
            init_cache=lambda batch, max_len, dtype=torch.bfloat16, *, device: (
                multimodal.vlm_init_cache(cfg, batch, max_len, dtype,
                                          device=device)
            ),
            serve_step=lambda p, t, pos, c, *, vision_embeds: (
                multimodal.vlm_serve_step(p, cfg, t, pos, c, vision_embeds)
            ),
            extra_train_inputs={"vision_embeds": (
                lambda b, s: (b, cfg.n_image_tokens, cfg.vision_dim),
                torch.bfloat16)},
        )
    if cfg.family == "ssm":
        return ModelBundle(
            cfg=cfg,
            init=lambda generator, device=None, dtype=None: convert.init_ssm(
                cfg, generator, device, dtype
            ),
            loss_fn=lambda p, b: _ssm_loss(p, cfg, b),
            init_cache=lambda batch, max_len, dtype=torch.bfloat16, *, device: (
                ssm.mamba1_cache(cfg, batch, dtype, device=device)
            ),
            serve_step=lambda p, t, pos, c: _ssm_serve_step(p, cfg, t, pos, c),
        )
    if cfg.family == "hybrid":
        return ModelBundle(
            cfg=cfg,
            init=lambda generator, device=None, dtype=None: (
                convert.init_hybrid(cfg, generator, device, dtype)
            ),
            loss_fn=lambda p, b: hybrid.loss_fn(p, cfg, b),
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
            init=lambda generator, device=None, dtype=None: (
                convert.init_whisper(cfg, generator, device, dtype)
            ),
            loss_fn=lambda p, b: multimodal.whisper_loss_fn(p, cfg, b),
            init_cache=lambda batch, max_len, dtype=torch.bfloat16, *, device: (
                multimodal.whisper_init_cache(cfg, batch, max_len, dtype,
                                              device=device)
            ),
            serve_step=lambda p, t, pos, c: multimodal.whisper_serve_step(
                p, cfg, t, pos, c
            ),
            extra_train_inputs={"frame_embeds": (
                lambda b, s: (b, cfg.n_audio_frames, cfg.d_model),
                torch.bfloat16)},
        )
    return ModelBundle(
        cfg=cfg,
        init=lambda generator, device=None, dtype=None: convert.init_lm(
            cfg, generator, device, dtype
        ),
        loss_fn=lambda p, b: transformer.loss_fn(p, cfg, b),
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
