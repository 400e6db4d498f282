"""build(cfg) -> ModelBundle (counterpart of ``repro.models.model_zoo``).

Only the dense family's paged serving interface is ported: the engine
needs ``init_paged_cache``, ``paged_serve_step`` and
``paged_prefill_step``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import convert, transformer


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    #   (generator, device) -> params
    init: Callable[..., dict]
    #   (num_pages, page_size, dtype=..., device=...) -> pool
    init_paged_cache: Callable[..., dict]
    #   (params, token (B,), pos (B,), pool, page_table (B, mp))
    #   -> (logits (B, V), pool)
    paged_serve_step: Callable[..., tuple]
    #   (params, tokens (B, CS), start (B,), kv_len (B,), last_idx (B,),
    #    pool, page_table (B, mp)) -> (logits (B, V), pool)
    paged_prefill_step: Callable[..., tuple]


def build(cfg: ModelConfig) -> ModelBundle:
    cfg.validate()
    if cfg.qk_norm:
        raise NotImplementedError("qk-norm attention is not ported yet")
    return ModelBundle(
        cfg=cfg,
        init=lambda generator, device=None: convert.init_lm(
            cfg, generator, device
        ),
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
