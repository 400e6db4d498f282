"""Step factories of the serving entry point (counterpart of
``repro.launch.steps``; only ``make_serve_step`` is ported)."""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.model_zoo import ModelBundle


def make_serve_step(bundle: ModelBundle) -> Callable:
    """(params, token, pos, cache, **extras) -> (next_token, logits,
    cache): one greedy decode step on the dense cache; ``extras`` (the
    vlm's ``vision_embeds``) go to the bundle's step."""

    def serve_step(params, token, pos, cache, **extras):
        logits, cache = bundle.serve_step(params, token, pos, cache, **extras)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits, cache

    return serve_step
