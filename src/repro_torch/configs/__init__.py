"""Architecture registry for the configs ported so far."""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import AttentionConfig, ModelConfig

_ID_TO_MODULE = {
    "qwen2-7b": "qwen2_7b",
}

ALL_ARCHS: List[str] = list(_ID_TO_MODULE)


def get_config(arch_id: str) -> ModelConfig:
    try:
        mod_name = _ID_TO_MODULE[arch_id]
    except KeyError as e:
        raise ValueError(
            f"arch {arch_id!r} is not ported to repro_torch; have {ALL_ARCHS}"
        ) from e
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG.validate()


__all__ = ["ALL_ARCHS", "AttentionConfig", "ModelConfig", "get_config"]
