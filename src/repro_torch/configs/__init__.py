"""Architecture registry for the configs ported so far."""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import (AttentionConfig, ModelConfig, MoEConfig,
                                      SSMConfig)

_ID_TO_MODULE = {
    "qwen2-7b": "qwen2_7b",
    "qwen3-4b": "qwen3_4b",
    "qwen3-14b": "qwen3_14b",
    "qwen3-32b": "qwen3_32b",
    "qwen1.5-32b": "qwen1_5_32b",
    "zamba2-1.2b": "zamba2_1_2b",
    "whisper-large-v3": "whisper_large_v3",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
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


__all__ = ["ALL_ARCHS", "AttentionConfig", "ModelConfig", "MoEConfig",
           "SSMConfig", "get_config"]
