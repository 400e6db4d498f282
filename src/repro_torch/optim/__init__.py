"""AdamW and its learning-rate schedule (counterpart of ``repro.optim``).

The reference's int8 error-feedback gradient compression
(``compression.py``: ``CompressionState``, ``compression_init``,
``compressed_psum``) syncs gradients across data-parallel processes; it
waits for the port's data-parallel trainer (ROADMAP A15b)."""

from repro_torch.optim.adamw import (
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
)
from repro_torch.optim.schedule import cosine_warmup

__all__ = [
    "AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm",
    "cosine_warmup", "global_norm",
]
