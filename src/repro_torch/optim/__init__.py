"""AdamW, its learning-rate schedule and the int8 error-feedback
gradient compression of the cross-pod sync (counterpart of
``repro.optim``)."""

from repro_torch.optim.adamw import (
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
)
from repro_torch.optim.compression import (
    CompressionState,
    compressed_psum,
    compression_init,
)
from repro_torch.optim.schedule import cosine_warmup

__all__ = [
    "AdamWState", "CompressionState", "adamw_init", "adamw_update",
    "clip_by_global_norm", "compressed_psum", "compression_init",
    "cosine_warmup", "global_norm",
]
