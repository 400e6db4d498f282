"""Synthetic and token-file training data (counterpart of ``repro.data``)."""

from repro_torch.data.pipeline import (
    DataPipeline,
    TokenFileDataset,
    synthetic_batch,
)

__all__ = ["DataPipeline", "TokenFileDataset", "synthetic_batch"]
