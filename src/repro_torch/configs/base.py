"""Model/config schema (counterpart of ``repro.configs.base``).

Only the fields the dense family's serving routes (paged and dense) read
are ported; the MoE/SSM/multimodal blocks arrive with those families.
"""

from __future__ import annotations

import dataclasses

import torch


IMPLS = ("pasa", "flash", "naive")


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    """The attention implementation switch, as the reference's:
    ``impl="pasa"`` runs PASA at ``pasa_policy`` and ``beta``;
    ``"flash"`` runs FlashAttention-2 (beta = 0) at ``policy``, the
    paper's safe baseline; ``"naive"`` the materialized softmax
    (``core.naive``, plain PyTorch on every device)."""

    impl: str = "pasa"            # "pasa" | "flash" | "naive"
    beta: float = 0.984497        # paper's adopted optimal-accuracy beta
    policy: str = "bf16_fp32"     # precision policy when impl == "flash"
    pasa_policy: str = "fp16"     # policy when impl == "pasa" (paper: fully fp16)
    block_kv: int = 128           # PASA shift block == KV page size
    # The dense prefill shifts K with the paper's batched-GEMM M (the
    # algebraic shift there is not ported: False raises), and attends with
    # K/V expanded to the query heads in the plain version (the reference's
    # layout; the grouped layout is not ported: False raises).  The card's
    # kernels map each query head to its kv head, with the same result.
    use_gemm_shift: bool = True
    expand_kv: bool = True
    # Scale statistic of quantized KV pools (runtime/paged_cache.py
    # quantize_kv_page): "absmax" (exact range, the attention-accuracy
    # default) or "quantile" (clipped absmax: finer bulk resolution, worse
    # attention on outlier-heavy pages).
    kv_quant_scale: str = "absmax"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                   # dense (the only family ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1.0e6
    norm_eps: float = 1.0e-6

    attention: AttentionConfig = AttentionConfig()

    compute_dtype: str = "bfloat16"

    def torch_compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def group(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def validate(self) -> "ModelConfig":
        if self.family != "dense":
            raise ValueError(
                f"family {self.family!r} is not ported to repro_torch yet"
            )
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        if self.attention.impl not in IMPLS:
            raise ValueError(
                f"unknown attention impl {self.attention.impl!r}; have {IMPLS}"
            )
        return self

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU tests (the reference's sizes)."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=16,
            d_ff=128,
            vocab_size=512,
        )
