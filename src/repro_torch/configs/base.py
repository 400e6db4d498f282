"""Model/config schema (counterpart of ``repro.configs.base``).

The fields the serving routes of the dense family (paged and dense), of
the hybrid family (Mamba-2 + a shared attention block, dense route), of
the vlm family (Llama-3.2-Vision: gated image cross-attention, dense
route), of the ssm family (Mamba-1, dense route) and of the audio family
(the Whisper encoder-decoder, dense route) and of the moe family (the
dense layer with a routed expert FFN, both routes) read are ported.
"""

from __future__ import annotations

import dataclasses

import torch


IMPLS = ("pasa", "flash", "naive")
FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "audio")


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
    # algebraic shift there has no kernel: False raises, ROADMAP A12b), and
    # its plain version attends with K/V expanded to the query heads
    # (True, the reference's default) or in the grouped (B, KVH, G, S, hd)
    # layout (False).  The card's kernel maps each query head to its kv
    # head in both.
    use_gemm_shift: bool = True
    expand_kv: bool = True
    # Scale statistic of quantized KV pools (runtime/paged_cache.py
    # quantize_kv_page): "absmax" (exact range, the attention-accuracy
    # default) or "quantile" (clipped absmax: finer bulk resolution, worse
    # attention on outlier-heavy pages).
    kv_quant_scale: str = "absmax"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The routed expert FFN (the reference's fields and defaults): top-k
    of ``n_experts`` per token, each expert taking at most
    ceil(T k / E * ``capacity_factor``) of a call's T tokens.
    ``router_jitter`` is read by no forward of either package;
    ``dispatch`` "a2a" takes the expert-parallel path only across devices
    (ROADMAP A13), so on one device every call takes the gspmd path."""

    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    dispatch: str = "a2a"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """The state-space block's shape (the reference's fields and
    defaults): ``version`` 1 is Mamba-1 (the ssm family), 2 Mamba-2 (the
    hybrid family)."""

    state: int = 16
    d_conv: int = 4
    expand: int = 2
    version: int = 1              # 1 = Mamba-1 (falcon-mamba), 2 = Mamba-2 (zamba2)
    head_p: int = 64              # mamba2 head size
    chunk: int = 128              # mamba2 SSD chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                   # dense | moe | vlm | hybrid | ssm | audio
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

    moe: MoEConfig = MoEConfig()
    ssm: SSMConfig = SSMConfig()
    attention: AttentionConfig = AttentionConfig()

    # hybrid (zamba2): a weight-shared attention block every `attn_every`
    # SSM layers (applied before layers 0, attn_every, 2*attn_every, ...).
    attn_every: int = 0

    # vlm (llama-3.2-vision): a cross-attention layer every `cross_attn_every`
    # layers (layer i is cross-attn iff i % cross_attn_every == 0).
    cross_attn_every: int = 0
    n_image_tokens: int = 0
    vision_dim: int = 0

    # audio (whisper): encoder depth + precomputed-frame-embedding count.
    n_encoder_layers: int = 0
    n_audio_frames: int = 0

    # the reference's parameter dtype (bf16 for kimi-k2); the port stores
    # each weight at the dtype the reference casts it to before use
    # (models/convert.py), so only training (ROADMAP A15) would read it
    param_dtype: str = "float32"
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
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.family == "hybrid" and (self.ssm.version != 2
                                        or self.attn_every < 1):
            raise ValueError(
                "the hybrid family is ported with Mamba-2 (ssm.version 2) "
                "and attn_every >= 1"
            )
        if self.family == "vlm" and self.cross_attn_every < 1:
            raise ValueError("the vlm family needs cross_attn_every >= 1")
        if self.family == "moe" and not self.moe.n_experts:
            raise ValueError("moe family needs moe.n_experts")
        if self.family == "ssm" and self.ssm.version != 1:
            raise ValueError(
                "the ssm family is ported with Mamba-1 (ssm.version 1)"
            )
        if self.family != "ssm" and self.n_kv_heads \
                and self.n_heads % self.n_kv_heads:
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
            n_layers=min(self.n_layers, 2 if self.family != "vlm" else 4),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=16,
            d_ff=128,
            vocab_size=512,
            moe=dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
            ) if self.moe.n_experts else self.moe,
            ssm=dataclasses.replace(
                self.ssm, state=min(self.ssm.state, 8), head_p=8, chunk=16,
            ),
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            cross_attn_every=min(self.cross_attn_every, 2)
            if self.cross_attn_every else 0,
            n_image_tokens=min(self.n_image_tokens, 16) or 0,
            vision_dim=min(self.vision_dim, 32) or 0,
            n_encoder_layers=min(self.n_encoder_layers, 2)
            if self.n_encoder_layers else 0,
            n_audio_frames=min(self.n_audio_frames, 16) or 0,
        )
