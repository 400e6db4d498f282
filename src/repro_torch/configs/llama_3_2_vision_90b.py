"""llama-3.2-vision-90b [vlm]: 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 - cross-attn image layers  [hf:meta-llama/...; unverified].

Every 5th layer (i % 5 == 0 -> 20 of 100) is an image cross-attention layer
with tanh-gated residuals.  The vision tower is a stub, as in the
reference: ``vision_embeds`` (B, 1601, 1280) stand for its patch
embeddings.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=5.0e5,
    cross_attn_every=5,
    n_image_tokens=1601,
    vision_dim=1280,
)
