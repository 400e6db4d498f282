"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (kv=16) expert d_ff=1024
vocab=50304, MoE 64 experts top-8  [arXiv:2409.02060; hf].

qk-norm, head_dim 128; each layer's FFN is 64 SwiGLU experts of width
1024, 8 per token, capacity factor 1.25.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    qk_norm=True,   # OLMoE uses qk-norm
    rope_theta=1.0e4,
    moe=MoEConfig(n_experts=64, top_k=8, capacity_factor=1.25),
)
