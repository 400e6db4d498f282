"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64 - Mamba2 backbone + weight-shared attention blocks
[arXiv:2411.15242; hf].

One shared transformer block applied every 6 mamba2 layers (7
applications).  PASA applies to the shared attention (head_dim 64);
mamba blocks are attention-free.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    rope_theta=1.0e4,
    ssm=SSMConfig(state=64, d_conv=4, expand=2, version=2, head_p=64),
    attn_every=6,
)
