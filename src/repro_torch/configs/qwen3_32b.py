"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936.

qk_norm + GQA [hf:Qwen/Qwen3-8B; hf].  head_dim=128 (q_dim = 8192 > d_model,
as in the real qwen3-32b).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    qkv_bias=False,
    rope_theta=1.0e6,
)
