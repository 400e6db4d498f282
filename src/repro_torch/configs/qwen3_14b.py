"""qwen3-14b [dense]: 40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.

qk_norm + GQA, no QKV bias (qwen3 family)  [hf:Qwen/Qwen3-8B; hf].
head_dim=128 (qwen3 uses a fixed 128 head_dim; q_dim = 40*128 = 5120).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    qkv_bias=False,
    rope_theta=1.0e6,
)
