"""qwen2-7b - the paper's own language-model validation case (Section 3.3.2).

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064, QKV bias
[arXiv:2309.16609 / Qwen2 report].
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1.0e6,
)
