"""qwen1.5-32b [dense]: 64L d_model=5120 40H (GQA kv=40) d_ff=27392 vocab=152064.

QKV bias, no qk_norm (qwen1.5 family)  [hf:Qwen/Qwen1.5-0.5B; hf].
kv=40 == n_heads -> effectively MHA.  head_dim = 5120/40 = 128.
The QKV bias is precisely the paper's "large bias in K" overflow risk
(PAPER.md).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    qk_norm=False,
    qkv_bias=True,
    rope_theta=1.0e6,
)
