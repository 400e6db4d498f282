"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) expert d_ff=2048
vocab=163840, MoE 384 experts top-8  [arXiv:2501.kimi2; unverified].

The trillion-parameter config of the reference, with its bf16 parameter
dtype and the GQA attention it is specified with (the published K2 uses
MLA).  One layer's experts are 384 x 3 x 7168 x 2048 weights, ~33.8 GB
in bf16: the port serves it only ``reduced()`` or across devices
(ROADMAP A13).
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab_size=163840,
    qk_norm=False,
    rope_theta=5.0e4,
    moe=MoEConfig(n_experts=384, top_k=8, capacity_factor=1.25),
    param_dtype="bfloat16",
    optimizer_dtype="bfloat16",
)
