"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16 - pure Mamba-1  [arXiv:2410.05355; unverified].

No attention, so PASA does not apply: the model runs no attention
kernel.  Decode carries O(1) state per sequence (the conv window and the
SSM state).
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=65024,
    ssm=SSMConfig(state=16, d_conv=4, expand=2, version=1),
    supports_long_context=True,
)
