"""whisper-large-v3 [audio]: 32L(dec)+32L(enc) d_model=1280 20H (kv=20)
d_ff=5120 vocab=51866 - enc-dec, conv frontend STUB  [arXiv:2212.04356].

The frame embeddings (B, 1500, 1280) stand for the conv front-end's
output; the backbone (bidirectional encoder + causal decoder with cached
self-attention and cross-attention) is implemented.  head_dim = 1280/20
= 64.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    rope_theta=1.0e4,
    n_encoder_layers=32,
    n_audio_frames=1500,
)
