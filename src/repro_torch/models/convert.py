"""Parameters of the dense transformer: carried across from the reference,
or drawn at random on the device.

Both produce the layout of the reference's ``transformer.init_lm``::

    {"embed": (V, D), "final_norm": (D,), "lm_head": (D, V),
     "blocks": {"ln1", "ln2": (L, D),
                "attn": {"wq": (L, D, H*hd), "wk"/"wv": (L, D, KVH*hd),
                         "wo": (L, H*hd, D), "bq"/"bk"/"bv": (L, n)},
                "mlp": {"w1"/"w3": (L, D, F), "w2": (L, F, D)}}}

Each weight is stored at the dtype the reference casts it to before use,
not at the reference's fp32 parameter dtype: the compute dtype (bf16) for
the projections, MLP, embedding, norms and biases, and fp32 for
``lm_head`` (the logits GEMM runs in fp32).  Rounding fp32 -> bf16 once at
load gives the same values as rounding at every use, and halves the
memory of a full-width model (about 14 GB in bf16 for qwen2-7b, plus
2.2 GB for the fp32 head).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig


def _leaf_dtype(path: tuple, cfg: ModelConfig) -> torch.dtype:
    return torch.float32 if path == ("lm_head",) else cfg.torch_compute_dtype()


def params_from_numpy(tree: dict, cfg: ModelConfig, device) -> dict:
    """The reference's ``init_lm`` pytree, given as nested dicts of numpy
    arrays, -> the port's parameters on ``device``."""
    dev = resolve_device(device)

    def conv(node, path):
        if isinstance(node, dict):
            return {k: conv(v, path + (k,)) for k, v in node.items()}
        arr = np.asarray(node)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=dev, dtype=_leaf_dtype(path, cfg)
        )

    return conv(tree, ())


def _normal(shape, scale, dtype, generator, device) -> torch.Tensor:
    """N(0, scale^2) drawn in fp32, stored at ``dtype``; stacked (L, ...)
    leaves are drawn one layer at a time to bound the fp32 temporary."""
    out = torch.empty(shape, dtype=dtype, device=device)
    parts = out if len(shape) == 3 else out[None]
    for part in parts:
        part.copy_(
            torch.randn(part.shape, generator=generator, dtype=torch.float32,
                        device=device).mul_(scale)
        )
    return out


def init_lm(cfg: ModelConfig, generator: torch.Generator, device=None) -> dict:
    """Random parameters with the reference's distributions: embedding
    N(0, 1); projections N(0, 1/d_in); norm weights 1; biases 0.  The
    generator must live on ``device``.  Different draws from the
    reference's (jax.random vs torch), same distributions."""
    dev = resolve_device(device)
    cd = cfg.torch_compute_dtype()
    nl, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff

    def dense(d_in, d_out, n_stack=None, dtype=cd):
        shape = (d_in, d_out) if n_stack is None else (n_stack, d_in, d_out)
        return _normal(shape, 1.0 / math.sqrt(d_in), dtype, generator, dev)

    def const(shape, value):
        return torch.full(shape, value, dtype=cd, device=dev)

    attn = {
        "wq": dense(d, cfg.q_dim, nl),
        "wk": dense(d, cfg.kv_dim, nl),
        "wv": dense(d, cfg.kv_dim, nl),
        "wo": dense(cfg.q_dim, d, nl),
    }
    if cfg.qkv_bias:
        attn["bq"] = const((nl, cfg.q_dim), 0.0)
        attn["bk"] = const((nl, cfg.kv_dim), 0.0)
        attn["bv"] = const((nl, cfg.kv_dim), 0.0)
    return {
        "embed": _normal((cfg.vocab_size, d), 1.0, cd, generator, dev),
        "blocks": {
            "ln1": const((nl, d), 1.0),
            "ln2": const((nl, d), 1.0),
            "attn": attn,
            "mlp": {
                "w1": dense(d, f, nl),
                "w3": dense(d, f, nl),
                "w2": dense(f, d, nl),
            },
        },
        "final_norm": const((d,), 1.0),
        "lm_head": dense(d, cfg.vocab_size, dtype=torch.float32),
    }
