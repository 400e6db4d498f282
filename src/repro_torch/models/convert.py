"""Parameters of the dense and moe transformers, the hybrid (zamba2) model,
Llama-3.2-Vision, the Mamba-1 LM (falcon-mamba) and Whisper: carried
across from the reference, or drawn at random on the device.

Both produce the layout of the reference's ``transformer.init_lm``::

    {"embed": (V, D), "final_norm": (D,), "lm_head": (D, V),
     "blocks": {"ln1", "ln2": (L, D),
                "attn": {"wq": (L, D, H*hd), "wk"/"wv": (L, D, KVH*hd),
                         "wo": (L, H*hd, D), "bq"/"bk"/"bv": (L, n),
                         "q_norm"/"k_norm": (L, hd)},
                "mlp": {"w1"/"w3": (L, D, F), "w2": (L, F, D)}}}

(the moe family: ``"moe": {"router": (L, D, E), "w1"/"w3": (L, E, D, F),
"w2": (L, E, F, D)}`` in place of ``"mlp"``),

or of its ``hybrid.init_hybrid`` (Di = expand * D, NH = Di / head_p,
N = the SSM state, K = d_conv)::

    {"embed": (V, D), "final_norm": (D,), "lm_head": (D, V),
     "mamba": {"in_proj": (L, D, 2 Di + 2 N + NH), "conv_w": (L, Di, K),
               "conv_b": (L, Di), "a_log", "dt_bias", "d_skip": (L, NH),
               "norm_w": (L, Di), "out_proj": (L, Di, D)},
     "mamba_ln": (L, D),
     "shared": {"ln1", "ln2": (D,), "attn": {"wq", "wk", "wv", "wo"},
                "mlp": {"w1", "w3", "w2"}}}

or of its ``multimodal.init_vlm`` (G = L / cross_attn_every groups of one
cross-attention layer and per = cross_attn_every - 1 self-attention
layers, Dv the vision width)::

    {"embed": (V, D), "vision_proj": (Dv, D), "final_norm": (D,),
     "lm_head": (D, V),
     "self": {"ln1", "ln2": (G, per, D), "attn": {"wq": (G, per, D, H*hd),
              ...}, "mlp": {...}},
     "cross": {"ln1", "ln2": (G, D), "attn": {...}, "mlp": {...},
               "gate_attn", "gate_mlp": (G,)}}

or of its ``model_zoo._ssm_init`` (Mamba-1; R = the dt rank D / 16)::

    {"embed": (V, D), "ln": (L, D), "final_norm": (D,), "lm_head": (D, V),
     "mamba": {"in_proj": (L, D, 2 Di), "conv_w": (L, Di, K),
               "conv_b", "dt_bias", "d_skip": (L, Di),
               "x_proj": (L, Di, R + 2 N), "dt_proj": (L, R, Di),
               "a_log": (L, Di, N), "out_proj": (L, Di, D)}}

or of its ``multimodal.init_whisper`` (Le encoder and L decoder layers,
T audio frames)::

    {"embed": (V, D), "pos_embed": (T, D), "enc_norm", "final_norm": (D,),
     "lm_head": (D, V),
     "enc": {"ln1", "ln2": (Le, D), "attn": {...}, "mlp": {...}},
     "dec": {"ln1", "ln_x", "ln2": (L, D), "self_attn": {...},
             "cross_attn": {...}, "mlp": {...}}}

Each weight is stored at the dtype the reference casts it to before use,
not at the reference's fp32 parameter dtype: the compute dtype (bf16) for
the projections, MLP, embedding, norms and biases, and fp32 for
``lm_head`` (the logits GEMM runs in fp32) and the moe ``router`` (the
reference draws it in fp32 and routes in fp32), for the Mamba weights the
reference reads in fp32 (``conv_w``, ``conv_b``, ``a_log``, ``dt_bias``,
``d_skip``, Mamba-1's ``dt_proj``) and for the vlm's cross-attention gates
(``gate_attn``, ``gate_mlp``: the reference takes their tanh at fp32 and
only then casts to the compute dtype).  Rounding fp32 -> bf16 once at
load gives the same values as rounding at every use, and halves the
memory of a full-width model (about 14 GB in bf16 for qwen2-7b, plus 2.2
GB for the fp32 head; 2.4 GB for zamba2-1.2b, plus 0.26 GB for its head;
3.9 GB for whisper-large-v3, plus 0.27 GB for its head; 13.5 GB for
falcon-mamba-7b, plus 1.07 GB for its head; 1.71 GB a layer for
llama-3.2-vision-90b, plus 2.1 GB of embedding and 4.2 GB for its head;
13.4 GB for olmoe-1b-7b's layers, plus 0.21 GB of embedding and 0.41 GB
for its head).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig


# the leaves the reference reads in fp32 whatever the compute dtype
FP32_LEAVES = (("lm_head",), ("blocks", "moe", "router"), ("mamba", "conv_w"),
               ("mamba", "conv_b"), ("mamba", "a_log"), ("mamba", "dt_bias"),
               ("mamba", "d_skip"), ("mamba", "dt_proj"),
               ("cross", "gate_attn"), ("cross", "gate_mlp"))


def _leaf_dtype(path: tuple, cfg: ModelConfig) -> torch.dtype:
    return (torch.float32 if path in FP32_LEAVES
            else cfg.torch_compute_dtype())


def params_from_numpy(tree: dict, cfg: ModelConfig, device) -> dict:
    """The reference's ``init_lm``, ``init_hybrid``, ``init_vlm``,
    ``_ssm_init`` or ``init_whisper`` pytree, given as nested dicts of
    numpy arrays (any number of stacking axes), -> the port's parameters
    on ``device``."""
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
    or (G, per, ...) matrices are drawn one matrix at a time to bound the
    fp32 temporary."""
    out = torch.empty(shape, dtype=dtype, device=device)
    parts = out.view(-1, *shape[-2:]) if len(shape) >= 3 else out[None]
    for part in parts:
        part.copy_(
            torch.randn(part.shape, generator=generator, dtype=torch.float32,
                        device=device).mul_(scale)
        )
    return out


def _lead(n_stack) -> tuple:
    """The stacking axes: none, one (L,) or several, e.g. (G, per)."""
    if n_stack is None:
        return ()
    return tuple(n_stack) if isinstance(n_stack, tuple) else (n_stack,)


class _Draw:
    """Random leaves on one device from one generator, with the
    reference's distributions: N(0, scale^2) drawn in fp32 (projections
    N(0, 1/d_in)), constants for norms and biases.  ``n_stack`` is the
    leading stacking axes: None, a layer count or a tuple of them."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device):
        self.cd = cfg.torch_compute_dtype()
        self.gen = generator
        self.dev = device

    def normal(self, shape, scale, dtype=None):
        return _normal(shape, scale, dtype or self.cd, self.gen, self.dev)

    def dense(self, d_in, d_out, n_stack=None, dtype=None):
        return self.normal(_lead(n_stack) + (d_in, d_out),
                           1.0 / math.sqrt(d_in), dtype)

    def const(self, shape, value, dtype=None):
        return torch.full(shape, value, dtype=dtype or self.cd,
                          device=self.dev)

    def attention(self, cfg: ModelConfig, n_stack=None) -> dict:
        """The reference's ``init_attention`` layout (one layer, or
        stacked over ``n_stack`` layers)."""
        d = cfg.d_model
        stack = lambda n: _lead(n_stack) + (n,)
        attn = {
            "wq": self.dense(d, cfg.q_dim, n_stack),
            "wk": self.dense(d, cfg.kv_dim, n_stack),
            "wv": self.dense(d, cfg.kv_dim, n_stack),
            "wo": self.dense(cfg.q_dim, d, n_stack),
        }
        if cfg.qkv_bias:
            attn["bq"] = self.const(stack(cfg.q_dim), 0.0)
            attn["bk"] = self.const(stack(cfg.kv_dim), 0.0)
            attn["bv"] = self.const(stack(cfg.kv_dim), 0.0)
        if cfg.qk_norm:
            attn["q_norm"] = self.const(stack(cfg.head_dim), 1.0)
            attn["k_norm"] = self.const(stack(cfg.head_dim), 1.0)
        return attn

    def mlp(self, d, f, n_stack=None) -> dict:
        return {"w1": self.dense(d, f, n_stack), "w3": self.dense(d, f, n_stack),
                "w2": self.dense(f, d, n_stack)}


def init_lm(cfg: ModelConfig, generator: torch.Generator, device=None) -> dict:
    """Random parameters with the reference's distributions: embedding
    N(0, 1); projections N(0, 1/d_in); norm weights 1; biases 0; the moe
    family's router (fp32) and expert ``w1`` / ``w3`` N(0, 1/D), ``w2``
    N(0, 1/F) (``moe.init_moe``).  The generator must live on
    ``device``.  Different draws from the reference's (jax.random vs
    torch), same distributions."""
    r = _Draw(cfg, generator, resolve_device(device))
    nl, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    attn = r.attention(cfg, nl)        # drawn first, then the embedding
    embed = r.normal((cfg.vocab_size, d), 1.0)
    blocks = {"ln1": r.const((nl, d), 1.0), "ln2": r.const((nl, d), 1.0),
              "attn": attn}
    if cfg.family == "moe":
        e = cfg.moe.n_experts
        blocks["moe"] = {
            "router": r.dense(d, e, nl, dtype=torch.float32),
            "w1": r.normal((nl, e, d, f), 1.0 / math.sqrt(d)),
            "w3": r.normal((nl, e, d, f), 1.0 / math.sqrt(d)),
            "w2": r.normal((nl, e, f, d), 1.0 / math.sqrt(f)),
        }
    else:
        blocks["mlp"] = r.mlp(d, f, nl)
    return {
        "embed": embed,
        "blocks": blocks,
        "final_norm": r.const((d,), 1.0),
        "lm_head": r.dense(d, cfg.vocab_size, dtype=torch.float32),
    }


def init_hybrid(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random parameters of the hybrid model with the reference's
    distributions (``hybrid.init_hybrid``, ``ssm.init_mamba2``): as
    :func:`init_lm` for the embedding, the shared block and the head;
    Mamba ``in_proj`` / ``out_proj`` N(0, 1/d_in), ``conv_w``
    N(0, 1/d_conv), ``conv_b`` and ``a_log`` 0, ``dt_bias`` -4, ``d_skip``
    and the norm weights 1."""
    r = _Draw(cfg, generator, resolve_device(device))
    nl, d = cfg.n_layers, cfg.d_model
    di, n, k = cfg.ssm.expand * d, cfg.ssm.state, cfg.ssm.d_conv
    nh = di // cfg.ssm.head_p
    f32 = torch.float32
    return {
        "embed": r.normal((cfg.vocab_size, d), 1.0),
        "mamba": {
            "in_proj": r.dense(d, 2 * di + 2 * n + nh, nl),
            "conv_w": r.normal((nl, di, k), 1.0 / math.sqrt(k), f32),
            "conv_b": r.const((nl, di), 0.0, f32),
            "a_log": r.const((nl, nh), 0.0, f32),
            "dt_bias": r.const((nl, nh), -4.0, f32),
            "d_skip": r.const((nl, nh), 1.0, f32),
            "norm_w": r.const((nl, di), 1.0),
            "out_proj": r.dense(di, d, nl),
        },
        "mamba_ln": r.const((nl, d), 1.0),
        "shared": {
            "ln1": r.const((d,), 1.0),
            "attn": r.attention(cfg),
            "ln2": r.const((d,), 1.0),
            "mlp": r.mlp(d, cfg.d_ff),
        },
        "final_norm": r.const((d,), 1.0),
        "lm_head": r.dense(d, cfg.vocab_size, dtype=f32),
    }


def init_whisper(cfg: ModelConfig, generator: torch.Generator,
                 device=None) -> dict:
    """Random parameters of Whisper with the reference's distributions
    (``multimodal.init_whisper``): as :func:`init_lm` for the embedding,
    the attention and MLP stacks of both halves and the head; the learned
    frame positions ``pos_embed`` N(0, 0.01^2)."""
    r = _Draw(cfg, generator, resolve_device(device))
    ne, nd, d = cfg.n_encoder_layers, cfg.n_layers, cfg.d_model
    return {
        "enc": {
            "ln1": r.const((ne, d), 1.0),
            "attn": r.attention(cfg, ne),
            "ln2": r.const((ne, d), 1.0),
            "mlp": r.mlp(d, cfg.d_ff, ne),
        },
        "dec": {
            "ln1": r.const((nd, d), 1.0),
            "self_attn": r.attention(cfg, nd),
            "ln_x": r.const((nd, d), 1.0),
            "cross_attn": r.attention(cfg, nd),
            "ln2": r.const((nd, d), 1.0),
            "mlp": r.mlp(d, cfg.d_ff, nd),
        },
        "embed": r.normal((cfg.vocab_size, d), 1.0),
        "pos_embed": r.normal((cfg.n_audio_frames, d), 0.01),
        "enc_norm": r.const((d,), 1.0),
        "final_norm": r.const((d,), 1.0),
        "lm_head": r.dense(d, cfg.vocab_size, dtype=torch.float32),
    }


def init_vlm(cfg: ModelConfig, generator: torch.Generator,
             device=None) -> dict:
    """Random parameters of Llama-3.2-Vision with the reference's
    distributions and layout (``multimodal.init_vlm``): as
    :func:`init_lm` for the embedding, the blocks and the head;
    ``vision_proj`` N(0, 1/vision_dim); the self-attention blocks stacked
    (G, per, ...), the cross-attention blocks (G, ...) with their gates
    ``gate_attn`` / ``gate_mlp`` at zeros in fp32 (tanh(0) = 0: at this
    init no cross layer reaches the logits)."""
    r = _Draw(cfg, generator, resolve_device(device))
    d = cfg.d_model
    g = cfg.n_layers // cfg.cross_attn_every
    per = cfg.cross_attn_every - 1

    def block(lead):
        return {"ln1": r.const(lead + (d,), 1.0),
                "attn": r.attention(cfg, lead),
                "ln2": r.const(lead + (d,), 1.0),
                "mlp": r.mlp(d, cfg.d_ff, lead)}

    cross = block((g,))
    cross["gate_attn"] = r.const((g,), 0.0, torch.float32)
    cross["gate_mlp"] = r.const((g,), 0.0, torch.float32)
    return {
        "embed": r.normal((cfg.vocab_size, d), 1.0),
        "vision_proj": r.dense(cfg.vision_dim, d),
        "self": block((g, per)),
        "cross": cross,
        "final_norm": r.const((d,), 1.0),
        "lm_head": r.dense(d, cfg.vocab_size, dtype=torch.float32),
    }


def init_ssm(cfg: ModelConfig, generator: torch.Generator,
             device=None) -> dict:
    """Random parameters of the Mamba-1 LM with the reference's
    distributions (``model_zoo._ssm_init``, ``ssm.init_mamba1``): as
    :func:`init_lm` for the embedding and the head; ``in_proj``,
    ``x_proj``, ``dt_proj``, ``out_proj`` N(0, 1/d_in), ``conv_w``
    N(0, 1/d_conv), ``conv_b`` 0, ``dt_bias`` -4, ``a_log`` log(1..N)
    along the state, ``d_skip`` and the norm weights 1."""
    r = _Draw(cfg, generator, resolve_device(device))
    nl, d = cfg.n_layers, cfg.d_model
    di, n, k = cfg.ssm.expand * d, cfg.ssm.state, cfg.ssm.d_conv
    dr = max(d // 16, 1)
    f32 = torch.float32
    a_log = torch.log(torch.arange(1, n + 1, dtype=f32, device=r.dev))
    return {
        "embed": r.normal((cfg.vocab_size, d), 1.0),
        "mamba": {
            "in_proj": r.dense(d, 2 * di, nl),
            "conv_w": r.normal((nl, di, k), 1.0 / math.sqrt(k), f32),
            "conv_b": r.const((nl, di), 0.0, f32),
            "x_proj": r.dense(di, dr + 2 * n, nl),
            "dt_proj": r.dense(dr, di, nl, dtype=f32),
            "dt_bias": r.const((nl, di), -4.0, f32),
            "a_log": a_log.expand(nl, di, n).contiguous(),
            "d_skip": r.const((nl, di), 1.0, f32),
            "out_proj": r.dense(di, d, nl),
        },
        "ln": r.const((nl, d), 1.0),
        "final_norm": r.const((d,), 1.0),
        "lm_head": r.dense(d, cfg.vocab_size, dtype=f32),
    }
