"""Shared building blocks: RMSNorm, RoPE, SwiGLU MLP, embedding.

Counterpart of ``repro.models.layers`` with the same dtype steps: norms
and RoPE compute in fp32 and store at the activation dtype, matmuls run at
the compute dtype.  The reference's sharding hooks (``shard``,
``row_parallel_matmul``) reduce to plain matmuls on one device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w.to(dt)


def rope_angles(pos: torch.Tensor, seq: int, head_dim: int, theta: float):
    """Per-row RoPE tables for absolute positions ``pos + [0, seq)``.

    pos: (B,) start positions (decode: the write position; chunked
    prefill: the chunk start).  Returns cos, sin of shape (B, seq, 1,
    head_dim // 2) in fp32, broadcasting over heads."""
    half = head_dim // 2
    dev = pos.device
    freqs = 1.0 / (
        theta ** (torch.arange(0, half, dtype=torch.float32, device=dev) / half)
    )
    abs_pos = (
        pos.to(torch.float32)[:, None]
        + torch.arange(seq, dtype=torch.float32, device=dev)[None, :]
    )                                                  # (B, S)
    ang = abs_pos[:, :, None] * freqs
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin broadcastable to (B, S, H, hd/2)."""
    half = x.shape[-1] // 2
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    return torch.cat(
        [x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1
    ).to(x.dtype)


def mlp(x: torch.Tensor, p: dict, compute_dtype: torch.dtype) -> torch.Tensor:
    """SwiGLU: (silu(x W1) * (x W3)) W2 at the compute dtype."""
    x = x.to(compute_dtype)
    h = F.silu(x @ p["w1"].to(compute_dtype))
    h = h * (x @ p["w3"].to(compute_dtype))
    return h @ p["w2"].to(compute_dtype)


def embed(tokens: torch.Tensor, table: torch.Tensor,
          compute_dtype: torch.dtype) -> torch.Tensor:
    return table[tokens.long()].to(compute_dtype)
