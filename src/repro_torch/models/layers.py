"""Shared building blocks: RMSNorm, RoPE, SwiGLU MLP, embedding.

Counterpart of ``repro.models.layers`` with the same dtype steps: norms
and RoPE compute in fp32 and store at the activation dtype, matmuls run at
the compute dtype.  The reference's sharding hooks (``shard``,
``row_parallel_matmul``) reduce to plain matmuls on one device.  Norms and
products over a few rows run padded to ``MIN_ROWS`` rows, so that each
row's result does not depend on how many rows share the call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last dim, on the rows of x padded to MIN_ROWS."""
    dt = x.dtype
    xf = _rows(x).float()
    var = (xf * xf).mean(-1, keepdim=True)
    return _unrows((xf * torch.rsqrt(var + eps)).to(dt) * w.to(dt), x)


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


# A product or a norm over fewer rows than this runs on its rows
# zero-padded to this count.  cuBLAS picks its kernel, and the card's row
# reduction its split of a row, by the number of rows, and two choices may
# round a row differently: unpadded, the rows of a decode step (one per
# sequence) would depend on how many sequences share the step, and PASA's
# fp16 recovery can amplify a one-ulp difference into another token.
MIN_ROWS = 16


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x (..., K) as a (rows, K) matrix, zero-padded to MIN_ROWS."""
    n = x.numel() // x.shape[-1]
    flat = x.reshape(n, x.shape[-1])
    if n < MIN_ROWS:
        flat = F.pad(flat, (0, 0, 0, MIN_ROWS - n))
    return flat


def _unrows(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The real rows of a product of ``_rows(like)``, in like's shape."""
    n = like.numel() // like.shape[-1]
    return y[:n].reshape(*like.shape[:-1], y.shape[-1])


def matmuls(x: torch.Tensor, *ws: torch.Tensor):
    """x @ w for each w (x (..., K), w (K, N)), each row's result
    independent of how many rows x has (see MIN_ROWS)."""
    xr = _rows(x)
    return tuple(_unrows(xr @ w, x) for w in ws)


def mlp(x: torch.Tensor, p: dict, compute_dtype: torch.dtype) -> torch.Tensor:
    """SwiGLU: (silu(x W1) * (x W3)) W2 at the compute dtype."""
    x = x.to(compute_dtype)
    xr = _rows(x)
    h = F.silu(xr @ p["w1"].to(compute_dtype))
    h = h * (xr @ p["w3"].to(compute_dtype))
    return _unrows(h @ p["w2"].to(compute_dtype), x)


def embed(tokens: torch.Tensor, table: torch.Tensor,
          compute_dtype: torch.dtype) -> torch.Tensor:
    return table[tokens.long()].to(compute_dtype)
