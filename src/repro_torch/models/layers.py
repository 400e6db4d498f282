"""Shared building blocks: RMSNorm, RoPE, SwiGLU MLP, embedding, the
chunked cross-entropy of training and per-layer remat.

Counterpart of ``repro.models.layers`` with the same dtype steps: norms
and RoPE compute in fp32 and store at the activation dtype, matmuls run at
the compute dtype.  The reference's placement hints (``shard``) have no
counterpart (``launch.sharding``); its ``row_parallel_matmul`` is the
MLP's ``w2`` product across the mesh's model axis.  Norms and products
over a few rows run padded to ``MIN_ROWS`` rows, so that each row's
result does not depend on how many rows share the call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import collectives as C
from repro_torch.launch.sharding import get_mesh, in_manual_region


def rows_sharded(k_dim: int, mesh) -> bool:
    """True when ``mesh`` (or None) splits a row-parallel weight of
    ``k_dim`` rows over its "model" axis: M > 1 divides K."""
    m = 1 if mesh is None else mesh.shape.get("model", 1)
    return m > 1 and k_dim % m == 0


def row_parallel_matmul(x: torch.Tensor, w: torch.Tensor,
                        compute_dtype: torch.dtype) -> torch.Tensor:
    """y = x @ w with the contraction dim K split over the active mesh's
    "model" axis (the reference's bf16-wire row-parallel matmul).

    x (..., K) is replicated across the model axis; under a mesh whose
    model axis M > 1 divides K (outside a manual region), ``w`` holds this
    rank's K / M rows at rest (``models.convert.shard_params``).  Each
    rank multiplies its K / M columns of x by them, accumulating in fp32
    and storing at the compute dtype, and the M partial products are
    summed at that dtype over the group (the reference's bf16 wire).
    Otherwise the plain product."""
    mesh = get_mesh()
    k_dim = x.shape[-1]
    if not rows_sharded(k_dim, mesh) or in_manual_region():
        return x.to(compute_dtype) @ w.to(compute_dtype)
    m = mesh.shape["model"]
    if w.shape[0] != k_dim // m:
        raise ValueError(f"row-parallel w has {w.shape[0]} rows; this rank "
                         f"holds {k_dim // m} of {k_dim}")
    group = mesh.axis_group("model")
    x_loc = C.slice_replicated(x.to(compute_dtype), x.dim() - 1, group)
    return C.sum_replicated(x_loc @ w.to(compute_dtype), group)


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
    """SwiGLU: (silu(x W1) * (x W3)) W2 at the compute dtype, W2
    row-parallel (:func:`row_parallel_matmul`)."""
    x = x.to(compute_dtype)
    xr = _rows(x)
    h = F.silu(xr @ p["w1"].to(compute_dtype))
    h = h * (xr @ p["w3"].to(compute_dtype))
    return _unrows(row_parallel_matmul(h, p["w2"], compute_dtype), x)


def embed(tokens: torch.Tensor, table: torch.Tensor,
          compute_dtype: torch.dtype) -> torch.Tensor:
    return table[tokens.long()].to(compute_dtype)


def lm_loss_chunked(h: torch.Tensor, w_out: torch.Tensor,
                    labels: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """Mean next-token cross-entropy of h (B, S, D) under the head w_out
    (D, V), labels (B, S) with -1 ignored, over sequence chunks of
    ``chunk`` rows and a remainder chunk: at most one chunk's (B, chunk,
    V) fp32 logits at a time in the forward.  The reference's
    ``lm_loss_chunked``: per chunk the sums of (logsumexp - gold logit)
    over the valid labels and of their count, added chunk by chunk in
    order; the mean over max(count, 1)."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    n_chunks = s // chunk
    w = w_out.float()
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    bounds = [(i * chunk, (i + 1) * chunk) for i in range(n_chunks)]
    if s > n_chunks * chunk:
        bounds.append((n_chunks * chunk, s))
    for lo, hi in bounds:
        logits = h[:, lo:hi].float() @ w
        yc = labels[:, lo:hi]
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            yc.long().clamp(min=0)[..., None])[..., 0]
        valid = (yc >= 0).float()
        tot = tot + torch.sum((logz - gold) * valid)
        cnt = cnt + torch.sum(valid)
    return tot / torch.clamp(cnt, min=1.0)


def _needs_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_needs_grad(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_needs_grad(v) for v in tree)
    return isinstance(tree, torch.Tensor) and tree.requires_grad


def remat(cfg, fn, *args, **kwargs):
    """fn(*args, **kwargs), recomputed in the backward instead of keeping
    its activations when ``cfg.remat`` and autograd records the call (an
    input requires grad): the reference's per-layer ``jax.checkpoint``.
    A serve's call is a plain call."""
    if cfg.remat and torch.is_grad_enabled() and _needs_grad(args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kwargs)
    return fn(*args, **kwargs)
