"""Selective state-space blocks: Mamba-1 (falcon-mamba) and Mamba-2
(zamba2's backbone).

Counterpart of ``repro.models.ssm``: ``_dt_rank``, ``d_inner``,
``_causal_conv``, ``_mamba1_inner``, ``mamba1_block`` and ``mamba1_cache``
(Mamba-1); ``mamba2_heads``, ``_ssd_chunked``, ``mamba2_block`` and
``mamba2_cache`` (Mamba-2), each block with its no-cache and its decode
branch.  The blocks are attention-free: PASA does not apply here, and
they run in plain PyTorch on every device.

Dtypes follow the reference: the projections run at the compute dtype
(bf16) through ``layers.matmuls``; the convolution and the whole SSM run
in fp32 (``a_log``, ``dt_bias``, ``d_skip``, Mamba-1's ``dt_proj`` and the
SSM state are fp32); the conv window is cached at the cache dtype
(bf16).  The decode branches write the layer's cache in place.

Batch invariance of the decode step (each row's result independent of
how many rows share the step, as ``layers.MIN_ROWS`` keeps it for the
GEMMs and norms): the convolution is a sum of K elementwise products in
tap order; the readout ``C . h`` and the transcendental steps (silu,
softplus, exp) run on the batch zero-padded to ``MIN_ROWS`` rows - a CPU
kernel takes its vectorized or its scalar code for an element by the
element's offset in the tensor, and the two may round differently.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def _dt_rank(cfg: ModelConfig) -> int:
    return max(cfg.d_model // 16, 1)


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm.expand * cfg.d_model


def mamba2_heads(cfg: ModelConfig) -> int:
    return d_inner(cfg) // cfg.ssm.head_p


def _conv_taps(window: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """sum_i window[..., i, :] * w[:, i] + b in fp32, taps in order.
    window (..., K, C) fp32, w (C, K), b (C,)."""
    w, b = w.float(), b.float()
    out = window[..., 0, :] * w[:, 0]
    for i in range(1, w.shape[-1]):
        out = out + window[..., i, :] * w[:, i]
    return out + b


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv in fp32, returned at x's dtype; x (B, S, C),
    w (C, K), b (C,) -> (B, S, C)."""
    s, k = x.shape[1], w.shape[-1]
    xp = F.pad(x.float(), (0, 0, k - 1, 0))                 # (B, S+K-1, C)
    window = torch.stack([xp[:, i:i + s] for i in range(k)], dim=2)
    return _conv_taps(window, w, b).to(x.dtype)


def _padded(fn, *xs: torch.Tensor) -> torch.Tensor:
    """fn(*xs) computed on the batch (the leading dim of each x)
    zero-padded to ``L.MIN_ROWS`` rows."""
    n = xs[0].shape[0]
    if n >= L.MIN_ROWS:
        return fn(*xs)
    pad = lambda x: torch.cat([x, x.new_zeros((L.MIN_ROWS - n,) + x.shape[1:])])
    return fn(*map(pad, xs))[:n]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# =============================================================================
# Mamba-1 (falcon-mamba-7b)
# =============================================================================

def _mamba1_inner(x, dt, bmat, cmat, a, d_skip, h0=None):
    """Sequential selective scan in fp32 (the reference's scan is a loop
    here).

    x, dt: (B, S, Di); bmat, cmat: (B, S, N); a: (Di, N); d_skip: (Di,).
    Returns y (B, S, Di) and the final state (B, Di, N)."""
    bb, s, di = x.shape
    n = bmat.shape[-1]
    x, dt, bmat, cmat = (t.float() for t in (x, dt, bmat, cmat))
    d_skip = d_skip.float()
    h = (torch.zeros((bb, di, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    readout = lambda hh, c: (hh * c[:, None, :]).sum(-1)
    ys = []
    for t in range(s):
        da = _padded(torch.exp, dt[:, t, :, None] * a)           # (B, Di, N)
        h = da * h + (dt[:, t] * x[:, t])[..., None] * bmat[:, t, None, :]
        ys.append(_padded(readout, h, cmat[:, t]) + d_skip * x[:, t])
    return torch.stack(ys, dim=1), h


def mamba1_block(x: torch.Tensor, p: dict, cfg: ModelConfig, *,
                 cache: Optional[dict] = None):
    """x: (B, S, D) -> (y (B, S, D), cache).

    Without a cache: the scan over the whole sequence (returns cache
    None).  With ``cache = {"conv": (B, K-1, Di), "ssm": (B, Di, N)}``
    (one layer's views): one decode step (S == 1) that rolls the conv
    window and advances the SSM state, both written in place; returns the
    same dict."""
    cd = cfg.torch_compute_dtype()
    di, n, dr = d_inner(cfg), cfg.ssm.state, _dt_rank(cfg)
    s = x.shape[1]
    x = x.to(cd)
    (xz,) = L.matmuls(x, p["in_proj"].to(cd))
    xs, z = torch.split(xz, [di, di], dim=-1)

    if cache is None:
        xs = _causal_conv(xs, p["conv_w"], p["conv_b"])
    else:
        if s != 1:
            raise ValueError(f"mamba1 decode takes one token per row, got {s}")
        window = torch.cat([cache["conv"], xs.to(cache["conv"].dtype)], dim=1)
        xs = _conv_taps(window.float(), p["conv_w"], p["conv_b"])[:, None]
        xs = xs.to(cd)
        cache["conv"].copy_(window[:, 1:])
    xs = _padded(F.silu, xs)

    (dbc,) = L.matmuls(xs, p["x_proj"].to(cd))
    dt, bmat, cmat = torch.split(dbc, [dr, n, n], dim=-1)
    (dt,) = L.matmuls(dt.float(), p["dt_proj"].float())
    dt = _padded(_softplus, dt + p["dt_bias"].float())           # (B, S, Di)
    a = -torch.exp(p["a_log"].float())                          # (Di, N)

    h0 = None if cache is None else cache["ssm"]
    y, h = _mamba1_inner(xs, dt, bmat, cmat, a, p["d_skip"], h0=h0)
    if cache is not None:
        cache["ssm"].copy_(h)

    (y,) = L.matmuls(y.to(cd) * _padded(F.silu, z), p["out_proj"].to(cd))
    return y, cache


def mamba1_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16, *,
                 device) -> dict:
    """Per-layer decode state: the conv window (L, B, K-1, Di) at ``dtype``
    and the SSM state (L, B, Di, N) in fp32."""
    di, n, dc = d_inner(cfg), cfg.ssm.state, cfg.ssm.d_conv
    return {
        "conv": torch.zeros((cfg.n_layers, batch, dc - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((cfg.n_layers, batch, di, n), dtype=torch.float32,
                           device=device),
    }


# =============================================================================
# Mamba-2 (zamba2)
# =============================================================================

def _ssd_chunked(x, dt, bmat, cmat, a, h0=None):
    """Chunked SSD (Mamba-2 dual form).

    x: (B, S, NH, P); dt: (B, S, NH); bmat/cmat: (B, S, N); a: (NH,) < 0.
    Returns y (B, S, NH, P), final state (B, NH, N, P).  The chunk is
    min(S, 128), halved until it divides S (the reference's rule; it does
    not read ``cfg.ssm.chunk``); the reference's scan over chunk states
    is a loop here."""
    bb, s, nh, p = x.shape
    n = bmat.shape[-1]
    c = min(s, 128)
    while s % c:
        c //= 2
    nc = s // c

    da = dt * a[None, None, :]                                  # (B, S, NH) <= 0
    xc = x.reshape(bb, nc, c, nh, p)
    dtc = dt.reshape(bb, nc, c, nh)
    dac = da.reshape(bb, nc, c, nh)
    bc = bmat.reshape(bb, nc, c, n)
    cc = cmat.reshape(bb, nc, c, n)

    cum = torch.cumsum(dac, dim=2)                              # (B, NC, c, NH)
    # within-chunk decay L[i, j] = exp(cum_i - cum_j), i >= j
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]          # (B,NC,c,c,NH)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    lmask = torch.where(tri[None, None, :, :, None], torch.exp(li),
                        torch.zeros((), dtype=li.dtype, device=x.device))
    # scores (C_i . B_j) * L * dt_j
    att = torch.einsum("bzin,bzjn->bzij", cc, bc)[..., None] * lmask
    att = att * dtc[:, :, None, :, :]
    y_diag = torch.einsum("bzijh,bzjhp->bzihp", att, xc)

    # chunk-final states: S_z = sum_j exp(cum_end - cum_j) dt_j B_j x_j^T
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)              # (B,NC,c,NH)
    sstate = torch.einsum("bzjh,bzjn,bzjhp->bznhp", decay_end * dtc, bc, xc)

    # inter-chunk recurrence over NC states
    chunk_decay = torch.exp(cum[:, :, -1, :])                   # (B, NC, NH)
    h = (torch.zeros((bb, n, nh, p), dtype=x.dtype, device=x.device)
         if h0 is None else h0.movedim(1, 2).to(x.dtype))       # (B,N,NH,P)
    hprev = []
    for z in range(nc):
        hprev.append(h)                                         # state BEFORE chunk
        h = h * chunk_decay[:, z, None, :, None] + sstate[:, z]
    hprev = torch.stack(hprev, dim=1)                           # (B,NC,N,NH,P)
    y_off = torch.einsum("bzin,bzih,bznhp->bzihp", cc, torch.exp(cum), hprev)
    y = (y_diag + y_off).reshape(bb, s, nh, p)
    return y, h.movedim(1, 2)                                   # (B,NH,N,P)


def mamba2_block(x: torch.Tensor, p: dict, cfg: ModelConfig, *,
                 cache: Optional[dict] = None):
    """x: (B, S, D) -> (y (B, S, D), cache).

    Without a cache: the chunked SSD over the whole sequence (returns
    cache None).  With ``cache = {"conv": (B, K-1, Di), "ssm": (B, NH, N,
    P)}`` (one layer's views): one decode step (S == 1) that rolls the conv
    window and advances the SSM state, both written in place; returns the
    same dict."""
    cd = cfg.torch_compute_dtype()
    di, n = d_inner(cfg), cfg.ssm.state
    nh, hp = mamba2_heads(cfg), cfg.ssm.head_p
    bsz, s, _ = x.shape
    x = x.to(cd)
    (proj,) = L.matmuls(x, p["in_proj"].to(cd))
    z, xs, bmat, cmat, dt = torch.split(proj, [di, di, n, n, nh], dim=-1)

    if cache is None:
        xs = _causal_conv(xs, p["conv_w"], p["conv_b"])
    else:
        if s != 1:
            raise ValueError(f"mamba2 decode takes one token per row, got {s}")
        window = torch.cat([cache["conv"], xs.to(cache["conv"].dtype)], dim=1)
        xs = _conv_taps(window.float(), p["conv_w"], p["conv_b"])[:, None]
        xs = xs.to(cd)
        cache["conv"].copy_(window[:, 1:])
    xs = _padded(F.silu, xs)

    dt = _padded(_softplus, dt.float() + p["dt_bias"].float())  # (B,S,NH)
    a = -torch.exp(p["a_log"].float())                          # (NH,)
    xh = xs.reshape(bsz, s, nh, hp).float()
    bf = bmat.float()
    cf = cmat.float()

    if cache is None:
        y, _ = _ssd_chunked(xh, dt, bf, cf, a)
    else:
        # O(1) decode step: h <- exp(dt*a) h + dt * (B outer x); y = C.h
        h0 = cache["ssm"].float()                               # (B,NH,N,P)
        da = _padded(torch.exp, dt[:, 0, :, None, None] * a[None, :, None, None])
        upd = (dt[:, 0, :, None, None] * bf[:, 0, None, :, None]
               * xh[:, 0, :, None, :])
        h = da * h0 + upd
        y = _padded(lambda c, hh: torch.einsum("bn,bhnp->bhp", c, hh),
                    cf[:, 0], h).reshape(bsz, 1, nh, hp)
        cache["ssm"].copy_(h)

    y = y + p["d_skip"].float()[None, None, :, None] * xh
    y = y.reshape(bsz, s, di).to(cd)
    y = L.rms_norm(y * _padded(F.silu, z), p["norm_w"], cfg.norm_eps)
    (y,) = L.matmuls(y, p["out_proj"].to(cd))
    return y, cache


def mamba2_cache(cfg: ModelConfig, n_layers: int, batch: int,
                 dtype=torch.bfloat16, *, device) -> dict:
    """Per-layer decode state: the conv window (L, B, K-1, Di) at ``dtype``
    and the SSM state (L, B, NH, N, P) in fp32."""
    di, n = d_inner(cfg), cfg.ssm.state
    nh, hp = mamba2_heads(cfg), cfg.ssm.head_p
    return {
        "conv": torch.zeros((n_layers, batch, cfg.ssm.d_conv - 1, di),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((n_layers, batch, nh, n, hp), dtype=torch.float32,
                           device=device),
    }
