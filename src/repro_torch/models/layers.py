"""Shared building blocks: RMSNorm, RoPE, SwiGLU MLP, embedding, the
chunked cross-entropy of training and per-layer remat.

Counterpart of ``repro.models.layers`` with the same dtype steps: norms
and RoPE compute in fp32 and store at the activation dtype, matmuls run at
the compute dtype.  The reference's placement hints (``shard``) have no
counterpart (``launch.sharding``); its ``row_parallel_matmul`` is the
MLP's ``w2`` product across the mesh's model axis, after the
column-parallel ``w1`` / ``w3``, and its chunk logits sharded vocab-wise
are the vocab-parallel ``embed`` and ``lm_loss_chunked`` on this rank's
V / M rows and columns.  Norms and products
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
                        compute_dtype: torch.dtype,
                        x_split: bool = False) -> torch.Tensor:
    """y = x @ w with the contraction dim K split over the active mesh's
    "model" axis (the reference's bf16-wire row-parallel matmul).

    ``w`` holds this rank's K / M rows at rest
    (``models.convert.shard_params``).  With ``x_split`` x (..., K / M)
    is this rank's K / M columns already (a column-parallel product's
    output: the MLP's hidden units, the attention's heads); otherwise x
    (..., K) is replicated across the model axis and, under a mesh whose
    model axis M > 1 divides K (outside a manual region), each rank takes
    its K / M columns.  Each rank multiplies its columns by its rows,
    accumulating in fp32 and storing at the compute dtype, and the M
    partial products are summed at that dtype over the group (the
    reference's bf16 wire).  Otherwise the plain product."""
    mesh = get_mesh()
    x = x.to(compute_dtype)
    if x_split:
        return C.sum_replicated(x @ w.to(compute_dtype),
                                mesh.axis_group("model"))
    k_dim = x.shape[-1]
    if not rows_sharded(k_dim, mesh) or in_manual_region():
        return x @ w.to(compute_dtype)
    m = mesh.shape["model"]
    if w.shape[0] != k_dim // m:
        raise ValueError(f"row-parallel w has {w.shape[0]} rows; this rank "
                         f"holds {k_dim // m} of {k_dim}")
    group = mesh.axis_group("model")
    x_loc = C.slice_replicated(x, x.dim() - 1, group)
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


def mlp(x: torch.Tensor, p: dict, compute_dtype: torch.dtype,
        d_ff: int) -> torch.Tensor:
    """SwiGLU: (silu(x W1) * (x W3)) W2 at the compute dtype.  Where a
    training mesh's placement leaves this rank F / M of the ``d_ff``
    hidden units (``models.convert.gather_params``), column-parallel:
    its ``w1`` / ``w3`` columns give its hidden units, which go straight
    into its rows of the row-parallel ``w2`` (:func:`row_parallel_matmul`),
    and the input's gradient is summed over the model group."""
    x = x.to(compute_dtype)
    split = p["w1"].shape[-1] != d_ff
    if split:
        x = C.sum_grad(x, get_mesh().axis_group("model"))
    xr = _rows(x)
    h = F.silu(xr @ p["w1"].to(compute_dtype))
    h = h * (xr @ p["w3"].to(compute_dtype))
    return _unrows(row_parallel_matmul(h, p["w2"], compute_dtype, split), x)


def _vocab_block(rows: int, vocab: int):
    """(model group, first vocabulary row) of this rank's ``rows`` of the
    ``vocab`` rows of a table split on V over the active mesh's model
    axis (``models.convert.computes_split``)."""
    mesh = get_mesh()
    m = 1 if mesh is None else mesh.shape.get("model", 1)
    if rows * m != vocab or in_manual_region():
        raise ValueError(f"a vocabulary block of {rows} of {vocab} rows "
                         f"outside a training mesh's model axis of {m}")
    return mesh.axis_group("model"), mesh.axis_rank("model") * rows


def embed(tokens: torch.Tensor, table: torch.Tensor,
          compute_dtype: torch.dtype, vocab=None) -> torch.Tensor:
    """The rows of ``table`` (V, D) at ``tokens``, at the compute dtype.

    Given the whole vocabulary size ``vocab``, a table of fewer rows is
    this rank's block of V / M rows (the plan splits V over the model
    axis): vocab-parallel, each rank looks up the tokens that fall in its
    rows, writes zero rows elsewhere, and the rows are summed over the
    model group - one term of each sum is not zero, so the result is the
    whole table's lookup bit for bit; the backward leaves each rank the
    gradient of its own rows."""
    if vocab is None or table.shape[0] == vocab:
        return table[tokens.long()].to(compute_dtype)
    group, v0 = _vocab_block(table.shape[0], vocab)
    local = tokens.long() - v0
    own = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)].to(compute_dtype)
    zero = torch.zeros((), dtype=compute_dtype, device=rows.device)
    return C.sum_replicated(torch.where(own[..., None], rows, zero), group)


def _split_logz_gold(logits: torch.Tensor, yc: torch.Tensor, v0: int,
                     group):
    """(logsumexp, gold logit) of each row of a chunk's logits whose
    columns [v0, v0 + V / M) this rank holds: the row max all-reduced
    (max, no gradient through it), the sum of exp(logit - max) and the
    gold logit (from the rank that owns its column, 0 elsewhere) summed
    over the group in fp32; both are replicated, so the sum's backward is
    the identity."""
    mx = C.all_reduce(logits.detach().amax(-1), "max", group)
    local = yc.long() - v0
    own = (local >= 0) & (local < logits.shape[-1])
    pick = torch.gather(logits, -1,
                        local.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    sums = C.sum_replicated(torch.stack([
        torch.exp(logits - mx[..., None]).sum(-1),
        torch.where(own, pick, zero)]), group)
    return mx + torch.log(sums[0]), sums[1]


def lm_loss_chunked(h: torch.Tensor, w_out: torch.Tensor,
                    labels: torch.Tensor, chunk: int = 1024,
                    vocab=None) -> torch.Tensor:
    """Mean next-token cross-entropy of h (B, S, D) under the head w_out
    (D, V), labels (B, S) with -1 ignored, over sequence chunks of
    ``chunk`` rows and a remainder chunk: at most one chunk's (B, chunk,
    V) fp32 logits at a time in the forward.  The reference's
    ``lm_loss_chunked``: per chunk the sums of (logsumexp - gold logit)
    over the valid labels and of their count, added chunk by chunk in
    order; the mean over max(count, 1).

    Given the whole vocabulary size ``vocab``, a head of fewer columns
    is this rank's block of V / M columns (the plan splits V over the
    model axis): vocab-parallel, each rank computes its chunk's (B,
    chunk, V / M) logits, the log-partition and the gold logit come from
    fp32 reductions over the model group (:func:`_split_logz_gold`), and
    each chunk of h enters through ``collectives.sum_grad`` (its gradient
    summed over the group, in fp32)."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    n_chunks = s // chunk
    w = w_out.float()
    split = vocab is not None and w.shape[-1] != vocab
    if split:
        group, v0 = _vocab_block(w.shape[-1], vocab)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    bounds = [(i * chunk, (i + 1) * chunk) for i in range(n_chunks)]
    if s > n_chunks * chunk:
        bounds.append((n_chunks * chunk, s))
    for lo, hi in bounds:
        yc = labels[:, lo:hi]
        if split:
            logits = C.sum_grad(h[:, lo:hi].float(), group) @ w
            logz, gold = _split_logz_gold(logits, yc, v0, group)
        else:
            logits = h[:, lo:hi].float() @ w
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
