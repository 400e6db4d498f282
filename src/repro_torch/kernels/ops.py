"""Public entry points of the attention kernels (counterpart of
``repro.kernels.ops``).

Dispatch is by the device of the tensors: a CPU tensor goes to the
kernel's plain PyTorch version, a CUDA tensor to the CUDA kernel - or the
call raises (unsupported shape, dtype, policy or block size).  There is
no fall back from the card to the plain version.  Each wrapper counts the
kernel launches it makes in a plain integer attribute,
``<wrapper>.launches`` (``pasa_attention`` with beta > 0 also launches the
shift kernel, counted in ``shift_kv.launches``), and each of its kernel's
modes apart in ``<wrapper>.launches_by_mode``: the attention and decode
ops keyed by the policy and the dtype of the pool or cache they read
(``pasa_paged_decode.mode_name``, e.g. ``"bf16_fp32/bfloat16"``), the
shift op by its own modes (``shift_kv.mode_name``).  The four attention
kernels run the fp16, fp16_fp32, fp32 and bf16_fp32 policies, with the
output at the policy's output dtype; the float64 oracle policy raises on
the card.  Every op takes head_dim 32, 64 or 128 on the card and counts
a launch at 32 or 64 under a mode of its own (``"fp16/bfloat16/d64"``,
``"bf16_keys/fp16_ops/block128/d32"``); each raises before any launch
for another width.  The attention ops take ``kv_valid``: the keys' columns at or past
it are padding (zero rows the caller added to reach a whole block), which
the row pseudo-average counts and the softmax masks, as the reference's
``blocked_attention`` pads and masks.

A tensor on the ``meta`` device (the dry run's shapes) gets an empty
output of the right shape and dtype and runs no loop of the plain
version: it is no fallback, since a CUDA tensor still goes to the kernel
or raises.  Under ``launch.op_analysis.count()`` each op's call adds its
FLOP / byte formula (``kernels.cost``) and nothing of what runs inside
it, on every device; outside a count the op runs its body directly.

The reference's ``interpret`` and ``use_kernel`` switches have no
counterpart: the plain versions live beside each kernel in its module.
The paged ops take a quantized pool (int8 or float8_e4m3fn codes) with
its four f32 sidecars ``k_scale``/``v_scale`` (P, KVH) and
``k_shift``/``v_shift`` (P, KVH, D) - all four or none - and count its
launches in the same counters as raw pools.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.beta import DEFAULT_BETA
from repro_torch.core.collectives import all_gather, shard
from repro_torch.core.precision import FP16, PrecisionPolicy
from repro_torch.core.shifting import effective_invariance, shifting_matrix
from repro_torch.kernels import cost
from repro_torch.kernels.cost import host_lengths, run_op
# the kernel modules (flash_attention's at the end of this file, as it
# imports an op from here): imported while the package initialises, before
# its __init__ binds these names to the ops below, so that a later import
# of one finds it loaded and leaves the package's names alone
from repro_torch.kernels import pasa_attention as _attn
from repro_torch.kernels import pasa_decode as _cdecode
from repro_torch.kernels import pasa_paged_decode as _decode
from repro_torch.kernels import pasa_paged_prefill as _prefill
from repro_torch.kernels import shift_kv as _shift


_QUANT_NAMES = ("k_scale", "k_shift", "v_scale", "v_shift")


def _check_quant(k_pages: torch.Tensor, quant) -> dict:
    """The all-or-none sidecar bundle, shapes checked (the reference's
    ``_check_quant``); returns ``{name: tensor}``, empty for a raw pool."""
    given = [x is not None for x in quant]
    if not any(given):
        return {}
    if not all(given):
        raise ValueError(f"quantized pool needs all of {_QUANT_NAMES}")
    p, _, kvh, d = k_pages.shape
    for name, x, want in zip(_QUANT_NAMES, quant,
                             ((p, kvh), (p, kvh, d), (p, kvh), (p, kvh, d))):
        if tuple(x.shape) != want:
            raise ValueError(f"{name} shape {tuple(x.shape)} != {want}")
    return dict(zip(_QUANT_NAMES, quant))


def _check_pages(k_pages: torch.Tensor, v_pages: torch.Tensor) -> None:
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"pages must be (P, page, KVH, D); got {tuple(k_pages.shape)} / "
            f"{tuple(v_pages.shape)}"
        )


def _count(wrapper, mode: str) -> None:
    """One launch of ``wrapper``'s kernel in mode ``mode``."""
    wrapper.launches += 1
    wrapper.launches_by_mode[mode] = wrapper.launches_by_mode.get(mode, 0) + 1


def _head_dim(op: str, d: int, head_dims) -> None:
    """Raise (before any launch) unless the kernel of ``op`` is built for
    head width ``d``."""
    if d not in head_dims:
        widths = " or ".join(str(w) for w in head_dims)
        raise NotImplementedError(
            f"the CUDA {op} kernel is written for head_dim {widths}, got {d}")


def _cuda_inputs(op, q, k_pages, v_pages, ints, policy, quant, head_dims):
    """Validate and normalize the inputs of the paged kernel of ``op``:
    everything on q's CUDA device, head width in ``head_dims``, q at the
    policy's input dtype, pools contiguous - bf16/fp16 values without
    sidecars, int8/fp8 codes with them (f32, contiguous) - index tensors
    int32 contiguous (small copies only; the pool is never copied)."""
    _decode.policy_scalars(0.0, policy, _decode.HEAD_DIM)  # policy check
    dev = q.device
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages)) + tuple(
        ints.items()
    ) + tuple(quant.items()):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
    raw = (torch.bfloat16, torch.float16)
    codes = (torch.int8, torch.float8_e4m3fn)
    if v_pages.dtype != k_pages.dtype \
            or k_pages.dtype not in (codes if quant else raw):
        raise NotImplementedError(
            f"the CUDA kernels read bf16/fp16 pools without sidecars and "
            f"int8/fp8_e4m3 pools with them, got {k_pages.dtype} "
            f"{'with' if quant else 'without'} sidecars"
        )
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("page pools must be contiguous")
    for name, x in quant.items():
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    _head_dim(op, q.shape[-1], head_dims)
    b = q.shape[0]
    for name, x in ints.items():
        want = 2 if name == "page_table" else 1
        if x.dim() != want or x.shape[0] != b:
            raise ValueError(
                f"{name} shape {tuple(x.shape)} does not match batch {b}"
            )
    q = q.to(policy.input_dtype).contiguous()
    ints = {k: v.to(torch.int32).contiguous() for k, v in ints.items()}
    return q, ints


def pasa_paged_decode(
    q: torch.Tensor,           # (B, KVH, G, D) grouped query heads, one token
    k_pages: torch.Tensor,     # (num_pages, page, KVH, D) raw physical pages
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (B, max_pages) int32
    kv_len: torch.Tensor,      # (B,)
    *,
    beta: float = DEFAULT_BETA,
    policy: PrecisionPolicy = FP16,
    k_scale: Optional[torch.Tensor] = None,
    k_shift: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    v_shift: Optional[torch.Tensor] = None,
    block_kv: Optional[int] = None,
) -> torch.Tensor:
    """GQA flash-decode over a paged KV pool (``shift_mask_valid``).

    ``block_kv`` is the PASA shift-block length (default: the page size).
    Both versions shift in blocks of ``block_kv`` rows of the page-table
    view, whatever the page size, as the reference's attention layer
    does; the CUDA kernel takes ``block_kv`` a multiple of 16 up to 256
    (as the contiguous decode) and a page of any size.  The four sidecars
    select the quantized mode (codes dequantized at
    ``policy.input_dtype``)."""
    if q.dim() != 4:
        raise ValueError("q must be (B, KVH, G, D)")
    _check_pages(k_pages, v_pages)
    quant = _check_quant(k_pages, (k_scale, k_shift, v_scale, v_shift))
    if q.shape[1] != k_pages.shape[2]:
        raise ValueError(
            f"q has {q.shape[1]} kv heads, the pages {k_pages.shape[2]}"
        )
    block_kv = k_pages.shape[1] if block_kv is None else int(block_kv)
    return run_op("pasa_paged_decode", _paged_decode_cost, _paged_decode,
                  q, k_pages, v_pages, page_table, kv_len, beta, policy,
                  block_kv, quant)


def _paged_decode_cost(q, k_pages, v_pages, page_table, kv_len, beta,
                       policy, block_kv, quant):
    b, kvh, g, d = q.shape
    return cost.paged_decode_cost(
        b, kvh, g, d, host_lengths("kv_len", kv_len), page_table.numel(),
        kv_itemsize=k_pages.element_size(), q_itemsize=q.element_size(),
        page=k_pages.shape[1] if quant else None)


def _paged_decode(q, k_pages, v_pages, page_table, kv_len, beta, policy,
                  block_kv, quant):
    if q.device.type == "cpu":
        return _decode.paged_decode_plain(
            q, k_pages, v_pages, page_table, kv_len,
            beta=beta, policy=policy, block_kv=block_kv, **quant,
        )
    if q.device.type == "meta":
        return q.new_empty(q.shape, dtype=policy.out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"no pasa_paged_decode for device {q.device}")
    _cuda_block("block_kv", block_kv, _cdecode.MAX_BLOCK)
    if q.shape[2] > _decode.MAX_GROUP:
        raise NotImplementedError(
            f"GQA group {q.shape[2]} > {_decode.MAX_GROUP}"
        )
    q, ints = _cuda_inputs(
        "paged decode", q, k_pages, v_pages,
        {"page_table": page_table, "kv_len": kv_len}, policy, quant,
        _decode.HEAD_DIMS,
    )
    out = _decode.kernel_call(
        q, k_pages, v_pages, ints["page_table"], ints["kv_len"],
        beta=beta, policy=policy, block_kv=block_kv, quant=quant,
    )
    _count(pasa_paged_decode,
           _decode.mode_name(policy, k_pages.dtype, q.shape[-1]))
    return out


pasa_paged_decode.launches = 0
pasa_paged_decode.launches_by_mode = {}


def pasa_paged_verify(
    q: torch.Tensor,           # (B, KVH, G, W, D) grouped queries, W positions
    k_pages: torch.Tensor,     # (num_pages, page, KVH, D) raw physical pages,
    v_pages: torch.Tensor,     #   or int8 / fp8 codes with the sidecars
    page_table: torch.Tensor,  # (B, max_pages) int32
    start: torch.Tensor,       # (B,) absolute position of query column 0
    *,
    beta: float = DEFAULT_BETA,
    policy: PrecisionPolicy = FP16,
    k_scale: Optional[torch.Tensor] = None,
    k_shift: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    v_shift: Optional[torch.Tensor] = None,
    block_kv: Optional[int] = None,
) -> torch.Tensor:
    """Speculative-verify attention: W consecutive decode positions per
    row over a paged pool -> (B, KVH, G, W, D).

    Column j is :func:`pasa_paged_decode` at ``kv_len = start + 1 + j``
    (its K/V already in its page), so each column equals the one-token
    decode at that position bit for bit: W decode calls, each a kernel
    launch on the card (counted in ``pasa_paged_decode.launches``) and the
    plain version on the CPU.  The decode shift convention
    (``shift_mask_valid``), not the chunk-exact prefill one.  The engine's
    verify chains whole decode steps and does not call this."""
    if q.dim() != 5:
        raise ValueError("q must be (B, KVH, G, W, D)")
    cols = [
        pasa_paged_decode(
            q[:, :, :, j], k_pages, v_pages, page_table, start + 1 + j,
            beta=beta, policy=policy, k_scale=k_scale, k_shift=k_shift,
            v_scale=v_scale, v_shift=v_shift, block_kv=block_kv,
        )
        for j in range(q.shape[3])
    ]
    return torch.stack(cols, dim=3)


def pasa_paged_prefill(
    q: torch.Tensor,            # (B, H, CS, D) chunk queries, full query heads
    k_pages: torch.Tensor,      # (num_pages, page, KVH, D) raw physical pages
    v_pages: torch.Tensor,
    page_table: torch.Tensor,   # (B, max_pages) int32
    chunk_start: torch.Tensor,  # (B,) absolute position of the chunk's row 0
    kv_len: torch.Tensor,       # (B,) valid KV length (chunk end)
    *,
    beta: float = DEFAULT_BETA,
    policy: PrecisionPolicy = FP16,
    k_scale: Optional[torch.Tensor] = None,
    k_shift: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    v_shift: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Chunked prefill over a paged KV pool (chunk-exact convention).

    The chunk's K/V must already be written into its pages; the B rows may
    belong to different requests, and a pad row (``kv_len == 0``) emits
    zeros.  A page is one PASA block; the CUDA kernel takes pages of 1 to
    256 rows.  The four sidecars select the quantized mode."""
    if q.dim() != 4:
        raise ValueError("q must be (B, H, CS, D)")
    _check_pages(k_pages, v_pages)
    quant = _check_quant(k_pages, (k_scale, k_shift, v_scale, v_shift))
    if q.shape[1] % k_pages.shape[2]:
        raise ValueError(
            f"q heads {q.shape[1]} not a multiple of kv heads "
            f"{k_pages.shape[2]}"
        )
    return run_op("pasa_paged_prefill", _paged_prefill_cost, _paged_prefill,
                  q, k_pages, v_pages, page_table, chunk_start, kv_len, beta,
                  policy, quant)


def _paged_prefill_cost(q, k_pages, v_pages, page_table, chunk_start, kv_len,
                        beta, policy, quant):
    b, h, cs, d = q.shape
    return cost.paged_prefill_cost(
        b, h, cs, d, k_pages.shape[2],
        host_lengths("chunk_start", chunk_start),
        host_lengths("kv_len", kv_len), page_table.numel(),
        kv_itemsize=k_pages.element_size(), q_itemsize=q.element_size(),
        page=k_pages.shape[1] if quant else None)


def _paged_prefill(q, k_pages, v_pages, page_table, chunk_start, kv_len,
                   beta, policy, quant):
    if q.device.type == "cpu":
        return _prefill.paged_prefill_plain(
            q, k_pages, v_pages, page_table, chunk_start, kv_len,
            beta=beta, policy=policy, **quant,
        )
    if q.device.type == "meta":
        return q.new_empty(q.shape, dtype=policy.out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"no pasa_paged_prefill for device {q.device}")
    if k_pages.shape[1] > _prefill.MAX_PAGE:
        raise NotImplementedError(
            f"the CUDA prefill kernel takes pages of 1 to {_prefill.MAX_PAGE} "
            f"rows (one PASA block a page), got {k_pages.shape[1]}"
        )
    q, ints = _cuda_inputs(
        "paged prefill", q, k_pages, v_pages,
        {"page_table": page_table, "chunk_start": chunk_start,
         "kv_len": kv_len},
        policy, quant, _decode.HEAD_DIMS,
    )
    out = _prefill.kernel_call(
        q, k_pages, v_pages, ints["page_table"], ints["chunk_start"],
        ints["kv_len"], beta=beta, policy=policy, quant=quant,
    )
    _count(pasa_paged_prefill,
           _decode.mode_name(policy, k_pages.dtype, q.shape[-1]))
    return out


pasa_paged_prefill.launches = 0
pasa_paged_prefill.launches_by_mode = {}


# Model-axis sharded entry points.  Both paged kernels are local to a kv
# head: the page shift, the softmax statistics and the PV product never
# cross the KVH axis.  When the model axis divides the kv heads, every rank
# runs the same kernel on its kv heads' slice of q and of the pool, and the
# outputs all-gathered along KVH in rank order are the unsharded call's
# bit for bit.  When it does not, both take the replicated call: every
# rank runs the one-device kernel on the whole inputs.  Every rank calls
# these with the whole inputs, as the reference's ``shard_map`` takes
# global arrays.


def _kv_slice(mesh, axis, x, dim):
    """This rank's part of ``x`` along its kv-head ``dim`` (None stays
    None)."""
    if x is None:
        return None
    n = mesh.shape[axis]
    return shard(x, dim, n, mesh.axis_rank(axis))


def pasa_paged_decode_sharded(
    q: torch.Tensor,           # (B, KVH, G, D)
    k_pages: torch.Tensor,     # (P, page, KVH, D)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    kv_len: torch.Tensor,
    *,
    mesh,
    axis: str = "model",
    beta: float = DEFAULT_BETA,
    policy: PrecisionPolicy = FP16,
    k_scale: Optional[torch.Tensor] = None,
    k_shift: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    v_shift: Optional[torch.Tensor] = None,
    block_kv: Optional[int] = None,
) -> torch.Tensor:
    """:func:`pasa_paged_decode` kv-head-split over ``mesh``'s ``axis``:
    the unsharded call's output bit for bit when ``KVH % axis_size == 0``,
    else the replicated call."""
    msize = mesh.shape.get(axis, 1)
    kw = dict(beta=beta, policy=policy, block_kv=block_kv)
    if msize <= 1 or q.shape[1] % msize:
        return pasa_paged_decode(
            q, k_pages, v_pages, page_table, kv_len, k_scale=k_scale,
            k_shift=k_shift, v_scale=v_scale, v_shift=v_shift, **kw)
    local = pasa_paged_decode(
        _kv_slice(mesh, axis, q, 1), _kv_slice(mesh, axis, k_pages, 2),
        _kv_slice(mesh, axis, v_pages, 2), page_table, kv_len,
        k_scale=_kv_slice(mesh, axis, k_scale, 1),
        k_shift=_kv_slice(mesh, axis, k_shift, 1),
        v_scale=_kv_slice(mesh, axis, v_scale, 1),
        v_shift=_kv_slice(mesh, axis, v_shift, 1), **kw)
    return all_gather(local, 1, mesh.axis_group(axis))


def pasa_paged_prefill_sharded(
    q: torch.Tensor,            # (B, H, CS, D)
    k_pages: torch.Tensor,      # (P, page, KVH, D)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    chunk_start: torch.Tensor,
    kv_len: torch.Tensor,
    *,
    mesh,
    axis: str = "model",
    beta: float = DEFAULT_BETA,
    policy: PrecisionPolicy = FP16,
    k_scale: Optional[torch.Tensor] = None,
    k_shift: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    v_shift: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`pasa_paged_prefill` over ``mesh``'s ``axis``.  When the axis
    divides KVH and H: a kv-head split (queries split along their
    kv-head-major H axis, whole GQA groups per rank), the unsharded call's
    output bit for bit.  Otherwise the replicated call."""
    msize = mesh.shape.get(axis, 1)
    quant = dict(k_scale=k_scale, k_shift=k_shift, v_scale=v_scale,
                 v_shift=v_shift)
    if msize <= 1:
        return pasa_paged_prefill(q, k_pages, v_pages, page_table,
                                  chunk_start, kv_len, beta=beta,
                                  policy=policy, **quant)
    if k_pages.shape[2] % msize or q.shape[1] % msize:
        return pasa_paged_prefill(q, k_pages, v_pages, page_table,
                                  chunk_start, kv_len, beta=beta,
                                  policy=policy, **quant)
    local = pasa_paged_prefill(
        _kv_slice(mesh, axis, q, 1), _kv_slice(mesh, axis, k_pages, 2),
        _kv_slice(mesh, axis, v_pages, 2), page_table, chunk_start,
        kv_len, beta=beta, policy=policy,
        **{name: _kv_slice(mesh, axis, x, 1) for name, x in quant.items()})
    return all_gather(local, 1, mesh.axis_group(axis))


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("expected (B, H, S, D) tensors")
    if k.shape != v.shape:
        raise ValueError(f"k/v shape mismatch: {tuple(k.shape)} vs {tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"q {tuple(q.shape)} incompatible with kv {tuple(k.shape)}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"q heads {q.shape[1]} % kv heads {k.shape[1]} != 0")


def _cuda_block(name: str, block: int, limit: int) -> None:
    if block % 16 or not 16 <= block <= limit:
        raise NotImplementedError(
            f"the CUDA kernel takes {name} a multiple of 16 up to {limit}, "
            f"got {block}"
        )


def _cuda_rows(name: str, x: torch.Tensor, dev) -> None:
    """The kernels read 16-byte row segments through the strides (the
    caller has checked the head width)."""
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, q on {dev}")
    if x.stride(-1) != 1 or any(st % 8 for st in x.stride()[:-1]) \
            or x.data_ptr() % 16:
        raise ValueError(
            f"{name} needs unit stride on the head dim, other strides that "
            f"are multiples of 8 and a 16-byte aligned start"
        )


def shift_kv(
    k: torch.Tensor,            # (B, KVH, S2, D)
    *,
    beta: float = DEFAULT_BETA,
    block_kv: int = 128,
    policy: PrecisionPolicy = FP16,
) -> torch.Tensor:
    """Standalone K pre-processing (Algorithm 1 lines 5-7): K'_j = M K_j
    with the shifting matrix at ``policy.input_dtype``."""
    if k.dim() != 4:
        raise ValueError("k must be (B, KVH, S2, D)")
    if k.shape[2] % block_kv:
        raise ValueError(f"S2={k.shape[2]} not divisible by block_kv={block_kv}")
    return run_op("shift_kv", _shift_kv_cost, _shift_kv, k, beta, block_kv,
                  policy)


def _shift_kv_cost(k, beta, block_kv, policy):
    return cost.shift_kv_cost(k.numel(), k.element_size(), block_kv,
                              out_itemsize=policy.input_dtype.itemsize)


def _shift_kv(k, beta, block_kv, policy):
    d = k.shape[-1]
    if k.device.type == "cpu":
        m = shifting_matrix(block_kv, d, beta, policy.input_dtype)
        return _shift.shift_kv_plain(m, k.to(policy.input_dtype), block_kv,
                                     out_dtype=policy.input_dtype)
    if k.device.type == "meta":
        return k.new_empty(k.shape, dtype=policy.input_dtype)
    if k.device.type != "cuda":
        raise ValueError(f"no shift_kv for device {k.device}")
    op = policy.input_dtype
    if op not in (torch.float16, torch.bfloat16):
        raise NotImplementedError(
            f"the CUDA shift kernel takes fp16 or bf16 operands, not {op}")
    if block_kv not in (64, 128):
        raise NotImplementedError(
            f"the CUDA shift kernel takes block_kv 64 or 128, got {block_kv}")
    _head_dim("shift", d, _decode.HEAD_DIMS)
    # bf16 keys under fp16 operands are rounded on chip
    if k.dtype != op and not (op == torch.float16 and k.dtype == torch.bfloat16):
        k = k.to(op)
    _cuda_rows("k", k, k.device)
    m = _shift.device_matrix(block_kv, d, float(beta), op, k.device)
    out = _shift.kernel_call(m, k, block_kv=block_kv)
    _count(shift_kv, _shift.mode_name(k.dtype, op, block_kv, d))
    return out


shift_kv.launches = 0
shift_kv.launches_by_mode = {}


def _attention(q, k, v, *, beta, policy, block_q, block_kv, causal,
               kv_valid, wrapper):
    """The shift-KV pass (beta > 0) then the fused attention sweep."""
    _check(q, k, v)
    s2 = k.shape[2]
    if q.shape[2] % block_q or s2 % block_kv:
        raise ValueError(
            f"S1={q.shape[2]} % block_q={block_q} and S2={s2} % "
            f"block_kv={block_kv} must be 0 (the dense layer pads)"
        )
    if kv_valid is not None and not s2 - block_kv < kv_valid <= s2:
        raise ValueError(
            f"kv_valid={kv_valid} must pad less than one block: "
            f"{s2 - block_kv} < kv_valid <= S2={s2}"
        )
    return run_op(wrapper.__name__, _attention_cost, _attention_call, q, k,
                  v, beta=beta, policy=policy, block_q=block_q,
                  block_kv=block_kv, causal=causal, kv_valid=kv_valid,
                  wrapper=wrapper)


def _attention_cost(q, k, v, *, beta, policy, block_q, block_kv, causal,
                    kv_valid, wrapper):
    return attention_op_cost(q, k, beta=beta, policy=policy,
                             block_kv=block_kv, causal=causal,
                             kv_valid=kv_valid)


def attention_op_cost(q, k, *, beta, policy, block_kv, causal, kv_valid,
                      backward=False):
    """(bytes, flops) of one attention op call (``kernels.cost``): the
    sweep over K' and V, and the shift-KV pass when beta > 0; for the
    plain-version backward of ``kernels.train_attention``,
    ``cost.BACKWARD_FACTOR`` times the sweep's FLOPs, reading q, K, V and
    the output's gradient and writing their gradients."""
    b, h, s1, d = q.shape
    kvh, s2 = k.shape[1], k.shape[2]
    item = policy.input_dtype.itemsize
    nbytes, flops = cost.attention_cost(b, h, s1, kvh, s2, d, causal=causal,
                                        kv_valid=kv_valid, itemsize=item)
    if backward:   # q, K, V, dO in; dQ, dK, dV out
        return ((3 * q.numel() + 4 * k.numel()) * item,
                int(cost.BACKWARD_FACTOR * flops))
    if beta > 0.0:
        sb, sf = cost.shift_kv_cost(k.numel(), k.element_size(), block_kv,
                                    out_itemsize=item)
        nbytes, flops = nbytes + sb, flops + sf
    return nbytes, flops


def _attention_call(q, k, v, *, beta, policy, block_q, block_kv, causal,
                    kv_valid, wrapper):
    if q.device.type == "cpu":
        return _attn.attention_plain(q, k, v, beta=beta, policy=policy,
                                     block_kv=block_kv, causal=causal,
                                     kv_valid=kv_valid)
    if q.device.type == "meta":
        return q.new_empty(q.shape, dtype=policy.out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    for name, block in (("block_q", block_q), ("block_kv", block_kv)):
        if block not in (64, 128):
            raise NotImplementedError(
                f"the CUDA attention kernel takes {name} 64 or 128, got {block}"
            )
    d = q.shape[-1]
    _head_dim("attention", d, _decode.HEAD_DIMS)
    op = policy.input_dtype
    # the recovery multiplier of the GEMM shift is the invariance the
    # rounded M realizes, not the ideal beta/(1-beta)
    inva = (effective_invariance(block_kv, d, beta, op)
            if beta > 0.0 else 0.0)
    _decode.policy_scalars(beta, policy, d, inva)   # raises before a launch
    mode = _decode.mode_name(policy, k.dtype, d)
    q, v = q.to(op), v.to(op)
    for name, x in (("q", q), ("v", v)):
        _cuda_rows(name, x, q.device)
    if beta > 0.0:
        k_sh = shift_kv(k, beta=beta, block_kv=block_kv, policy=policy)
    else:
        k_sh = k.to(op)
        _cuda_rows("k", k_sh, q.device)
    out = _attn.kernel_call(q, k_sh, v, beta=beta, inva=inva, policy=policy,
                            causal=causal, block_q=block_q, block_kv=block_kv,
                            kv_valid=kv_valid)
    _count(wrapper, mode)
    return out


def pasa_attention(
    q: torch.Tensor,            # (B, H, S1, D)
    k: torch.Tensor,            # (B, KVH, S2, D) RAW keys
    v: torch.Tensor,
    *,
    beta: float = DEFAULT_BETA,
    policy: PrecisionPolicy = FP16,
    block_q: int = 128,
    block_kv: int = 128,
    causal: bool = False,
    kv_valid: Optional[int] = None,
) -> torch.Tensor:
    """Fused PASA attention: shift-KV GEMM pass + online-recovery sweep.
    S1 % block_q == 0 and S2 % block_kv == 0, else ValueError; key columns
    at or past ``kv_valid`` (S2 - block_kv < kv_valid <= S2) are padding."""
    return _attention(q, k, v, beta=beta, policy=policy, block_q=block_q,
                      block_kv=block_kv, causal=causal, kv_valid=kv_valid,
                      wrapper=pasa_attention)


pasa_attention.launches = 0
pasa_attention.launches_by_mode = {}


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    policy: PrecisionPolicy = FP16,
    block_q: int = 128,
    block_kv: int = 128,
    causal: bool = False,
    kv_valid: Optional[int] = None,
) -> torch.Tensor:
    """FlashAttention-2 baseline: the attention kernel at beta = 0."""
    return _attention(q, k, v, beta=0.0, policy=policy, block_q=block_q,
                      block_kv=block_kv, causal=causal, kv_valid=kv_valid,
                      wrapper=flash_attention)


flash_attention.launches = 0
flash_attention.launches_by_mode = {}


def pasa_decode(
    q: torch.Tensor,            # (B, KVH, G, D) grouped query heads, one token
    k_cache: torch.Tensor,      # (B, KVH, S2, D) raw cache, any row strides
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,       # (B,)
    *,
    beta: float = DEFAULT_BETA,
    policy: PrecisionPolicy = FP16,
    block_kv: int = 256,
) -> torch.Tensor:
    """GQA flash-decode with the algebraic valid-column shift (ideal
    invariance beta/(1-beta)).  Positions at or past ``kv_len`` are never
    read on the card and are inert in the plain version."""
    if q.dim() != 4:
        raise ValueError("q must be (B, KVH, G, D)")
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[:2] != q.shape[:2] \
            or k_cache.shape[-1] != q.shape[-1]:
        raise ValueError(
            f"caches must be (B, KVH, S2, D) matching q {tuple(q.shape)}; "
            f"got {tuple(k_cache.shape)} / {tuple(v_cache.shape)}"
        )
    return run_op("pasa_decode", _contiguous_decode_cost, _contiguous_decode,
                  q, k_cache, v_cache, kv_len, beta, policy, block_kv)


def _contiguous_decode_cost(q, k_cache, v_cache, kv_len, beta, policy,
                            block_kv):
    b, kvh, g, d = q.shape
    return cost.decode_cost(b, kvh, g, d, host_lengths("kv_len", kv_len),
                            kv_itemsize=k_cache.element_size(),
                            q_itemsize=q.element_size())


def _contiguous_decode(q, k_cache, v_cache, kv_len, beta, policy, block_kv):
    if q.device.type == "cpu":
        return _cdecode.decode_plain(q, k_cache, v_cache, kv_len, beta=beta,
                                     policy=policy, block_kv=block_kv)
    if q.device.type == "meta":
        return q.new_empty(q.shape, dtype=policy.out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"no pasa_decode for device {q.device}")
    _cuda_block("block_kv", block_kv, _cdecode.MAX_BLOCK)
    _head_dim("decode", q.shape[-1], _decode.HEAD_DIMS)
    if q.shape[2] > _decode.MAX_GROUP:
        raise NotImplementedError(f"GQA group {q.shape[2]} > {_decode.MAX_GROUP}")
    if k_cache.dtype not in (torch.bfloat16, torch.float16) \
            or v_cache.dtype != k_cache.dtype \
            or v_cache.stride() != k_cache.stride():
        raise NotImplementedError(
            "the CUDA decode kernel reads bf16 or fp16 caches of one layout")
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        _cuda_rows(name, x, q.device)
    if kv_len.device != q.device or kv_len.shape != (q.shape[0],):
        raise ValueError(f"kv_len must be ({q.shape[0]},) on {q.device}")
    q = q.to(policy.input_dtype).contiguous()
    out = _cdecode.kernel_call(
        q, k_cache, v_cache, kv_len.to(torch.int32).contiguous(),
        beta=beta, policy=policy, block_kv=block_kv,
    )
    _count(pasa_decode, _decode.mode_name(policy, k_cache.dtype, q.shape[-1]))
    return out


pasa_decode.launches = 0
pasa_decode.launches_by_mode = {}

WRAPPERS = (pasa_paged_decode, pasa_paged_prefill, pasa_attention,
            flash_attention, pasa_decode, shift_kv)


def reset_launches() -> None:
    """Set every wrapper's launch counts to 0."""
    for wrapper in WRAPPERS:
        wrapper.launches = 0
        wrapper.launches_by_mode = {}


# last: the flash_attention module imports the op defined above
from repro_torch.kernels import flash_attention as _flash  # noqa: E402,F401
