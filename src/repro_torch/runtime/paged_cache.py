"""Paged KV cache: fixed-size pages + per-sequence page tables.

Counterpart of ``repro.runtime.paged_cache``.

  * **Pool**: ``k``/``v`` tensors of shape ``(n_layers, num_pages,
    page_size, kv_dim)``; one physical page id addresses the same slot in
    every layer's pool.
  * **Page table**: ``(max_batch, max_pages_per_seq) int32`` mapping a
    sequence's logical page ``pos // page_size`` to a physical page id.
  * **Null page**: physical page 0 is a write sink.  Inactive batch slots
    and pad positions write there; the allocator never hands it out.

The pool is updated IN PLACE (``index_put_``): the attention layer writes
each step's K/V into the pool tensors it was given and returns the same
tensors.  The reference donates the pool through its jitted calls
(``runtime/engine.py``) for the same reason - the pool can dwarf device
memory if double-buffered - and in eager PyTorch the in-place write is how
that is expressed.

Pages are recycled without scrubbing: the attention kernels take the
per-page key shift and row pseudo-average over the valid (pos < kv_len)
columns only and zero V there, so stale bytes past ``kv_len`` never reach
an output.  The page size is free of ``attention.block_kv``: decode shifts
in blocks of ``block_kv`` rows of the page-table view (a block may span
pages), prefill in one block a page, as the reference serves them.

Quantized pools (``"fp8_e4m3"``, ``"int8"``) store **shift-centered**
8-bit codes plus per-page, per-kv-head sidecars: ``*_shift`` (the page's
valid-row mean, a head_dim vector per kv head, f32) and ``*_scale``
(absmax of the centered values / qmax, f32).  Subtracting the per-page
key mean before rounding is PASA's pseudo-average shift used as a storage
format: the sequence bias lives in the mean, and what is left fits 8 bits.
The kernels dequantize ``codes * scale + shift`` in registers.  Sidecars
are pool leaves indexed by physical page id, so recycling a page recycles
its metadata with it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch.core.collectives import shard

NULL_PAGE = 0

# CLI/engine-facing names for the pool storage dtype.
POOL_DTYPES = {
    "bf16": torch.bfloat16,
    "fp8_e4m3": torch.float8_e4m3fn,
    "int8": torch.int8,
}

# Largest code magnitude per quantized dtype: int8 uses the symmetric
# [-127, 127] (the zero point stays exactly 0); float8_e4m3fn's largest
# finite value is 448 and it has no Inf, so codes are clipped first.
QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}


def resolve_pool_dtype(dtype) -> torch.dtype:
    """Accept a ``POOL_DTYPES`` name or a torch dtype; return the dtype."""
    if isinstance(dtype, str):
        try:
            return POOL_DTYPES[dtype]
        except KeyError as e:
            raise ValueError(
                f"unknown pool dtype {dtype!r}; have {sorted(POOL_DTYPES)}"
            ) from e
    if not isinstance(dtype, torch.dtype) or not (
            dtype.is_floating_point or dtype in QMAX):
        raise ValueError(f"unsupported pool dtype {dtype!r}")
    return dtype


def is_quantized_dtype(dtype) -> bool:
    return resolve_pool_dtype(dtype) in QMAX


def pool_dtype_name(dtype) -> str:
    """The ``POOL_DTYPES`` name of a pool dtype (else torch's name)."""
    dt = resolve_pool_dtype(dtype)
    for name, d in POOL_DTYPES.items():
        if d == dt:
            return name
    return str(dt).replace("torch.", "")


class PageAllocator:
    """Free-list allocator over physical page ids ``1..num_pages-1``.

    Invariants: the free list and the live set partition
    ``{1..num_pages-1}``; page 0 is never allocated or freed; ``alloc`` is
    all-or-nothing; double and foreign frees raise.  ``metrics`` (a
    ``runtime.telemetry.MetricsRegistry``, optional) counts
    ``pages.allocated`` and ``pages.freed``."""

    def __init__(self, num_pages: int, metrics=None):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the null sink)")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._live = set()
        self.metrics = metrics

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        return len(self._live)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` pages, or None (and no state change) if unavailable."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._live.update(pages)
        if self.metrics is not None and pages:
            self.metrics.counter("pages.allocated").inc(len(pages))
        return pages

    def free(self, pages) -> None:
        n = 0
        for p in pages:
            if p == NULL_PAGE:
                raise ValueError("cannot free the null page")
            if p not in self._live:
                raise ValueError(f"double/foreign free of page {p}")
            self._live.remove(p)
            self._free.append(p)
            n += 1
        if self.metrics is not None and n:
            self.metrics.counter("pages.freed").inc(n)


def init_paged_pool(n_layers: int, num_pages: int, page_size: int,
                    kv_dim: int, dtype=torch.bfloat16,
                    n_kv_heads: Optional[int] = None, *, device) -> dict:
    """Zero-initialized pool: ``k``/``v`` of (L, P, page, kv_dim); a
    quantized dtype adds ``k_scale``/``v_scale`` (L, P, KVH) and
    ``k_shift``/``v_shift`` (L, P, kv_dim), all f32, and needs
    ``n_kv_heads`` (the scale granularity)."""
    dtype = resolve_pool_dtype(dtype)
    shape = (n_layers, num_pages, page_size, kv_dim)
    pool = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }
    if dtype in QMAX:
        if n_kv_heads is None or kv_dim % n_kv_heads:
            raise ValueError(
                f"quantized pool needs n_kv_heads dividing kv_dim "
                f"({n_kv_heads} / {kv_dim})"
            )
        for side in ("k", "v"):
            pool[f"{side}_scale"] = torch.zeros(
                (n_layers, num_pages, n_kv_heads), dtype=torch.float32,
                device=device)
            pool[f"{side}_shift"] = torch.zeros(
                (n_layers, num_pages, kv_dim), dtype=torch.float32,
                device=device)
    return pool


# Fraction of a page's VALID elements the "quantile" scale mode treats as
# outliers: the scale comes from the largest magnitude after dropping the
# top QUANTILE_DROP fraction; the dropped outliers saturate at the code
# range's edge.
QUANTILE_DROP = 0.01

SCALE_MODES = ("absmax", "quantile")


def quantize_kv_page(raw: torch.Tensor, valid: torch.Tensor, dtype, *,
                     center: bool = True, scale_mode: str = "absmax"):
    """Shift-centered symmetric quantization of KV pages.

    raw: (..., page, KVH, D) float values; valid: (..., page) bool rows
    (invalid rows are left out of the statistics and coded as 0).

    Returns (codes (..., page, KVH, D) in ``dtype``, scale (..., KVH) f32,
    shift (..., KVH, D) f32) with ``dequant = codes * scale + shift`` on
    the valid rows.  The statistics read only the valid rows, so a page's
    codes and sidecars are a function of its own valid values.

    ``scale_mode``: ``"absmax"`` (scale = max |centered| / qmax) or
    ``"quantile"`` (clipped absmax: the largest magnitude after dropping
    the top :data:`QUANTILE_DROP` of the valid elements; finer resolution
    of the bulk, but outliers saturate - and softmax attends exactly those,
    so end-to-end attention is worse on outlier-heavy pages).
    ``center=False`` forces the shift to 0: the unshifted baseline."""
    dtype = resolve_pool_dtype(dtype)
    if scale_mode not in SCALE_MODES:
        raise ValueError(
            f"unknown scale_mode {scale_mode!r}; have {SCALE_MODES}"
        )
    qmax = QMAX[dtype]
    raw = raw.float()
    vm = valid[..., None, None]                       # (..., page, 1, 1)
    zero = raw.new_zeros(())
    if center:
        cnt = torch.clamp(vm.float().sum(-3, keepdim=True), min=1.0)
        shift = torch.where(vm, raw, zero).sum(-3, keepdim=True) / cnt
    else:
        shift = torch.zeros_like(raw[..., :1, :, :])
    centered = torch.where(vm, raw - shift, zero)      # (..., page, KVH, D)
    if scale_mode == "quantile":
        amax = _quantile_amax(centered, valid)
    else:
        amax = centered.abs().amax(dim=(-3, -1))       # (..., KVH)
    scale = torch.clamp(amax, min=1e-8) / qmax
    codes = torch.clamp(centered / scale[..., None, :, None], -qmax, qmax)
    if dtype == torch.int8:
        codes = torch.round(codes)
    return codes.to(dtype), scale, shift[..., 0, :, :]


def _quantile_amax(centered: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Largest |centered| per (..., KVH) after dropping the top
    :data:`QUANTILE_DROP` fraction of the VALID elements.  Invalid rows are
    zeros, so they sort to the bottom and the k-th largest element overall
    is the k-th largest valid one."""
    page, kvh, d = centered.shape[-3:]
    mags = centered.abs().movedim(-2, -3)              # (..., KVH, page, D)
    flat = mags.reshape(*mags.shape[:-2], page * d)
    srt = torch.sort(flat, dim=-1).values              # ascending
    n_valid = valid.to(torch.int32).sum(-1) * d        # (...,)
    drop = (QUANTILE_DROP * n_valid.float()).to(torch.int64)
    idx = torch.clamp(page * d - 1 - drop, 0, page * d - 1)
    idx = idx[..., None, None].expand(*srt.shape[:-1], 1)
    return torch.gather(srt, -1, idx)[..., 0]          # (..., KVH)


def dequantize_kv_page(codes: torch.Tensor, scale: torch.Tensor,
                       shift: torch.Tensor) -> torch.Tensor:
    """codes (..., page, KVH, D) x scale (..., KVH) x shift (..., KVH, D)
    -> f32 values: the product and the sum each rounded in f32, as the
    kernels compute them."""
    return (codes.float() * scale[..., None, :, None]
            + shift[..., None, :, :])


def gather_pages_dequant(pool_layer: torch.Tensor, scale: torch.Tensor,
                         shift: torch.Tensor,
                         page_table: torch.Tensor) -> torch.Tensor:
    """Quantized counterpart of :func:`gather_pages`: codes (P, page,
    kv_dim), scale (P, KVH), shift (P, kv_dim) and a (B, max_pages) table
    -> (B, max_pages * page, kv_dim) f32.  Positions past ``kv_len``
    dequantize stale bytes and are masked downstream."""
    b, mp = page_table.shape
    _, page, kv_dim = pool_layer.shape
    kvh = scale.shape[-1]
    flat = page_table.reshape(-1).long()
    codes = pool_layer[flat].reshape(b, mp, page, kvh, kv_dim // kvh)
    sc = scale[flat].reshape(b, mp, kvh)
    sh = shift[flat].reshape(b, mp, kvh, kv_dim // kvh)
    return dequantize_kv_page(codes, sc, sh).reshape(b, mp * page, kv_dim)


def gather_pages(pool_layer: torch.Tensor,
                 page_table: torch.Tensor) -> torch.Tensor:
    """(P, page, kv_dim) x (B, max_pages) -> (B, max_pages*page, kv_dim).

    The plain read path: one gather rebuilds each sequence's contiguous
    view.  Positions past ``kv_len`` may hold stale page contents and are
    masked downstream."""
    b, mp = page_table.shape
    page = pool_layer.shape[1]
    out = pool_layer[page_table.reshape(-1).long()]
    return out.reshape(b, mp * page, *pool_layer.shape[2:])


# Speculative-verify page snapshot and rollback (the engine's verify).
#
# A K-draft verify chains K+1 decode sub-steps; each sub-step's append
# touches exactly one physical page per row, the page holding its write
# position (a quantized pool rewrites that page's codes and sidecars
# whole, a raw pool one slot).  Rolling back rejected sub-steps is a byte
# restore of those per-sub-step pre-images in reverse order: no allocator
# traffic, no re-quantization.


def touched_pages(page_table: torch.Tensor, pos: torch.Tensor,
                  page_size: int) -> torch.Tensor:
    """(B, max_pages) table x (B,) write positions -> the (B,) physical
    page each row's decode append at ``pos`` lands in (a nulled table row
    resolves to the null page)."""
    idx = (pos.long() // page_size)[:, None]
    return torch.gather(page_table, 1, idx)[:, 0]


def capture_pages(pool: dict, phys: torch.Tensor) -> dict:
    """Pre-image of physical pages ``phys`` (B,) across every pool leaf:
    per leaf a (layers, B, ...) slice of the page dim (axis 1), codes and
    the 8-bit pools' scale/shift sidecars alike.  The pool is written in
    place by the next sub-step, so this gathers a copy (advanced indexing
    never returns a view)."""
    idx = phys.long()
    return {name: leaf[:, idx] for name, leaf in pool.items()}


def restore_pages(pool: dict, phys: torch.Tensor, pre: dict,
                  undo: torch.Tensor) -> dict:
    """Write the :func:`capture_pages` pre-image back into pages ``phys``
    where ``undo`` (B,) holds, in place; returns the pool.  Kept rows are
    redirected to the null page with an identity write.  Several rows may
    then target page 0 in one write, and which of them lands there is
    unspecified; that does not matter, because page 0 is never attended
    (inactive rows and pad positions write there)."""
    b = phys.shape[0]
    tgt = torch.where(undo, phys, NULL_PAGE).long()
    for name, leaf in pool.items():
        keep = undo.reshape((1, b) + (1,) * (leaf.dim() - 2))
        leaf[:, tgt] = torch.where(keep, pre[name], leaf[:, tgt])
    return pool


# Sharding over the mesh's model axis.  Every pool leaf is kv-head-major
# in its trailing axis: ``k``/``v`` (L, P, page, kv_dim), ``*_scale``
# (L, P, KVH) and ``*_shift`` (L, P, kv_dim).  When the model axis divides
# the kv heads, each rank keeps its kv heads' columns of every leaf, so the
# split lands on head boundaries and one rule covers raw and 8-bit pools;
# otherwise every rank keeps the whole pool (replicated).

#: The dim each pool leaf splits over the model axis.
_SPLIT_DIM = {"k": 3, "v": 3, "k_scale": 2, "v_scale": 2, "k_shift": 2,
              "v_shift": 2}


def model_axis_size(mesh, axis: str = "model") -> int:
    """Size of a mesh axis (1 when the axis is absent or mesh is None)."""
    if mesh is None:
        return 1
    return int(dict(mesh.shape).get(axis, 1))


def pool_model_sharded(mesh, n_kv_heads: Optional[int]) -> bool:
    """True when the pool's leaves split over the mesh's model axis: the
    split must land on kv-head boundaries."""
    m = model_axis_size(mesh)
    return m > 1 and n_kv_heads is not None and n_kv_heads % m == 0


def pool_pspecs(mesh, pool: dict, n_kv_heads: Optional[int]) -> dict:
    """The port's PartitionSpec of every pool leaf: the dim it splits over
    the model axis (its trailing kv-head-major axis), or None where the
    pool stays replicated."""
    shard = pool_model_sharded(mesh, n_kv_heads)
    return {name: _SPLIT_DIM[name] if shard else None for name in pool}


@dataclasses.dataclass(frozen=True)
class LeafSharding:
    """Where one pool leaf lives on the model axis: split into ``parts``
    along ``dim`` with this rank holding part ``index``, or whole on every
    rank (``dim`` None)."""

    dim: Optional[int]
    parts: int
    index: int

    @property
    def is_fully_replicated(self) -> bool:
        return self.dim is None or self.parts == 1

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole leaf ``x`` (a contiguous copy)."""
        if self.is_fully_replicated:
            return x
        return shard(x, self.dim, self.parts, self.index)


def pool_shardings(mesh, pool: dict, n_kv_heads: Optional[int]) -> dict:
    """:func:`pool_pspecs` as a :class:`LeafSharding` per leaf, at this
    process's rank on the model axis."""
    specs = pool_pspecs(mesh, pool, n_kv_heads)
    m = model_axis_size(mesh)
    r = mesh.axis_rank("model") if m > 1 else 0
    return {name: LeafSharding(dim, m, r) for name, dim in specs.items()}


class ShardedPool(dict):
    """A page pool whose leaves hold this rank's part (``shardings``: the
    :class:`LeafSharding` of every leaf), the one record of its layout, as
    a jax array carries its sharding.  :func:`paged_bytes` counts the
    whole pool, :func:`paged_bytes_per_device` this rank's part, and the
    engine's pool boundary gathers and splits by it."""

    def __init__(self, leaves: dict, shardings: dict):
        super().__init__(leaves)
        self.shardings = dict(shardings)


def shard_pool(pool: dict, shardings: dict) -> ShardedPool:
    """This rank's part of every leaf of the whole ``pool``."""
    return ShardedPool(
        {name: shardings[name].shard(x) for name, x in pool.items()},
        shardings)


def paged_bytes(pool: dict) -> int:
    """The pool's whole footprint in bytes, sidecars included: on every
    rank together for a :class:`ShardedPool`."""
    sh = getattr(pool, "shardings", {})
    return sum(
        x.numel() * x.element_size()
        * (1 if name not in sh or sh[name].is_fully_replicated
           else sh[name].parts)
        for name, x in pool.items())


def paged_bytes_per_device(pool: dict) -> int:
    """The bytes this rank holds: each leaf's local part times its
    itemsize.  Equals :func:`paged_bytes` for a one-device or replicated
    pool, 1/M of it for the kv-head-sharded layout."""
    return sum(x.numel() * x.element_size() for x in pool.values())


def sharded_pool_device_bytes(
    n_layers: int, num_pages: int, page_size: int, kv_dim: int,
    dtype, n_kv_heads: int, model_size: int,
) -> int:
    """Analytic per-device pool bytes under the :func:`pool_shardings`
    layout for a model axis of ``model_size``, with no device: every leaf
    splits its kv-head axis when ``n_kv_heads % model_size == 0``, else
    everything is replicated."""
    dtype = resolve_pool_dtype(dtype)
    div = model_size if (model_size > 1
                         and n_kv_heads % model_size == 0) else 1
    kv_bytes = n_layers * num_pages * page_size * (kv_dim // div)
    total = 2 * kv_bytes * torch.empty((), dtype=dtype).element_size()
    if is_quantized_dtype(dtype):
        total += 2 * n_layers * num_pages * (n_kv_heads // div) * 4
        total += 2 * n_layers * num_pages * (kv_dim // div) * 4
    return total
