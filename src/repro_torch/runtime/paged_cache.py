"""Paged KV cache: fixed-size pages + per-sequence page tables.

Counterpart of ``repro.runtime.paged_cache`` for raw (unquantized) pools.

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
an output.  Keeping ``page_size == attention.block_kv`` makes a page one
PASA shift block.
"""

from __future__ import annotations

from typing import List, Optional

import torch

NULL_PAGE = 0

# CLI/engine-facing names for the pool storage dtype.  The quantized pools
# of the reference (fp8_e4m3, int8) are not ported yet.
POOL_DTYPES = {"bf16": torch.bfloat16}


def resolve_pool_dtype(dtype) -> torch.dtype:
    """Accept a ``POOL_DTYPES`` name or a torch floating dtype."""
    if isinstance(dtype, str):
        try:
            return POOL_DTYPES[dtype]
        except KeyError as e:
            raise NotImplementedError(
                f"pool dtype {dtype!r} is not ported; have {sorted(POOL_DTYPES)}"
            ) from e
    if not (isinstance(dtype, torch.dtype) and dtype.is_floating_point):
        raise NotImplementedError(f"pool dtype {dtype!r} is not ported")
    return dtype


class PageAllocator:
    """Free-list allocator over physical page ids ``1..num_pages-1``.

    Invariants: the free list and the live set partition
    ``{1..num_pages-1}``; page 0 is never allocated or freed; ``alloc`` is
    all-or-nothing; double and foreign frees raise."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the null sink)")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._live = set()

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
        return pages

    def free(self, pages) -> None:
        for p in pages:
            if p == NULL_PAGE:
                raise ValueError("cannot free the null page")
            if p not in self._live:
                raise ValueError(f"double/foreign free of page {p}")
            self._live.remove(p)
            self._free.append(p)


def init_paged_pool(n_layers: int, num_pages: int, page_size: int,
                    kv_dim: int, dtype=torch.bfloat16, *, device) -> dict:
    """Zero-initialized raw pool ``{"k", "v"}`` of (L, P, page, kv_dim)."""
    dtype = resolve_pool_dtype(dtype)
    shape = (n_layers, num_pages, page_size, kv_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


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


def paged_bytes(pool: dict) -> int:
    """Device footprint of the pool in bytes."""
    return sum(x.numel() * x.element_size() for x in pool.values())
