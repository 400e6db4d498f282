"""PASA chunked prefill over a PAGED KV pool: CUDA kernel + plain version.

Counterpart of ``repro.kernels.pasa_paged_prefill``.

  * :func:`kernel_call` launches ``csrc/pasa_paged_prefill.cu`` (pages of
    1 to 128 rows) or ``csrc/pasa_paged_prefill_wide.cu`` (129 or more: a
    page over 256 rows streams through its 256-row stage in pieces, one
    PASA block a page still), or their ``_q8`` siblings for 8-bit pools,
    one template
    (``csrc/pasa_paged_prefill.cuh``): one CTA per (row *
    head, 128-query tile), longest causal tiles first; the visible pages
    arrive by TMA into stages of 128 key rows - pages of up to 32 rows
    several to a stage, each at a row offset rounded up to 16 (pages of
    1 to 16 rows: 8 a stage), a page of 33 to 128 rows alone - a converter
    warpgroup turns each page into the shifted operands (at the policy's
    input dtype, the key mean over that page's valid rows) a stage ahead,
    and two consumer warpgroups run one score GEMM a stage as wgmma with
    the scores in registers, then each page in page order as its own
    PASA block: its statistics, P, P V of its columns alone into a fresh
    sum, the rows' step and the fold (see the source's note).  One
    instance per head width in ``pasa_paged_decode.HEAD_DIMS``.
  * :func:`paged_prefill_plain` is the port of the reference's
    ``paged_prefill_xla``: a gather of the pages (dequantized for 8-bit
    pools, as in ``pasa_paged_decode``), then
    :func:`repro_torch.core.pasa.blocked_attention` at the chunk-exact
    convention with block granularity == page size.  It is the kernel's
    oracle and the path every CPU tensor takes.

Both compute a prompt chunk of full-head queries q (B, H, CS, D) against
pages (P, page, KVH, D): each row b has its own ``chunk_start`` (absolute
position of query 0), ``kv_len`` (valid positions after the chunk) and
page-table row; a pad row with ``kv_len == 0`` emits zeros.  The output is
bit-invariant to the chunk schedule (page-aligned chunk boundaries).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.pasa import blocked_attention
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.kernels import _build
from repro_torch.kernels.pasa_paged_decode import (
    POOL_KINDS,
    _gather_dequant,
    policy_scalars,
    sidecar_ptrs,
)

WIDE_PAGE = 128      # pages over this many rows build in the wide source


def paged_prefill_plain(
    q: torch.Tensor,            # (B, H, CS, D)
    k_pages: torch.Tensor,      # (P, page, KVH, D)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,   # (B, max_pages)
    chunk_start: torch.Tensor,  # (B,)
    kv_len: torch.Tensor,       # (B,)
    *,
    beta: float,
    policy: PrecisionPolicy,
    k_scale: Optional[torch.Tensor] = None,   # (P, KVH) f32 } 8-bit pools:
    k_shift: Optional[torch.Tensor] = None,   # (P, KVH, D)  } all four
    v_scale: Optional[torch.Tensor] = None,
    v_shift: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gather-then-attend at the chunk-exact convention."""
    b, h, cs, d = q.shape
    page, kvh = k_pages.shape[1], k_pages.shape[2]
    dt = policy.input_dtype
    ks = _gather_dequant(k_pages, k_scale, k_shift, page_table, dt).movedim(2, 1)
    vs = _gather_dequant(v_pages, v_scale, v_shift, page_table, dt).movedim(2, 1)
    out = blocked_attention(
        q.to(policy.input_dtype).reshape(b, kvh, h // kvh, cs, d),
        ks[:, :, None], vs[:, :, None],
        beta=beta, policy=policy, block_kv=page, causal=True,
        kv_len=kv_len.reshape(b, 1, 1),
        q_offset=chunk_start.reshape(b, 1, 1, 1),
        use_gemm_shift=False, chunk_exact=True,
    )
    return out.reshape(b, h, cs, d)


def _entry(name: str) -> ctypes._CFuncPtr:
    fn = getattr(_build.load(name), f"{name}_launch")
    fn.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_float] * 4
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def kernel_call(
    q: torch.Tensor,            # (B, H, CS, D) input dtype, contiguous
    k_pages: torch.Tensor,      # (P, page, KVH, D) bf16/fp16 values or
    v_pages: torch.Tensor,      #   int8/fp8 codes, contiguous
    page_table: torch.Tensor,   # (B, max_pages) int32, contiguous
    chunk_start: torch.Tensor,  # (B,) int32
    kv_len: torch.Tensor,       # (B,) int32
    *,
    beta: float,
    policy: PrecisionPolicy,
    quant: Optional[dict] = None,   # 8-bit pools: the four f32 sidecars
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (D in
    ``pasa_paged_decode.HEAD_DIMS``, pages of any size).
    Arguments are validated by
    :func:`repro_torch.kernels.ops.pasa_paged_prefill`."""
    b, h, cs, d = q.shape
    _, page, kvh, _ = k_pages.shape
    out = torch.empty_like(q)
    name = ("pasa_paged_prefill" + ("" if page <= WIDE_PAGE else "_wide")
            + ("_q8" if quant else ""))
    err = _entry(name)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        *sidecar_ptrs(quant),
        page_table.data_ptr(), chunk_start.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(),
        b, h, kvh, d, cs, page, page_table.shape[1], k_pages.shape[0],
        POOL_KINDS[k_pages.dtype],
        *policy_scalars(beta, policy, d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return out
