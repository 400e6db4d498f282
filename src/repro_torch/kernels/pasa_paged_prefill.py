"""PASA chunked prefill over a PAGED KV pool: CUDA kernel + plain version.

Counterpart of ``repro.kernels.pasa_paged_prefill``.

  * :func:`kernel_call` launches ``csrc/pasa_paged_prefill.cu`` (one CTA
    per (row * head, 64-query tile), tensor-core GEMMs; see the source's
    note).
  * :func:`paged_prefill_plain` is the port of the reference's
    ``paged_prefill_xla``: a gather of the pages, then
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

import torch

from repro_torch.core.pasa import blocked_attention
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.kernels import _build
from repro_torch.kernels.pasa_paged_decode import policy_scalars
from repro_torch.runtime.paged_cache import gather_pages


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
) -> torch.Tensor:
    """Gather-then-attend at the chunk-exact convention."""
    b, h, cs, d = q.shape
    page, kvh = k_pages.shape[1], k_pages.shape[2]
    ks = gather_pages(k_pages, page_table).to(policy.input_dtype).movedim(2, 1)
    vs = gather_pages(v_pages, page_table).to(policy.input_dtype).movedim(2, 1)
    out = blocked_attention(
        q.to(policy.input_dtype).reshape(b, kvh, h // kvh, cs, d),
        ks[:, :, None], vs[:, :, None],
        beta=beta, policy=policy, block_kv=page, causal=True,
        kv_len=kv_len.reshape(b, 1, 1),
        q_offset=chunk_start.reshape(b, 1, 1, 1),
        use_gemm_shift=False, chunk_exact=True,
    )
    return out.reshape(b, h, cs, d)


def _entry() -> ctypes._CFuncPtr:
    fn = _build.load("pasa_paged_prefill").pasa_paged_prefill_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float] * 4
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def kernel_call(
    q: torch.Tensor,            # (B, H, CS, 128) fp16, contiguous
    k_pages: torch.Tensor,      # (P, page, KVH, 128) bf16 or fp16, contiguous
    v_pages: torch.Tensor,
    page_table: torch.Tensor,   # (B, max_pages) int32, contiguous
    chunk_start: torch.Tensor,  # (B,) int32
    kv_len: torch.Tensor,       # (B,) int32
    *,
    beta: float,
    policy: PrecisionPolicy,
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.  Arguments are
    validated by :func:`repro_torch.kernels.ops.pasa_paged_prefill`."""
    b, h, cs, d = q.shape
    _, page, kvh, _ = k_pages.shape
    out = torch.empty_like(q)
    err = _entry()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), chunk_start.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(),
        b, h, kvh, cs, page, page_table.shape[1],
        int(k_pages.dtype == torch.bfloat16),
        *policy_scalars(beta, policy, d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"pasa_paged_prefill launch failed: cudaError {err}")
    return out
