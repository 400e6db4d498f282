"""PASA flash-decode over a PAGED KV pool: CUDA kernel + plain version.

Counterpart of ``repro.kernels.pasa_paged_decode``.

  * :func:`kernel_call` launches ``csrc/pasa_paged_decode.cu`` (one CTA
    per (sequence, kv-head), pages folded in order by the block update
    the contiguous decode kernel will share; see the source's note).
  * :func:`paged_decode_plain` is the port of the reference's
    ``paged_decode_xla``: a gather of the pages, then
    :func:`repro_torch.core.pasa.blocked_attention` at the
    ``shift_mask_valid`` convention.  It is the kernel's oracle and the
    path every CPU tensor takes.

Both compute one new token per sequence with the GQA group as rows: q
(B, KVH, G, D) against pages (P, page, KVH, D) through a (B, max_pages)
page table, ``kv_len`` (B,) valid positions per sequence.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core.beta import ideal_invariance
from repro_torch.core.pasa import blocked_attention
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.kernels import _build
from repro_torch.runtime.paged_cache import gather_pages

HEAD_DIM = 128       # the head width the kernels are written for
MAX_GROUP = 16       # query heads per kv head the decode kernel holds
MAX_PAGE = 128       # rows per page the kernels hold in shared memory


def paged_decode_plain(
    q: torch.Tensor,           # (B, KVH, G, D)
    k_pages: torch.Tensor,     # (P, page, KVH, D)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (B, max_pages)
    kv_len: torch.Tensor,      # (B,)
    *,
    beta: float,
    policy: PrecisionPolicy,
    block_kv: int,
) -> torch.Tensor:
    """Gather-then-attend at the ``shift_mask_valid`` convention, with the
    shift computed in blocks of ``block_kv`` over the gathered view (the
    kernel's per-page shift equals it when ``block_kv`` is the page)."""
    b = q.shape[0]
    ks = gather_pages(k_pages, page_table).to(policy.input_dtype).movedim(2, 1)
    vs = gather_pages(v_pages, page_table).to(policy.input_dtype).movedim(2, 1)
    return blocked_attention(
        q.to(policy.input_dtype), ks, vs, beta=beta, policy=policy,
        block_kv=block_kv, causal=False, kv_len=kv_len.reshape(b, 1),
        shift_mask_valid=True,
    )


@functools.lru_cache(maxsize=8)
def policy_scalars(beta: float, policy: PrecisionPolicy, d: int):
    """The policy and beta as the kernels' launch arguments: (beta, inva
    rounded to the statistic dtype, fp32 1/sqrt(d), fp16 1/sqrt(d),
    stat_half, acc_half).  Raises NotImplementedError for a policy the
    kernels do not implement (fp16 inputs, scores and outputs are
    required; statistics and accumulator may be fp16 or fp32)."""
    half, f32 = torch.float16, torch.float32
    if (policy.input_dtype, policy.score_dtype, policy.out_dtype) != (half,) * 3 \
            or policy.stat_dtype not in (half, f32) \
            or policy.acc_dtype not in (half, f32):
        raise NotImplementedError(
            f"the CUDA PASA kernels implement the fp16 and fp16_fp32 "
            f"policies, not {policy.name!r}"
        )
    inva = ideal_invariance(beta)
    return (
        float(beta),
        float(torch.tensor(inva, dtype=policy.stat_dtype)),
        float(torch.tensor(1.0 / math.sqrt(d), dtype=f32)),
        float(torch.tensor(1.0 / math.sqrt(d), dtype=half)),
        int(policy.stat_dtype == half),
        int(policy.acc_dtype == half),
    )


def _entry() -> ctypes._CFuncPtr:
    fn = _build.load("pasa_paged_decode").pasa_paged_decode_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float] * 4
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def kernel_call(
    q: torch.Tensor,           # (B, KVH, G, 128) fp16, contiguous
    k_pages: torch.Tensor,     # (P, page, KVH, 128) bf16 or fp16, contiguous
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (B, max_pages) int32, contiguous
    kv_len: torch.Tensor,      # (B,) int32
    *,
    beta: float,
    policy: PrecisionPolicy,
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.  Arguments are
    validated by :func:`repro_torch.kernels.ops.pasa_paged_decode`."""
    b, kvh, g, d = q.shape
    _, page, _, _ = k_pages.shape
    out = torch.empty_like(q)
    err = _entry()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        b, kvh, g, page, page_table.shape[1],
        int(k_pages.dtype == torch.bfloat16),
        *policy_scalars(beta, policy, d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"pasa_paged_decode launch failed: cudaError {err}")
    return out
