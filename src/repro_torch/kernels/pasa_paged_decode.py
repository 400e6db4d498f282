"""PASA flash-decode over a PAGED KV pool: CUDA kernel + plain version.

Counterpart of ``repro.kernels.pasa_paged_decode``.

  * :func:`kernel_call` launches ``csrc/pasa_paged_decode.cu``: a cluster
    of 8 CTAs per (sequence, kv-head) reduces the live pages to per-page
    partials in parallel, then folds them exactly in page order (see the
    source's note), into a workspace the wrapper allocates.
  * :func:`paged_decode_plain` is the port of the reference's
    ``paged_decode_xla``: a gather of the pages (dequantized for 8-bit
    pools by :func:`_gather_dequant`), then
    :func:`repro_torch.core.pasa.blocked_attention` at the
    ``shift_mask_valid`` convention.  It is the kernel's oracle and the
    path every CPU tensor takes.

Both compute one new token per sequence with the GQA group as rows: q
(B, KVH, G, D) against pages (P, page, KVH, D) through a (B, max_pages)
page table, ``kv_len`` (B,) valid positions per sequence.  Raw pools are
bf16 or fp16; quantized pools (``runtime/paged_cache.py``) are int8 or
float8_e4m3fn codes with per-(page, kv-head) sidecars ``scale`` (P, KVH)
and ``shift`` (P, KVH, D), f32, dequantized as ``codes * scale + shift``
in f32 and rounded once to the policy's input dtype.  The kernel takes
D 64 or 128 (``DECODE_HEAD_DIMS``; one instance per width).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.core.beta import ideal_invariance
from repro_torch.core.pasa import blocked_attention
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.kernels import _build
from repro_torch.runtime.paged_cache import gather_pages, gather_pages_dequant

HEAD_DIM = 128       # the head width of the wgmma kernels
DECODE_HEAD_DIMS = (64, 128)   # the head widths of both decode kernels
MAX_GROUP = 16       # query heads per kv head the decode kernel holds
MAX_PAGE = 128       # rows per page the kernels hold in shared memory

# The kernels' pool-kind launch argument (csrc/pasa_common.cuh PoolKind).
POOL_KINDS = {torch.float16: 0, torch.bfloat16: 1, torch.int8: 2,
              torch.float8_e4m3fn: 3}


def _gather_dequant(pages: torch.Tensor, scale: Optional[torch.Tensor],
                    shift: Optional[torch.Tensor], page_table: torch.Tensor,
                    deq_dtype: torch.dtype) -> torch.Tensor:
    """Page gather (+ dequantization when sidecars are given) to
    (B, max_pages * page, KVH, D) at ``deq_dtype``.  The f32 values of
    :func:`gather_pages_dequant` are the kernels' own (product and sum
    rounded separately); one rounding to ``deq_dtype`` follows, as in the
    kernels' loader, so the plain versions see the same values bit for
    bit."""
    if scale is None:
        return gather_pages(pages, page_table).to(deq_dtype)
    n, page, kvh, d = pages.shape
    deq = gather_pages_dequant(pages.reshape(n, page, kvh * d), scale,
                               shift.reshape(n, kvh * d), page_table)
    return deq.reshape(*deq.shape[:2], kvh, d).to(deq_dtype)


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
    k_scale: Optional[torch.Tensor] = None,   # (P, KVH) f32 } 8-bit pools:
    k_shift: Optional[torch.Tensor] = None,   # (P, KVH, D)  } all four
    v_scale: Optional[torch.Tensor] = None,
    v_shift: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gather-then-attend at the ``shift_mask_valid`` convention, with the
    shift computed in blocks of ``block_kv`` over the gathered view (the
    kernel's per-page shift equals it when ``block_kv`` is the page)."""
    b = q.shape[0]
    dt = policy.input_dtype
    ks = _gather_dequant(k_pages, k_scale, k_shift, page_table, dt).movedim(2, 1)
    vs = _gather_dequant(v_pages, v_scale, v_shift, page_table, dt).movedim(2, 1)
    return blocked_attention(
        q.to(policy.input_dtype), ks, vs, beta=beta, policy=policy,
        block_kv=block_kv, causal=False, kv_len=kv_len.reshape(b, 1),
        use_gemm_shift=False, shift_mask_valid=True,
    )


@functools.lru_cache(maxsize=16)
def policy_scalars(beta: float, policy: PrecisionPolicy, d: int,
                   inva: Optional[float] = None):
    """The policy and beta as the kernels' launch arguments: (beta, inva
    rounded to the statistic dtype, fp32 1/sqrt(d), 1/sqrt(d) at the score
    dtype, stat_half, acc_half, score_half, op_bf16).  ``inva`` defaults
    to the ideal beta/(1-beta) of the algebraic shift; the GEMM-shift
    attention kernel passes the invariance its rounded matrix realizes.

    The kernels implement every policy of ``core.precision`` but the
    float64 oracle: inputs and output at fp16 or bf16 (one dtype), scores
    stored at fp16 (fp16 inputs only) or fp32, statistics and accumulator
    at fp16 or fp32 (fp32 beside fp32 scores).  Any other policy raises
    NotImplementedError."""
    half, bf16, f32 = torch.float16, torch.bfloat16, torch.float32
    op = policy.input_dtype
    score_half = policy.score_dtype == half
    ok = (op in (half, bf16) and policy.out_dtype == op
          and policy.score_dtype in ((half, f32) if op == half else (f32,))
          and policy.stat_dtype in ((half, f32) if score_half else (f32,))
          and policy.acc_dtype in ((half, f32) if score_half else (f32,)))
    if not ok:
        raise NotImplementedError(
            f"the CUDA PASA kernels implement the fp16, fp16_fp32, fp32 and "
            f"bf16_fp32 policies, not {policy.name!r}"
        )
    if inva is None:
        inva = ideal_invariance(beta)
    return (
        float(beta),
        float(torch.tensor(inva, dtype=policy.stat_dtype)),
        float(torch.tensor(1.0 / math.sqrt(d), dtype=f32)),
        float(torch.tensor(1.0 / math.sqrt(d), dtype=policy.score_dtype)),
        int(policy.stat_dtype == half),
        int(policy.acc_dtype == half),
        int(score_half),
        int(op == bf16),
    )


def mode_name(policy: PrecisionPolicy, pool_dtype: torch.dtype,
              head_dim: int = HEAD_DIM) -> str:
    """The key of a kernel mode in the ops' ``launches_by_mode`` counters:
    the policy's name and the dtype of the pool or cache read, e.g.
    ``"bf16_fp32/bfloat16"``, and a head width other than 128 after them,
    e.g. ``"fp16/bfloat16/d64"``."""
    name = f"{policy.name}/{str(pool_dtype).removeprefix('torch.')}"
    return name if head_dim == HEAD_DIM else f"{name}/d{head_dim}"


def sidecar_ptrs(quant: Optional[dict]) -> list:
    """Device pointers of (k_scale, k_shift, v_scale, v_shift); None for
    a raw pool (the kernels never read them then)."""
    if not quant:
        return [None] * 4
    return [quant[n].data_ptr()
            for n in ("k_scale", "k_shift", "v_scale", "v_shift")]


def _entry() -> ctypes._CFuncPtr:
    fn = _build.load("pasa_paged_decode").pasa_paged_decode_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_float] * 4
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def kernel_call(
    q: torch.Tensor,           # (B, KVH, G, D) at the input dtype, contiguous
    k_pages: torch.Tensor,     # (P, page, KVH, D) bf16/fp16 values or
    v_pages: torch.Tensor,     #   int8/fp8 codes, contiguous
    page_table: torch.Tensor,  # (B, max_pages) int32, contiguous
    kv_len: torch.Tensor,      # (B,) int32
    *,
    beta: float,
    policy: PrecisionPolicy,
    quant: Optional[dict] = None,   # 8-bit pools: the four f32 sidecars
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (D 64 or 128).
    Arguments are validated by :func:`repro_torch.kernels.ops.pasa_paged_decode`."""
    b, kvh, g, d = q.shape
    _, page, _, _ = k_pages.shape
    max_pages = page_table.shape[1]
    out = torch.empty_like(q)
    # the pages' partials: P V (B, KVH, max_pages, G, D) then the row
    # statistics (B, KVH, max_pages, 3, G), f32
    workspace = torch.empty(b * kvh * max_pages * g * (d + 3),
                            dtype=torch.float32, device=q.device)
    err = _entry()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        *sidecar_ptrs(quant),
        page_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        workspace.data_ptr(),
        b, kvh, g, d, page, max_pages, POOL_KINDS[k_pages.dtype],
        *policy_scalars(beta, policy, d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"pasa_paged_decode launch failed: cudaError {err}")
    return out
