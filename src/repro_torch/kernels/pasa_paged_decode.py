"""PASA flash-decode over a PAGED KV pool: CUDA kernel + plain version.

Counterpart of ``repro.kernels.pasa_paged_decode``.

  * :func:`kernel_call` launches ``csrc/pasa_paged_decode.cu`` (bf16
    pools) or its sibling source of the pool's type (``_fp16``,
    ``_int8``, ``_fp8``), one template (``csrc/pasa_paged_decode.cuh``,
    ``csrc/pasa_decode_split.cuh``): each live block of ``block_kv`` rows
    of a (sequence, kv-head)'s page-table view (any page size: a block may
    span pages or share one) is reduced to its partials by a CTA of its
    own, into a workspace the wrapper allocates, and the last CTA of the
    pair to finish (an int32 ticket a pair, :func:`tickets`) folds them
    exactly in block order (see the source's note).
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
D 32, 64 or 128 (:data:`HEAD_DIMS`; one instance per width).
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

HEAD_DIM = 128       # the served head width: launch modes name any other
# the head widths every CUDA kernel is built for (csrc/pasa_common.cuh
# head_dim_built), one instance each
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 16       # query heads per kv head the decode kernel holds

# The kernels' pool-kind launch argument (csrc/pasa_common.cuh PoolKind).
POOL_KINDS = {torch.float16: 0, torch.bfloat16: 1, torch.int8: 2,
              torch.float8_e4m3fn: 3}
# the library (csrc source) of each pool type's paged decode instances
DECODE_SOURCES = {torch.bfloat16: "pasa_paged_decode",
                  torch.float16: "pasa_paged_decode_fp16",
                  torch.int8: "pasa_paged_decode_int8",
                  torch.float8_e4m3fn: "pasa_paged_decode_fp8"}


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
    shift computed in blocks of ``block_kv`` over the gathered view,
    whatever the page size (the reference's ``paged_decode_xla``)."""
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


def _entry(name: str) -> ctypes._CFuncPtr:
    fn = getattr(_build.load(name), f"{name}_launch")
    fn.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_float] * 4
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


# The decode kernels' tickets: an int32 counter a (sequence, kv-head) pair
# that the pair's CTAs take when their blocks are written (the last one
# folds and resets it), one buffer a (device, stream), zeroed when it is
# made or grown.  Every launch leaves its counters at 0, so calls in order
# on one stream share a buffer; calls on two streams have two.
_TICKETS: dict = {}


def tickets(device: torch.device, pairs: int) -> torch.Tensor:
    """The current stream's ticket buffer on ``device``, of at least
    ``pairs`` counters (all 0 between launches)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    buf = _TICKETS.get((device.index, stream))
    if buf is None or buf.numel() < pairs:
        buf = torch.zeros(pairs, dtype=torch.int32, device=device)
        _TICKETS[(device.index, stream)] = buf
    return buf


def occupancy(pool_dtype: torch.dtype, head_dim: int, group: int, page: int,
              block: int, policy: PrecisionPolicy) -> tuple:
    """(dynamic shared-memory bytes, resident CTAs an SM on the current
    card) of the decode instance a call at these arguments launches - a
    paged call from a pool of ``pool_dtype``, or a contiguous call from a
    bf16 / fp16 cache.  Launches nothing."""
    name = DECODE_SOURCES[pool_dtype]
    fn = getattr(_build.load(name), f"{name}_occupancy")
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 2)()
    score_half, op_bf16 = policy_scalars(0.0, policy, head_dim)[6:]
    err = fn(head_dim, group, page, block, score_half, op_bf16,
             ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"{name}_occupancy failed: cudaError {err}")
    return out[0], out[1]


def kernel_call(
    q: torch.Tensor,           # (B, KVH, G, D) at the input dtype, contiguous
    k_pages: torch.Tensor,     # (P, page, KVH, D) bf16/fp16 values or
    v_pages: torch.Tensor,     #   int8/fp8 codes, contiguous
    page_table: torch.Tensor,  # (B, max_pages) int32, contiguous
    kv_len: torch.Tensor,      # (B,) int32
    *,
    beta: float,
    policy: PrecisionPolicy,
    block_kv: int,
    quant: Optional[dict] = None,   # 8-bit pools: the four f32 sidecars
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (D in
    :data:`HEAD_DIMS`, ``block_kv`` rows of the page-table view a block).
    Arguments are validated by
    :func:`repro_torch.kernels.ops.pasa_paged_decode`."""
    b, kvh, g, d = q.shape
    _, page, _, _ = k_pages.shape
    max_pages = page_table.shape[1]
    n_blocks = -(-max_pages * page // block_kv)
    out = torch.empty_like(q)
    # the blocks' partials: P V (B, KVH, n_blocks, G, D) then the row
    # statistics (B, KVH, n_blocks, 3, G), f32
    workspace = torch.empty(b * kvh * n_blocks * g * (d + 3),
                            dtype=torch.float32, device=q.device)
    name = DECODE_SOURCES[k_pages.dtype]
    err = _entry(name)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        *sidecar_ptrs(quant),
        page_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        workspace.data_ptr(), tickets(q.device, b * kvh).data_ptr(),
        b, kvh, g, d, page, max_pages, block_kv, POOL_KINDS[k_pages.dtype],
        *policy_scalars(beta, policy, d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return out
