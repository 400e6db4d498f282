"""Batched-GEMM K pre-processing (Algorithm 1 lines 5-7): CUDA kernel and
plain version.

Counterpart of ``repro.kernels.shift_kv``.

  * :func:`kernel_call` launches ``csrc/shift_kv.cu``: ``K'_j = M K_j``
    per block of ``block_kv`` (64 or 128) rows at head width 64 or 128,
    one CTA per (b * kv-head, block) of one warpgroup per 64-column half
    of the head: TMA loads of M and of the block's key halves, wgmma
    with operands at M's dtype (fp16, or bf16 under the bf16_fp32 policy),
    fp32 sums in registers, one rounding to M's dtype, TMA stores.  It
    reads K through its strides (bf16 or fp16; bf16 keys under an fp16 M
    are rounded to fp16 on chip), so the prefill's (B, S, KVH, D) keys are
    read where they lie.
  * :func:`shift_kv_plain` is the port of the reference's
    ``ref.shift_kv_ref`` (``core.shifting.shift_kv_blocks``): the kernel's
    oracle and the path every CPU tensor takes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.shifting import shift_kv_blocks, shifting_matrix
from repro_torch.kernels import _build

HEAD_DIMS = (64, 128)      # the head widths of the kernel's instances


def shift_kv_plain(m: torch.Tensor, k: torch.Tensor, block_kv: int,
                   out_dtype: torch.dtype = torch.float16) -> torch.Tensor:
    """K'_j = M K_j at M's dtype (fp32 sums, one store), then ``out_dtype``."""
    return shift_kv_blocks(k, m, block_kv).to(out_dtype)


def mode_name(key_dtype: torch.dtype, op_dtype: torch.dtype,
              block_kv: int, head_dim: int = 128) -> str:
    """The kernel mode a launch runs, e.g. ``"bf16_keys/fp16_ops/block128"``:
    the keys' dtype as the kernel reads them, the operand dtype, the block,
    and a head width other than 128 after them (``".../block128/d64"``)."""
    short = {torch.float16: "fp16", torch.bfloat16: "bf16"}
    name = f"{short[key_dtype]}_keys/{short[op_dtype]}_ops/block{block_kv}"
    return name if head_dim == 128 else f"{name}/d{head_dim}"


@functools.lru_cache(maxsize=16)
def device_matrix(block_kv: int, d: int, beta: float, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """M on ``device``, built once per (block, d, beta, dtype, device).

    The kernel relies on M being symmetric (it computes K'^T = K^T M), as
    ``a I - b J`` rounded entrywise is; checked here, once per matrix."""
    m = shifting_matrix(block_kv, d, beta, dtype)
    if not torch.equal(m, m.T):
        raise ValueError("the shift kernel needs a symmetric M")
    return m.to(device).contiguous()


def _entry() -> ctypes._CFuncPtr:
    fn = _build.load("shift_kv").shift_kv_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def kernel_call(m: torch.Tensor, k: torch.Tensor, *,
                block_kv: int) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.

    m: (block_kv, block_kv) fp16 or bf16, contiguous and symmetric (the
    kernel computes K'^T = K^T M; :func:`device_matrix` builds and checks
    it); k: (B, KVH, S2, D) bf16 or fp16 (bf16 under a bf16 m), D 64 or
    128, unit stride on the last dim, other strides multiples of 8.
    Returns (B, KVH, S2, D) at m's dtype, contiguous.  Arguments are validated by
    :func:`repro_torch.kernels.ops.shift_kv`."""
    b, kvh, s2, d = k.shape
    out = torch.empty((b, kvh, s2, d), dtype=m.dtype, device=k.device)
    err = _entry()(
        m.data_ptr(), k.data_ptr(), out.data_ptr(),
        b, kvh, s2, block_kv, d, k.stride(0), k.stride(1), k.stride(2),
        int(m.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
        torch.cuda.current_stream(k.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"shift_kv launch failed: cudaError {err}")
    return out
