"""Batched-GEMM K pre-processing (Algorithm 1 lines 5-7): CUDA kernel and
plain version.

Counterpart of ``repro.kernels.shift_kv``.

  * :func:`kernel_call` launches ``csrc/shift_kv.cu``: ``K'_j = M K_j``
    per block of ``block_kv`` rows, one CTA per (b * kv-head, block),
    tensor-core GEMM with fp16 operands, fp32 sums and one fp16 store.
    It reads K through its strides (bf16 or fp16), so the prefill's
    (B, S, KVH, D) keys are read where they lie.
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


def shift_kv_plain(m: torch.Tensor, k: torch.Tensor, block_kv: int,
                   out_dtype: torch.dtype = torch.float16) -> torch.Tensor:
    """K'_j = M K_j at M's dtype (fp32 sums, one store), then ``out_dtype``."""
    return shift_kv_blocks(k, m, block_kv).to(out_dtype)


@functools.lru_cache(maxsize=16)
def device_matrix(block_kv: int, d: int, beta: float, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """M on ``device``, built once per (block, d, beta, dtype, device)."""
    return shifting_matrix(block_kv, d, beta, dtype).to(device).contiguous()


def _entry() -> ctypes._CFuncPtr:
    fn = _build.load("shift_kv").shift_kv_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3
        + [ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def kernel_call(m: torch.Tensor, k: torch.Tensor, *,
                block_kv: int) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.

    m: (block_kv, block_kv) fp16 contiguous; k: (B, KVH, S2, 128) bf16 or
    fp16, unit stride on the last dim, other strides multiples of 8.
    Returns (B, KVH, S2, 128) fp16, contiguous.  Arguments are validated
    by :func:`repro_torch.kernels.ops.shift_kv`."""
    b, kvh, s2, d = k.shape
    out = torch.empty((b, kvh, s2, d), dtype=torch.float16, device=k.device)
    err = _entry()(
        m.data_ptr(), k.data_ptr(), out.data_ptr(),
        b, kvh, s2, block_kv, k.stride(0), k.stride(1), k.stride(2),
        int(k.dtype == torch.bfloat16),
        torch.cuda.current_stream(k.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"shift_kv launch failed: cudaError {err}")
    return out
