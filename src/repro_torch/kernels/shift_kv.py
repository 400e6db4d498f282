"""Batched-GEMM K pre-processing (Algorithm 1 lines 5-7): CUDA kernel and
plain version.

Counterpart of ``repro.kernels.shift_kv``.

  * :func:`kernel_call` launches ``csrc/shift_kv.cu``: ``K'_j = M K_j``
    per block of ``block_kv`` (64 or 128) rows at head width 32, 64 or
    128, one CTA per (b * kv-head, block) of one warpgroup per 64-column
    half of the head (at 32 one half, zero past column 32): TMA loads of
    M and of the block's key halves, wgmma
    with operands at M's dtype (fp16, or bf16 under the bf16_fp32 policy),
    fp32 sums in registers, one rounding to M's dtype, TMA stores.  It
    reads K through its strides (bf16 or fp16; bf16 keys under an fp16 M
    are rounded to fp16 on chip), so the prefill's (B, S, KVH, D) keys are
    read where they lie.
  * :func:`shift_kv_plain` is the port of the reference's
    ``ref.shift_kv_ref`` (``core.shifting.shift_kv_blocks``): the kernel's
    oracle and the path every CPU tensor takes.

The algebraic mode (the reference's ``use_gemm_shift=False``, which it
computes in XLA inside ``blocked_attention``): :func:`kernel_call_mean`
launches the same source's ``shift_kv_mean_launch`` - per block, the
key mean over all its rows (an fp32 sum in row order; zero pad rows
count) and K' = (k - beta * mean) / sqrt(d) in fp32, rounded once to the
operand dtype - and :func:`shift_kv_mean_plain` is its plain version
(``core.pasa.algebraic_shift``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.pasa import algebraic_shift
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.shifting import shift_kv_blocks, shifting_matrix
from repro_torch.kernels import _build


def shift_kv_plain(m: torch.Tensor, k: torch.Tensor, block_kv: int,
                   out_dtype: torch.dtype = torch.float16) -> torch.Tensor:
    """K'_j = M K_j at M's dtype (fp32 sums, one store), then ``out_dtype``."""
    return shift_kv_blocks(k, m, block_kv).to(out_dtype)


def shift_kv_mean_plain(k: torch.Tensor, beta: float, block_kv: int,
                        policy: PrecisionPolicy) -> torch.Tensor:
    """The algebraic mode: (k - beta * blockmean) / sqrt(d) per block of
    ``block_kv`` rows, k rounded to the policy's input dtype first; K' at
    that dtype."""
    return algebraic_shift(k.to(policy.input_dtype), beta, block_kv, policy)


def mode_name(key_dtype: torch.dtype, op_dtype: torch.dtype,
              block_kv: int, head_dim: int = 128,
              gemm_shift: bool = True) -> str:
    """The kernel mode a launch runs, e.g. ``"bf16_keys/fp16_ops/block128"``:
    the keys' dtype as the kernel reads them, the operand dtype, the block,
    ``algebraic`` for the algebraic mode, and a head width other than 128
    last (``".../block128/d64"``, ``".../block128/algebraic/d64"``)."""
    short = {torch.float16: "fp16", torch.bfloat16: "bf16"}
    name = f"{short[key_dtype]}_keys/{short[op_dtype]}_ops/block{block_kv}"
    if not gemm_shift:
        name += "/algebraic"
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
    it); k: (B, KVH, S2, D) bf16 or fp16 (bf16 under a bf16 m), D in
    ``pasa_paged_decode.HEAD_DIMS``, unit stride on the last dim, other strides
    multiples of 8.
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


def _mean_entry() -> ctypes._CFuncPtr:
    fn = _build.load("shift_kv").shift_kv_mean_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3
        + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def kernel_call_mean(k: torch.Tensor, *, beta: float, block_kv: int,
                     op_dtype: torch.dtype, shift_scale: float) -> torch.Tensor:
    """Launch the algebraic mode on the current stream: k as for
    :func:`kernel_call` (bf16 keys under bf16 operands), ``op_dtype`` fp16
    or bf16, ``shift_scale`` the fp32 1/sqrt(D).  Returns (B, KVH, S2, D)
    at ``op_dtype``, contiguous.  Arguments are validated by
    :func:`repro_torch.kernels.ops.shift_kv`."""
    b, kvh, s2, d = k.shape
    out = torch.empty((b, kvh, s2, d), dtype=op_dtype, device=k.device)
    err = _mean_entry()(
        k.data_ptr(), out.data_ptr(), b, kvh, s2, block_kv, d,
        k.stride(0), k.stride(1), k.stride(2),
        int(op_dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
        float(beta), float(shift_scale),
        torch.cuda.current_stream(k.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"shift_kv_mean launch failed: cudaError {err}")
    return out
