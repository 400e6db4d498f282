"""PASA flash-decode over a CONTIGUOUS KV cache: CUDA kernel and plain
version.

Counterpart of ``repro.kernels.pasa_decode``.

  * :func:`kernel_call` launches ``csrc/pasa_decode.cu``: one CTA per
    (sequence, kv-head) folds blocks of ``block_kv`` rows in order up to
    ``kv_len`` through ``decode_block_update``, the block update the paged
    decode kernel runs per page - so paged == contiguous bit for bit when
    page == block.  The cache is read in its stored layout and dtype
    (bf16) through its strides; rows at or past ``kv_len`` are never read.
  * :func:`decode_plain` is what the dense decode layer runs:
    ``core.pasa.blocked_attention`` at the ``shift_mask_valid``
    convention over the cache (``paged_decode_plain`` without the
    gather).  It is the kernel's oracle and the path every CPU tensor
    takes.

Both compute one new token per sequence with the GQA group as rows: q
(B, KVH, G, D) against k/v (B, KVH, S2, D), ``kv_len`` (B,) valid rows.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.pasa import blocked_attention
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.kernels import _build
from repro_torch.kernels.pasa_paged_decode import policy_scalars


def decode_plain(
    q: torch.Tensor,        # (B, KVH, G, D)
    k_cache: torch.Tensor,  # (B, KVH, S2, D)
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,   # (B,)
    *,
    beta: float,
    policy: PrecisionPolicy,
    block_kv: int,
) -> torch.Tensor:
    """Algebraic valid-column shift in blocks of ``block_kv`` over the
    cache; positions at or past ``kv_len`` are inert (NaN-safe)."""
    b = q.shape[0]
    cast = lambda x: x.to(policy.input_dtype).contiguous()
    return blocked_attention(
        cast(q), cast(k_cache), cast(v_cache), beta=beta, policy=policy,
        block_kv=block_kv, causal=False, kv_len=kv_len.reshape(b, 1),
        use_gemm_shift=False, shift_mask_valid=True,
    )


def _entry() -> ctypes._CFuncPtr:
    fn = _build.load("pasa_decode").pasa_decode_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3
        + [ctypes.c_int] + [ctypes.c_float] * 4 + [ctypes.c_int] * 2
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def kernel_call(
    q: torch.Tensor,        # (B, KVH, G, 128) fp16, contiguous
    k_cache: torch.Tensor,  # (B, KVH, S2, 128) bf16 or fp16, strided
    v_cache: torch.Tensor,  # same dtype and strides as k_cache
    kv_len: torch.Tensor,   # (B,) int32
    *,
    beta: float,
    policy: PrecisionPolicy,
    block_kv: int,
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.  Arguments are
    validated by :func:`repro_torch.kernels.ops.pasa_decode`."""
    b, kvh, g, d = q.shape
    s2 = k_cache.shape[2]
    out = torch.empty_like(q)
    err = _entry()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(),
        b, kvh, g, s2, block_kv, *k_cache.stride()[:3],
        int(k_cache.dtype == torch.bfloat16),
        *policy_scalars(beta, policy, d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"pasa_decode launch failed: cudaError {err}")
    return out
