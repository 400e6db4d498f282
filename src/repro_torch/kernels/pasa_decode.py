"""PASA flash-decode over a CONTIGUOUS KV cache: CUDA kernel and plain
version.

Counterpart of ``repro.kernels.pasa_decode``.

  * :func:`kernel_call` launches the paged decode kernel's instances
    over the cache seen as one page a sequence (``pasa_decode_launch`` of
    ``csrc/pasa_paged_decode.cu`` for a bf16 cache,
    ``pasa_decode_fp16_launch`` of ``_fp16.cu`` for fp16; the template of
    ``csrc/pasa_decode_split.cuh``): each live block of ``block_kv`` rows
    (a multiple of 16 up to 256, the op's default 256 included) up to
    ``kv_len`` is reduced to its partials by a CTA of its own, into a
    workspace the wrapper allocates, and the last CTA of the (sequence,
    kv-head) to finish folds them exactly in block order - so paged ==
    contiguous bit for bit at the same block, whatever the page size.  The
    cache is read in its stored layout and dtype (bf16) through its
    strides; rows at or past ``kv_len`` are never read.
  * :func:`_walk_call` launches the sequential walk of
    ``csrc/pasa_decode_walk.cu`` (one CTA per (sequence, kv-head), blocks
    in order): the on-card oracle that both decode ops equal bit for
    bit.  Only the card tests and ``chip_smoke.py`` call it; no wrapper
    does.
  * :func:`decode_plain` is what the dense decode layer runs:
    ``core.pasa.blocked_attention`` at the ``shift_mask_valid``
    convention over the cache (``paged_decode_plain`` without the
    gather).  It is the kernel's oracle and the path every CPU tensor
    takes.

Both compute one new token per sequence with the GQA group as rows: q
(B, KVH, G, D) against k/v (B, KVH, S2, D), ``kv_len`` (B,) valid rows.
The kernel takes D 32, 64 or 128 (one instance per width, the walk's
too).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.pasa import blocked_attention
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.kernels import _build
from repro_torch.kernels.pasa_paged_decode import (DECODE_SOURCES,
                                                   policy_scalars, tickets)

MAX_BLOCK = 256      # rows per block both decode ops hold
# the C entry of each cache dtype, in its pool type's library
ENTRIES = {torch.bfloat16: "pasa_decode_launch",
           torch.float16: "pasa_decode_fp16_launch"}


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


def _entry(name: str, dtype: torch.dtype) -> ctypes._CFuncPtr:
    walk = name == "pasa_decode_walk_launch"
    fn = getattr(_build.load("pasa_decode_walk" if walk
                             else DECODE_SOURCES[dtype]), name)
    n_ptrs = 5 if walk else 7   # the walk's + the workspace and tickets
    fn.argtypes = (
        [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6
        + [ctypes.c_longlong] * 3 + [ctypes.c_int] + [ctypes.c_float] * 4
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def kernel_call(
    q: torch.Tensor,        # (B, KVH, G, D) input dtype, contiguous
    k_cache: torch.Tensor,  # (B, KVH, S2, D) bf16 or fp16, strided
    v_cache: torch.Tensor,  # same dtype and strides as k_cache
    kv_len: torch.Tensor,   # (B,) int32
    *,
    beta: float,
    policy: PrecisionPolicy,
    block_kv: int,
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (D 32, 64 or 128).
    Arguments are validated by :func:`repro_torch.kernels.ops.pasa_decode`."""
    b, kvh, g, d = q.shape
    n_blocks = -(-k_cache.shape[2] // block_kv)
    # the blocks' partials: P V (B, KVH, n_blocks, G, D) then the row
    # statistics (B, KVH, n_blocks, 3, G), f32
    workspace = torch.empty(b * kvh * n_blocks * g * (d + 3),
                            dtype=torch.float32, device=q.device)
    return _launch(ENTRIES[k_cache.dtype], q, k_cache, v_cache, kv_len,
                   [workspace, tickets(q.device, b * kvh)], beta=beta,
                   policy=policy, block_kv=block_kv)


def _walk_call(q, k_cache, v_cache, kv_len, *, beta: float,
               policy: PrecisionPolicy, block_kv: int) -> torch.Tensor:
    """The sequential walk on the card (inputs as :func:`kernel_call`
    takes them): the bit-for-bit oracle of both decode ops, for tests and
    ``chip_smoke.py`` only."""
    return _launch("pasa_decode_walk_launch", q, k_cache, v_cache, kv_len,
                   [], beta=beta, policy=policy, block_kv=block_kv)


def _launch(name, q, k_cache, v_cache, kv_len, buffers, *, beta, policy,
            block_kv):
    b, kvh, g, d = q.shape
    out = torch.empty_like(q)
    err = _entry(name, k_cache.dtype)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(), *(x.data_ptr() for x in buffers),
        b, kvh, g, d, k_cache.shape[2], block_kv, *k_cache.stride()[:3],
        int(k_cache.dtype == torch.bfloat16),
        *policy_scalars(beta, policy, d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err}")
    return out
