"""PASA flash-decode over a CONTIGUOUS KV cache: CUDA kernel and plain
version.

Counterpart of ``repro.kernels.pasa_decode``.

  * :func:`kernel_call` launches ``csrc/pasa_decode.cu``: a cluster of 8
    CTAs per (sequence, kv-head) reduces the blocks of ``block_kv`` rows (a
    multiple of 16 up to 256, the op's default 256 included) up to
    ``kv_len`` to partials in parallel, then folds them exactly in block
    order, into a workspace the wrapper allocates - the paged decode
    kernel's template over a strided cache, so paged == contiguous bit for
    bit at the same block, whatever the page size.  The cache is read in its stored layout and
    dtype (bf16) through its strides; rows at or past ``kv_len`` are never
    read.
  * :func:`_walk_call` launches the sequential walk of
    ``csrc/pasa_decode_walk.cu`` (one CTA per (sequence, kv-head), blocks
    in order): the on-card oracle that both cluster kernels equal bit for
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
from repro_torch.kernels.pasa_paged_decode import policy_scalars

MAX_BLOCK = 256      # rows per block both decode kernels hold


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


def _entry(name: str = "pasa_decode_launch") -> ctypes._CFuncPtr:
    walk = name == "pasa_decode_walk_launch"
    fn = getattr(_build.load("pasa_decode_walk" if walk else "pasa_decode"),
                 name)
    n_ptrs = 5 if walk else 6   # the cluster kernel's + the workspace
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
    return _launch("pasa_decode_launch", q, k_cache, v_cache, kv_len,
                   workspace, beta=beta, policy=policy, block_kv=block_kv)


def _walk_call(q, k_cache, v_cache, kv_len, *, beta: float,
               policy: PrecisionPolicy, block_kv: int) -> torch.Tensor:
    """The sequential walk on the card (inputs as :func:`kernel_call`
    takes them): the bit-for-bit oracle of the cluster kernels, for tests
    and ``chip_smoke.py`` only."""
    return _launch("pasa_decode_walk_launch", q, k_cache, v_cache, kv_len,
                   None, beta=beta, policy=policy, block_kv=block_kv)


def _launch(name, q, k_cache, v_cache, kv_len, workspace, *, beta, policy,
            block_kv):
    b, kvh, g, d = q.shape
    out = torch.empty_like(q)
    ws = [] if workspace is None else [workspace.data_ptr()]
    err = _entry(name)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(), *ws,
        b, kvh, g, d, k_cache.shape[2], block_kv, *k_cache.stride()[:3],
        int(k_cache.dtype == torch.bfloat16),
        *policy_scalars(beta, policy, d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err}")
    return out
