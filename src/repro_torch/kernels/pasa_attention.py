"""Fused PASA / FlashAttention-2 over pre-shifted keys: CUDA kernel and
plain version.

Counterpart of ``repro.kernels.pasa_attention`` (Algorithm 1 lines 8-23).

  * :func:`kernel_call` launches ``csrc/pasa_attention.cu`` (head width
    32, 64 or 128): one CTA per
    (b * head, query tile) walks the key tiles in order with the state at
    the policy's dtypes - a producer warp loads K'/V tiles by TMA into a
    two-stage ring, consumer warpgroups of 64 query rows run both GEMMs
    as wgmma with the scores in registers; GQA maps query head h to kv
    head h // group, so K'/V are never expanded; a causal tile wholly
    above the diagonal is skipped.  With ``beta = 0`` (inva 0, 1/sqrt(d)
    applied after the score store) it is the FlashAttention-2 baseline.
    ``block_q`` and ``block_kv`` are 64 or 128.  Columns at or past
    ``kv_valid`` (a pad shorter than one block) are masked after the row
    pseudo-average, with P and V zero there.  Operands and output are at
    the policy's input dtype (fp16, or bf16 under bf16_fp32); at fp32
    scores P enters the P V product rounded to that dtype (the source's
    note).
  * :func:`attention_plain` is the port of the reference's
    ``ref.attention_ref``: RAW keys, the GEMM shift and
    ``core.pasa.blocked_attention`` on K/V expanded to the H query heads,
    with ``kv_valid`` as its ``kv_len``: on keys padded with zero rows that
    is the reference's ``blocked_attention`` on the unpadded keys.
    It is the oracle of the shift + attention pipeline
    (``ops.pasa_attention``) and the path every CPU tensor takes.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.pasa import blocked_attention
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.kernels import _build
from repro_torch.kernels.pasa_paged_decode import policy_scalars


def _expand_kv(x: torch.Tensor, h: int) -> torch.Tensor:
    """(B, KVH, S, D) -> (B, H, S, D), each kv head repeated over its group."""
    b, kvh, s, d = x.shape
    return x[:, :, None].expand(b, kvh, h // kvh, s, d).reshape(b, h, s, d)


def attention_plain(
    q: torch.Tensor,   # (B, H, S1, D)
    k: torch.Tensor,   # (B, KVH, S2, D) RAW keys
    v: torch.Tensor,
    *,
    beta: float,
    policy: PrecisionPolicy,
    block_kv: int,
    causal: bool = False,
    kv_valid: Optional[int] = None,
) -> torch.Tensor:
    """GEMM-shift PASA (FlashAttention-2 at beta = 0) on expanded K/V;
    columns at or past ``kv_valid`` are masked."""
    h = q.shape[1]
    kv_len = (None if kv_valid is None else
              torch.tensor(kv_valid, dtype=torch.int32, device=q.device))
    return blocked_attention(
        q, _expand_kv(k, h), _expand_kv(v, h), beta=beta, policy=policy,
        block_kv=block_kv, causal=causal, kv_len=kv_len, use_gemm_shift=True,
    )


def _entry() -> ctypes._CFuncPtr:
    fn = _build.load("pasa_attention").pasa_attention_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_longlong] * 9
        + [ctypes.c_float] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def kernel_call(
    q: torch.Tensor,          # (B, H, S1, D) }
    k_shifted: torch.Tensor,  # (B, KVH, S2, D) } at the policy's input
    v: torch.Tensor,          # (B, KVH, S2, D) } dtype (raw keys at beta 0)
    *,
    beta: float,
    inva: float,
    policy: PrecisionPolicy,
    causal: bool,
    block_q: int,
    block_kv: int,
    kv_valid: Optional[int] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (D in
    ``pasa_paged_decode.HEAD_DIMS``; columns
    at or past ``kv_valid``, default S2, are padding).  Each input is read
    through its strides (unit stride on the head dim; the tensor maps need
    the others to be multiples of 8 elements).  Arguments are validated by
    :func:`repro_torch.kernels.ops.pasa_attention`."""
    b, h, s1, d = q.shape
    _, kvh, s2, _ = k_shifted.shape
    out = torch.empty((b, h, s1, d), dtype=policy.out_dtype, device=q.device)
    strides = [x.stride(i) for x in (q, k_shifted, v) for i in range(3)]
    err = _entry()(
        q.data_ptr(), k_shifted.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, kvh, s1, s2, d, s2 if kv_valid is None else kv_valid, block_q,
        block_kv, int(causal), *strides,
        *policy_scalars(beta, policy, d, inva),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"pasa_attention launch failed: cudaError {err}")
    return out
