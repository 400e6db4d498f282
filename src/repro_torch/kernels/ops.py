"""Public entry points of the attention kernels (counterpart of
``repro.kernels.ops``, paged ops of this slice).

Dispatch is by the device of the tensors: a CPU tensor goes to the
kernel's plain PyTorch version, a CUDA tensor to the CUDA kernel - or the
call raises (unsupported shape, dtype or policy).  There is no fall back
from the card to the plain version.  Each wrapper counts its kernel
launches in a plain integer attribute, ``<wrapper>.launches``.

The reference's ``interpret`` and ``use_kernel`` switches have no
counterpart: the plain versions are ``paged_decode_plain`` and
``paged_prefill_plain`` in the kernel modules.  Quantized pools (the four
sidecar arguments) are not ported yet and raise NotImplementedError.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.beta import DEFAULT_BETA
from repro_torch.core.precision import FP16, PrecisionPolicy
from repro_torch.kernels import pasa_paged_decode as _decode
from repro_torch.kernels import pasa_paged_prefill as _prefill


def _no_sidecars(*quant) -> None:
    if any(x is not None for x in quant):
        raise NotImplementedError(
            "quantized (fp8/int8) pools are not ported to repro_torch yet"
        )


def _check_pages(k_pages: torch.Tensor, v_pages: torch.Tensor) -> None:
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"pages must be (P, page, KVH, D); got {tuple(k_pages.shape)} / "
            f"{tuple(v_pages.shape)}"
        )


def _cuda_inputs(q, k_pages, v_pages, ints, policy):
    """Validate and normalize the kernel inputs: everything on q's CUDA
    device, q at fp16, pools bf16/fp16 contiguous, index tensors int32
    contiguous (small copies only; the pool is never copied)."""
    dev = q.device
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages)) + tuple(
        ints.items()
    ):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
    if k_pages.dtype not in (torch.bfloat16, torch.float16) \
            or v_pages.dtype != k_pages.dtype:
        raise NotImplementedError(
            f"the CUDA kernels read bf16 or fp16 pools, got {k_pages.dtype}"
        )
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("page pools must be contiguous")
    if q.shape[-1] != _decode.HEAD_DIM:
        raise NotImplementedError(
            f"the CUDA kernels are written for head_dim {_decode.HEAD_DIM}, "
            f"got {q.shape[-1]}"
        )
    if k_pages.shape[1] > _decode.MAX_PAGE:
        raise NotImplementedError(
            f"page size {k_pages.shape[1]} > {_decode.MAX_PAGE}"
        )
    b = q.shape[0]
    for name, x in ints.items():
        want = 2 if name == "page_table" else 1
        if x.dim() != want or x.shape[0] != b:
            raise ValueError(
                f"{name} shape {tuple(x.shape)} does not match batch {b}"
            )
    q = q.to(policy.input_dtype).contiguous()
    ints = {k: v.to(torch.int32).contiguous() for k, v in ints.items()}
    return q, ints


def pasa_paged_decode(
    q: torch.Tensor,           # (B, KVH, G, D) grouped query heads, one token
    k_pages: torch.Tensor,     # (num_pages, page, KVH, D) raw physical pages
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (B, max_pages) int32
    kv_len: torch.Tensor,      # (B,)
    *,
    beta: float = DEFAULT_BETA,
    policy: PrecisionPolicy = FP16,
    k_scale: Optional[torch.Tensor] = None,
    k_shift: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    v_shift: Optional[torch.Tensor] = None,
    block_kv: Optional[int] = None,
) -> torch.Tensor:
    """GQA flash-decode over a paged KV pool (``shift_mask_valid``).

    ``block_kv`` is the PASA shift-block length (default: the page size).
    The plain version shifts in blocks of ``block_kv`` over the gathered
    view, as the reference's attention layer does; the CUDA kernel shifts
    per page and raises unless ``block_kv`` is the page size."""
    if q.dim() != 4:
        raise ValueError("q must be (B, KVH, G, D)")
    _check_pages(k_pages, v_pages)
    _no_sidecars(k_scale, k_shift, v_scale, v_shift)
    if q.shape[1] != k_pages.shape[2]:
        raise ValueError(
            f"q has {q.shape[1]} kv heads, the pages {k_pages.shape[2]}"
        )
    page = k_pages.shape[1]
    block_kv = page if block_kv is None else int(block_kv)
    if q.device.type == "cpu":
        return _decode.paged_decode_plain(
            q, k_pages, v_pages, page_table, kv_len,
            beta=beta, policy=policy, block_kv=block_kv,
        )
    if q.device.type != "cuda":
        raise ValueError(f"no pasa_paged_decode for device {q.device}")
    if block_kv != page:
        raise ValueError(
            f"the CUDA decode kernel shifts per page: page size {page} must "
            f"equal block_kv {block_kv}"
        )
    if q.shape[2] > _decode.MAX_GROUP:
        raise NotImplementedError(
            f"GQA group {q.shape[2]} > {_decode.MAX_GROUP}"
        )
    q, ints = _cuda_inputs(
        q, k_pages, v_pages,
        {"page_table": page_table, "kv_len": kv_len}, policy,
    )
    out = _decode.kernel_call(
        q, k_pages, v_pages, ints["page_table"], ints["kv_len"],
        beta=beta, policy=policy,
    )
    pasa_paged_decode.launches += 1
    return out


pasa_paged_decode.launches = 0


def pasa_paged_prefill(
    q: torch.Tensor,            # (B, H, CS, D) chunk queries, full query heads
    k_pages: torch.Tensor,      # (num_pages, page, KVH, D) raw physical pages
    v_pages: torch.Tensor,
    page_table: torch.Tensor,   # (B, max_pages) int32
    chunk_start: torch.Tensor,  # (B,) absolute position of the chunk's row 0
    kv_len: torch.Tensor,       # (B,) valid KV length (chunk end)
    *,
    beta: float = DEFAULT_BETA,
    policy: PrecisionPolicy = FP16,
    k_scale: Optional[torch.Tensor] = None,
    k_shift: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    v_shift: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Chunked prefill over a paged KV pool (chunk-exact convention).

    The chunk's K/V must already be written into its pages; the B rows may
    belong to different requests, and a pad row (``kv_len == 0``) emits
    zeros."""
    if q.dim() != 4:
        raise ValueError("q must be (B, H, CS, D)")
    _check_pages(k_pages, v_pages)
    _no_sidecars(k_scale, k_shift, v_scale, v_shift)
    if q.shape[1] % k_pages.shape[2]:
        raise ValueError(
            f"q heads {q.shape[1]} not a multiple of kv heads "
            f"{k_pages.shape[2]}"
        )
    if q.device.type == "cpu":
        return _prefill.paged_prefill_plain(
            q, k_pages, v_pages, page_table, chunk_start, kv_len,
            beta=beta, policy=policy,
        )
    if q.device.type != "cuda":
        raise ValueError(f"no pasa_paged_prefill for device {q.device}")
    if k_pages.shape[1] % 16:
        raise NotImplementedError(
            f"the CUDA prefill kernel needs a page size that is a multiple "
            f"of 16, got {k_pages.shape[1]}"
        )
    q, ints = _cuda_inputs(
        q, k_pages, v_pages,
        {"page_table": page_table, "chunk_start": chunk_start,
         "kv_len": kv_len},
        policy,
    )
    out = _prefill.kernel_call(
        q, k_pages, v_pages, ints["page_table"], ints["chunk_start"],
        ints["kv_len"], beta=beta, policy=policy,
    )
    pasa_paged_prefill.launches += 1
    return out


pasa_paged_prefill.launches = 0


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    pasa_paged_decode.launches = 0
    pasa_paged_prefill.launches = 0
