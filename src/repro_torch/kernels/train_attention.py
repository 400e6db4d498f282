"""The attention ops of the dense prefill under autograd: the kernels
forward, the plain version's gradient backward.

The reference trains through ``jax.value_and_grad`` over
``blocked_attention(..., use_gemm_shift=...)`` and has no backward
kernel; neither has the port.  :class:`KernelAttention` runs
``ops.pasa_attention`` (the shift kernel, then the attention kernel) or
``ops.flash_attention`` forward - on the card the CUDA kernels, counted
in their wrappers' launches, on the CPU their plain version - and saves
its inputs.  Its backward runs ``attention_plain`` again on the saved
inputs under autograd and returns that recompute's gradients, so the
input gradients are those of the plain version's autograd, bit for bit
(with ``gemm_shift=False`` differentiated through the algebraic shift
and its block mean).  Causal and non-causal (``kv_valid``) calls, PASA
at any beta in either shift mode and FlashAttention-2 (beta 0) alike.
On the ``meta`` device (the dry run)
the backward returns empty gradients and recomputes nothing; under
``launch.op_analysis.count()`` it adds ``cost.BACKWARD_FACTOR`` times
its forward sweep's FLOPs, on every device.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.precision import PrecisionPolicy
from repro_torch.kernels import ops
from repro_torch.kernels.pasa_attention import attention_plain
from repro_torch.kernels.cost import run_op


class KernelAttention(torch.autograd.Function):
    """(q (B, H, S1, D), k, v (B, KVH, S2, D) raw keys) -> (B, H, S1, D)
    at the policy's output dtype; the arguments of ``ops.pasa_attention``
    (``flash`` picks ``ops.flash_attention``, which needs beta 0 and no
    shift).

    With grad off, or no input requiring grad, ``apply`` runs only the
    forward: the op's call, bits and launches, which is how every serve
    reaches the dense prefill.  The backward runs only under autograd."""

    @staticmethod
    def forward(ctx, q, k, v, flash: bool, beta: float,
                policy: PrecisionPolicy, block_q: int, block_kv: int,
                causal: bool, kv_valid: Optional[int], gemm_shift: bool):
        blocks = dict(policy=policy, block_q=block_q, block_kv=block_kv,
                      causal=causal, kv_valid=kv_valid)
        if flash:
            if beta != 0.0:
                raise ValueError(f"flash attention runs at beta 0, got {beta}")
            out = ops.flash_attention(q, k, v, **blocks)
        else:
            out = ops.pasa_attention(q, k, v, beta=beta, gemm_shift=gemm_shift,
                                     **blocks)
        ctx.save_for_backward(q, k, v)
        ctx.plain = dict(beta=beta, policy=policy, block_kv=block_kv,
                         causal=causal, kv_valid=kv_valid,
                         gemm_shift=gemm_shift)
        ctx.op = "flash_attention" if flash else "pasa_attention"
        return out

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors           # unpacked once (remat)
        return run_op(f"{ctx.op}.backward", _backward_cost,
                      KernelAttention._plain_backward, ctx, saved, grad_out)

    @staticmethod
    def _plain_backward(ctx, saved, grad_out):
        need = ctx.needs_input_grad[:3]
        if grad_out.device.type == "meta":
            return tuple(torch.empty_like(t) if n else None
                         for t, n in zip(saved, need)) + (None,) * 8
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(saved, need)]
            out = attention_plain(*ins, **ctx.plain)
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(ins, need) if n], grad_out))
        return tuple(next(grads) if n else None for n in need) + (None,) * 8


def _backward_cost(ctx, saved, grad_out):
    return ops.attention_op_cost(saved[0], saved[1], backward=True,
                                 **ctx.plain)


def kernel_attention(q, k, v, *, flash: bool = False, beta: float = 0.0,
                     policy: PrecisionPolicy, block_q: int = 128,
                     block_kv: int = 128, causal: bool = False,
                     kv_valid: Optional[int] = None,
                     gemm_shift: bool = True) -> torch.Tensor:
    """:class:`KernelAttention` with keyword arguments."""
    return KernelAttention.apply(q, k, v, flash, beta, policy, block_q,
                                 block_kv, causal, kv_valid, gemm_shift)
