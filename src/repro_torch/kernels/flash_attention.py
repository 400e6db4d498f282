"""FlashAttention-2 baseline (counterpart of ``repro.kernels.flash_attention``).

The baseline is the PASA attention kernel at ``inva = 0`` with the
1/sqrt(d) scale applied after the fp16 score store (paper Eqs. 1-2), on
the identical tiling - exactly the comparison the paper's performance
numbers isolate.  See :func:`repro_torch.kernels.ops.flash_attention`.
"""

from repro_torch.kernels.ops import flash_attention

__all__ = ["flash_attention"]
