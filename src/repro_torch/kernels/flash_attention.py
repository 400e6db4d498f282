"""FlashAttention-2 baseline (counterpart of ``repro.kernels.flash_attention``).

The baseline is the PASA attention kernel at ``inva = 0`` with the
1/sqrt(d) scale applied after the score store (paper Eqs. 1-2), on the
identical tiling - exactly the comparison the paper's performance numbers
isolate - at any policy of the kernels (the model's ``impl="flash"``
serves it at ``bf16_fp32``).  See
:func:`repro_torch.kernels.ops.flash_attention`.
"""

from repro_torch.kernels.ops import flash_attention

__all__ = ["flash_attention"]
