"""Attention kernels: CUDA sources in ``csrc/``, built with nvcc on first
use (``_build``), each beside its plain PyTorch version.

As in ``repro.kernels``, the package binds the public entry points of
``ops`` under their own names, so ``from repro_torch.kernels import
pasa_attention`` gives the op.  Those names shadow the kernel modules of
the same name as attributes of the package: reach a module through
``importlib.import_module("repro_torch.kernels.<name>")`` (or
``from repro_torch.kernels.<name> import ...``).

``pasa_paged_verify`` is W calls of ``pasa_paged_decode``; it needs no
kernel of its own.  ``pasa_paged_decode_sharded`` and
``pasa_paged_prefill_sharded`` run the paged kernels on each model rank's
kv-head slice over a mesh's process group (the replicated call where the
kv heads do not divide the model axis).
"""

# ops loads every kernel module before the names below rebind them.
from repro_torch.kernels.ops import (
    flash_attention,
    pasa_attention,
    pasa_decode,
    pasa_paged_decode,
    pasa_paged_decode_sharded,
    pasa_paged_prefill,
    pasa_paged_prefill_sharded,
    pasa_paged_verify,
    shift_kv,
)

__all__ = [
    "flash_attention",
    "pasa_attention",
    "pasa_decode",
    "pasa_paged_decode",
    "pasa_paged_decode_sharded",
    "pasa_paged_prefill",
    "pasa_paged_prefill_sharded",
    "pasa_paged_verify",
    "shift_kv",
]
