"""PyTorch/CUDA port of the PASA serving system (``src/repro`` is the JAX
reference).

The sub-packages mirror the reference's layout - ``core/``, ``configs/``,
``kernels/``, ``models/``, ``runtime/``, ``launch/`` - so the counterpart
of ``repro.X.Y`` is ``repro_torch.X.Y``.  This package imports ``torch``
and never ``jax`` or anything of ``repro``.

Entry points run on the GPU: ``device=None`` means ``"cuda"``, and asking
for CUDA without a card raises.  The CPU is reached only by an explicit
``device="cpu"`` (the tests do this); there every kernel wrapper takes its
plain PyTorch version because the tensors it gets lie on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` -> ``cuda``.

    Raises RuntimeError when CUDA is asked for and no card is visible;
    there is no silent fall back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' explicitly to run the plain PyTorch path"
        )
    return dev
