"""The port's device mesh (counterpart of ``repro.launch.mesh``).

A JAX mesh is a grid of devices that one program drives.  In the port the
``model`` axis is a ``torch.distributed`` group of processes, one per
rank, and every other axis stays inside the process: a :class:`Mesh` is
the grid of ``torch.device`` cells, the axis names and sizes, and the
model axis's process group.  The process with model rank r serves the
cells of column r.

Constructing a mesh starts nothing: the process group is the caller's
(``torchrun`` or ``torch.multiprocessing.spawn`` and
``dist.init_process_group``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.collectives import group_rank, group_size

MODEL = "model"


class Mesh:
    """``shape``: {axis name: size} in axis order; ``axis_names``;
    ``devices``: a numpy object array of ``torch.device`` of that shape;
    ``group``: the process group of the ``model`` axis (None when the axis
    is absent or of size 1)."""

    def __init__(self, shape: dict, devices: np.ndarray, group=None):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.devices = devices
        self.group = group

    def axis_group(self, axis: str):
        """The process group of ``axis``: the model axis's group; None for
        an axis that stays inside the process (or one of size 1)."""
        return self.group if axis == MODEL else None

    def axis_rank(self, axis: str = MODEL) -> int:
        """This process's index along ``axis`` (0 for an axis that stays
        inside the process)."""
        if axis != MODEL or self.shape.get(MODEL, 1) == 1:
            return 0
        return group_rank(self.group)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def _cell(device) -> torch.device:
    """``device`` with its card's index (``cuda`` names the current card),
    so that two cells on one card compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _device_grid(shape, devices) -> np.ndarray:
    """The cells of ``shape``: by default the CUDA cards round-robin
    (every cell on ``cuda:0`` when there is one card), one device for all,
    or a nested sequence of ``shape``."""
    cells = list(np.ndindex(*shape))
    if devices is None:
        resolve_device("cuda")
        n = torch.cuda.device_count()
        devs = [torch.device("cuda", i % n) for i in range(len(cells))]
    elif isinstance(devices, (str, torch.device)):
        devs = [_cell(devices)] * len(cells)
    else:
        devs = [_cell(d) for d in np.asarray(devices, dtype=object).ravel()]
        if len(devs) != len(cells):
            raise ValueError(f"{len(devs)} devices for a mesh of shape "
                             f"{shape}")
    grid = np.empty(shape, dtype=object)
    for idx, dev in zip(cells, devs):
        grid[idx] = dev
    return grid


def make_mesh(shape, axes=("data", MODEL), devices=None, group=None) -> Mesh:
    """A mesh of ``shape`` over ``axes`` (default ``("data", "model")``).

    ``devices``: None (the CUDA cards round-robin), one device for every
    cell (``"cpu"``), or a nested sequence of ``shape``.  A ``model`` axis
    of M > 1 needs a process group of M ranks: ``group``, or the default
    group when it has M ranks."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh sizes must be >= 1, got {shape}")
    sizes = dict(zip(axes, shape))
    m = sizes.get(MODEL, 1)
    if m == 1:
        group = None
    elif group_size(group) != m:
        raise RuntimeError(
            f"a model axis of {m} runs one process per rank in a "
            f"torch.distributed group of {m}; this process has "
            f"{group_size(group)} (start it with torchrun --standalone "
            f"--nproc-per-node {m}, or pass group=)")
    return Mesh(sizes, _device_grid(shape, devices), group)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 16 x 16 (and 2 x 16 x 16) TPU pod meshes have no
    counterpart on the card yet (ROADMAP A16)."""
    raise NotImplementedError(
        "production meshes are TPU pod layouts; their H100 counterpart is "
        "ROADMAP A16")
