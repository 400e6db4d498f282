"""The mesh registry (counterpart of ``repro.launch.sharding``).

Models never hold a mesh: the trainer (``launch/train.py``) activates
one with :func:`set_mesh`, and the model code that has a distributed
form asks :func:`get_mesh` - ``models.convert.gather_params`` (each
layer's weights gathered from this process's blocks),
``models.attention.attention`` and ``models.layers.mlp`` (column-parallel
on the model axis), ``models.layers.embed`` and ``lm_loss_chunked``
(vocab-parallel), ``models.ssm``'s blocks (their channels on the model
axis), ``models.moe.moe_ffn`` (the expert-parallel dispatch) and
``models.layers.row_parallel_matmul`` - and takes its
one-device form when no mesh is active or inside :func:`manual_region`.

A manual region is the reference's ``shard_map`` body: there the step's
collectives are the caller's, and the models' own distributed forms
stay off (JAX rejects nested manual regions over other axes).  The
port's sharded serving step is one (``runtime.engine``): it keeps the
one-device dispatch whatever mesh is active.

The registry is the process's, not a thread's (the reference keeps it
per thread): autograd runs the backward, and with it a remat layer's
recomputed forward, on its own threads, which must take the forward's
path.  A process is one mesh cell.

The reference's ``shard`` and ``shard_if_divisible`` are GSPMD placement
hints (sharding constraints on intermediates and at the jit boundary);
the port has no GSPMD partitioner, so they have no counterpart: a
process holds its blocks of the state explicitly, by the reference's
plan (``models.convert.shard_params``), and the collectives are written
out (``core.collectives``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional


class _Registry:
    def __init__(self):
        self.mesh = None
        self.manual = 0
        self.lock = threading.Lock()


_state = _Registry()


def set_mesh(mesh) -> None:
    """Activate ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh`, or
    None) for this process."""
    _state.mesh = mesh


def get_mesh() -> Optional[object]:
    return _state.mesh


@contextlib.contextmanager
def manual_region():
    """Run the body as a manual region (see the module docstring)."""
    with _state.lock:
        _state.manual += 1
    try:
        yield
    finally:
        with _state.lock:
            _state.manual -= 1


def in_manual_region() -> bool:
    """True inside :func:`manual_region`."""
    return _state.manual > 0


def dp_axes() -> tuple:
    """The data-parallel axes of the active mesh ('pod' first if
    present); ("data",) without a mesh."""
    mesh = get_mesh()
    return ("data",) if mesh is None else mesh.dp_axes()
