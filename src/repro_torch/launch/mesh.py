"""The port's device mesh (counterpart of ``repro.launch.mesh``).

A JAX mesh is a grid of devices that one program drives.  In the port an
axis either runs across processes - one process per index along it, a
``torch.distributed`` group of processes - or stays inside the process.
A :class:`Mesh` is the grid of ``torch.device`` cells, the axis names and
sizes, this process's coordinates and the process group of each axis
across processes larger than 1 (``axis_group``).

  * Serving (:func:`make_mesh`): the ``model`` axis runs across
    processes, and ``data`` stays inside the process as the replicas of
    ``runtime.EngineReplicaGroup``; the process with model rank r serves
    the cells of column r.
  * Training (:func:`make_train_mesh`): ``pod``, ``data`` and ``model``
    all run across processes; rank r of the default group sits at the
    mesh coordinates of r in row-major order, and every axis larger than
    1 has its group (and the data axes together, ``dp_group()``, the
    group the gradients are averaged over).
  * The dry run (:func:`make_production_mesh`, :func:`make_abstract_mesh`):
    a mesh of shapes only, on the ``meta`` device, whose axes' groups are
    ``collectives.AbstractGroup`` - no process and no process group.

Constructing a mesh starts no process: the default process group is the
caller's (``torchrun`` or ``torch.multiprocessing.spawn`` and
``dist.init_process_group``); the axis groups are made with
``dist.new_group``, in the same order on every rank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.core.collectives import (LOCAL, AbstractGroup, group_rank,
                                         group_size)

MODEL = "model"
DP_AXES = ("pod", "data")


class Mesh:
    """``shape``: {axis name: size} in axis order; ``axis_names``;
    ``devices``: a numpy object array of ``torch.device`` of that shape;
    ``groups``: {tuple of axes: process group} for the axes across
    processes larger than 1 (None: the default group); ``coords``: this
    process's index along each axis across processes (0 along the
    others)."""

    def __init__(self, shape: dict, devices: np.ndarray, *, groups=None,
                 coords=None):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.devices = devices
        self.groups = dict(groups or {})
        self.coords = dict(coords or {})

    def axis_size(self, axes) -> int:
        """The number of cells along ``axes`` (a name or a tuple of names;
        1 for an absent axis)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return int(np.prod([self.shape.get(a, 1) for a in axes]))

    def axis_group(self, axes):
        """The process group of ``axes`` (a name or a tuple of names): the
        group of the processes that differ only along them (None: the
        default group); ``collectives.LOCAL`` where they are all of size
        1 or stay inside the process."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return self.groups.get(tuple(a for a in axes
                                     if self.shape.get(a, 1) > 1), LOCAL)

    def axis_rank(self, axis: str = MODEL) -> int:
        """This process's index along ``axis`` (0 for an axis that stays
        inside the process)."""
        return self.coords.get(axis, 0)

    def dp_axes(self) -> tuple:
        """The data-parallel axes of the mesh ('pod' first if present)."""
        return tuple(a for a in DP_AXES if a in self.shape)

    def dp_group(self):
        """The process group the data-parallel gradients are averaged
        over (see :meth:`axis_group`)."""
        return self.axis_group(self.dp_axes())

    def dp_rank(self) -> int:
        """This process's index over the data axes together (row-major):
        the slice of the global batch it takes."""
        idx = 0
        for a in self.dp_axes():
            idx = idx * self.shape[a] + self.axis_rank(a)
        return idx

    def drop(self, axis: str) -> "Mesh":
        """This mesh without ``axis``, at this process's index along it:
        the other axes' sizes, cells, groups and coordinates.  A step
        whose collectives over ``axis`` are its own (the compressed step's
        pods) runs the model and places the state on it."""
        i = self.axis_names.index(axis)
        return Mesh({a: k for a, k in self.shape.items() if a != axis},
                    np.take(self.devices, self.axis_rank(axis), axis=i),
                    groups={k: g for k, g in self.groups.items()
                            if axis not in k},
                    coords={a: c for a, c in self.coords.items()
                            if a != axis})

    def local_device(self) -> torch.device:
        """This process's cell (a training mesh)."""
        return self.devices[tuple(self.coords.get(a, 0)
                                  for a in self.axis_names)]

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


def _axis_groups(sizes: dict, rank: int):
    """(this rank's coordinates, {axes: group}) for a mesh whose axes run
    one process each (rank r at the row-major coordinates of r): a group
    for each axis larger than 1 and one for the data axes together.
    Every rank makes every group, in one order; a group of every rank is
    the default group (None)."""
    proc = [a for a in sizes if sizes[a] > 1]
    shape = [sizes[a] for a in proc]
    coords = dict(zip(proc, np.unravel_index(rank, shape))) if proc else {}
    coords = {a: int(i) for a, i in coords.items()}
    keys = [(a,) for a in proc]
    dp = tuple(a for a in DP_AXES if a in proc)
    if len(dp) > 1:
        keys.append(dp)
    world = int(np.prod(shape)) if shape else 1
    groups = {}
    for key in keys:
        if int(np.prod([sizes[a] for a in key])) == world:
            groups[key] = None
            continue
        rest = [a for a in proc if a not in key]
        for other in np.ndindex(*[sizes[a] for a in rest]):
            fixed = dict(zip(rest, other))
            ranks = [r for r in range(world)
                     if all(int(np.unravel_index(r, shape)[proc.index(a)])
                            == i for a, i in fixed.items())]
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[key] = g
    return coords, groups


def _sizes(shape, axes) -> tuple:
    """(shape as ints, {axis: size}), checked."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh sizes must be >= 1, got {shape}")
    return shape, dict(zip(axes, shape))


def make_mesh(shape, axes=("data", MODEL), devices=None,
              group=None) -> Mesh:
    """A serving mesh of ``shape`` over ``axes`` (default ``("data",
    "model")``): the ``model`` axis runs one process per rank, and its M >
    1 needs a process group of M ranks: ``group``, or the default group
    when it has M ranks.

    ``devices``: None (the CUDA cards round-robin), one device for every
    cell (``"cpu"``), or a nested sequence of ``shape``."""
    shape, sizes = _sizes(shape, axes)
    m = sizes.get(MODEL, 1)
    if m == 1:
        return Mesh(sizes, _device_grid(shape, devices))
    if group_size(group) != m:
        raise RuntimeError(
            f"a model axis of {m} runs one process per rank in a "
            f"torch.distributed group of {m}; this process has "
            f"{group_size(group)} (start it with torchrun --standalone "
            f"--nproc-per-node {m}, or pass group=)")
    return Mesh(sizes, _device_grid(shape, devices),
                groups={(MODEL,): group}, coords={MODEL: group_rank(group)})


def make_train_mesh(shape, axes=("data", MODEL), devices=None) -> Mesh:
    """A training mesh of ``shape`` over ``axes`` (``pod``, ``data`` and
    ``model``): every axis runs one process per index across the default
    group, whose size must be the product of the axes' sizes.
    ``devices`` as in :func:`make_mesh`."""
    shape, sizes = _sizes(shape, axes)
    n = int(np.prod(shape))
    if n > 1 and group_size() != n:
        raise RuntimeError(
            f"a mesh of {sizes} runs one process per cell: {n} processes "
            f"in the default group; this process has {group_size()} "
            f"(start it with torchrun --standalone --nproc-per-node {n})")
    coords, groups = _axis_groups(sizes, group_rank())
    return Mesh(sizes, _device_grid(shape, devices), groups=groups,
                coords=coords)


def make_abstract_mesh(shape, axes) -> Mesh:
    """A mesh of ``shape`` over ``axes`` that exists as shapes only: every
    cell the ``meta`` device, no process started and no process group
    made.  Each axis larger than 1 (and the data axes together) has a
    ``collectives.AbstractGroup`` of its size, this process rank 0 of
    each: run on meta tensors under it (``launch.sharding.set_mesh``), a
    step is rank 0's program - its shapes, FLOPs and, in
    ``collectives.WIRE``, its collective bytes - with nothing computed."""
    shape, sizes = _sizes(shape, axes)
    keys = [(a,) for a in sizes if sizes[a] > 1]
    dp = tuple(a for a in DP_AXES if sizes.get(a, 1) > 1)
    if len(dp) > 1:
        keys.append(dp)
    groups = {key: AbstractGroup(int(np.prod([sizes[a] for a in key])))
              for key in keys}
    return Mesh(sizes, _device_grid(shape, "meta"), groups=groups,
                coords={a: 0 for a in sizes})


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The dry run's production mesh, abstract (:func:`make_abstract_mesh`):
    ``data`` 32 x ``model`` 8 (256 cards), or ``pod`` 2 x ``data`` 32 x
    ``model`` 8 (512).

    The reference's TPU meshes are 16 x 16 and 2 x 16 x 16: its 16-wide
    model axis stays inside one pod's ICI torus.  On H100s the domain that
    holds a tensor-parallel axis is one 8-card NVLink node, so the model
    axis is 8 wide and the data axis 32 (across nodes, over InfiniBand);
    the device counts stay the reference's.  Serving or training on such a
    mesh runs one process per card under ``torchrun`` (``make_mesh``,
    ``make_train_mesh``); this mesh runs nothing."""
    shape = (2, 32, 8) if multi_pod else (32, 8)
    axes = ("pod", "data", MODEL) if multi_pod else ("data", MODEL)
    return make_abstract_mesh(shape, axes)


def refuse_production_mesh(spec: str, multi_pod: bool = False):
    """Raise, before any work, for a CLI's ``--mesh prod`` / ``prod2``: the
    production mesh runs one process per card under ``torchrun``, 256 (or
    512) of them, and one process does not stand in for them; the dry
    run (``python -m repro_torch.launch.dryrun``) reckons that mesh on the
    meta device."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    n = int(np.prod(list(mesh.shape.values())))
    dims = " x ".join(f"{a} {k}" for a, k in mesh.shape.items())
    raise RuntimeError(
        f"--mesh {spec}: the production mesh ({dims}) runs one process per "
        f"card, {n} processes under torchrun; this is one process (the dry "
        f"run, python -m repro_torch.launch.dryrun, reckons the mesh on the "
        f"meta device)")
