"""The placement plan of parameters and serve caches (counterpart of
``repro.launch.params``).

The reference places every leaf with a GSPMD sharding: rules by leaf
name, *right-aligned* over the trailing dims (stacked-layer leading dims
replicated), filtered through ``shard_if_divisible`` so that an axis that
does not divide its dim drops out.  The port has no partitioner, so the
plan here is a pure function from (path, shape, mesh shape) to the axes
along which each dim splits, and the port places its training state by
it explicitly: ``models.convert.shard_params`` gives each process the
block of every parameter (and so of its gradient and AdamW moments) that
the reference's ``NamedSharding`` gives the device at the same mesh
coordinates, and ``models.convert.gather_params`` gathers a layer's
blocks before the layer runs.  The dry run (``launch.dryrun``) reads the
plan to reckon each device's state, and :func:`held_split` reads the
placement the port holds (``models.convert.shard_dim``), which is the
plan.

Placement summary (the reference's):
  * column-parallel weights (wq/wk/wv/w1/w3/in_proj/...):  (..., FSDP, "model")
  * row-parallel weights (wo/w2/out_proj):                 (..., "model", FSDP)
  * embedding (V, D): ("model", FSDP); lm_head (D, V): (FSDP, "model")
  * MoE expert weights (..., E, D, F): E over "model" (expert parallelism),
    D over FSDP
  * SSM channel dims over "model"; KV caches (..., B, S, kv_dim):
    (DP, None, "model") right-aligned.

FSDP = ("pod", "data"): ZeRO-style parameter sharding over the data axes.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

FSDP = ("pod", "data")
DP = ("pod", "data")

# name -> right-aligned trailing spec (leading dims replicated)
_TRAILING_RULES = {
    # attention / mlp projections (column-parallel)
    "wq": (FSDP, "model"),
    "wk": (FSDP, "model"),
    "wv": (FSDP, "model"),
    "w1": (FSDP, "model"),
    "w3": (FSDP, "model"),
    "in_proj": (FSDP, "model"),
    "dt_proj": (None, "model"),
    "x_proj": ("model", None),
    "lm_head": (FSDP, "model"),
    "vision_proj": (FSDP, "model"),
    "router": (FSDP, "model"),
    # row-parallel
    "wo": ("model", FSDP),
    "w2": ("model", FSDP),
    "out_proj": ("model", FSDP),
    # ssm channel tensors
    "conv_w": ("model", None),
    # vectors sharded on model (column-parallel biases / per-channel)
    "bq": ("model",),
    "bk": ("model",),
    "bv": ("model",),
    "conv_b": ("model",),
    "dt_bias": ("model",),
    "d_skip": ("model",),
    "norm_w": ("model",),
    # embeddings
    "embed": ("model", FSDP),
    "pos_embed": (None, FSDP),
}

# MoE expert tensors: (..., E, D, F) / (..., E, F, D) - E over "model"
_MOE_RULES = {
    "w1": ("model", FSDP, None),
    "w3": ("model", FSDP, None),
    "w2": ("model", None, FSDP),
}

# serve-cache leaves, right-aligned
_CACHE_RULES = {
    "k": (DP, None, "model"),      # (..., B, S, kv_dim)
    "v": (DP, None, "model"),
    "conv": (DP, None, "model"),   # (..., B, K-1, Di)
    "enc_out": (DP, None, None),   # (B, S_audio, D)
}


def _right_align(rank: int, trailing) -> tuple:
    trailing = tuple(trailing)[-rank:]
    return (None,) * (rank - len(trailing)) + trailing


def leaf_spec(path: Sequence[str], rank: int) -> tuple:
    """The reference's ``_leaf_spec``: the wanted axes of each dim of the
    parameter leaf at ``path`` (its keys) with ``rank`` dims."""
    name = path[-1]
    if "moe" in path and name in _MOE_RULES:
        return _right_align(rank, _MOE_RULES[name])
    if name == "a_log":
        # mamba1: (L, Di, N) -> model on Di; mamba2: (L, NH) -> model on NH
        return _right_align(rank, ("model", None) if rank >= 3 else ("model",))
    rule = _TRAILING_RULES.get(name)
    if rule is None:
        return (None,) * rank  # norms, gates, scalars -> replicated
    return _right_align(rank, rule)


def if_divisible(mesh_shape: Dict[str, int], shape: Sequence[int],
                 spec: Sequence) -> Tuple[Optional[tuple], ...]:
    """``shard_if_divisible``'s rule: per dim the axes of ``spec`` that
    exist in the mesh and keep dividing the dim, in order (a tuple, or
    None for a dim that stays whole)."""
    out = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        if entry is None:
            out.append(None)
            continue
        entries = entry if isinstance(entry, (tuple, list)) else (entry,)
        kept, size = [], 1
        for a in entries:
            if a not in mesh_shape:
                continue
            if dim % (size * mesh_shape[a]) == 0:
                kept.append(a)
                size *= mesh_shape[a]
        out.append(tuple(kept) or None)
    return tuple(out)


def param_plan(path: Sequence[str], shape: Sequence[int],
               mesh_shape: Dict[str, int]) -> tuple:
    """The plan of one parameter leaf (or its gradient or AdamW moment,
    which share its layout): per dim the mesh axes it splits over."""
    return if_divisible(mesh_shape, shape, leaf_spec(path, len(shape)))


def cache_plan(path: Sequence[str], shape: Sequence[int],
               mesh_shape: Dict[str, int]) -> tuple:
    """The plan of one serve-cache leaf (the reference's
    ``cache_shardings``)."""
    name, rank = path[-1], len(shape)
    if name == "ssm":
        # mamba1 (L,B,Di,N): B at -3; mamba2 (L,B,NH,N,P): B at -4
        spec = (DP, "model", None) if rank == 4 else (DP, "model", None,
                                                      None)
        return if_divisible(mesh_shape, shape, _right_align(rank, spec))
    rule = _CACHE_RULES.get(name, (DP,) + (None,) * (rank - 1))
    return if_divisible(mesh_shape, shape, _right_align(rank, rule))


def split_count(plan: tuple, mesh_shape: Dict[str, int]) -> int:
    """Into how many parts a plan splits its leaf."""
    return math.prod(mesh_shape[a] for axes in plan if axes for a in axes)


def held_split(path: Sequence[str], cfg, mesh_shape: Dict[str, int]) -> int:
    """Into how many parts the port's placement
    (``models.convert.shard_dim``) splits the parameter leaf at ``path``
    of ``cfg``'s model on a mesh of ``mesh_shape``."""
    from repro_torch.launch.roofline import ShapeOnlyMesh
    from repro_torch.models.convert import shard_dim

    return split_count(shard_dim(tuple(path), cfg, ShapeOnlyMesh(mesh_shape)),
                       mesh_shape)
