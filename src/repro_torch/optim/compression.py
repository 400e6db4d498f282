"""Int8 error-feedback gradient compression for the cross-pod gradient
sync (counterpart of ``repro.optim.compression``).

Each gradient leaf is quantized to int8 codes under one fp32 scale that
every rank of the group shares (the group max of |g| / 127), the codes
are summed exactly across the group, and the quantization residual is
folded into the next step's gradient (error feedback, Karimireddy et
al., "Error Feedback Fixes SignSGD", 2019).  The codes travel as int16
(two bytes an element), so their sum cannot overflow below 258 ranks.

The port's group is a ``torch.distributed`` process group (the
reference's ``shard_map`` axis); its sum and max are
``core.collectives.all_reduce``: gathered and folded in rank order, the
same bits on every rank.  ``collectives.WIRE`` records each leaf's int16
``all_gather``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.collectives import all_reduce, group_size
from repro_torch.optim.adamw import tree_leaves, tree_map


@dataclasses.dataclass
class CompressionState:
    """Per-leaf fp32 error-feedback residuals (same tree as grads)."""

    residual: Any


def compression_init(grads_like) -> CompressionState:
    return CompressionState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


def compressed_psum(grads, state: CompressionState, group=None):
    """Error-feedback int8 sum over the process group ``group`` (None:
    the default group, or this process alone when no group exists),
    averaged.  For each leaf, in the same order on every rank: ``gf = g +
    residual``; ``scale = max|gf| over the group / 127 + 1e-12``; ``q =
    clip(round(gf / scale), -127, 127)``, summed as int16; the result
    ``sum * scale / n`` at g's dtype and the new residual ``gf - q *
    scale``.  Both are written IN PLACE, into the gradient tensors and
    the state's residual tensors (the reference's call is functional; a
    full-width trainer keeps one copy of each tree, as with AdamW), and
    returned: (averaged grads, new state)."""
    n = group_size(group)

    def leaf(g, r):
        # the divisors are device tensors: on the card a division by a
        # host scalar runs as a product with its reciprocal, which rounds
        # differently from the reference's division
        const = lambda v: torch.full((), v, dtype=torch.float32,
                                     device=r.device)
        gf = g.float() + r
        amax = all_reduce(gf.abs().max(), "max", group)
        scale = amax / const(127.0) + 1e-12
        q = torch.clamp(torch.round(gf / scale), -127, 127)
        summed = all_reduce(q.to(torch.int16), "sum", group)
        g.copy_(summed.float() * scale / const(n))
        r.copy_(gf - q * scale)

    for g, r in zip(tree_leaves(grads), tree_leaves(state.residual)):
        leaf(g, r)
    return grads, state
