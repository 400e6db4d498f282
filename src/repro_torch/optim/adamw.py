"""AdamW with global-norm clipping (counterpart of ``repro.optim.adamw``).

The state and the arithmetic of the reference, leaf by leaf in fp32:
moments at ``moment_dtype`` (``ModelConfig.optimizer_dtype``: fp32, bf16
for kimi-k2), the gradients clipped to ``max_grad_norm`` by one global
scale, bias-corrected moments, decoupled weight decay.  A tree is a
nested dict of tensors, walked in sorted key order (the order of the
reference's ``jax.tree.leaves``).

:func:`adamw_update` writes the parameters and moments IN PLACE and
returns the same tensors: the reference's trainer donates its state to
the jitted step (``donate_argnums=(0,)``), so a full-width model holds
one copy of it, and so does the port's.  A caller that needs the old
values clones them first.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor          # () int32
    mu: Any
    nu: Any


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of dict trees of one structure (sorted keys)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a dict tree in sorted key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def adamw_init(params, moment_dtype=torch.float32) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
    dev = tree_leaves(params)[0].device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params),
    )


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    total = None
    for leaf in tree_leaves(tree):
        sq = torch.sum(torch.square(leaf.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / (norm + 1e-12)), norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def adamw_update(
    params,
    grads,
    state: AdamWState,
    *,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1.0e-8,
    weight_decay: float = 0.1,
    max_grad_norm: Optional[float] = 1.0,
):
    """One AdamW step, written into ``params`` and the moments in place.
    ``lr`` is a float or a () tensor.  Returns (params, new state,
    {"grad_norm": the norm before clipping})."""
    gnorm = global_norm(grads)
    scale = None
    if max_grad_norm is not None:
        # clip_by_global_norm's scale, applied leaf by leaf below
        scale = torch.clamp(max_grad_norm / (gnorm + 1e-12), max=1.0)

    step = state.step + 1
    stepf = step.float()
    c1 = 1.0 - b1 ** stepf
    c2 = 1.0 - b2 ** stepf
    lr = torch.as_tensor(lr, dtype=torch.float32, device=stepf.device)
    f32 = torch.float32

    @torch.no_grad()
    def upd(p, g, mu, nu):
        # the reference's arithmetic in its order; fp32 moments and
        # parameters are updated in place, others through fp32 copies
        if scale is not None:
            g = g * scale.to(g.dtype)
        gf = g.float()
        mu_f = mu if mu.dtype == f32 else mu.float()
        mu_f.mul_(b1).add_((1 - b1) * gf)
        nu_f = nu if nu.dtype == f32 else nu.float()
        nu_f.mul_(b2).add_((1 - b2) * gf * gf)
        del g, gf
        update = (mu_f / c1).div_(torch.sqrt(nu_f / c2).add_(eps))
        update.add_(weight_decay * p.float())
        if p.dtype == f32:
            p.sub_(update.mul_(lr))
        else:
            p.copy_(p.float() - lr * update)
        if mu_f is not mu:
            mu.copy_(mu_f)
        if nu_f is not nu:
            nu.copy_(nu_f)

    for p, g, mu, nu in zip(*(tree_leaves(t) for t in
                              (params, grads, state.mu, state.nu))):
        upd(p, g, mu, nu)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), {
        "grad_norm": gnorm}
