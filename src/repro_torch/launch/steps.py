"""Train and serve step factories over a ModelBundle (counterpart of
``repro.launch.steps``: ``TrainHyper``, ``init_train_state``,
``make_train_step``, ``make_compressed_train_step`` and
``make_serve_step``).

The reference differentiates its jnp path with ``jax.value_and_grad``;
the port differentiates its forward with autograd.  On the card the
attention of every layer runs the hand-written kernels forward and the
plain version's gradient backward (``kernels.train_attention``).  The
optimizer step updates the state in place (``optim.adamw_update``), as
the reference's trainer donates its state to the jitted step.

Across processes (a training mesh active through ``launch.sharding``,
one process per cell): each process runs its slice of the global batch
and holds, at rest, exactly its block of every parameter, gradient and
AdamW moment under the reference's plan (``launch.params.param_plan``:
ZeRO over the data axes, the attention's and MLPs' projections, the
embeddings and the SSM channels over the model axis;
``models.convert.shard_params``).  Each layer gathers its weights just
before it runs (``models.convert.gather_params``), and the backward
reduce-scatters their gradients onto the blocks, so a gradient comes
out of the backward already summed over the data axes its leaf is split
over; the step sums the rest over the data axes (the leaves the plan
keeps whole there), averages, and runs AdamW on the blocks.  The loss is
the data ranks' mean, and the gradient norm sums each leaf's squares
over the group of axes that split it, each element once.  Every
reduction folds the ranks in order, so a block held by several
processes stays the same bits on each.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.collectives import all_reduce
from repro_torch.launch.sharding import get_mesh
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.optim import adamw_init, adamw_update, cosine_warmup
from repro_torch.optim.adamw import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    peak_lr: float = 3.0e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    # gradient accumulation: the global batch split into this many
    # microbatches run one after the other, their gradients summed in
    # fp32 and averaged - live activation memory divided by the same
    # factor
    microbatches: int = 1


def init_train_state(bundle: ModelBundle, generator: torch.Generator,
                     device=None, mesh=None) -> Dict[str, Any]:
    """Random parameters at ``cfg.param_dtype`` (from ``generator``, which
    lives on ``device``) and a fresh AdamW state with moments at
    ``cfg.optimizer_dtype``: ``{"params": tree, "opt": AdamWState}``.
    Under a training ``mesh``, this process's blocks of them
    (``models.convert.shard_params``; every process draws the whole
    model from the same seed first)."""
    from repro_torch.models.convert import shard_params

    cfg = bundle.cfg
    params = bundle.init(generator, resolve_device(device),
                         dtype=cfg.torch_param_dtype())
    if mesh is not None:
        params = shard_params(params, mesh)
    return {"params": params,
            "opt": adamw_init(params, cfg.torch_optimizer_dtype())}


def batch_to_device(batch: dict, device) -> dict:
    """A pipeline batch (numpy arrays or tensors) as tensors on ``device``."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v))
                if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


def _grads_fn(bundle: ModelBundle, hyper: TrainHyper) -> Callable:
    """(params, leaves, batch) -> (loss, [gradient of each leaf]) over
    ``hyper.microbatches`` microbatches of this process's batch."""

    def grad(loss, leaves):
        # a leaf the loss does not reach has gradient 0, as under jax
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(leaves, gs)]

    def grads_of(params, leaves, batch):
        if hyper.microbatches <= 1:
            loss = bundle.loss_fn(params, batch)
            return loss.detach(), grad(loss, leaves)
        mb = hyper.microbatches
        for x in batch.values():
            if x.shape[0] % mb:
                raise ValueError(
                    f"batch {x.shape[0]} % microbatches {mb} != 0")
        micro = {k: x.chunk(mb) for k, x in batch.items()}
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
        gacc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves]
        for i in range(mb):
            loss = bundle.loss_fn(params, {k: x[i] for k, x in micro.items()})
            for a, g in zip(gacc, grad(loss, leaves)):
                a.add_(g.float())
            loss_sum = loss_sum + loss.detach()
        inv = 1.0 / mb
        return loss_sum * inv, [g.mul_(inv) for g in gacc]

    return grads_of


def _split_axes(plan) -> tuple:
    """The mesh axes a leaf's plan splits it over."""
    return tuple(a for axes in plan if axes for a in axes)


def _group_mean(loss, grads, mesh, axes, plans=None):
    """(loss, grads) averaged over ``mesh``'s ``axes`` (no-op at size
    1): each summed in rank order, then divided by the group's size; the
    gradients in place, one leaf's sum alive at a time.  A leaf whose
    plan (``plans``, one per gradient) splits it over some of ``axes``
    came out of the backward summed over them already (the
    reduce-scatter of its gather), so it is summed over the others
    only."""
    n = mesh.axis_size(axes)
    if n == 1:
        return loss, grads
    out = []
    for i, g in enumerate(grads):
        split = () if plans is None else _split_axes(plans[i])
        rest = tuple(a for a in axes if a not in split)
        if mesh.axis_size(rest) > 1:
            g.copy_(all_reduce(g, "sum", mesh.axis_group(rest)))
        out.append(g.div_(n))
    return all_reduce(loss, "sum", mesh.axis_group(axes)) / n, out


def _grad_norm(mesh, plans, grads):
    """The global norm of ``grads`` when the mesh splits some of them,
    else None (AdamW's own ``global_norm``): each leaf's squares summed
    on this process's block, the leaves bucketed by the axes that split
    them, each bucket's sum reduced over those axes (the model group,
    then the data axes' group), so every element counts once."""
    if mesh is None:
        return None
    keys = [tuple(a for a in mesh.axis_names
                  if a in _split_axes(plan) and mesh.shape[a] > 1)
            for plan in plans]
    if not any(keys):
        return None
    buckets = {}
    for g, key in zip(grads, keys):
        sq = torch.sum(torch.square(g.float()))
        buckets[key] = sq if key not in buckets else buckets[key] + sq
    total = None
    for key, sq in buckets.items():
        if "model" in key:
            sq = all_reduce(sq, "sum", mesh.axis_group("model"))
        dp = tuple(a for a in key if a != "model")
        if dp:
            sq = all_reduce(sq, "sum", mesh.axis_group(dp))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _apply(hyper: TrainHyper, params, opt, grads, gnorm):
    """The cosine warmup learning rate at the state's step and one AdamW
    update in place: (params, opt, {"lr", "grad_norm"})."""
    lr = cosine_warmup(
        opt.step, peak_lr=hyper.peak_lr, warmup_steps=hyper.warmup_steps,
        total_steps=hyper.total_steps,
    )
    it = iter(grads)
    grads = tree_map(lambda _: next(it), params)
    params, opt, m = adamw_update(
        params, grads, opt, lr=lr, b1=hyper.b1, b2=hyper.b2,
        weight_decay=hyper.weight_decay, max_grad_norm=hyper.max_grad_norm,
        grad_norm=gnorm,
    )
    return params, opt, {"lr": lr, **m}


def _leaves_for_grad(params):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return leaves


def make_train_step(bundle: ModelBundle, hyper: TrainHyper) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: the loss and its
    gradients (over ``hyper.microbatches`` microbatches), the cosine
    warmup learning rate at the state's step, and one AdamW update of the
    state in place.  ``metrics``: () tensors ``loss``, ``lr`` and
    ``grad_norm`` (before clipping).

    Under an active training mesh (``launch.sharding.get_mesh()`` at the
    call) ``batch`` is this process's slice of the global batch (the
    pipeline's ``process_index`` slice, by ``mesh.dp_rank()``) and
    ``state`` its blocks of the state (``init_train_state(...,
    mesh=)``); the gradients and the loss are averaged over the data
    axes (``pod`` and ``data``) before AdamW."""
    from repro_torch.models.convert import shard_dims

    grads_of = _grads_fn(bundle, hyper)

    def train_step(state, batch):
        mesh = get_mesh()
        params, opt = state["params"], state["opt"]
        batch = batch_to_device(batch, opt.step.device)
        leaves = _leaves_for_grad(params)
        loss, grads = grads_of(params, leaves, batch)
        plans = None
        if mesh is not None:
            plans = shard_dims(params, bundle.cfg, mesh)
            loss, grads = _group_mean(loss, grads, mesh, mesh.dp_axes(),
                                      plans)
        params, opt, m = _apply(hyper, params, opt, grads,
                                _grad_norm(mesh, plans, grads))
        return {"params": params, "opt": opt}, {"loss": loss, **m}

    return train_step


def make_compressed_train_step(bundle: ModelBundle, hyper: TrainHyper,
                               mesh) -> Callable:
    """Train step with int8 error-feedback gradient sync across "pod"
    (the reference's cross-pod topology): the parameters are
    pod-replicated, placed by the plan over ``data`` and ``model`` only
    (FSDP over ``data``: the mesh without its pod axis,
    ``train_step.mesh = mesh.drop("pod")``, on which the model runs and
    ``init_train_state(..., mesh=train_step.mesh)`` places the state);
    each process's gradients are averaged plainly over ``data`` within
    its pod, then across pods on its data block with
    :func:`repro_torch.optim.compressed_psum`; the loss is the mean over
    both.  ``mesh`` is the training mesh of this process; ``batch`` this
    process's slice of the global batch.

    ``state = {"params", "opt", "comp": residual tree}``;
    ``train_step.init_comp(params)`` makes the residual tree (of the
    blocks).  The reference's residual tree has a leading (n_pod,) dim
    sharded over "pod"; here each process holds its own residual tree
    (its pod's row), a difference in form only.  Returns
    ``train_step(state, batch) -> (state, metrics)``."""
    from repro_torch.launch.sharding import set_mesh
    from repro_torch.models.convert import shard_dims
    from repro_torch.optim.compression import (CompressionState,
                                               compressed_psum)

    if "pod" not in mesh.axis_names:
        raise ValueError("compressed train step needs a 'pod' mesh axis")
    grads_of = _grads_fn(bundle, hyper)
    inner = mesh.drop("pod")

    def init_comp(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        batch = batch_to_device(batch, opt.step.device)
        leaves = _leaves_for_grad(params)
        outer = get_mesh()
        set_mesh(inner)
        try:
            loss, grads = grads_of(params, leaves, batch)
        finally:
            set_mesh(outer)
        plans = shard_dims(params, bundle.cfg, inner)
        loss, grads = _group_mean(loss, grads, mesh, ("data",), plans)
        it = iter(grads)
        grads, comp = compressed_psum(
            tree_map(lambda _: next(it), params),
            CompressionState(residual=state["comp"]),
            mesh.axis_group("pod"))
        loss, _ = _group_mean(loss, [], mesh, ("pod",))
        grads = tree_leaves(grads)
        params, opt, m = _apply(hyper, params, opt, grads,
                                _grad_norm(inner, plans, grads))
        return ({"params": params, "opt": opt, "comp": comp.residual},
                {"loss": loss, **m})

    train_step.init_comp = init_comp
    train_step.mesh = inner
    return train_step


def make_serve_step(bundle: ModelBundle) -> Callable:
    """(params, token, pos, cache, **extras) -> (next_token, logits,
    cache): one greedy decode step on the dense cache; ``extras`` (the
    vlm's ``vision_embeds``) go to the bundle's step."""

    def serve_step(params, token, pos, cache, **extras):
        logits, cache = bundle.serve_step(params, token, pos, cache, **extras)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits, cache

    return serve_step
