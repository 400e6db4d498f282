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
and holds its part of the state (``models.convert.shard_params``); the
gradients are averaged over the data axes before AdamW, the loss is
their mean, and the gradient norm counts each model-sharded leaf's
parts once.  Every reduction folds the ranks in order, so the
replicated state stays the same bits on every process.
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
    Under a training ``mesh``, this process's part of them
    (``models.convert.shard_params``; every process draws the whole
    model from the same seed first)."""
    from repro_torch.models.convert import shard_params

    cfg = bundle.cfg
    params = bundle.init(generator, resolve_device(device),
                         dtype=cfg.torch_param_dtype())
    if mesh is not None:
        params = shard_params(params, cfg, mesh)
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


def _group_mean(loss, grads, mesh, axes):
    """(loss, grads) averaged over ``mesh``'s ``axes`` (no-op at size
    1): each summed in rank order, then divided by the group's size; the
    gradients in place, one leaf's sum alive at a time."""
    n = mesh.axis_size(axes)
    if n == 1:
        return loss, grads
    group = mesh.axis_group(axes)
    return (all_reduce(loss, "sum", group) / n,
            [g.copy_(all_reduce(g, "sum", group)).div_(n) for g in grads])


def _grad_norm(bundle: ModelBundle, mesh, params, grads):
    """The global norm of ``grads`` when the model axis splits some of
    them (each part's squares summed over the model group, added to the
    replicated leaves'), else None (AdamW's own ``global_norm``)."""
    from repro_torch.models.convert import shard_dims

    if mesh is None or mesh.axis_size("model") == 1:
        return None
    dims = shard_dims(params, bundle.cfg, mesh)
    if not any(d is not None for d in dims):
        return None
    zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    rep, part = zero, zero
    for g, d in zip(grads, dims):
        sq = torch.sum(torch.square(g.float()))
        if d is None:
            rep = rep + sq
        else:
            part = part + sq
    part = all_reduce(part, "sum", mesh.axis_group("model"))
    return torch.sqrt(rep + part)


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
    ``state`` its part of the state; the gradients and the loss are
    averaged over the data axes (``pod`` and ``data``) before AdamW."""
    grads_of = _grads_fn(bundle, hyper)

    def train_step(state, batch):
        mesh = get_mesh()
        params, opt = state["params"], state["opt"]
        batch = batch_to_device(batch, opt.step.device)
        leaves = _leaves_for_grad(params)
        loss, grads = grads_of(params, leaves, batch)
        if mesh is not None:
            loss, grads = _group_mean(loss, grads, mesh, mesh.dp_axes())
        params, opt, m = _apply(hyper, params, opt, grads,
                                _grad_norm(bundle, mesh, params, grads))
        return {"params": params, "opt": opt}, {"loss": loss, **m}

    return train_step


def make_compressed_train_step(bundle: ModelBundle, hyper: TrainHyper,
                               mesh) -> Callable:
    """Train step with int8 error-feedback gradient sync across "pod"
    (the reference's cross-pod topology): each process's gradients are
    averaged plainly over ``data`` within its pod, then across pods with
    :func:`repro_torch.optim.compressed_psum`; the loss is the mean over
    both.  ``mesh`` is the training mesh of this process; ``batch`` this
    process's slice of the global batch.

    ``state = {"params", "opt", "comp": residual tree}``;
    ``train_step.init_comp(params)`` makes the residual tree.  The
    reference's residual tree has a leading (n_pod,) dim sharded over
    "pod"; here each process holds its own residual tree (its pod's
    row), a difference in form only.  Returns ``train_step(state, batch)
    -> (state, metrics)``."""
    from repro_torch.optim.compression import (CompressionState,
                                               compressed_psum)

    if "pod" not in mesh.axis_names:
        raise ValueError("compressed train step needs a 'pod' mesh axis")
    grads_of = _grads_fn(bundle, hyper)

    def init_comp(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        batch = batch_to_device(batch, opt.step.device)
        leaves = _leaves_for_grad(params)
        loss, grads = grads_of(params, leaves, batch)
        loss, grads = _group_mean(loss, grads, mesh, ("data",))
        it = iter(grads)
        grads, comp = compressed_psum(
            tree_map(lambda _: next(it), params),
            CompressionState(residual=state["comp"]),
            mesh.axis_group("pod"))
        loss, _ = _group_mean(loss, [], mesh, ("pod",))
        grads = tree_leaves(grads)
        params, opt, m = _apply(hyper, params, opt, grads,
                                _grad_norm(bundle, mesh, params, grads))
        return ({"params": params, "opt": opt, "comp": comp.residual},
                {"loss": loss, **m})

    train_step.init_comp = init_comp
    return train_step


def make_serve_step(bundle: ModelBundle) -> Callable:
    """(params, token, pos, cache, **extras) -> (next_token, logits,
    cache): one greedy decode step on the dense cache; ``extras`` (the
    vlm's ``vision_embeds``) go to the bundle's step."""

    def serve_step(params, token, pos, cache, **extras):
        logits, cache = bundle.serve_step(params, token, pos, cache, **extras)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits, cache

    return serve_step
