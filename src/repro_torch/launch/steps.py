"""Train and serve step factories over a ModelBundle (counterpart of
``repro.launch.steps``: ``TrainHyper``, ``init_train_state``,
``make_train_step`` and ``make_serve_step``).

The reference differentiates its jnp path with ``jax.value_and_grad``;
the port differentiates its forward with autograd.  On the card the
attention of every layer runs the hand-written kernels forward and the
plain version's gradient backward (``kernels.train_attention``).  The
optimizer step updates the state in place (``optim.adamw_update``), as
the reference's trainer donates its state to the jitted step.
``make_compressed_train_step`` (int8 gradient sync across data-parallel
processes) waits for the port's data-parallel trainer (ROADMAP A15b).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch import resolve_device
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
                     device=None) -> Dict[str, Any]:
    """Random parameters at ``cfg.param_dtype`` (from ``generator``, which
    lives on ``device``) and a fresh AdamW state with moments at
    ``cfg.optimizer_dtype``: ``{"params": tree, "opt": AdamWState}``."""
    cfg = bundle.cfg
    params = bundle.init(generator, resolve_device(device),
                         dtype=cfg.torch_param_dtype())
    return {"params": params,
            "opt": adamw_init(params, cfg.torch_optimizer_dtype())}


def batch_to_device(batch: dict, device) -> dict:
    """A pipeline batch (numpy arrays or tensors) as tensors on ``device``."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v))
                if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


def make_train_step(bundle: ModelBundle, hyper: TrainHyper) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: the loss and its
    gradients (over ``hyper.microbatches`` microbatches), the cosine
    warmup learning rate at the state's step, and one AdamW update of the
    state in place.  ``metrics``: () tensors ``loss``, ``lr`` and
    ``grad_norm`` (before clipping)."""

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

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        batch = batch_to_device(batch, opt.step.device)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, grads = grads_of(params, leaves, batch)
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        lr = cosine_warmup(
            opt.step, peak_lr=hyper.peak_lr, warmup_steps=hyper.warmup_steps,
            total_steps=hyper.total_steps,
        )
        params, opt, m = adamw_update(
            params, grads, opt, lr=lr, b1=hyper.b1, b2=hyper.b2,
            weight_decay=hyper.weight_decay, max_grad_norm=hyper.max_grad_norm,
        )
        return {"params": params, "opt": opt}, {"loss": loss, "lr": lr, **m}

    return train_step


def make_serve_step(bundle: ModelBundle) -> Callable:
    """(params, token, pos, cache, **extras) -> (next_token, logits,
    cache): one greedy decode step on the dense cache; ``extras`` (the
    vlm's ``vision_embeds``) go to the bundle's step."""

    def serve_step(params, token, pos, cache, **extras):
        logits, cache = bundle.serve_step(params, token, pos, cache, **extras)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits, cache

    return serve_step
