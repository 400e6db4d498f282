"""Token-choice top-k MoE with sort-based capacity dispatch (counterpart
of ``repro.models.moe``).

The reference's single-device path, step for step:
  1. router -> fp32 logits, softmax, top-k experts per token,
     renormalized gates;
  2. the (token, slot) pairs stably sorted by expert id; position within
     its expert by ``searchsorted(side="left")`` on the sorted ids;
  3. each expert takes at most ``cap = ceil(T k / E * capacity_factor)``
     of the call's T tokens, earlier tokens first; later slots are
     dropped (their contribution is 0);
  4. per-expert SwiGLU products on the (E, cap, D) buffer;
  5. the gate-weighted sum back in token order.

T counts every row of the call, dead decode slots and prefill pad
positions included, so a row's output depends on the other rows of its
call whenever a slot is dropped (ROADMAP C); with ``capacity_factor >=
E / k`` nothing is.  The reference's ``moe_ffn`` takes its
expert-parallel ``moe_ffn_a2a`` only under a mesh whose "model" axis is
larger than 1, so on one device every call is ``moe_ffn_gspmd``; the
port has no mesh yet (ROADMAP A13).

Where the port differs in form, not in value: the buffer is filled by a
gather (each expert's run of the sorted slots) rather than a scatter,
its rows are padded to ``MIN_ROWS`` (zero rows change no product, and a
decode row's bits then do not depend on the batch), and each token's k
contributions are summed in a fixed order at the compute dtype -
ascending expert id, the order in which the reference's scatter-add
applies its sorted updates - where an ``index_add_`` on the card would
add them with atomics in no fixed order.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def moe_ffn(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).  One device: the gspmd dispatch."""
    return moe_ffn_gspmd(x, p, cfg)


def route(xf: torch.Tensor, router: torch.Tensor, k: int):
    """Rows (T, D) at the compute dtype -> (gates (T, k) fp32 renormalized,
    experts (T, k)), each row's top-k in descending probability.  The
    fp32 logits, softmax, top-k and sum run on the rows padded to
    MIN_ROWS, so a row's routing does not depend on how many rows share
    the call."""
    t = xf.shape[0]
    xr = F.pad(xf.float(), (0, 0, 0, max(L.MIN_ROWS - t, 0)))
    probs = torch.softmax(xr @ router.float(), dim=-1)
    gate, top_e = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(dim=-1, keepdim=True)
    return gate[:t], top_e[:t]


def _sorted_slots(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Position of each element within its run of equal (sorted) keys."""
    n = sorted_keys.shape[0]
    return torch.arange(n, device=sorted_keys.device) - torch.searchsorted(
        sorted_keys, sorted_keys, side="left")


def moe_ffn_gspmd(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """The reference's single-device dispatch (see the module docstring)."""
    cd = cfg.torch_compute_dtype()
    b, s, d = x.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    t = b * s
    dev = x.device
    xf = x.reshape(t, d).to(cd)

    # --- routing -----------------------------------------------------------
    gate, top_e = route(xf, p["router"], k)
    # each token's experts in ascending id: the order of its contributions
    # in the reference's sorted scatter-add (the stable sort below gives
    # the same order either way: a token's experts are distinct)
    top_e, perm = torch.sort(top_e, dim=-1)
    gate = torch.gather(gate, -1, perm)

    # --- sort-based dispatch -------------------------------------------------
    flat_e = top_e.reshape(-1)                                # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    pos = torch.empty_like(order).scatter_(0, order, _sorted_slots(se))
    cap = max(int(math.ceil(t * k / e * cfg.moe.capacity_factor)), 1)
    keep = pos < cap

    # expert i's buffer rows are its run of the sorted slots, up to cap;
    # empty and padding rows read the zero row t
    rows = max(cap, L.MIN_ROWS)
    experts = torch.arange(e, device=dev)
    c = torch.arange(rows, device=dev)
    slot = torch.searchsorted(se, experts)[:, None] + c[None, :]   # (E, rows)
    slot_c = slot.clamp(max=t * k - 1)
    valid = ((c[None, :] < cap) & (slot < t * k)
             & (se[slot_c] == experts[:, None]))
    tok = torch.where(valid, order[slot_c] // k, t)
    buf = torch.cat([xf, xf.new_zeros(1, d)])[tok]            # (E, rows, D)

    # --- expert products ------------------------------------------------------
    h = F.silu(torch.bmm(buf, p["w1"].to(cd)))
    h = h * torch.bmm(buf, p["w3"].to(cd))
    y = torch.bmm(h, p["w2"].to(cd))                          # (E, rows, D)

    # --- weighted combine, in token order --------------------------------------
    contrib = y[flat_e, pos.clamp(max=cap - 1)]
    contrib = contrib * (gate.reshape(-1) * keep).to(cd)[:, None]
    contrib = contrib.view(t, k, d)
    out = torch.zeros((t, d), dtype=cd, device=dev)
    for j in range(k):
        out = out + contrib[:, j]
    return out.reshape(b, s, d)


def aux_load_balance_loss(logits: torch.Tensor, top_e: torch.Tensor,
                          e: int) -> torch.Tensor:
    """Switch-style load-balance auxiliary (exposed for training recipes)."""
    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(dim=0)
    ce = F.one_hot(top_e[:, 0].long(), e).float().mean(dim=0)
    return e * torch.sum(me * ce)
