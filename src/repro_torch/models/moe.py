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
E / k`` nothing is.

``moe_ffn`` takes the expert-parallel ``moe_ffn_a2a`` under the
reference's conditions: an active mesh (``launch.sharding``) whose
"model" axis M > 1 divides E, outside a manual region (the sharded
serving step is one: serving keeps ``moe_ffn_gspmd``), and tokens that
split evenly.  There each model rank holds E / M experts at rest
(``models.convert.shard_params``), routes its T / M of the call's
tokens, and the experts' tokens travel by ``all_to_all``.

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
from repro_torch.core import collectives as C
from repro_torch.launch.sharding import get_mesh, in_manual_region
from repro_torch.models import layers as L


def experts_sharded(cfg: ModelConfig, mesh) -> bool:
    """True when ``mesh`` (or None) puts E / M experts on each model
    rank: a "model" axis M > 1 that divides E, the a2a dispatch."""
    m = 1 if mesh is None else mesh.shape.get("model", 1)
    return (cfg.moe.dispatch == "a2a" and m > 1
            and cfg.moe.n_experts % m == 0)


def moe_ffn(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D), this process's rows.  The dispatch per
    the reference's switch (see the module docstring); its batch
    condition reads the global batch, B times the data axes' size."""
    mesh = get_mesh()
    if experts_sharded(cfg, mesh) and not in_manual_region():
        nm = mesh.shape["model"]
        dp_n = mesh.axis_size(mesh.dp_axes())
        b, s, d = x.shape
        if b * s % nm == 0 and d % dp_n == 0:
            return moe_ffn_a2a(x, p, cfg, mesh)
    if p["w1"].shape[0] != cfg.moe.n_experts:
        raise ValueError(
            f"this rank holds {p['w1'].shape[0]} of {cfg.moe.n_experts} "
            f"experts, and the call ({tuple(x.shape)}) does not take the "
            f"expert-parallel dispatch: the one-device dispatch needs "
            f"every expert")
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


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    """The inverse of a permutation, by a sort (deterministic on the card
    under ``torch.use_deterministic_algorithms``)."""
    return torch.argsort(perm, stable=True)


def _run_rows(sorted_keys: torch.Tensor, n_keys: int, rows: int, cap: int):
    """For each key i < n_keys and row c < rows: the index into the
    sorted keys of the c-th element of key i's run, and whether it is one
    (c < cap, inside the run)."""
    dev = sorted_keys.device
    n = sorted_keys.shape[0]
    keys = torch.arange(n_keys, device=dev)
    c = torch.arange(rows, device=dev)
    idx = torch.searchsorted(sorted_keys, keys)[:, None] + c[None, :]
    idx_c = idx.clamp(max=n - 1)
    valid = (c[None, :] < cap) & (idx < n) & (sorted_keys[idx_c]
                                              == keys[:, None])
    return idx_c, valid


def moe_ffn_a2a(x: torch.Tensor, p: dict, cfg: ModelConfig,
                mesh) -> torch.Tensor:
    """Explicit expert parallelism over the mesh's "model" axis: the
    reference's two-level dispatch, in one process per model rank.

    ``x`` (B, S, D) is this process's rows, replicated across the model
    axis; model rank mi routes the mi-th T / M of them (T = B S).  p's
    ``w1`` / ``w3`` / ``w2`` hold this rank's E / M experts (experts
    mi E / M onwards), ``router`` all of them (replicated: its gradient
    is summed over the model group).
      level 1 - each (token, slot) pair goes to the rank owning its
        expert: pairs stably sorted by destination, at most ``cap =
        ceil((T / M) k / M * capacity_factor)`` per destination, packed
        into (M, cap, D) and exchanged with one ``all_to_all``, with each
        slot's local expert;
      level 2 - the received rows sorted by local expert, at most
        ``cap2 = ceil(M cap / (E / M) * capacity_factor)`` each, packed
        into the (E / M, cap2, D) GEMM buffer.
    The return path unpacks level 2, sends the rows back with one more
    ``all_to_all``, combines each token's k contributions in ascending
    expert order (as ``moe_ffn_gspmd``) and gathers the M parts of the
    output (one ``all_gather``).  Buffers are built by gathers, so the
    dispatch is deterministic on the card too."""
    cd = cfg.torch_compute_dtype()
    b, s, d = x.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    group = mesh.axis_group("model")
    nm = mesh.shape["model"]
    e_loc = e // nm
    t = b * s // nm
    dev = x.device
    xf = C.slice_replicated(x.reshape(b * s, d), 0, group).to(cd)  # (t, D)

    gate, top_e = route(xf, C.sum_grad(p["router"], group), k)

    # ---- level 1: pack by destination rank ------------------------------
    flat_e = top_e.reshape(-1)                                  # (t k,)
    flat_tgt = torch.div(flat_e, e_loc, rounding_mode="floor")
    order = torch.argsort(flat_tgt, stable=True)
    s_tgt = flat_tgt[order]
    slot = _sorted_slots(s_tgt)
    cap = max(int(math.ceil(t * k / nm * cfg.moe.capacity_factor)), 1)
    idx, valid = _run_rows(s_tgt, nm, cap, cap)                 # (M, cap)
    src = order[idx]
    tok = torch.where(valid, torch.div(src, k, rounding_mode="floor"), t)
    send_x = torch.cat([xf, xf.new_zeros(1, d)])[tok]           # (M, cap, D)
    send_le = torch.where(valid, flat_e[src] % e_loc, e_loc)
    recv_x = C.all_to_all_autograd(send_x, group)
    recv_le = C.all_to_all(send_le, group)

    # ---- level 2: pack by local expert ------------------------------------
    n_recv = nm * cap
    rx = torch.cat([recv_x.reshape(n_recv, d), recv_x.new_zeros(1, d)])
    rle = recv_le.reshape(n_recv)
    order2 = torch.argsort(rle, stable=True)                    # invalid last
    s2_le = rle[order2]
    slot2 = _sorted_slots(s2_le)
    cap2 = max(int(math.ceil(n_recv / e_loc * cfg.moe.capacity_factor)), 1)
    rows = max(cap2, L.MIN_ROWS)
    idx2, valid2 = _run_rows(s2_le, e_loc, rows, cap2)          # (E/M, rows)
    buf = rx[torch.where(valid2, order2[idx2], n_recv)]

    h = F.silu(torch.bmm(buf, p["w1"].to(cd)))
    h = h * torch.bmm(buf, p["w3"].to(cd))
    y = torch.bmm(h, p["w2"].to(cd))                            # (E/M, rows, D)

    # unpack level 2 into receive-slot order
    pos2 = slot2[_inverse(order2)]
    keep2 = (rle < e_loc) & (pos2 < cap2)
    y_recv = y[rle.clamp(max=e_loc - 1), pos2.clamp(max=rows - 1)]
    y_recv = y_recv * keep2.to(cd)[:, None]

    # ---- return all_to_all and the combine, in token order ---------------
    y_back = C.all_to_all_autograd(y_recv.reshape(nm, cap, d), group)
    pos1 = slot[_inverse(order)]                                # (t k,)
    keep = pos1 < cap
    contrib = y_back.reshape(n_recv, d)[
        flat_tgt * cap + pos1.clamp(max=cap - 1)]
    contrib = contrib * (gate.reshape(-1) * keep).to(cd)[:, None]
    asc = torch.argsort(top_e, dim=-1)       # a token's experts ascending
    contrib = torch.gather(contrib.view(t, k, d), 1,
                           asc[..., None].expand(t, k, d))
    out = torch.zeros((t, d), dtype=cd, device=dev)
    for j in range(k):
        out = out + contrib[:, j]
    return C.gather_replicated(out, 0, group).reshape(b, s, d)


def aux_load_balance_loss(logits: torch.Tensor, top_e: torch.Tensor,
                          e: int) -> torch.Tensor:
    """Switch-style load-balance auxiliary (exposed for training recipes)."""
    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(dim=0)
    ce = F.one_hot(top_e[:, 0].long(), e).float().mean(dim=0)
    return e * torch.sum(me * ce)
