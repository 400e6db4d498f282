"""Roofline terms on H100 terms (counterpart of ``repro.launch.roofline``).

Per (arch x shape x mesh) cell of the dry run (``launch.dryrun``):

  compute_term    = FLOPs_per_device / PEAK_FLOPS
  memory_term     = HBM_bytes_per_device / HBM_BW
  collective_term = sum over mesh axes of that axis's collective bytes
                    per device / the rate of the link the axis crosses

The peaks are NVIDIA's published dense rates of one H100 SXM at its full
700 W limit: 989 TFLOP/s bf16 / fp16 tensor core, 3.35 TB/s HBM3; NVLink
4 within an 8-card node, 450 GB/s a direction a card; InfiniBand NDR
across nodes, 50 GB/s a card.  A card set below 700 W runs slower.  The
FLOPs come from ``launch.op_analysis`` (an executed step, on the ``meta``
device in the dry run); HBM bytes from :func:`analytic_memory_bytes`, the
reference's model of one step's traffic; collective bytes from
:func:`collective_bytes`, what the port's own steps put on the wire
(``core.collectives.WIRE`` counts the same on a run).

The least time of one attention-op call (:func:`bound`, the two
compute and memory peaks, and a FLOP / byte formula per op) lives with
the ops, in ``kernels.cost``; this module re-exports it.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.kernels.cost import (  # noqa: F401  (re-exported)
    BACKWARD_FACTOR,
    HBM_BW,
    PEAK_FLOPS,
    attention_cost,
    bound,
    decode_cost,
    paged_decode_cost,
    paged_prefill_cost,
    shift_kv_cost,
    visible_pairs,
)
from repro_torch.models.convert import (  # noqa: F401  (_walk re-exported)
    _walk,
    computes_split,
)

NVLINK_BW = 450e9          # bytes/s a direction a card, NVLink 4 in a node
IB_BW = 50e9               # bytes/s a card, InfiniBand NDR across nodes
NODE_CARDS = 8             # cards one NVLink domain holds

MODEL = "model"
DP_AXES = ("pod", "data")


# ------------------------------------------------------------- roofline --

def link_rate(axis: str, mesh_shape: Dict[str, int]) -> float:
    """The rate of the link a collective over ``axis`` crosses: NVLink
    for the model axis while it fits one node, InfiniBand otherwise."""
    if axis == MODEL and mesh_shape.get(MODEL, 1) <= NODE_CARDS:
        return NVLINK_BW
    return IB_BW


def roofline_terms(flops: float, bytes_accessed: float,
                   coll_bytes_by_axis: Dict[str, float],
                   mesh_shape: Dict[str, int]) -> Dict[str, float]:
    """The three terms in seconds, the dominant one, and the compute
    term's share of the largest; each axis's collective bytes over the
    rate of the link it crosses (:func:`link_rate`)."""
    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_accessed / HBM_BW
    coll_s = sum(b / link_rate(a, mesh_shape)
                 for a, b in coll_bytes_by_axis.items())
    dominant = max(
        ("compute", compute_s), ("memory", memory_s), ("collective", coll_s),
        key=lambda kv: kv[1],
    )[0]
    top = max(compute_s, memory_s, coll_s)
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "dominant": dominant,
        "roofline_fraction": compute_s / top if top > 0 else 0.0,
        "peaks": "published H100 SXM peaks at 700 W, not measured",
    }


def _itemsize(name: str) -> int:
    return torch.empty((), dtype=getattr(torch, name)).element_size()


def analytic_memory_bytes(
    cfg, kind: str, batch: int, seq: int, n_dev: int, model_par: int,
    *, param_dtype: Optional[str] = None,
) -> Dict[str, float]:
    """Per-device HBM traffic model for one step: the reference's
    (``repro.launch.roofline.analytic_memory_bytes``), term for term.

      train  : weights read 3x (fwd + bwd + remat-recompute) + grad write
               + optimizer read/write of params and both moments
               + per-layer activation traffic (~2.5 reads + writes of the
                 live set) + CE logits chunks (fp32, read + write)
      prefill: weights 1x + activation traffic 1x
      decode : weights 1x + full KV-cache read + O(1) cache write

    ``param_dtype`` names the weights' dtype where they are held at
    another than ``cfg.param_dtype`` (the training state's): a server's
    weights, :func:`held_dtype` of its tree.
    """
    pd = _itemsize(param_dtype or cfg.param_dtype)
    od = _itemsize(cfg.optimizer_dtype)
    ad = 2  # bf16/fp16 activations

    d, f, l_ = cfg.d_model, cfg.d_ff, cfg.n_layers
    v = cfg.vocab_size
    if cfg.family == "ssm":
        di = cfg.ssm.expand * d
        per_layer = d * 2 * di + di * (d // 16 + 2 * cfg.ssm.state) \
            + (d // 16) * di + di * d + di * cfg.ssm.d_conv
    elif cfg.family == "hybrid":
        di = cfg.ssm.expand * d
        nh = di // cfg.ssm.head_p
        per_layer = d * (2 * di + 2 * cfg.ssm.state + nh) + di * d \
            + di * cfg.ssm.d_conv
        # one shared attn+mlp block amortized over the stack
        per_layer += (d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d
                      + 3 * d * f) / max(l_, 1)
    else:
        attn = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
        if cfg.family == "moe" and cfg.moe.n_experts:
            ffn = 3 * d * f * cfg.moe.n_experts + d * cfg.moe.n_experts
        else:
            ffn = 3 * d * f
        per_layer = attn + ffn
        if cfg.family == "audio":
            per_layer = per_layer * 2  # encoder stack + decoder cross-attn

    n_params = per_layer * l_ + 2 * v * d
    p_dev = n_params * pd / n_dev

    b_loc = max(batch // (n_dev // model_par), 1)
    if kind == "decode":
        if cfg.family == "ssm":
            cache = b_loc * (cfg.ssm.expand * d) * (cfg.ssm.state * 4
                                                    + 3 * ad) * l_
        elif cfg.family == "hybrid":
            apps = (l_ + cfg.attn_every - 1) // cfg.attn_every
            cache = (
                apps * b_loc * seq * 2 * cfg.kv_dim * ad
                + l_ * b_loc * (cfg.ssm.expand * d) * cfg.ssm.state * 4
            ) / model_par
        else:
            cache = l_ * b_loc * seq * 2 * cfg.kv_dim * ad / model_par
        total = p_dev + cache * 1.05  # read cache + small write
        return {"bytes": total, "weights": p_dev, "cache": cache,
                "activations": 0.0, "optimizer": 0.0}

    if cfg.family == "ssm":
        di = cfg.ssm.expand * d
        act_elems = 2 * di + 2 * d + di * 0.5
    elif cfg.family == "hybrid":
        di = cfg.ssm.expand * d
        act_elems = 2 * di + 2 * d
    else:
        act_elems = (cfg.q_dim + 2 * cfg.kv_dim + 2 * f / (
            cfg.moe.n_experts / cfg.moe.top_k if cfg.moe.n_experts else 1
        ) + 4 * d)
    tok_dev = b_loc * seq
    act_traffic = 2.5 * l_ * tok_dev * act_elems * ad / model_par
    ce = 2 * tok_dev * v * 4 / model_par  # fp32 logit chunks, read+write

    if kind == "train":
        moments = 2 * n_params * od / n_dev
        opt = 2 * (p_dev + moments)
        total = 3 * p_dev + p_dev + opt + 3 * act_traffic + ce
        return {"bytes": total, "weights": 4 * p_dev, "optimizer": opt,
                "activations": 3 * act_traffic, "cache": 0.0, "ce": ce}
    total = p_dev + act_traffic + ce / 2
    return {"bytes": total, "weights": p_dev, "activations": act_traffic,
            "optimizer": 0.0, "cache": 0.0, "ce": ce / 2}


def held_dtype(params) -> str:
    """The dtype, by name (``"bfloat16"``), that holds most elements of a
    parameter tree."""
    held: Dict[str, int] = {}
    for _, leaf in _walk(params):
        name = str(leaf.dtype).rpartition(".")[2]
        held[name] = held.get(name, 0) + leaf.numel()
    return max(held, key=held.get)


def count_params(params) -> Dict[str, float]:
    """Total and expert parameter counts of a parameter tree (real or on
    ``meta``): the reference's count, an expert leaf being a ``w1`` /
    ``w2`` / ``w3`` under a ``moe`` key."""
    total = expert = 0
    for path, leaf in _walk(params):
        n = leaf.numel()
        total += n
        if "moe" in path and path[-1] in ("w1", "w2", "w3"):
            expert += n
    return {"total": float(total), "expert": float(expert)}


def model_flops(
    n_params_total: float,
    n_params_expert: float,
    top_k: int,
    n_experts: int,
    tokens: float,
    *,
    kind: str,
) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (decode fwd), N = active params
    (the reference's)."""
    active = n_params_total
    if n_experts:
        active = n_params_total - n_params_expert * (1.0 - top_k / n_experts)
    mult = 6.0 if kind == "train" else 2.0
    return mult * active * tokens


# ------------------------------------------------------ collective bytes --
#
# What ``core.collectives`` logs in ``WIRE`` for one call: an
# ``all_gather`` (and an ``all_reduce``, which is one) this rank's bytes;
# an ``all_to_all`` and a ``reduce_scatter`` the bytes that leave this
# rank, (n - 1) / n of its buffer.

def _a2a(nbytes: int, n: int) -> int:
    return nbytes * (n - 1) // n


# the stacks whose layers run under ``layers.remat`` (recomputed in the
# backward, their weights gathered again): every family's layer stack
# but the vlm's cross layers and the hybrid's shared block
_REMAT_STACKS = ("blocks", "mamba", "self", "enc", "dec")


def _axis_name(axes) -> str:
    """The ``by_axis`` key of a collective over ``axes``."""
    return "+".join(axes)


def _placed_leaves(params, cfg, mesh_shape: Dict[str, int]):
    """(path, plan with the axes of size 1 dropped, numel on this rank,
    itemsize, dtype name) of every parameter leaf under the placement
    (``models.convert.shard_dim``: the plan on ``mesh_shape``)."""
    from repro_torch.launch.params import param_plan, split_count

    for path, leaf in _walk(params):
        plan = tuple(tuple(a for a in axes if mesh_shape[a] > 1) or None
                     if axes else None
                     for axes in param_plan(path, leaf.shape, mesh_shape))
        yield (path, plan,
               leaf.numel() // split_count(plan, mesh_shape),
               leaf.element_size(), _dt(leaf.dtype))


class ShapeOnlyMesh:
    """The part of a mesh the placement predicates read: its shape."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)


def _dt(name) -> str:
    return str(getattr(torch, name) if isinstance(name, str) else name
               ).replace("torch.", "")


def _moe_wire(cfg, tokens: int, m: int, grad: bool, remat: bool) -> dict:
    """{(op, dtype): bytes} of one ``moe_ffn_a2a`` call over a model axis
    of ``m`` ranks on ``tokens`` rows (replicated across the axis):
    forward the rows' ``all_to_all`` there and back, their local experts'
    (int64) and the output's gather; backward the two row ``all_to_all``
    again, the gather of the input slice's gradient and the sum of the
    router's (fp32) gradient.  With remat the backward's recompute of
    the layer runs the forward again up to its last saved tensor (the
    checkpoint's early stop): the ``all_to_all`` again, not the output's
    gather."""
    cd = _itemsize(cfg.compute_dtype)
    d, e, k = cfg.d_model, cfg.moe.n_experts, cfg.moe.top_k
    t = tokens // m
    cap = max(int(math.ceil(t * k / m * cfg.moe.capacity_factor)), 1)
    rows = _a2a(m * cap * d * cd, m)
    fwd = {("all_to_all", _dt(cfg.compute_dtype)): 2 * rows,
           ("all_to_all", "int64"): _a2a(m * cap * 8, m),
           ("all_gather", _dt(cfg.compute_dtype)): t * d * cd}
    if not grad:
        return fwd
    out = {key: (2 if remat and key[0] == "all_to_all" else 1) * v
           for key, v in fwd.items()}
    out[("all_to_all", _dt(cfg.compute_dtype))] += 2 * rows
    out[("all_gather", _dt(cfg.compute_dtype))] += t * d * cd
    out[("all_gather", "float32")] = d * e * 4
    return out


def _w2_wire(cfg, tokens: int, grad: bool) -> dict:
    """{(op, dtype): bytes} of one column-parallel MLP (``layers.mlp``):
    forward the (rows, D) partial sums of the
    row-parallel ``w2`` at the compute dtype, on the rows padded to
    MIN_ROWS; backward the sum of the input's gradient (``sum_grad``).
    A remat recompute stops before the sum (nothing after the product is
    saved)."""
    from repro_torch.models.layers import MIN_ROWS

    cd = _itemsize(cfg.compute_dtype)
    nbytes = max(tokens, MIN_ROWS) * cfg.d_model * cd
    if grad:
        nbytes += tokens * cfg.d_model * cd
    return {("all_gather", _dt(cfg.compute_dtype)): nbytes}


def _attn_wire(cfg, rows: int, cross_rows: int, grad: bool,
               recompute: bool) -> dict:
    """{(op, dtype): bytes} of one column-parallel attention
    (``attention.heads_sharded``): forward the sum of ``wo``'s partial
    products on the (rows, D) output at the compute dtype, again in a
    remat recompute; backward the sums of the input's gradient, of a
    cross-attention's keys' source (``cross_rows``) and, with qk-norm,
    of the two norm weights' (at the parameter dtype)."""
    cd, dt = _itemsize(cfg.compute_dtype), _dt(cfg.compute_dtype)
    out = {("all_gather", dt): (1 + recompute) * rows * cfg.d_model * cd}
    if grad:
        out[("all_gather", dt)] += (rows + cross_rows) * cfg.d_model * cd
        if cfg.qk_norm:
            out[("all_gather", _dt(cfg.param_dtype))] = (
                2 * cfg.head_dim * _itemsize(cfg.param_dtype))
    return out


def _vocab_wire(cfg, b: int, seq: int, grad: bool) -> dict:
    """{(op, dtype): bytes} of one pass's vocab-parallel embedding and
    loss (``layers.embed``, ``layers.lm_loss_chunked`` on V / M columns)
    over ``b`` rows of ``seq`` tokens: forward the lookup's sum at the
    compute dtype and, per token, the loss's fp32 row max and its stacked
    sum of exp and gold logit; backward the sum of h's fp32 gradient."""
    cd = _itemsize(cfg.compute_dtype)
    tokens = b * seq
    out = {("all_gather", _dt(cfg.compute_dtype)): tokens * cfg.d_model * cd,
           ("all_gather", "float32"): 3 * tokens * 4}
    if grad:
        out[("all_gather", "float32")] += tokens * cfg.d_model * 4
    return out


def _ssm_wire(cfg, rows: int, m: int, grad: bool, remat: bool) -> dict:
    """{(op, dtype): bytes} of one Mamba layer on its model-axis channels
    (``ssm.channels_sharded``) over ``rows`` tokens: forward the exchange
    of ``in_proj``'s column blocks and (Mamba-1) ``x_proj``'s fp32 sum or
    (Mamba-2) the gated norm's fp32 sum of squares, both again in a remat
    recompute, and ``out_proj``'s sum at the compute dtype (after the
    recompute's last saved tensor); backward the exchange of this rank's
    channels' gradients, the fp32 sum again and the input's gradient's
    sum."""
    from repro_torch.models.ssm import _dt_rank, d_inner, mamba2_heads

    cd, dt = _itemsize(cfg.compute_dtype), _dt(cfg.compute_dtype)
    di, n = d_inner(cfg), cfg.ssm.state
    if cfg.ssm.version == 1:
        width, kept = 2 * di, 2 * di // m
        f32 = _dt_rank(cfg) + 2 * n
    else:
        nh = mamba2_heads(cfg)
        width, kept = 2 * di + 2 * n + nh, (2 * di + nh) // m + 2 * n
        f32 = 1
    passes = 1 + (grad and remat)
    out = {("all_gather", dt): (passes * width // m + cfg.d_model) * rows * cd,
           ("all_gather", "float32"): passes * rows * f32 * 4}
    if grad:
        out[("all_gather", dt)] += (kept + cfg.d_model) * rows * cd
        out[("all_gather", "float32")] += rows * f32 * 4
    return out


def _attn_calls(cfg, b_loc: int, seq: int, remat: bool) -> list:
    """(rows, cross-attention key-source rows, recomputed) of each
    attention call one pass runs."""
    tokens = b_loc * seq
    if cfg.family in ("dense", "moe"):
        return [(tokens, 0, remat)] * cfg.n_layers
    if cfg.family == "hybrid":
        return [(tokens, 0, False)] * ((cfg.n_layers + cfg.attn_every - 1)
                                       // cfg.attn_every)
    if cfg.family == "vlm":
        g = cfg.n_layers // cfg.cross_attn_every
        return ([(tokens, 0, remat)] * (g * (cfg.cross_attn_every - 1))
                + [(tokens, b_loc * cfg.n_image_tokens, False)] * g)
    if cfg.family == "audio":
        frames = b_loc * cfg.n_audio_frames
        return ([(frames, 0, remat)] * cfg.n_encoder_layers
                + [(tokens, 0, remat), (tokens, frames, remat)]
                * cfg.n_layers)
    return []


def _mlp_rows(cfg, b_loc: int, seq: int) -> list:
    """The rows of each SwiGLU MLP (``layers.mlp``) one pass runs: the
    text tokens', and for Whisper's encoder its audio frames'."""
    tokens = b_loc * seq
    if cfg.family in ("dense", "vlm"):
        return [tokens] * cfg.n_layers
    if cfg.family == "hybrid":
        return [tokens] * ((cfg.n_layers + cfg.attn_every - 1)
                           // cfg.attn_every)
    if cfg.family == "audio":
        return ([b_loc * cfg.n_audio_frames] * cfg.n_encoder_layers
                + [tokens] * cfg.n_layers)
    return []


def collective_bytes(cfg, kind: str, batch: int, seq: int,
                     mesh_shape: Dict[str, int], *, params=None,
                     microbatches: int = 1,
                     num_pages: Optional[int] = None,
                     page_size: Optional[int] = None,
                     pool_dtype="bf16") -> Dict:
    """What one process puts on the wire in one step of ``kind`` on a mesh
    of ``mesh_shape`` ({axis: size}), as ``core.collectives.WIRE`` logs it.

    ``batch`` is the global batch; each data rank takes batch / (pod x
    data) rows of ``seq`` tokens.  Kinds:

      * ``"train"``: ``launch.steps.make_train_step`` on the state placed
        by the plan - each leaf's gather before its layer (over the data
        axes its plan splits it on, then over ``model`` unless its layer
        computes on the model block; again in a remat recompute) and its
        gradient's reduce-scatter onto the blocks; the model axis's
        collectives in the forward and backward (``moe_ffn_a2a``'s
        ``all_to_all`` and gathers, the column-parallel attention's and
        MLP's sums, the vocab-parallel embedding's and loss's sums, the
        Mamba layers' activation exchanges and sums); then the
        gradient sync over pod x data of each leaf over the data axes
        its plan keeps whole, the loss's mean, and
        the gradient norm's partial sums (one a group of splitting
        axes); ``microbatches`` passes of the forward and backward;
      * ``"train_compressed"``: ``make_compressed_train_step`` - as
        ``"train"`` with the plan over data and model only (the
        parameters pod-replicated), the sync across ``pod`` as int16
        codes and one f32 max a leaf (``optim.compressed_psum``);
      * ``"prefill"``: the forward alone (``loss_fn`` without grad), its
        gathers included;
      * ``"decode"``: one call of the serving engine with the pool
        kv-head-sharded over the model axis (``ServeEngine(mesh=)``),
        which gathers every pool leaf at every call: ``num_pages`` pages
        of ``page_size`` rows (default: each replica's rows at ``seq``,
        plus the null page).

    ``params`` (the whole parameter tree, on ``meta`` or not, at the
    trained dtype) is needed for the train and prefill kinds.  Returns ``{"bytes": {kind of
    collective: bytes}, "by_axis": {axis: bytes}, "total_bytes": n,
    "by_op": {(op, dtype): bytes}}``."""
    m = mesh_shape.get(MODEL, 1)
    n_dp = int(math.prod(mesh_shape.get(a, 1) for a in DP_AXES))
    b_loc = max(batch // n_dp, 1)
    kinds: Dict[str, int] = {}
    by_axis: Dict[str, int] = {}
    by_op: Dict[tuple, int] = {}

    def add(name, axis, key, nbytes):
        if nbytes:
            kinds[name] = kinds.get(name, 0) + nbytes
            by_axis[axis] = by_axis.get(axis, 0) + nbytes
            by_op[key] = by_op.get(key, 0) + nbytes

    if kind == "decode":
        if m > 1 and cfg.n_kv_heads and cfg.n_kv_heads % m == 0:
            from repro_torch.runtime.paged_cache import (is_quantized_dtype,
                                                         resolve_pool_dtype)

            page = page_size or cfg.attention.block_kv
            pages = num_pages or b_loc * math.ceil(seq / page) + 1
            rows = _attention_layers(cfg) * pages
            dt = resolve_pool_dtype(pool_dtype)
            add("pool_gather", MODEL, ("all_gather", _dt(dt)),
                2 * rows * page * (cfg.kv_dim // m) * dt.itemsize)
            if is_quantized_dtype(pool_dtype):   # scale and shift sidecars
                add("pool_gather", MODEL, ("all_gather", "float32"),
                    2 * rows * (cfg.n_kv_heads + cfg.kv_dim) // m * 4)
        return _collective_report(kinds, by_axis, by_op)

    if kind not in ("train", "train_compressed", "prefill"):
        raise ValueError(f"unknown step kind {kind!r}")
    if params is None:
        raise ValueError("the train and prefill kinds need the parameter "
                         "tree")
    grad = kind != "prefill"
    remat = grad and cfg.remat
    mb = microbatches if grad else 1
    b_mb = max(b_loc // mb, 1)
    if m > 1:
        from repro_torch.models.attention import heads_sharded
        from repro_torch.models.layers import rows_sharded
        from repro_torch.models.moe import experts_sharded
        from repro_torch.models.ssm import channels_sharded

        mesh = ShapeOnlyMesh(mesh_shape)
        if rows_sharded(cfg.vocab_size, mesh):
            for key, nbytes in _vocab_wire(cfg, b_mb, seq, grad).items():
                add("vocab_parallel", MODEL, key, nbytes * mb)
        if cfg.family in ("ssm", "hybrid") and channels_sharded(cfg, mesh):
            for key, nbytes in _ssm_wire(cfg, b_mb * seq, m, grad,
                                         remat).items():
                add("ssm_channels", MODEL, key, nbytes * cfg.n_layers * mb)
        if cfg.family == "moe" and experts_sharded(cfg, mesh) \
                and b_mb * seq % m == 0:
            for key, nbytes in _moe_wire(cfg, b_mb * seq, m, grad,
                                         remat).items():
                add("moe_a2a", MODEL, key, nbytes * cfg.n_layers * mb)
        if heads_sharded(cfg, mesh):
            for rows, cross, again in _attn_calls(cfg, b_mb, seq, remat):
                for key, nbytes in _attn_wire(cfg, rows, cross, grad,
                                              again).items():
                    add("column_parallel_attention", MODEL, key,
                        nbytes * mb)
        if rows_sharded(cfg.d_ff, mesh):
            for rows in _mlp_rows(cfg, b_mb, seq):
                for key, nbytes in _w2_wire(cfg, rows, grad).items():
                    add("column_parallel_mlp", MODEL, key, nbytes * mb)

    # the placement: the compressed step's parameters are pod-replicated
    # (the plan over data and model only)
    place = ({a: k for a, k in mesh_shape.items() if a != "pod"}
             if kind == "train_compressed" else mesh_shape)
    leaves = list(_placed_leaves(params, cfg, place))
    place_mesh = ShapeOnlyMesh(place)
    for path, plan, numel, size, dt in leaves:
        passes = mb * (1 + (remat and path[0] in _REMAT_STACKS))
        split = [a for axes in plan if axes for a in axes]
        dp = tuple(a for a in split if a != MODEL)
        d = int(math.prod(place[a] for a in dp))
        if dp:
            add("param_gather", _axis_name(dp), ("all_gather", dt),
                passes * numel * size)
            if grad:
                add("grad_reduce_scatter", _axis_name(dp),
                    ("reduce_scatter", dt), mb * (d - 1) * numel * size)
        if MODEL in split and not computes_split(path, cfg, place_mesh):
            add("param_gather", MODEL, ("all_gather", dt),
                passes * d * numel * size)
    if not grad:
        return _collective_report(kinds, by_axis, by_op)

    # the gradient norm: a sum over each group of axes that splits leaves
    for key in {tuple(a for a in place if any(
            a in (axes or ()) for axes in plan)) for _, plan, *_ in leaves}:
        if MODEL in key:
            add("grad_norm", MODEL, ("all_gather", "float32"), 4)
        dp = tuple(a for a in key if a != MODEL)
        if dp:
            add("grad_norm", _axis_name(dp), ("all_gather", "float32"), 4)

    def plain_sync(axes):
        """The mean over ``axes`` (sizes above 1) of the loss and of each
        gradient leaf over the axes its plan does not split it on."""
        axes = tuple(a for a in axes if mesh_shape.get(a, 1) > 1)
        if not axes:
            return
        add("dp_grad_sync", _axis_name(axes), ("all_gather", "float32"), 4)
        for _, plan, numel, size, dt in leaves:
            rest = tuple(a for a in axes
                         if not any(a in (p or ()) for p in plan))
            if rest:
                add("dp_grad_sync", _axis_name(rest), ("all_gather", dt),
                    numel * size)

    if kind == "train":
        plain_sync(DP_AXES)
        return _collective_report(kinds, by_axis, by_op)
    # compressed: a plain mean over data inside the pod, then int16 codes
    # across pods (one f32 max a leaf), then the loss's mean across pods
    plain_sync(("data",))
    if mesh_shape.get("pod", 1) > 1:
        for _, _, numel, *_ in leaves:
            add("pod_int16_sync", "pod", ("all_gather", "float32"), 4)
            add("pod_int16_sync", "pod", ("all_gather", "int16"), numel * 2)
        add("pod_int16_sync", "pod", ("all_gather", "float32"), 4)
    return _collective_report(kinds, by_axis, by_op)


def _attention_layers(cfg) -> int:
    """The layers whose K/V the paged pool holds."""
    if cfg.family == "hybrid":
        return (cfg.n_layers + cfg.attn_every - 1) // cfg.attn_every
    return cfg.n_layers


def _collective_report(kinds, by_axis, by_op) -> Dict:
    return {"bytes": kinds, "by_axis": by_axis,
            "total_bytes": sum(kinds.values()), "by_op": by_op}
