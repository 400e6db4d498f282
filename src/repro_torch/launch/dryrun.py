"""The dry run of every (arch x shape x mesh) cell (counterpart of
``repro.launch.dryrun``), on the ``meta`` device.

The reference lowers and compiles each cell's jitted step for its 16 x 16
(and 2 x 16 x 16) TPU meshes on 512 placeholder host devices, and reads
the compiler's memory and cost analyses and the collectives of the HLO.
The port has no compiler to ask: it *runs* rank 0's program of each cell
on the ``meta`` device, which has shapes and no data, under the abstract
production mesh (``launch.mesh.make_production_mesh``: data 32 x model 8,
and pod 2 x data 32 x model 8, on H100 terms), so nothing is drawn,
allocated or computed, and no card is needed.  Per cell:

  * ``params`` (``roofline.count_params``, total and expert);
  * the per-device state - parameters, gradients and AdamW moments at
    ``cfg.optimizer_dtype`` - under the placement plan (``launch.params``)
    and under the placement the port holds (``models.convert.shard_dims``,
    which is the plan), each against the card's 80 GB;
  * ``hbm_bytes_per_device`` (``roofline.analytic_memory_bytes``);
  * ``flops_per_device``: ``launch.op_analysis`` over the step as run
    (train: ``make_train_step`` on this rank's batch slice under the
    mesh; prefill: ``loss_fn`` forward under the mesh; decode: one dense
    ``serve_step`` of a replica's rows at a full cache, the one-device
    step the engine's model axis runs on the gathered pool), and
    ``model_flops_*``;
  * ``collectives`` by kind (``roofline.collective_bytes``), held equal
    to what the run logged in ``core.collectives.WIRE``;
  * ``roofline`` terms from the published H100 peaks, and the dominant
    one.

Every record says ``"device": "meta"`` and carries no time: the terms
are bounds from published peaks, labelled so.  Cells that
``shape_supported`` refuses are ``skipped``, as in the reference.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
  python -m repro_torch.launch.dryrun --all                 # data 32 x model 8
  python -m repro_torch.launch.dryrun --all --both-meshes   # and pod 2 x ...
"""

from __future__ import annotations

import argparse
import json
import math
import os
import traceback
from typing import Dict, Optional

import torch

HBM_PER_CARD = 80e9        # bytes of device memory, H100 SXM


def _cell_id(arch, shape, multi_pod):
    return f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}"


def _inputs(bundle, batch: int, seq: int, device) -> dict:
    """A training batch of ``batch`` rows of ``seq`` tokens (and the
    family's extra inputs) on ``device``: empty on ``meta``, zeros
    elsewhere (the counts do not depend on the values)."""
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in bundle.train_inputs(batch, seq).items()}


def count_train_step(bundle, state, batch: int, seq: int, device,
                     microbatches: int = 1):
    """``op_analysis`` of one ``make_train_step`` call on ``state`` (this
    rank's part) and a batch of ``batch`` rows of ``seq`` tokens on
    ``device`` (the mesh active at the call is the step's)."""
    from repro_torch.launch import op_analysis
    from repro_torch.launch.steps import TrainHyper, make_train_step

    step = make_train_step(bundle, TrainHyper(microbatches=microbatches))
    inputs = _inputs(bundle, batch, seq, device)
    with op_analysis.count() as c:
        step(state, inputs)
    return c


def count_prefill(bundle, params, batch: int, seq: int, device):
    """``op_analysis`` of the reference's representative prefill: the
    forward of ``loss_fn`` (grad off) on ``batch`` x ``seq`` tokens."""
    from repro_torch.launch import op_analysis

    inputs = _inputs(bundle, batch, seq, device)
    with torch.no_grad(), op_analysis.count() as c:
        bundle.loss_fn(params, inputs)
    return c


def count_decode(bundle, params, batch: int, cache_rows: int, kv_len: int,
                 device, cache=None):
    """``op_analysis`` of one dense ``serve_step`` call: ``batch`` rows at
    position ``kv_len - 1`` of a ``cache_rows``-row cache (``cache``, or a
    fresh one on ``device``), with the family's extra inputs."""
    from repro_torch.launch import op_analysis
    from repro_torch.launch.serve import serve_extras

    if cache is None:
        cache = bundle.init_cache(batch, cache_rows, device=device)
    token = torch.zeros((batch,), dtype=torch.int32, device=device)
    pos = torch.full((batch,), kv_len - 1, dtype=torch.int32, device=device)
    extras = serve_extras(bundle.cfg, batch, device)
    with torch.no_grad(), op_analysis.count(
            lengths={"kv_len": [kv_len] * batch}) as c:
        bundle.serve_step(params, token, pos, cache, **extras)
    return c


def state_bytes(cfg, params, mesh_shape: Dict[str, int]) -> dict:
    """Per-device bytes of the training state (parameters and gradients at
    the parameters' dtype, two AdamW moments at ``cfg.optimizer_dtype``)
    under the placement plan and under the placement the port holds
    (``launch.params.held_split``: the same), each against the card's 80
    GB."""
    from repro_torch.launch import params as P
    from repro_torch.launch.roofline import _walk

    od = torch.empty((), dtype=cfg.torch_optimizer_dtype()).element_size()
    out = {}
    for layout in ("plan", "held"):
        p = m = 0
        for path, leaf in _walk(params):
            parts = (P.split_count(P.param_plan(path, leaf.shape, mesh_shape),
                                   mesh_shape) if layout == "plan"
                     else P.held_split(path, cfg, mesh_shape))
            n = leaf.numel() / parts
            p += n * leaf.element_size()
            m += 2 * n * od
        total = 2 * p + m
        out[layout] = {"params": p, "grads": p, "moments": m,
                       "total": total, "fits_80gb": total <= HBM_PER_CARD}
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Optional[str] = None, force: bool = False,
             microbatches: int = 1) -> dict:
    """The record of one cell (written to ``out_dir/<id>.json`` when
    given; an existing record is reused unless ``force``)."""
    from repro_torch.configs import SHAPES, get_config, shape_supported
    from repro_torch.core.collectives import WIRE
    from repro_torch.launch import roofline as R
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.sharding import set_mesh
    from repro_torch.models.convert import shard_params
    from repro_torch.models.model_zoo import build
    from repro_torch.optim import adamw_init

    cid = _cell_id(arch, shape_name, multi_pod)
    out_path = os.path.join(out_dir, cid + ".json") if out_dir else None
    if out_path and os.path.exists(out_path) and not force:
        with open(out_path) as f:
            print(f"[dryrun] {cid}: cached")
            return json.load(f)

    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(str(k) for k in mesh.shape.values()),
           "mesh_axes": dict(mesh.shape), "id": cid, "device": "meta"}
    ok, reason = shape_supported(cfg, shape_name)
    if not ok:
        rec.update(status="skipped", reason=reason)
        return _save(rec, out_path, f"SKIPPED ({reason})")

    spec = SHAPES[shape_name]
    kind, seq, batch = spec["kind"], spec["seq_len"], spec["global_batch"]
    bundle = build(cfg)
    n_dev = int(math.prod(mesh.shape.values()))
    model_par = mesh.shape["model"]
    dev = torch.device("meta")
    try:
        params = bundle.init(None, dev, dtype=cfg.torch_param_dtype())
        pc = R.count_params(params)
        b_loc = max(batch // (n_dev // model_par), 1)
        WIRE.reset()
        if kind == "decode":
            serve = bundle.init(None, dev)
            c = count_decode(bundle, serve, b_loc, seq, seq, dev)
            coll = R.collective_bytes(cfg, "decode", batch, seq, mesh.shape)
            n_tokens = batch
        else:
            set_mesh(mesh)
            try:
                local = shard_params(params, mesh)
                if kind == "train":
                    state = {"params": local, "opt": adamw_init(
                        local, cfg.torch_optimizer_dtype())}
                    c = count_train_step(bundle, state, b_loc, seq, dev,
                                         microbatches)
                else:
                    c = count_prefill(bundle, local, b_loc, seq, dev)
            finally:
                set_mesh(None)
            coll = R.collective_bytes(cfg, kind, batch, seq, mesh.shape,
                                      params=params,
                                      microbatches=microbatches)
            n_tokens = batch * seq
        # the reckoning against what the run put on WIRE (the decode
        # cell runs no collective: the pool gather is the engine's)
        wire = {}
        for (op, dt), v in WIRE.totals().items():
            wire[(op, dt)] = wire.get((op, dt), 0) + v["bytes"]
        if kind != "decode" and wire != coll["by_op"]:
            raise AssertionError(f"collective_bytes {coll['by_op']} != WIRE "
                                 f"{wire}")
        mf = R.model_flops(pc["total"], pc["expert"], cfg.moe.top_k,
                           cfg.moe.n_experts, n_tokens,
                           kind="train" if kind == "train" else "decode")
        membytes = R.analytic_memory_bytes(cfg, kind, batch, seq, n_dev,
                                           model_par)
        terms = R.roofline_terms(c.flops, membytes["bytes"],
                                 coll["by_axis"], mesh.shape)
        rec.update(
            status="ok", kind=kind, seq=seq, global_batch=batch,
            batch_per_device=b_loc, n_devices=n_dev,
            flops_per_device=c.flops, flops_by_op=c.flops_by_op,
            op_bytes_per_device=c.bytes,
            hbm_bytes_per_device=membytes,
            collectives={"total_bytes": coll["total_bytes"],
                         "bytes": coll["bytes"], "by_axis": coll["by_axis"]},
            state_bytes_per_device=state_bytes(cfg, params, mesh.shape),
            params=pc, model_flops_global=mf,
            model_flops_per_device=mf / n_dev,
            useful_flops_ratio=(mf / n_dev) / c.flops if c.flops else 0.0,
            roofline=terms,
        )
        return _save(rec, out_path, (
            f"OK  compute={terms['compute_s']:.4f}s "
            f"memory={terms['memory_s']:.4f}s "
            f"collective={terms['collective_s']:.4f}s "
            f"dominant={terms['dominant']} (published peaks)"))
    except Exception as e:  # a cell that fails is a record, and exits 1
        rec.update(status="error", error=f"{type(e).__name__}: {e}")
        traceback.print_exc()
        return _save(rec, out_path, f"ERROR {type(e).__name__}: {e}")


def _save(rec: dict, out_path: Optional[str], line: str) -> dict:
    if out_path:
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
    print(f"[dryrun] {rec['id']}: {line}")
    return rec


def summary(results) -> str:
    """A markdown table of the records: per arch and mesh the training
    state's GB a device under the plan and under the held layout, whether
    each fits the card's 80 GB, and each shape's dominant roofline term
    (counts from shapes and published peaks, not card measurements)."""
    from repro_torch.configs import SHAPES

    rows, seen = [], {}
    for r in results:
        if r.get("status") == "ok":
            seen.setdefault((r["arch"], r["mesh"]), {})[r["shape"]] = r
        elif r.get("status") == "skipped":
            seen.setdefault((r["arch"], r["mesh"]), {})[r["shape"]] = None
    rows.append("| arch | mesh | state GB a device: plan / held | fits 80 GB "
                "(plan / held) | dominant: " + " / ".join(SHAPES) + " |")
    rows.append("| --- | --- | --- | --- | --- |")
    for (arch, mesh), cells in seen.items():
        ok = [c for c in cells.values() if c]
        if not ok:
            continue
        sb = ok[0]["state_bytes_per_device"]
        dom = " / ".join(cells[s]["roofline"]["dominant"] if cells.get(s)
                         else "skipped" for s in SHAPES)
        rows.append(
            f"| {arch} | {mesh} | {sb['plan']['total'] / 1e9:.2f} / "
            f"{sb['held']['total'] / 1e9:.2f} | "
            f"{'yes' if sb['plan']['fits_80gb'] else 'no'} / "
            f"{'yes' if sb['held']['fits_80gb'] else 'no'} | {dom} |")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="Reckon every (arch x shape x mesh) cell on the meta "
                    "device: no card, no allocation.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    from repro_torch.configs import ASSIGNED_ARCHS, SHAPES

    archs = ASSIGNED_ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    results = [run_cell(arch, shape, mp, args.out, force=args.force,
                        microbatches=args.microbatches)
               for mp in meshes for arch in archs for shape in shapes]
    n = {s: sum(r.get("status") == s for r in results)
         for s in ("ok", "skipped", "error")}
    print(summary(results))
    print(f"[dryrun] done: {n['ok']} ok, {n['skipped']} skipped, "
          f"{n['error']} errors")
    return 1 if n["error"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
