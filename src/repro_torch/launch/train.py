"""End-to-end training driver (counterpart of ``repro.launch.train``):
the fault-tolerant loop over the deterministic data pipeline, AdamW with
its cosine warmup, async atomic checkpoints.

Example (CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --reduced --steps 50 --batch 8 --seq 64 --device cpu

On the card (the default device) the attention of every layer runs the
hand-written kernels forward; ``--reduced`` has head_dim 16, which the
kernels do not take, so on the card it needs ``--attention-impl naive``.
On CUDA the step is made deterministic (``torch.use_deterministic_
algorithms`` and cuBLAS's fixed workspace, set before the first cuBLAS
call), so that a restarted run equals a straight one bit for bit.

``--mesh DxM`` other than ``1x1`` trains across D x M processes, one a
mesh cell, started by torchrun (a gloo group; on one card every process
shares it)::

  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
      -m repro_torch.launch.train --arch qwen3-4b --reduced --steps 6 \
      --mesh 2x1 --device cpu

Each process takes its data rank's slice of the global batch, holds its
model rank's part of the state (``models.convert.shard_params``: the moe
experts and the MLPs' ``w2`` split over M), averages the gradients over
D, and writes and restores its own checkpoint shard (the reference's
multi-host layout).  Only rank 0 prints.  ``--mesh prod`` / ``prod2``
(the reference's TPU pod meshes) raise, naming ROADMAP A16.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config of the same family")
    ap.add_argument("--mesh", default="1x1",
                    help='"DxM" data x model (D x M processes under '
                         'torchrun); "prod" / "prod2" raise (ROADMAP A16)')
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--attention-impl", default=None,
                    choices=[None, "pasa", "flash", "naive"])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import resolve_device
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline
    from repro_torch.kernels.pasa_attention import HEAD_DIMS
    from repro_torch.launch.mesh import make_production_mesh, make_train_mesh
    from repro_torch.launch.sharding import set_mesh
    from repro_torch.launch.steps import (TrainHyper, init_train_state,
                                          make_train_step)
    from repro_torch.models.model_zoo import build
    from repro_torch.runtime import FaultTolerantLoop

    if args.mesh in ("prod", "prod2"):
        make_production_mesh(multi_pod=args.mesh == "prod2")
    try:
        d, m = (int(x) for x in args.mesh.split("x"))
    except ValueError:
        raise ValueError(f"--mesh must be DxM, got {args.mesh!r}") from None
    dev = resolve_device(args.device)
    mesh = None
    own_group = False
    if d * m > 1:
        if not dist.is_initialized():
            if "RANK" not in os.environ:
                raise RuntimeError(
                    f"--mesh {args.mesh} trains across {d * m} processes: "
                    f"start it with torchrun --standalone --nproc-per-node "
                    f"{d * m}")
            own_group = True
            dist.init_process_group("gloo")
        grid = ("cpu" if dev.type == "cpu" else None)
        mesh = make_train_mesh((d, m), ("data", "model"), devices=grid)
        dev = mesh.local_device()
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
    rank = dist.get_rank() if mesh is not None else 0
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.attention_impl:
        cfg = dataclasses.replace(
            cfg, attention=dataclasses.replace(
                cfg.attention, impl=args.attention_impl
            ),
        )
    if (dev.type == "cuda" and cfg.family != "ssm"
            and cfg.attention.impl != "naive"
            and cfg.head_dim not in HEAD_DIMS):
        raise NotImplementedError(
            f"the CUDA attention kernels take head_dim "
            f"{' or '.join(map(str, HEAD_DIMS))}, {args.arch} has "
            f"{cfg.head_dim}; on the card run it with --attention-impl naive"
        )
    if dev.type == "cuda":
        # before the first cuBLAS call: a fixed workspace makes cuBLAS
        # deterministic; the flag picks deterministic kernels elsewhere
        # (the embedding's scatter-add backward would use atomics)
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)

    set_mesh(mesh)
    bundle = build(cfg)
    hyper = TrainHyper(
        peak_lr=args.lr, warmup_steps=args.warmup, total_steps=args.steps
    )
    step_fn_raw = make_train_step(bundle, hyper)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = init_train_state(bundle, gen, dev, mesh=mesh)

    extras = {}
    if cfg.family == "vlm":
        extras["vision_embeds"] = (
            (args.batch, cfg.n_image_tokens, cfg.vision_dim), np.float32
        )
    if cfg.family == "audio":
        extras["frame_embeds"] = (
            (args.batch, cfg.n_audio_frames, cfg.d_model), np.float32
        )
    n_dp = 1 if mesh is None else mesh.axis_size(mesh.dp_axes())
    pipe = DataPipeline(
        batch=args.batch, seq=args.seq, vocab=cfg.vocab_size,
        seed=args.seed, extras=extras or None,
        process_index=0 if mesh is None else mesh.dp_rank(),
        process_count=n_dp,
    )

    def step_fn(state, batch):
        state, metrics = step_fn_raw(state, batch)
        return state, {k: float(v) for k, v in metrics.items()}

    ckpt = CheckpointManager(
        args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                      f"repro_torch_ckpt_{args.arch}"),
        keep=3, process_index=rank, process_count=d * m,
    )
    losses = []

    def metrics_cb(step, metrics, dt):
        losses.append(metrics["loss"])
        if step % args.log_every == 0:
            say(
                f"step {step:5d}  loss {metrics['loss']:.4f}  "
                f"lr {metrics['lr']:.2e}  gnorm {metrics['grad_norm']:.3f}"
                f"  {dt*1000:.0f} ms"
            )

    loop = FaultTolerantLoop(
        step_fn=step_fn, state=state, pipeline=pipe, ckpt=ckpt,
        ckpt_every=args.ckpt_every, install_signal_handlers=True, log=say,
    )
    loop.restore_latest()
    t0 = time.time()
    try:
        loop.run(args.steps, metrics_cb=metrics_cb)
    finally:
        pipe.close()
        set_mesh(None)
        if own_group:
            dist.destroy_process_group()
    if losses:
        say(
            f"done: {args.steps} steps in {time.time()-t0:.1f}s; "
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f}"
        )
    else:
        say(f"done: restored at step {loop.step}, nothing to run")
    return losses


if __name__ == "__main__":
    main()
