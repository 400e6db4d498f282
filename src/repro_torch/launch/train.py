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
Training runs on one device: ``--mesh`` other than ``1x1`` raises
(data-parallel training is ROADMAP A15b).
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
                    help='"DxM" data x model; only "1x1" is ported')
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--attention-impl", default=None,
                    choices=[None, "pasa", "flash", "naive"])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.mesh != "1x1":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port trains on one device; "
            "data-parallel training across processes is ROADMAP A15b"
        )

    import numpy as np
    import torch

    from repro_torch import resolve_device
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline
    from repro_torch.kernels.pasa_attention import HEAD_DIMS
    from repro_torch.launch.steps import (TrainHyper, init_train_state,
                                          make_train_step)
    from repro_torch.models.model_zoo import build
    from repro_torch.runtime import FaultTolerantLoop

    dev = resolve_device(args.device)
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

    bundle = build(cfg)
    hyper = TrainHyper(
        peak_lr=args.lr, warmup_steps=args.warmup, total_steps=args.steps
    )
    step_fn_raw = make_train_step(bundle, hyper)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = init_train_state(bundle, gen, dev)

    extras = {}
    if cfg.family == "vlm":
        extras["vision_embeds"] = (
            (args.batch, cfg.n_image_tokens, cfg.vision_dim), np.float32
        )
    if cfg.family == "audio":
        extras["frame_embeds"] = (
            (args.batch, cfg.n_audio_frames, cfg.d_model), np.float32
        )
    pipe = DataPipeline(
        batch=args.batch, seq=args.seq, vocab=cfg.vocab_size,
        seed=args.seed, extras=extras or None,
    )

    def step_fn(state, batch):
        state, metrics = step_fn_raw(state, batch)
        return state, {k: float(v) for k, v in metrics.items()}

    ckpt = CheckpointManager(
        args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                      f"repro_torch_ckpt_{args.arch}"),
        keep=3,
    )
    losses = []

    def metrics_cb(step, metrics, dt):
        losses.append(metrics["loss"])
        if step % args.log_every == 0:
            print(
                f"step {step:5d}  loss {metrics['loss']:.4f}  "
                f"lr {metrics['lr']:.2e}  gnorm {metrics['grad_norm']:.3f}"
                f"  {dt*1000:.0f} ms"
            )

    loop = FaultTolerantLoop(
        step_fn=step_fn, state=state, pipeline=pipe, ckpt=ckpt,
        ckpt_every=args.ckpt_every, install_signal_handlers=True,
    )
    loop.restore_latest()
    t0 = time.time()
    loop.run(args.steps, metrics_cb=metrics_cb)
    pipe.close()
    if losses:
        print(
            f"done: {args.steps} steps in {time.time()-t0:.1f}s; "
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f}"
        )
    else:
        print(f"done: restored at step {loop.step}, nothing to run")
    return losses


if __name__ == "__main__":
    main()
