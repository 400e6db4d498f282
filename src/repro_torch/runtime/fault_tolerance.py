"""Fault-tolerant training runtime: retry, stragglers, elasticity,
preemption (counterpart of ``repro.runtime.fault_tolerance``).

The loop contract:

  * every ``ckpt_every`` steps the full (params, opt) state is saved
    asynchronously and atomically;
  * a step raising (device loss, the NaN guard, an injected fault)
    triggers RESTORE-AND-RETRY: the state reloads from the newest valid
    checkpoint, the deterministic data pipeline rewinds to that step
    (stateless indexing makes this exact), and training resumes; after
    ``max_retries`` consecutive failures the loop surfaces the error;
  * SIGTERM/SIGINT (preemption notice) flips a flag; the loop checkpoints
    synchronously at the next step boundary and exits cleanly;
  * a straggler monitor tracks the step-time EMA and flags outliers (it
    feeds metrics and tests);
  * :func:`elastic_mesh_shape` picks the largest usable (data, model) mesh
    for a surviving device count.

The state is restored into its own tensors in place
(``CheckpointManager.restore``), so a device holds one copy of it, as the
trainer's in-place optimizer step does.  The NaN guard
reads the loss back at each step boundary: the training loop is
synchronous by design.
"""

from __future__ import annotations

import signal
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.runtime.telemetry import _drain_point


class StragglerMonitor:
    """EMA step-time tracker; flags steps slower than ``threshold x`` EMA."""

    def __init__(self, alpha: float = 0.1, threshold: float = 2.0,
                 warmup: int = 3):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.ema: Optional[float] = None
        self.count = 0
        self.flagged = 0

    def record(self, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        self.count += 1
        if self.ema is None:
            self.ema = dt
            return False
        is_straggler = (
            self.count > self.warmup and dt > self.threshold * self.ema
        )
        # stragglers shouldn't poison the EMA
        if not is_straggler:
            self.ema = (1 - self.alpha) * self.ema + self.alpha * dt
        if is_straggler:
            self.flagged += 1
        return is_straggler


def elastic_mesh_shape(
    n_devices: int, *, model_parallel: int, min_data: int = 1
) -> tuple:
    """Largest (data, model) mesh for a (possibly degraded) device count.

    Keeps the model-parallel degree fixed (weights shardings depend on it)
    and shrinks data-parallelism to the largest power-of-two slice that
    fits - the standard elastic-DP policy.
    """
    if n_devices < model_parallel * min_data:
        raise ValueError(
            f"{n_devices} devices cannot host model_parallel={model_parallel}"
        )
    data = n_devices // model_parallel
    # largest power of two <= data (slice-shaped reschedules)
    data = 1 << (data.bit_length() - 1)
    return (data, model_parallel)


class FaultTolerantLoop:
    def __init__(
        self,
        *,
        step_fn: Callable,          # (state, batch) -> (state, metrics)
        state,                      # pytree (params, opt, ...)
        pipeline,                   # repro_torch.data.DataPipeline
        ckpt,                       # repro_torch.checkpoint.CheckpointManager
        ckpt_every: int = 50,
        max_retries: int = 3,
        straggler: Optional[StragglerMonitor] = None,
        install_signal_handlers: bool = False,
        log: Callable[[str], None] = print,
    ):
        self.step_fn = step_fn
        self.state = state
        self.pipeline = pipeline
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.straggler = straggler or StragglerMonitor()
        self.log = log
        self.preempted = False
        self.step = 0
        if install_signal_handlers:
            for sig in (signal.SIGTERM, signal.SIGINT):
                signal.signal(sig, self._on_preempt)

    def _on_preempt(self, signum, frame):
        self.log(f"[runtime] received signal {signum}: draining")
        self.preempted = True

    # ------------------------------------------------------------------ run
    def restore_latest(self) -> None:
        hit = self.ckpt.restore(self.state)
        if hit is not None:
            step, state = hit
            self.state = state
            self.step = step
            self.pipeline.restore({"step": step, "seed": self.pipeline.seed})
            self.log(f"[runtime] restored step {step}")

    def run(self, n_steps: int, metrics_cb: Optional[Callable] = None):
        retries = 0
        while self.step < n_steps and not self.preempted:
            t0 = time.time()
            try:
                batch = next(self.pipeline)
                self.state, metrics = self.step_fn(self.state, batch)
                _nan_guard(metrics)
            except Exception as e:
                retries += 1
                self.log(
                    f"[runtime] step {self.step} failed ({e!r}); "
                    f"retry {retries}/{self.max_retries}"
                )
                if retries > self.max_retries:
                    raise
                self.ckpt.wait()
                self.restore_latest()
                continue
            retries = 0
            dt = time.time() - t0
            if self.straggler.record(dt):
                self.log(
                    f"[runtime] straggler step {self.step}: {dt:.3f}s "
                    f"(ema {self.straggler.ema:.3f}s)"
                )
            self.step += 1
            if metrics_cb is not None:
                metrics_cb(self.step, metrics, dt)
            if self.step % self.ckpt_every == 0:
                self.ckpt.save(self.step, self.state)
        if self.preempted:
            self.log("[runtime] preemption checkpoint")
            self.ckpt.save(self.step, self.state, blocking=True)
        self.ckpt.wait()
        return self.state


@_drain_point
def _nan_guard(metrics) -> None:
    """Raise FloatingPointError on a non-finite loss: the loop's one
    readback a step, at the step boundary."""
    loss = metrics.get("loss") if isinstance(metrics, dict) else None
    if isinstance(loss, torch.Tensor):
        loss = loss.detach().float().cpu().numpy()
    if loss is not None and not np.isfinite(np.asarray(loss)):
        raise FloatingPointError(f"non-finite loss {loss}")
