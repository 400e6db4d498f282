"""Async, atomic, checksum-validated checkpointing (counterpart of
``repro.checkpoint.manager``, on the reference's on-disk schema).

  * **Atomicity**: writes go to ``step_XXXXXXXXXX.tmp/`` and are renamed
    into place only after every array and the manifest are fsync'd - a
    preempted writer never leaves a half checkpoint that restore() would
    pick up.
  * **Async**: ``save()`` snapshots the tensors to host (blocking only on
    the device -> host copy) and hands serialization to a background
    thread; ``wait()`` joins it and raises what it raised.
  * **In place**: ``restore()`` verifies every leaf of a step, then
    copies into the template's tensors, so a device holds one copy of
    the state (the trainer's AdamW also updates in place).
  * **Validation**: every leaf's sha256 lands in the manifest; ``restore()``
    verifies and falls back to the previous checkpoint on a mismatch, a
    missing leaf or a shape mismatch.
  * **Retention**: keep the newest ``keep`` checkpoints (GC after rename).
  * **Layout**: ``step_%010d/shard_00000/<key>.npy`` plus
    ``manifest.json`` ({"step", "time", "leaves": {key: {"file", "shape",
    "dtype", "sha256"}}, "meta"}), one shard per process.
  * **Multi-process** (``process_count`` > 1, the reference's multi-host
    layout): process i writes only ``step_%010d/shard_%05d`` with its own
    ``manifest.json`` inside, built in ``step_%010d.shard_%05d.tmp`` and
    renamed into the step directory; a step is available once every
    process's shard is in place, and each process restores its own
    shard and removes its own old ones.

A leaf's key is its path in the state tree as the reference's
``_flatten_with_paths`` spells it: dict keys in sorted order, a
dataclass field (the optimizer's ``AdamWState``) as ``.<name>`` in field
order, a list or tuple index as its number - ``opt/.step``,
``opt/.mu/blocks/attn/wq``, ``params/embed``.  So a checkpoint the
reference wrote restores here, and one written here restores there.
bf16 leaves (which numpy has no dtype for) are stored as their uint16
bits, with ``"dtype": "bfloat16"`` in the manifest.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Optional, Tuple

import numpy as np
import torch


def _flatten_with_paths(tree, prefix=()):
    """[(key, leaf)] in the reference's order and spelling."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f".{f.name}", getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    else:
        return [("/".join(prefix), tree)]
    return [kv for name, sub in items
            for kv in _flatten_with_paths(sub, prefix + (name,))]


def _unflatten(template, leaves: dict, prefix=()):
    """``template``'s tree with each leaf replaced by ``leaves[key]``."""
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in template.items()}
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _unflatten(getattr(template, f.name), leaves,
                               prefix + (f".{f.name}",))
            for f in dataclasses.fields(template)})
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(x, leaves, prefix + (str(i),))
                              for i, x in enumerate(template))
    return leaves["/".join(prefix)]


def _to_host(x) -> np.ndarray:
    """A copy of a leaf as a numpy array (a bf16 tensor as its uint16
    bits).  A copy even on the CPU: the trainer updates its state in
    place while the async writer serializes the snapshot."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            x = x.view(torch.uint16)
        return x.numpy()
    return np.array(x)


def _dtype_name(x, arr: np.ndarray) -> str:
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _from_host(arr: np.ndarray, ent: dict) -> torch.Tensor:
    """The stored array as a CPU tensor (bf16 from its stored bits)."""
    if ent.get("dtype") == "bfloat16":
        # the port's uint16 bits, or the reference's ml_dtypes bfloat16,
        # which numpy alone reads as 2-byte void
        arr = arr.view(np.uint16)
    t = torch.from_numpy(np.require(arr, requirements="C"))
    if ent.get("dtype") == "bfloat16":
        t = t.view(torch.bfloat16)
    return t


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, *,
                 process_index: int = 0, process_count: int = 1):
        self.dir = directory
        self.keep = keep
        self.process_index, self.process_count = process_index, process_count
        self._shard = f"shard_{process_index:05d}"
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any, *, blocking: bool = False,
             extra_meta: Optional[dict] = None) -> None:
        self.wait()  # one in-flight save at a time
        host = [(key, _to_host(x), x) for key, x in _flatten_with_paths(state)]
        host = [(key, arr, _dtype_name(x, arr)) for key, arr, x in host]

        def _write():
            try:
                self._write_sync(step, host, extra_meta or {})
            except BaseException as e:  # surfaced on next wait()/save()
                self._error = e

        if blocking:
            _write()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def _write_sync(self, step: int, host, extra_meta: dict) -> None:
        final = os.path.join(self.dir, f"step_{step:010d}")
        multi = self.process_count > 1
        tmp = f"{final}.{self._shard}.tmp" if multi else final + ".tmp"
        shard_dir = tmp if multi else os.path.join(tmp, self._shard)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(shard_dir)

        manifest = {"step": step, "time": time.time(), "leaves": {},
                    "meta": extra_meta}
        for key, arr, dtype in host:
            fname = key.replace("/", "__") + ".npy"
            with open(os.path.join(shard_dir, fname), "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            manifest["leaves"][key] = {
                "file": fname,
                "shape": list(arr.shape),
                "dtype": dtype,
                "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if multi:
            os.makedirs(final, exist_ok=True)
            mine = os.path.join(final, self._shard)
            if os.path.exists(mine):
                shutil.rmtree(mine)
            os.replace(tmp, mine)  # atomic publish of this shard
        else:
            os.replace(tmp, final)  # atomic publish
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err

    def _gc(self) -> None:
        if self.process_count == 1:
            steps = sorted(self.available_steps())
            for s in steps[: -self.keep] if self.keep else []:
                shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                              ignore_errors=True)
            return
        # each process keeps its newest ``keep`` shards; processes that
        # save in step (a training run's) leave the newest ``keep`` - 1
        # steps complete at every moment
        mine = sorted(s for s in self._step_dirs() if os.path.exists(
            os.path.join(self.dir, f"step_{s:010d}", self._shard)))
        for s in mine[: -self.keep] if self.keep else []:
            step_dir = os.path.join(self.dir, f"step_{s:010d}")
            shutil.rmtree(os.path.join(step_dir, self._shard),
                          ignore_errors=True)
            try:
                os.rmdir(step_dir)  # the last process's removal
            except OSError:
                pass

    # --------------------------------------------------------------- restore
    def _step_dirs(self):
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    yield int(name[5:])
                except ValueError:
                    continue

    def available_steps(self):
        """The steps whose every shard is in place."""
        return sorted(
            s for s in self._step_dirs() if self.process_count == 1 or all(
                os.path.exists(os.path.join(
                    self.dir, f"step_{s:010d}", f"shard_{i:05d}",
                    "manifest.json"))
                for i in range(self.process_count)))

    def _manifest_path(self, step: int) -> str:
        final = os.path.join(self.dir, f"step_{step:010d}")
        if self.process_count > 1:
            return os.path.join(final, self._shard, "manifest.json")
        return os.path.join(final, "manifest.json")

    def restore(
        self, template: Any, step: Optional[int] = None
    ) -> Optional[Tuple[int, Any]]:
        """Restore the given (or newest valid) step into ``template``'s tree.

        Returns (step, state) or None if no valid checkpoint exists.
        Corrupt or incomplete checkpoints are skipped with a warning
        (falling back to older ones).  Every leaf of the step is read and
        verified first; then each tensor leaf of ``template`` is
        overwritten in place (at its own device and dtype), so that a
        device holds one copy of the state, and ``state`` is the template
        with its other leaves replaced by the stored arrays as tensors."""
        candidates = ([step] if step is not None
                      else list(reversed(self.available_steps())))
        for s in candidates:
            try:
                return s, self._read_sync(template, s)
            except Exception as e:  # corrupt -> try older
                print(f"[checkpoint] step {s} unusable ({e}); falling back")
        return None

    def _read_sync(self, template: Any, step: int) -> Any:
        final = os.path.join(self.dir, f"step_{step:010d}")
        with open(self._manifest_path(step)) as f:
            manifest = json.load(f)
        shard_dir = os.path.join(final, self._shard)
        read = {}
        for key, leaf in _flatten_with_paths(template):
            ent = manifest["leaves"].get(key)
            if ent is None:
                raise KeyError(f"missing leaf {key!r}")
            arr = np.load(os.path.join(shard_dir, ent["file"]))
            if hashlib.sha256(arr.tobytes()).hexdigest() != ent["sha256"]:
                raise IOError(f"checksum mismatch for {key!r}")
            want_shape = tuple(getattr(leaf, "shape", arr.shape))
            if tuple(arr.shape) != want_shape:
                raise ValueError(
                    f"shape mismatch for {key!r}: {arr.shape} vs {want_shape}"
                )
            read[key] = _from_host(arr, ent)
        with torch.no_grad():
            for key, leaf in _flatten_with_paths(template):
                if isinstance(leaf, torch.Tensor):
                    read[key] = leaf.copy_(read[key])
        return _unflatten(template, read)

    def meta(self, step: int) -> dict:
        with open(self._manifest_path(step)) as f:
            return json.load(f).get("meta", {})
