"""Deterministic, restart-reproducible data pipeline (a copy of the
reference's ``repro.data.pipeline``, which is numpy-only; the port keeps
its own so that it imports nothing of the reference).

  * **Stateless indexing**: sample ``i`` of step ``t`` is a pure function of
    (seed, t, i) via a counter-based hash, so a restarted job resumes at step
    ``t`` with bit-identical data and no shuffle-state checkpointing.
  * **Shard-aware**: each process materializes only its ``process_index``
    slice of the global batch.
  * **Prefetch**: a background thread keeps ``prefetch`` batches ready so
    host-side generation overlaps device compute.

Also includes an optional memory-mapped token-file backend for a local
corpus.  Batches are numpy arrays; the trainer moves them to its device.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


def _philox_like(seed: int, step: int, idx: np.ndarray) -> np.ndarray:
    """Cheap counter-based hash -> uint64 stream (splitmix-style)."""
    with np.errstate(over="ignore"):  # uint64 wraparound is the point
        x = (
            np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15)
            + np.uint64(step) * np.uint64(0xBF58476D1CE4E5B9)
            + idx.astype(np.uint64) * np.uint64(0x94D049BB133111EB)
        )
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    return x


def synthetic_batch(
    seed: int, step: int, batch: int, seq: int, vocab: int,
    process_index: int = 0, process_count: int = 1,
    extras: Optional[Dict[str, tuple]] = None,
) -> Dict[str, np.ndarray]:
    """One (local slice of a) global batch of structured synthetic tokens.

    Tokens follow a Markov-ish pattern (next token correlated with current)
    so a model can actually reduce loss on them - the e2e training example
    needs a learnable signal, not uniform noise.
    """
    if batch % process_count:
        raise ValueError(f"global batch {batch} % processes {process_count}")
    local = batch // process_count
    base = process_index * local
    idx = np.arange(local * (seq + 1), dtype=np.uint64).reshape(local, seq + 1)
    idx += np.uint64(base * (seq + 1))
    u = _philox_like(seed, step, idx)
    noise = (u % np.uint64(vocab)).astype(np.int64)
    # structured component: token_{t+1} = (token_t * 3 + 7) mod vocab with
    # 50% probability, noise otherwise
    toks = np.empty((local, seq + 1), np.int64)
    toks[:, 0] = noise[:, 0]
    coin = (u >> np.uint64(32)) % np.uint64(2)
    for t in range(1, seq + 1):
        pred = (toks[:, t - 1] * 3 + 7) % vocab
        toks[:, t] = np.where(coin[:, t] == 0, pred, noise[:, t])
    out = {"tokens": toks.astype(np.int32)}
    if extras:
        for name, (shape, dtype) in extras.items():
            e_idx = np.arange(int(np.prod(shape)), dtype=np.uint64)
            vals = _philox_like(seed + 1, step, e_idx).astype(np.float64)
            vals = (vals % np.uint64(2**20)).astype(np.float32) / 2**19 - 1.0
            out[name] = vals.reshape(shape).astype(dtype)
    return out


class TokenFileDataset:
    """Memory-mapped flat token file (np.int32), sampled by stateless index."""

    def __init__(self, path: str, seq: int):
        self.data = np.memmap(path, dtype=np.int32, mode="r")
        self.seq = seq
        self.n_windows = max(len(self.data) - (seq + 1), 1)

    def batch(self, seed: int, step: int, batch: int,
              process_index: int = 0, process_count: int = 1):
        local = batch // process_count
        idx = np.arange(local, dtype=np.uint64) + np.uint64(
            process_index * local
        )
        starts = (_philox_like(seed, step, idx) % np.uint64(self.n_windows)
                  ).astype(np.int64)
        toks = np.stack([
            np.asarray(self.data[s : s + self.seq + 1]) for s in starts
        ])
        return {"tokens": toks.astype(np.int32)}


class DataPipeline:
    """Prefetching iterator over deterministic steps.

    ``state()``/``restore()`` are trivially (step, seed) - everything else
    is stateless, which is the whole point.

    Each prefetched batch carries the generation it was made for (bumped
    by ``restore()``) with its seed and step, read together under one
    lock: a batch the producer was making when ``restore()`` ran belongs
    to an older generation and is dropped, so the batch after
    ``restore(s)`` is always ``synthetic_batch(s["seed"], s["step"], ...)``.
    """

    def __init__(
        self,
        batch: int,
        seq: int,
        vocab: int,
        seed: int = 0,
        start_step: int = 0,
        prefetch: int = 2,
        process_index: int = 0,
        process_count: int = 1,
        extras: Optional[Dict[str, tuple]] = None,
        backend=None,
    ):
        self.batch, self.seq, self.vocab = batch, seq, vocab
        self.seed = seed
        self.step = start_step
        self.process_index, self.process_count = process_index, process_count
        self.extras = extras
        self.backend = backend
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        # guards (_gen, seed, step, _next_to_produce) between the
        # producer thread and the caller's __next__ / restore
        self._lock = threading.Lock()
        self._gen = 0
        self._next_to_produce = start_step
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _make(self, seed: int, step: int):
        if self.backend is not None:
            return self.backend.batch(
                seed, step, self.batch, self.process_index,
                self.process_count,
            )
        return synthetic_batch(
            seed, step, self.batch, self.seq, self.vocab,
            self.process_index, self.process_count, self.extras,
        )

    def _producer(self):
        item = None
        while not self._stop.is_set():
            if item is None:
                with self._lock:
                    gen, seed, step = (self._gen, self.seed,
                                       self._next_to_produce)
                item = (gen, step, self._make(seed, step))
            try:
                self._q.put(item, timeout=0.2)
            except queue.Full:
                with self._lock:
                    if item[0] != self._gen:
                        item = None  # restored meanwhile: make anew
                continue
            with self._lock:
                if item[0] == self._gen:
                    self._next_to_produce = item[1] + 1
            item = None

    def __next__(self):
        while True:
            gen, step, data = self._q.get()
            with self._lock:
                # one generation's batches arrive in step order from the
                # step restore() set; an older generation's are stale
                if gen == self._gen:
                    assert step == self.step, (step, self.step)
                    self.step = step + 1
                    return data

    def __iter__(self) -> Iterator:
        return self

    def state(self) -> dict:
        with self._lock:
            return {"step": self.step, "seed": self.seed}

    def restore(self, state: dict) -> None:
        with self._lock:
            self._gen += 1
            self.step = int(state["step"])
            self.seed = int(state["seed"])
            self._next_to_produce = self.step
        # the queue is not drained here: a batch of the new generation may
        # already be in it, and __next__ drops the older ones

    def close(self):
        self._stop.set()
