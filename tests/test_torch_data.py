"""The port's data pipeline (``repro_torch.data``, its own copy of the
numpy-only reference module) against the reference's ``repro.data``:
``synthetic_batch`` bit for bit at several seeds, steps, shapes, process
slices and with float extras; ``DataPipeline`` batches, ``state()`` /
``restore()`` (a batch in production during a restore is dropped) and
prefetching; ``TokenFileDataset`` on a local token
file; and the port's versions of the reference's data tests
(tests/test_substrate.py)."""

import queue
import threading

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.data import DataPipeline as RefPipeline
from repro.data import synthetic_batch as ref_batch
from repro.data.pipeline import TokenFileDataset as RefTokenFile
from repro_torch.data import DataPipeline, TokenFileDataset, synthetic_batch


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed,step,batch,seq,vocab", [
    (0, 0, 8, 16, 1000), (3, 17, 4, 33, 97), (123, 4096, 2, 1024, 152064),
    (7, 5, 6, 1, 2),
])
def test_synthetic_batch_equals_reference(seed, step, batch, seq, vocab):
    _equal(synthetic_batch(seed, step, batch, seq, vocab),
           ref_batch(seed, step, batch, seq, vocab))


def test_extras_and_process_slices_equal_reference():
    extras = {"vision_embeds": ((4, 5, 6), np.float32),
              "frame_embeds": ((4, 3, 8), np.float32)}
    for procs in (1, 2, 4):
        for i in range(procs):
            _equal(synthetic_batch(9, 11, 4, 12, 500, i, procs, extras),
                   ref_batch(9, 11, 4, 12, 500, i, procs, extras))
    with pytest.raises(ValueError):
        synthetic_batch(0, 0, 6, 4, 10, 0, 4)


def test_pipeline_equals_reference_across_restore():
    """Every batch the port's pipeline yields, before and after two
    restores, is the reference's stateless ``synthetic_batch`` at the
    pipeline's (seed, step).  (The reference's ``DataPipeline`` has the
    restore race that the port's repaired, so it is not the oracle.)"""
    extras = {"frame_embeds": ((2, 4, 8), np.float32)}
    kw = dict(batch=2, seq=8, vocab=100, extras=extras)
    port = DataPipeline(seed=5, **kw)

    def expect(seed, step):
        return ref_batch(seed, step, kw["batch"], kw["seq"], kw["vocab"],
                         extras=extras)

    try:
        for step in range(4):
            _equal(next(port), expect(5, step))
        assert port.state() == {"step": 4, "seed": 5}
        port.restore({"step": 1, "seed": 5})
        for step in range(1, 4):
            _equal(next(port), expect(5, step))
        # rewound past the prefetched steps and forward again
        port.restore({"step": 10, "seed": 6})
        _equal(next(port), expect(6, 10))
        assert port.state() == {"step": 11, "seed": 6}
    finally:
        port.close()


class _BlockingBackend:
    """``synthetic_batch`` that blocks in ``batch()`` at (seed 5, step
    10) until ``release`` is set, signalling ``entered`` first."""

    def __init__(self, **kw):
        self.kw = kw
        self.entered = threading.Event()
        self.release = threading.Event()

    def batch(self, seed, step, batch, process_index, process_count):
        if (seed, step) == (5, 10):
            self.entered.set()
            assert self.release.wait(timeout=30)
        return synthetic_batch(seed, step, batch, self.kw["seq"],
                               self.kw["vocab"], process_index,
                               process_count)


def test_restore_drops_the_batch_in_production():
    """The producer is inside ``batch()`` for (seed 5, step 10) when
    ``restore({"step": 10, "seed": 6})`` runs; it then puts that stale
    batch in the queue.  The next batch is ``synthetic_batch(6, 10)``
    all the same, and the step counter is what restore set, plus one."""
    backend = _BlockingBackend(seq=8, vocab=100)
    pipe = DataPipeline(batch=2, seq=8, vocab=100, seed=5, start_step=10,
                        backend=backend)
    try:
        assert backend.entered.wait(timeout=30)
        pipe.restore({"step": 10, "seed": 6})
        backend.release.set()
        _equal(next(pipe), ref_batch(6, 10, 2, 8, 100))
        assert pipe.state() == {"step": 11, "seed": 6}
        _equal(next(pipe), ref_batch(6, 11, 2, 8, 100))
    finally:
        backend.release.set()
        pipe.close()


class _SeedBackend:
    """``synthetic_batch``, setting ``made_new`` once it has made a batch
    at seed 6."""

    def __init__(self, **kw):
        self.kw = kw
        self.made_new = threading.Event()

    def batch(self, seed, step, batch, process_index, process_count):
        out = synthetic_batch(seed, step, batch, self.kw["seq"],
                              self.kw["vocab"], process_index,
                              process_count)
        if seed == 6:
            self.made_new.set()
        return out


def _stalling_queue(backend):
    """A ``queue.Queue`` whose ``get_nowait`` - after taking its item -
    waits for the producer's next ``put``, until a put has carried a
    batch made at seed 6: whoever empties the queue with ``get_nowait``
    during a restore lets the producer put the new seed's first batch
    before it is done."""

    class Stalling(queue.Queue):
        def __init__(self, maxsize=0):
            super().__init__(maxsize)
            self.put_seen = threading.Event()
            self.fresh_put = threading.Event()

        def put(self, item, block=True, timeout=None):
            super().put(item, block, timeout)
            if backend.made_new.is_set():
                self.fresh_put.set()
            self.put_seen.set()

        def get_nowait(self):
            self.put_seen.clear()
            item = super().get_nowait()
            if not self.fresh_put.is_set():
                assert self.put_seen.wait(timeout=30)
            return item

    return Stalling


def test_restore_keeps_the_new_seeds_first_batch(monkeypatch):
    """The producer puts the first batch of ``restore({"step": 10,
    "seed": 6})`` into the queue before ``restore`` has returned (the
    queue's ``get_nowait`` stalls until it has, should ``restore`` empty
    the queue with it).  The next batch is ``synthetic_batch(6, 10)`` all
    the same, and the step counter is 11."""
    backend = _SeedBackend(seq=8, vocab=100)
    with monkeypatch.context() as m:
        m.setattr(queue, "Queue", _stalling_queue(backend))
        pipe = DataPipeline(batch=2, seq=8, vocab=100, seed=5, start_step=10,
                            prefetch=1, backend=backend)
    try:
        assert pipe._q.put_seen.wait(timeout=30)   # the queue holds a batch
        pipe.restore({"step": 10, "seed": 6})
        _equal(next(pipe), ref_batch(6, 10, 2, 8, 100))
        assert pipe.state() == {"step": 11, "seed": 6}
        _equal(next(pipe), ref_batch(6, 11, 2, 8, 100))
    finally:
        pipe.close()


def test_pipeline_start_step_and_process_slice():
    kw = dict(batch=4, seq=6, vocab=50, seed=2, start_step=3,
              process_index=1, process_count=2)
    port, ref = DataPipeline(**kw), RefPipeline(**kw)
    try:
        for _ in range(3):
            _equal(next(port), next(ref))
    finally:
        port.close()
        ref.close()


def test_token_file_dataset_equals_reference(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 1000, 4096, dtype=np.int32).tofile(
        path)
    port, ref = TokenFileDataset(str(path), 32), RefTokenFile(str(path), 32)
    assert port.n_windows == ref.n_windows
    for step in (0, 1, 99):
        _equal(port.batch(4, step, 8, 1, 2), ref.batch(4, step, 8, 1, 2))
    kw = dict(batch=4, seq=32, vocab=1000, seed=1)
    p = DataPipeline(backend=port, **kw)
    r = RefPipeline(backend=ref, **kw)
    try:
        for _ in range(2):
            _equal(next(p), next(r))
    finally:
        p.close()
        r.close()


# ---------------------------------------------- tests/test_substrate.py --

def test_data_deterministic_and_step_dependent():
    a = synthetic_batch(0, 5, 8, 16, 1000)
    b = synthetic_batch(0, 5, 8, 16, 1000)
    c = synthetic_batch(0, 6, 8, 16, 1000)
    assert (a["tokens"] == b["tokens"]).all()
    assert not (a["tokens"] == c["tokens"]).all()
    assert a["tokens"].min() >= 0 and a["tokens"].max() < 1000


@settings(max_examples=10, deadline=None)
@given(procs=st.sampled_from([1, 2, 4]), step=st.integers(0, 1000))
def test_property_process_sharding_consistent(procs, step):
    """Union of per-process slices == the global batch, any step."""
    g = synthetic_batch(7, step, 8, 12, 500)
    parts = [
        synthetic_batch(7, step, 8, 12, 500, i, procs) for i in range(procs)
    ]
    np.testing.assert_array_equal(
        np.concatenate([p["tokens"] for p in parts]), g["tokens"]
    )


def test_pipeline_restore_rewinds():
    pipe = DataPipeline(batch=4, seq=8, vocab=100, seed=3)
    b0 = next(pipe)
    next(pipe)
    pipe.restore({"step": 0, "seed": 3})
    np.testing.assert_array_equal(b0["tokens"], next(pipe)["tokens"])
    pipe.close()


def test_pipeline_learnable_signal():
    """The structured component makes next-token prediction beatable."""
    t = synthetic_batch(0, 0, 64, 64, 97)["tokens"]
    hit = ((t[:, :-1] * 3 + 7) % 97 == t[:, 1:]).mean()
    assert hit > 0.3  # ~50% by construction
