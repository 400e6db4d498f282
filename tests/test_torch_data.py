"""The port's data pipeline (``repro_torch.data``, its own copy of the
numpy-only reference module) against the reference's ``repro.data``:
``synthetic_batch`` bit for bit at several seeds, steps, shapes, process
slices and with float extras; ``DataPipeline`` batches, ``state()`` /
``restore()`` and prefetching; ``TokenFileDataset`` on a local token
file; and the port's versions of the reference's data tests
(tests/test_substrate.py)."""

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
    extras = {"frame_embeds": ((2, 4, 8), np.float32)}
    kw = dict(batch=2, seq=8, vocab=100, seed=5, extras=extras)
    port, ref = DataPipeline(**kw), RefPipeline(**kw)
    try:
        for _ in range(4):
            _equal(next(port), next(ref))
        assert port.state() == ref.state() == {"step": 4, "seed": 5}
        for p in (port, ref):
            p.restore({"step": 1, "seed": 5})
        for _ in range(3):
            _equal(next(port), next(ref))
        # rewound past the prefetched steps and forward again
        for p in (port, ref):
            p.restore({"step": 10, "seed": 6})
        _equal(next(port), next(ref))
        assert port.state() == ref.state() == {"step": 11, "seed": 6}
    finally:
        port.close()
        ref.close()


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
