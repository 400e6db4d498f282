"""The port's checkpoint manager and fault-tolerant loop
(``repro_torch.checkpoint``, ``repro_torch.runtime.fault_tolerance``)
against the reference's:

  * the on-disk schema: a checkpoint the reference's ``CheckpointManager``
    wrote (the reference's training state: ``opt/.step``,
    ``opt/.mu/...``, ``params/...``) restores in the port, and the port's
    in the reference, leaf for leaf; a step from a reference-written
    checkpoint continues to the reference's next step within the step
    bar of tests/test_torch_train_step.py;
  * the reference's manager and loop tests (tests/test_substrate.py):
    atomic publish, corrupt-leaf fallback, retention, async save, meta;
    retry with restore, the NaN guard, preemption, stragglers, the
    elastic mesh; the restore in place.
"""

import dataclasses
import glob
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro.configs import get_config as ref_get_config
from repro.launch.steps import TrainHyper as RefHyper
from repro.launch.steps import init_train_state as ref_init_state
from repro.launch.steps import make_train_step as ref_make_step
from repro.models.model_zoo import build as ref_build
from repro.runtime import FaultTolerantLoop as RefLoop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataPipeline, synthetic_batch
from repro_torch.launch.steps import (TrainHyper, init_train_state,
                                      make_train_step)
from repro_torch.models.model_zoo import build
from repro_torch.optim import AdamWState
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import (FaultTolerantLoop, StragglerMonitor,
                                 elastic_mesh_shape)

torch.set_num_threads(1)

# one train step from the same state and batch in both packages (fp32
# compute, fp32 PASA): the updated parameters agree within this (the
# bar of tests/test_torch_train_step.py)
STEP_ATOL = 1e-4


def _cfgs():
    f32 = lambda c: dataclasses.replace(
        c, compute_dtype="float32",
        attention=dataclasses.replace(c.attention, pasa_policy="fp32"))
    return (f32(ref_get_config("qwen3-4b").reduced()),
            f32(get_config("qwen3-4b").reduced()))


def _ref_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def test_reference_checkpoint_restores_and_continues(tmp_path):
    rc, tc = _cfgs()
    rb, tb = ref_build(rc), build(tc)
    hyper = dict(peak_lr=1e-3, warmup_steps=1, total_steps=4)
    ref_step = jax.jit(ref_make_step(rb, RefHyper(**hyper)))
    rs = ref_init_state(rb, jax.random.PRNGKey(3))
    b0, b1 = (synthetic_batch(1, i, 2, 24, rc.vocab_size) for i in (0, 1))
    rs, _ = ref_step(rs, {k: jnp.asarray(v) for k, v in b0.items()})
    RefManager(str(tmp_path), keep=2).save(1, rs, blocking=True)

    man = json.loads((tmp_path / "step_0000000001" / "manifest.json")
                     .read_text())
    assert "opt/.step" in man["leaves"]
    assert "opt/.mu/blocks/attn/wq" in man["leaves"]
    assert "params/embed" in man["leaves"]

    template = init_train_state(tb, torch.Generator().manual_seed(9), "cpu")
    step, ts = CheckpointManager(str(tmp_path)).restore(template)
    assert step == 1 and int(ts["opt"].step) == 1
    got = [np.asarray(x) for x in tree_leaves(ts["params"])]
    want = _ref_leaves(rs["params"])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(tree_leaves(ts["opt"].nu), _ref_leaves(rs["opt"].nu)):
        np.testing.assert_array_equal(np.asarray(g), w)

    ts, tm = make_train_step(tb, TrainHyper(**hyper))(ts, b1)
    rs, rm = ref_step(rs, {k: jnp.asarray(v) for k, v in b1.items()})
    assert abs(float(tm["loss"]) - float(rm["loss"])) < 1e-4
    for g, w in zip(tree_leaves(ts["params"]), _ref_leaves(rs["params"])):
        np.testing.assert_allclose(np.asarray(g.detach()), w,
                                   atol=STEP_ATOL, rtol=0)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    rc, tc = _cfgs()
    ts = init_train_state(build(tc), torch.Generator().manual_seed(0), "cpu")
    ts["opt"] = dataclasses.replace(ts["opt"], step=torch.tensor(
        7, dtype=torch.int32))
    CheckpointManager(str(tmp_path)).save(7, ts, blocking=True,
                                          extra_meta={"data_step": 7})
    template = jax.eval_shape(
        lambda: ref_init_state(ref_build(rc), jax.random.PRNGKey(0)))
    step, rs = RefManager(str(tmp_path)).restore(template)
    assert step == 7 and int(rs["opt"].step) == 7
    for g, w in zip(_ref_leaves(rs["params"]), tree_leaves(ts["params"])):
        np.testing.assert_array_equal(g, np.asarray(w.detach()))
    assert RefManager(str(tmp_path)).meta(7) == {"data_step": 7}


def test_bf16_leaves_round_trip(tmp_path):
    x = torch.randn(5, 3).to(torch.bfloat16)
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"p": x, "n": torch.arange(4)}, blocking=True)
    man = json.loads((tmp_path / "step_0000000001" / "manifest.json")
                     .read_text())
    assert man["leaves"]["p"]["dtype"] == "bfloat16"
    _, got = cm.restore({"p": torch.zeros(5, 3, dtype=torch.bfloat16),
                         "n": torch.zeros(4, dtype=torch.int64)})
    assert got["p"].dtype == torch.bfloat16 and torch.equal(got["p"], x)


def test_restore_copies_into_the_template_in_place(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    state = {"a": torch.arange(6.0), "opt": AdamWState(
        step=torch.tensor(3, dtype=torch.int32),
        mu={"a": torch.ones(6)}, nu={"a": torch.full((6,), 2.0)})}
    cm.save(3, state, blocking=True)
    live = {"a": torch.zeros(6), "opt": AdamWState(
        step=torch.tensor(0, dtype=torch.int32),
        mu={"a": torch.zeros(6)}, nu={"a": torch.zeros(6)})}
    ids = [id(x) for x in (live["a"], live["opt"].mu["a"])]
    step, got = cm.restore(live)
    assert step == 3
    assert [id(x) for x in (got["a"], got["opt"].mu["a"])] == ids
    assert torch.equal(live["a"], torch.arange(6.0))
    assert int(live["opt"].step) == 3
    # a corrupt newest step leaves the live state untouched until a
    # valid one is fully read
    cm.save(4, {"a": torch.full((6,), 9.0), "opt": state["opt"]},
            blocking=True)
    victim = glob.glob(os.path.join(str(tmp_path), "step_0000000004", "*",
                                    "opt__.mu__a.npy"))[0]
    with open(victim, "wb") as f:
        f.write(b"torn")
    step, _ = cm.restore(live)
    assert step == 3 and torch.equal(live["a"], torch.arange(6.0))


# ---------------------------------------------- tests/test_substrate.py --

def test_checkpoint_roundtrip_and_gc(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    state = {"a": torch.arange(8), "b": {"c": torch.ones((2, 3))}}
    for s in (1, 2, 3):
        cm.save(s, {"a": state["a"] * s, "b": {"c": state["b"]["c"] * s}},
                blocking=True)
    assert cm.available_steps() == [2, 3]
    step, got = cm.restore(state)
    assert step == 3
    np.testing.assert_array_equal(np.asarray(got["a"]), np.arange(8) * 3)


def test_checkpoint_corruption_fallback(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=3)
    state = {"a": torch.arange(8)}
    cm.save(1, state, blocking=True)
    cm.save(2, {"a": state["a"] * 2}, blocking=True)
    victim = glob.glob(os.path.join(str(tmp_path), "step_0000000002", "*",
                                    "a.npy"))[0]
    with open(victim, "wb") as f:
        f.write(b"torn write")
    step, got = cm.restore(state)
    assert step == 1
    np.testing.assert_array_equal(np.asarray(got["a"]), np.arange(8))


def test_checkpoint_async_then_wait(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    cm.save(5, {"x": torch.ones(4)})  # async
    cm.wait()
    assert cm.available_steps() == [5]


def test_async_save_snapshots_before_the_state_moves(tmp_path):
    """The trainer updates its state in place right after ``save()``
    returns: the checkpoint holds the values at the call, its checksums
    match, and a restore reads them back (CPU tensors alias numpy
    arrays, so the snapshot must be a copy)."""
    cm = CheckpointManager(str(tmp_path), keep=2)
    x = torch.arange(1 << 20, dtype=torch.float32)
    want = x.clone()
    cm.save(1, {"x": x})            # async
    x.mul_(-1.0)
    cm.wait()
    step, got = cm.restore({"x": torch.zeros(1 << 20)})
    assert step == 1 and torch.equal(got["x"], want)


def test_checkpoint_no_partial_publish(tmp_path):
    """A .tmp dir must never be visible as a restorable step."""
    cm = CheckpointManager(str(tmp_path), keep=2)
    os.makedirs(os.path.join(str(tmp_path), "step_0000000009.tmp"))
    assert cm.available_steps() == []
    assert cm.restore({"x": torch.ones(2)}) is None


def test_checkpoint_shape_mismatch_and_missing_leaf_fall_back(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=3)
    cm.save(1, {"x": torch.ones(2)}, blocking=True)
    cm.save(2, {"x": torch.ones(3)}, blocking=True)
    step, got = cm.restore({"x": torch.zeros(2)})
    assert step == 1
    assert cm.restore({"y": torch.zeros(2)}) is None


def test_fault_recovery_exact_resume(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=5)
    pipe = DataPipeline(batch=2, seq=4, vocab=11, seed=0)
    seen = []
    calls = {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        if calls["n"] == 7:
            raise RuntimeError("injected")
        seen.append((int(state["s"]), batch["tokens"].tobytes()))
        return {"s": state["s"] + 1}, {"loss": 1.0}

    loop = FaultTolerantLoop(
        step_fn=step_fn, state={"s": torch.zeros((), dtype=torch.int32)},
        pipeline=pipe, ckpt=cm, ckpt_every=2, log=lambda s: None,
    )
    final = loop.run(8)
    pipe.close()
    assert int(final["s"]) == 8
    by_step = {}
    for s, tb in seen:
        if s in by_step:
            assert by_step[s] == tb, "restart replayed different data"
        by_step[s] = tb


def test_fault_recovery_matches_the_reference_loop(tmp_path):
    """The same injected faults give the same (state, batch) sequence in
    the port's loop and the reference's."""
    def run(loop_cls, man_cls, pipe_cls, state, d):
        pipe = pipe_cls(batch=2, seq=4, vocab=11, seed=4)
        seen, calls = [], {"n": 0}

        def step_fn(state, batch):
            calls["n"] += 1
            if calls["n"] in (4, 9):
                raise RuntimeError("injected")
            seen.append((int(state["s"]), batch["tokens"].tobytes()))
            return {"s": state["s"] + 1}, {"loss": 1.0}

        loop = loop_cls(step_fn=step_fn, state=state, pipeline=pipe,
                        ckpt=man_cls(str(d), keep=5), ckpt_every=3,
                        log=lambda s: None)
        final = loop.run(9)
        pipe.close()
        return int(final["s"]), seen

    from repro.data import DataPipeline as RefPipeline

    port = run(FaultTolerantLoop, CheckpointManager, DataPipeline,
               {"s": torch.zeros((), dtype=torch.int32)}, tmp_path / "p")
    ref = run(RefLoop, RefManager, RefPipeline,
              {"s": jnp.zeros((), jnp.int32)}, tmp_path / "r")
    assert port == ref


def test_nan_guard_triggers_retry_then_raises(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    pipe = DataPipeline(batch=2, seq=4, vocab=11, seed=0)

    def bad_step(state, batch):
        return state, {"loss": torch.tensor(float("nan"))}

    loop = FaultTolerantLoop(
        step_fn=bad_step, state={"s": torch.zeros(())}, pipeline=pipe,
        ckpt=cm, max_retries=2, log=lambda s: None,
    )
    with pytest.raises(FloatingPointError):
        loop.run(3)
    pipe.close()


def test_preemption_drains_with_a_checkpoint(tmp_path):
    """SIGTERM flips the flag; the loop saves synchronously at the next
    step boundary and returns; a new loop resumes there."""
    cm = CheckpointManager(str(tmp_path), keep=2)
    pipe = DataPipeline(batch=2, seq=4, vocab=11, seed=0)
    old = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM,
                                                  signal.SIGINT)}
    try:
        def step_fn(state, batch):
            if int(state["s"]) == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return {"s": state["s"] + 1}, {"loss": 1.0}

        loop = FaultTolerantLoop(
            step_fn=step_fn, state={"s": torch.zeros((), dtype=torch.int32)},
            pipeline=pipe, ckpt=cm, ckpt_every=100,
            install_signal_handlers=True, log=lambda s: None)
        final = loop.run(10)
    finally:
        for sig, h in old.items():
            signal.signal(sig, h)
    assert loop.preempted and int(final["s"]) == 3
    assert cm.available_steps() == [3]
    resumed = FaultTolerantLoop(
        step_fn=lambda s, b: ({"s": s["s"] + 1}, {"loss": 1.0}),
        state={"s": torch.zeros((), dtype=torch.int32)}, pipeline=pipe,
        ckpt=cm, ckpt_every=100, log=lambda s: None)
    resumed.restore_latest()
    assert resumed.step == 3 and pipe.state()["step"] == 3
    assert int(resumed.run(5)["s"]) == 5
    pipe.close()


def test_straggler_monitor():
    mon = StragglerMonitor(threshold=2.0, warmup=2)
    for _ in range(5):
        assert not mon.record(0.1)
    assert mon.record(0.5)  # 5x EMA
    assert mon.flagged == 1
    assert mon.ema == pytest.approx(0.1, rel=0.05)  # outlier not folded in


def test_elastic_mesh():
    assert elastic_mesh_shape(512, model_parallel=16) == (32, 16)
    assert elastic_mesh_shape(400, model_parallel=16) == (16, 16)
    assert elastic_mesh_shape(100, model_parallel=16) == (4, 16)
    with pytest.raises(ValueError):
        elastic_mesh_shape(8, model_parallel=16)
