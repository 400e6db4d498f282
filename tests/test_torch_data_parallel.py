"""Training across processes on the CPU, in gloo process groups: the
int8 error-feedback gradient sync, the data-parallel and compressed
train steps, the model axis inside a whole train step, and the trainer
CLI across two processes.

  * ``compressed_psum`` at world 1 equals the reference's under its
    one-pod ``shard_map`` bit for bit (tests/test_substrate.py's fixture
    and bars, and a tree of three leaves over two rounds of error
    feedback); at worlds 2 and 4 it equals the reference's leaf formula
    (src/repro/optim/compression.py) applied in numpy to the stacked
    per-rank gradients, bit for bit, over two rounds; the residual is the
    quantization error and every leaf crosses as int16, once a round;
  * the data-parallel step (``make_train_step`` under a 2 x 1 and a
    4 x 1 mesh, each rank its slice of the global batch and its block of
    the state placed by the plan, gathered whole to compare) against the
    one-device step on the whole batch, 3 steps of reduced qwen3-4b at
    fp32 compute and the naive attention (see ``_qwen3_fp32``): the
    losses within 1e-5, the first step's moments (the averaged
    gradients) within 1e-5 of each leaf's largest, the parameters within
    1e-4 (Adam moves
    an element by at most lr a step whatever its gradient, so a
    near-zero gradient whose sign rounding flips parts the two runs by
    up to 2 lr: 6e-5 over these steps' lr 0, 1e-5, 2e-5); every leaf's
    state the same bits on every rank;
  * the compressed step at pod 2 (world 2) and pod 2 x data 2 (world 4)
    against the plain step, the reference's bars
    (tests/test_launch.py): 3 steps, |loss difference| < 0.05,
    parameters within 1e-3; and, since at these learning rates those
    bars cannot fail, the first step's gradient norm within 1 % and its
    moments within 5e-2 of each leaf's largest;
  * a whole train step of reduced olmoe-1b-7b (nothing dropped: capacity
    factor E / k) on a 1 x 2 and a 2 x 2 mesh - the expert-parallel
    dispatch and the column-parallel attention inside the model, data
    parallelism around it - against the one-device step: loss within
    1e-3, the first step's moments of every leaf (gathered whole) within
    the bf16 bar of tests/test_torch_moe.py (2e-2); the whole state the
    same bits on every rank;
  * ``launch/train.py --mesh 2x1``: a run restarted from its step-3
    checkpoints equals a straight 6-step run, every leaf of every
    process's shard bit for bit; the two shards hold different blocks.

Each world size spawns one group; the one-device runs they are held to
run in this process meanwhile.  The spawned ranks import this module and
need torch alone, so the reference is imported inside the functions of
the test process.
"""

import dataclasses
import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.launch.steps import (TrainHyper, init_train_state,
                                      make_train_step)
from repro_torch.models.model_zoo import build
from repro_torch.optim.adamw import tree_leaves

torch.set_num_threads(1)

WORLDS = (2, 4)
SPAWN_TIMEOUT_S = 300
STEPS = 3
BATCH, SEQ = 8, 32
HYPER = dict(peak_lr=1e-3)
EP_MESH = {2: (1, 2), 4: (2, 2)}          # world -> (data, model)
COMP_MESH = {2: (2, 1, 1), 4: (2, 2, 1)}  # world -> (pod, data, model)
CLI = ("--arch", "qwen3-4b", "--reduced", "--batch", "4", "--seq", "16",
       "--warmup", "2", "--ckpt-every", "3", "--log-every", "1",
       "--device", "cpu", "--mesh", "2x1")


def _grad_trees(n, rounds=2):
    """Per-rank gradient trees for ``rounds`` rounds: (round, rank) ->
    {name: float32 array}."""
    rng = np.random.default_rng(7)
    base = {"w": np.linspace(-1.0, 1.0, 64, dtype=np.float32).reshape(8, 8)}
    out = {}
    for t in range(rounds):
        for r in range(n):
            out[t, r] = {
                "w": base["w"] * np.float32(1 + 0.1 * r + 0.01 * t),
                "b": rng.normal(size=(5,)).astype(np.float32),
                "m": (rng.normal(size=(3, 4, 6)) * 1e-3).astype(np.float32),
            }
    return out


def _batch(cfg, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)


def _qwen3_fp32():
    """Reduced qwen3-4b at fp32 compute with the naive attention: the
    data-parallel step's bars are fp32 rounding's.  (A split batch sums
    each weight's gradient over other rows; at bf16 compute, or through
    the PASA attention, whose shift recovery amplifies rounding and whose
    q / k gradients are small residuals of cancellation, that moves a
    first-step moment by up to ~1 %.)"""
    cfg = get_config("qwen3-4b").reduced()
    return dataclasses.replace(cfg, compute_dtype="float32",
                               attention=dataclasses.replace(
                                   cfg.attention, impl="naive"))


def _olmoe():
    cfg = get_config("olmoe-1b-7b").reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def _state_numpy(state):
    """{key: array} of the params and moments (sorted leaf order)."""
    out = {}
    for name in ("params", "mu", "nu"):
        tree = state["params"] if name == "params" else getattr(
            state["opt"], name)
        for i, x in enumerate(tree_leaves(tree)):
            out[f"{name}/{i}"] = x.detach().float().numpy().copy()
    return out


def _run_steps(bundle, step_fn, state, batches, mesh=None):
    """Each batch through ``step_fn``: (losses, grad norms, the state
    after the first step, the state at the end), the state gathered
    whole from the blocks placed on ``mesh``."""
    losses, norms, first = [], [], None
    for b in batches:
        state, m = step_fn(state, {"tokens": torch.from_numpy(b)})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if first is None:
            first = _state_numpy(_whole(state, bundle.cfg, mesh))
    return losses, norms, first, _state_numpy(_whole(state, bundle.cfg,
                                                     mesh))


def _whole(state, cfg, mesh):
    """The whole state from every process's blocks on ``mesh`` (plain
    gathers along each split dim over its axes' group; None: as it
    is)."""
    from repro_torch.core.collectives import all_gather
    from repro_torch.models.convert import shard_dim
    from repro_torch.optim import AdamWState

    if mesh is None:
        return state

    def tree(t, path=()):
        if isinstance(t, dict):
            return {k: tree(v, path + (k,)) for k, v in t.items()}
        for dim, axes in enumerate(shard_dim(path, cfg, mesh)):
            if axes:
                t = all_gather(t.detach(), dim, mesh.axis_group(axes))
        return t

    opt = state["opt"]
    return {"params": tree(state["params"]),
            "opt": AdamWState(step=opt.step, mu=tree(opt.mu),
                              nu=tree(opt.nu))}


def _local(batch, index, count):
    rows = batch.shape[0] // count
    return batch[index * rows:(index + 1) * rows]


# ------------------------------------------------------------ the ranks --

def _rank_checks(rank, world, tmp, grads):
    from repro_torch.core.collectives import WIRE
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.launch.sharding import set_mesh
    from repro_torch.launch.steps import make_compressed_train_step
    from repro_torch.optim import compressed_psum, compression_init

    out = {}
    # compressed_psum over the default group, two rounds
    st = None
    for t in range(2):
        g = {k: torch.from_numpy(v.copy()) for k, v in
             grads[t, rank].items()}
        st = st or compression_init(g)
        WIRE.reset()
        avg, st = compressed_psum(g, st)
        res = st.residual
        out[f"psum{t}"] = {k: v.numpy().copy() for k, v in avg.items()}
        out[f"res{t}"] = {k: v.numpy().copy() for k, v in res.items()}
        out[f"wire{t}"] = list(WIRE.entries)

    cfg = get_config("qwen3-4b").reduced()
    bundle = build(cfg)
    batches = [_batch(cfg, s) for s in range(STEPS)]
    hyper = TrainHyper(**HYPER)

    # data parallel: world x 1
    mesh = make_train_mesh((world, 1), ("data", "model"), devices="cpu")
    set_mesh(mesh)
    fbundle = build(_qwen3_fp32())
    state = init_train_state(fbundle, torch.Generator().manual_seed(0),
                             "cpu", mesh=mesh)
    out["dp"] = _run_steps(fbundle, make_train_step(fbundle, hyper), state,
                           [_local(b, mesh.dp_rank(), world)
                            for b in batches], mesh)
    set_mesh(None)

    # compressed: pods (x data within a pod)
    shape = COMP_MESH[world]
    mesh = make_train_mesh(shape, ("pod", "data", "model"), devices="cpu")
    step = make_compressed_train_step(bundle, hyper, mesh)
    state = init_train_state(bundle, torch.Generator().manual_seed(0), "cpu",
                             mesh=step.mesh)
    state["comp"] = step.init_comp(state["params"])
    WIRE.reset()
    out["comp"] = _run_steps(bundle, step, state,
                             [_local(b, mesh.dp_rank(), shape[0] * shape[1])
                              for b in batches], step.mesh)
    out["comp_wire"] = list(WIRE.entries)
    out["n_leaves"] = len(tree_leaves(state["params"]))

    # the model axis inside a whole step (olmoe, experts and w2 split)
    d, m = EP_MESH[world]
    mesh = make_train_mesh((d, m), ("data", "model"), devices="cpu")
    ocfg = _olmoe()
    obundle = build(ocfg)
    set_mesh(mesh)
    state = init_train_state(obundle, torch.Generator().manual_seed(0),
                             "cpu", mesh=mesh)
    WIRE.reset()
    out["ep"] = _run_steps(obundle, make_train_step(obundle, hyper), state,
                           [_local(_batch(ocfg, 9), mesh.dp_rank(), d)],
                           mesh)
    out["ep_wire"] = WIRE.totals()
    set_mesh(None)
    out["coords"] = dict(mesh.coords)

    # the CLI across two processes: restart == straight
    if world == 2:
        a, b = Path(tmp) / "straight", Path(tmp) / "resumed"
        train.main([*CLI, "--steps", "6", "--ckpt-dir", str(a)])
        dist.barrier()
        if rank == 0:
            b.mkdir()
            shutil.copytree(a / "step_0000000003", b / "step_0000000003")
        dist.barrier()
        train.main([*CLI, "--steps", "6", "--ckpt-dir", str(b)])
        dist.barrier()
        out["cli"] = {}
        for d_ in (a, b):
            shard = d_ / "step_0000000006" / f"shard_{rank:05d}"
            man = json.loads((shard / "manifest.json").read_text())
            out["cli"][d_.name] = {
                k: np.load(shard / e["file"]).tobytes()
                for k, e in man["leaves"].items()}
        out["cli_shards"] = sorted(
            p.name for p in (a / "step_0000000006").iterdir())
    return out


def _rank_main(rank, world, store, out_dir, grads):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        torch.save(_rank_checks(rank, world, out_dir, grads),
                   f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------- the test process --

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    grads = {w: _grad_trees(w) for w in WORLDS}
    dirs = {w: tmp_path_factory.mktemp(f"world{w}") for w in WORLDS}
    ctxs = {w: mp.spawn(_rank_main, nprocs=w, join=False,
                        args=(w, str(dirs[w] / "store"), str(dirs[w]),
                              grads[w]))
            for w in WORLDS}
    # the one-device runs meanwhile
    plain = {}
    for name, cfg in (("bf16", get_config("qwen3-4b").reduced()),
                      ("fp32", _qwen3_fp32())):
        bundle = build(cfg)
        state = init_train_state(bundle, torch.Generator().manual_seed(0),
                                 "cpu")
        plain[name] = _run_steps(
            bundle, make_train_step(bundle, TrainHyper(**HYPER)), state,
            [_batch(cfg, s) for s in range(STEPS)])
    ocfg = _olmoe()
    obundle = build(ocfg)
    state = init_train_state(obundle, torch.Generator().manual_seed(0),
                             "cpu")
    olmoe = _run_steps(obundle, make_train_step(obundle,
                                                TrainHyper(**HYPER)),
                       state, [_batch(ocfg, 9)])
    out = {}
    for w, ctx in ctxs.items():
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"the world-{w} group ran past "
                            f"{SPAWN_TIMEOUT_S} s")
        out[w] = [torch.load(dirs[w] / f"rank{r}.pt", weights_only=False)
                  for r in range(w)]
    return grads, plain, olmoe, out


def test_compressed_psum_one_pod_equals_reference():
    """World 1: the reference's test_compressed_psum_error_feedback
    fixture and bars, and two rounds of a three-leaf tree, bit for bit
    against the reference under its one-pod shard_map."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import make_mesh, shard_map
    from repro.optim.compression import CompressionState as RefState
    from repro.optim.compression import compressed_psum as ref_psum
    from repro.optim.compression import compression_init as ref_init
    from repro_torch.optim import compressed_psum, compression_init

    mesh = make_mesh((1,), ("pod",))

    def f(grads, res):
        out, new = ref_psum(grads, RefState(residual=res), "pod")
        return out, new.residual

    fm = shard_map(f, mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()),
                   check_vma=False)
    g = {"w": jnp.linspace(-1.0, 1.0, 64).reshape(8, 8)}
    out, resid = fm(g, ref_init(g).residual)
    np.testing.assert_allclose(np.asarray(out["w"]), np.asarray(g["w"]),
                               atol=2.0 / 127)
    np.testing.assert_allclose(np.asarray(resid["w"]),
                               np.asarray(g["w"] - out["w"]), atol=1e-6)
    tg = {"w": torch.from_numpy(np.array(g["w"]))}
    got, st = compressed_psum(tg, compression_init(tg))
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(out["w"]))
    np.testing.assert_array_equal(st.residual["w"].numpy(),
                                  np.asarray(resid["w"]))

    trees = _grad_trees(1)
    ref_res = ref_init({k: jnp.asarray(v) for k, v in trees[0, 0].items()})
    ref_res = ref_res.residual
    st = compression_init({k: torch.from_numpy(v)
                           for k, v in trees[0, 0].items()})
    for t in range(2):
        rg = {k: jnp.asarray(v) for k, v in trees[t, 0].items()}
        r_out, ref_res = fm(rg, ref_res)
        p_out, st = compressed_psum(
            {k: torch.from_numpy(v.copy()) for k, v in trees[t, 0].items()},
            st)
        for k in rg:
            np.testing.assert_array_equal(p_out[k].numpy(),
                                          np.asarray(r_out[k]))
            np.testing.assert_array_equal(st.residual[k].numpy(),
                                          np.asarray(ref_res[k]))


def _formula(gs, rs):
    """The reference's leaf formula in numpy over the ranks' stacked
    gradients gs and residuals rs (n, ...): (averaged, new residuals)."""
    n = gs.shape[0]
    gf = gs.astype(np.float32) + rs
    amax = np.float32(np.abs(gf).max())
    scale = amax / np.float32(127.0) + np.float32(1e-12)
    q = np.clip(np.round(gf / scale), -127, 127)
    summed = q.astype(np.int16).sum(axis=0, dtype=np.int16)
    deq = summed.astype(np.float32) * scale / np.float32(n)
    return deq, gf - q * scale


@pytest.mark.parametrize("world", WORLDS)
def test_compressed_psum_equals_reference_formula(runs, world):
    grads, _, _, out = runs
    grads, ranks = grads[world], out[world]
    res = {k: np.zeros((world,) + v.shape, np.float32)
           for k, v in grads[0, 0].items()}
    for t in range(2):
        for k in grads[0, 0]:
            gs = np.stack([grads[t, r][k] for r in range(world)])
            want, res[k] = _formula(gs, res[k])
            for r in range(world):
                np.testing.assert_array_equal(ranks[r][f"psum{t}"][k], want)
                # the residual: this rank's quantization error
                np.testing.assert_array_equal(ranks[r][f"res{t}"][k],
                                              res[k][r])
        for r in range(world):
            int16 = [e for e in ranks[r][f"wire{t}"] if e[1] == "int16"]
            assert [(op, n) for op, _, n in int16] == [
                ("all_gather", 2 * grads[t, r][k].size)
                for k in sorted(grads[t, r])]


@pytest.mark.parametrize("world", WORLDS)
def test_data_parallel_step_equals_one_device(runs, world):
    _, plain, _, out = runs
    p_loss, p_norm, p_first, p_last = plain["fp32"]
    ranks = out[world]
    for r in ranks:
        loss, norm, first, last = r["dp"]
        np.testing.assert_allclose(loss, p_loss, atol=1e-5)
        np.testing.assert_allclose(norm, p_norm, rtol=1e-5)
        for k in p_first:
            if k.startswith("mu/"):
                scale = float(np.abs(p_first[k]).max())
                np.testing.assert_allclose(first[k], p_first[k], rtol=0,
                                           atol=1e-5 * scale, err_msg=k)
            np.testing.assert_allclose(last[k], p_last[k], atol=1e-4,
                                       rtol=0, err_msg=k)
            # the same bits on every rank
            np.testing.assert_array_equal(last[k], ranks[0]["dp"][3][k])


@pytest.mark.parametrize("world", WORLDS)
def test_compressed_step_tracks_plain_step(runs, world):
    _, plain, _, out = runs
    p_loss, _, _, p_last = plain["bf16"]
    _, p_norm, p_first, _ = plain["bf16"]
    for r in out[world]:
        loss, norm, first, last = r["comp"]
        assert abs(loss[-1] - p_loss[-1]) < 0.05
        # the first step, from one state on one global batch: the synced
        # gradient's norm and the first moments (0.1 x the clipped
        # averaged gradient) hold what the loss and the parameters cannot
        # see at these learning rates - a sum not divided by the ranks
        # (norm off by 100 %), a rank's slice left out (moments off by
        # ~100 % of a leaf's largest); quantization and bf16 rounding of
        # the split batch move them by 3e-4 and 1.3e-2
        assert abs(norm[0] - p_norm[0]) <= 1e-2 * p_norm[0]
        for k in p_first:
            if k.startswith("mu/"):
                scale = float(np.abs(p_first[k]).max())
                np.testing.assert_allclose(first[k] / scale,
                                           p_first[k] / scale, atol=5e-2,
                                           err_msg=k)
        d = max(float(np.abs(last[k] - p_last[k]).max())
                for k in p_last if k.startswith("params/"))
        assert d < 1e-3
        # every parameter leaf crosses the pods as int16, once a step
        int16 = [e for e in r["comp_wire"] if e[1] == "int16"]
        assert len(int16) == r["n_leaves"] * STEPS
        np.testing.assert_array_equal(last["params/0"],
                                      out[world][0]["comp"][3]["params/0"])


@pytest.mark.parametrize("world", WORLDS)
def test_model_axis_train_step_equals_one_device(runs, world):
    _, _, olmoe, out = runs
    p_loss, _, p_first, _ = olmoe
    ranks = out[world]
    for r in ranks:
        wire = r["ep_wire"]
        assert wire[("all_to_all", "bfloat16")]["calls"] > 0   # a2a taken
        assert wire[("all_gather", "bfloat16")]["calls"] > 0   # heads' sum
        np.testing.assert_allclose(r["ep"][0], p_loss, atol=1e-3)
    for k, want in p_first.items():
        if not k.startswith("mu/"):
            continue
        got = ranks[0]["ep"][2][k]
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(got / scale, want / scale, atol=2e-2,
                                   err_msg=k)
    # the whole state gathered from the blocks: the same bits on every
    # rank
    for k in p_first:
        for r in ranks:
            np.testing.assert_array_equal(r["ep"][3][k], ranks[0]["ep"][3][k],
                                          err_msg=k)


def test_train_cli_mesh_2x1_restart_equals_straight(runs):
    _, _, _, out = runs
    ranks = out[2]
    assert ranks[0]["cli_shards"] == ["shard_00000", "shard_00001"]
    for r in ranks:
        a, b = r["cli"]["straight"], r["cli"]["resumed"]
        assert sorted(a) == sorted(b) and len(a) > 10
        differ = [k for k in a if a[k] != b[k]]
        assert not differ, differ
    # the two processes hold their own blocks of the state (ZeRO over
    # the data axis), of one tree
    a, b = ranks[0]["cli"]["straight"], ranks[1]["cli"]["straight"]
    assert sorted(a) == sorted(b) and a != b


def test_checkpoint_shards_of_two_processes(tmp_path):
    """The multi-host layout: each process writes its own
    ``shard_%05d`` (with its manifest) into the step; a step is
    available once every shard is in place; each restores its own; the
    newest ``keep`` shards of each process stay, each process removing
    its own."""
    from repro_torch.checkpoint import CheckpointManager

    mgrs = [CheckpointManager(str(tmp_path), keep=2, process_index=i,
                              process_count=2) for i in range(2)]
    state = [{"w": torch.full((3,), float(i)), "s": torch.tensor(i)}
             for i in range(2)]
    mgrs[0].save(1, state[0], blocking=True)
    assert mgrs[0].available_steps() == mgrs[1].available_steps() == []
    mgrs[1].save(1, state[1], blocking=True)
    assert mgrs[0].available_steps() == [1]
    assert sorted(p.name for p in (tmp_path / "step_0000000001").iterdir()) \
        == ["shard_00000", "shard_00001"]
    for i, m in enumerate(mgrs):
        tmpl = {"w": torch.zeros(3), "s": torch.tensor(0)}
        step, got = m.restore(tmpl)
        assert step == 1 and torch.equal(got["w"], state[i]["w"])
        assert got["w"] is tmpl["w"]                       # in place
    for step in (2, 3):
        for i, m in enumerate(mgrs):
            m.save(step, state[i], blocking=True)
    assert mgrs[1].available_steps() == [2, 3]
    assert not (tmp_path / "step_0000000001").exists()
    mgrs[0].save(4, state[0], blocking=True)       # the other lags a step
    assert mgrs[1].available_steps() == [3]
