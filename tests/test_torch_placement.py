"""The training state placed by the reference's plan, on the CPU: every
process holds, at rest, exactly its block of every parameter and AdamW
moment under ``launch.params.param_plan`` (ZeRO over the data axes,
column-parallel attention and MLP on the model axis), gathers each
layer's weights before it runs and reduce-scatters their gradients.

  * placement == the reference's: for every arch at ``reduced()``, on a
    2 x 2 and a pod 2 x data 2 x model 2 mesh (abstract groups, no
    process started), each leaf's block shape of the parameters and both
    moments equals the reference's ``param_shardings(mesh,
    abstract).shard_shape`` on its 8-CPU-device mesh (computed in a
    fresh interpreter with 8 forced host devices), its dtype the
    reference's leaf's, so a rank's bytes at rest are the reference
    device's; and in a spawned world-4 group (2 x 2) each rank's block of
    reduced qwen3-4b's and olmoe's ``init_lm`` equals the whole leaf
    sliced at the reference's ``devices_indices_map`` for the device at
    the rank's mesh coordinates;
  * ``collectives.reduce_scatter`` equals ``all_reduce``'s block bit for
    bit at worlds 2 and 4 (fp32 and bf16, dims 0 and 1), and logs its
    own kind in ``WIRE``;
  * the FSDP step (2 x 1, 4 x 1; reduced qwen3-4b at fp32 compute and
    the naive attention, tests/test_torch_data_parallel.py's setting)
    without clipping equals the data-parallel step of whole replicated
    state (every gradient all-reduced over the data axis) bit for bit on
    every leaf of the gathered state and on the loss; with clipping on
    it is within that file's bars of the one-device step: loss 1e-5,
    first-step moments 1e-5 of each leaf's largest, parameters 1e-4;
  * the column-parallel step (reduced qwen3-4b, and olmoe at capacity
    factor E / k, at 1 x 2 and 2 x 2) against the one-device step: loss
    1e-3, first-step moments 2e-2 of each leaf's largest;
  * every other family (the hybrid's shared block, Whisper's and the
    vlm's cross-attention, the Mamba channels, qwen2-7b, kimi-k2) at fp32
    compute with the naive attention and remat, one step on 2 x 2 and on
    1 x 4 (the heads gathered: M does not divide KVH) against the
    one-device step: loss 1e-5, gradient norm 1e-4 relative;
  * the compressed step at pod 2 x data 2 (FSDP over ``data`` only, the
    parameters pod-replicated) against the one-device plain step at the
    reference's bars (tests/test_launch.py): |loss difference| < 0.05,
    parameters within 1e-3;
  * ``launch/train.py --mesh 1x2`` restarted from its step-3 checkpoints
    equals a straight 6-step run, every leaf of each process's shard bit
    for bit, the two shards holding different blocks;
  * ``roofline.collective_bytes`` equals what ``WIRE`` logged for every
    arch at ``reduced()`` with remat, on abstract meshes (rank 0's step
    on ``meta``): train, prefill and the compressed step on pod 2 x data
    2 x model 2, train on 1 x 4 - every gather, reduce-scatter and
    model-axis sum of the placement counted;
  * the dry run's state a device under the held layout equals the
    plan's, for every assigned arch on both production meshes.

Each world spawns one group that runs every check and saves what it
saw; the one-device runs and the reference's placement run in the test
process and its subprocess meanwhile.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.launch.steps import (TrainHyper, init_train_state,
                                      make_train_step)
from repro_torch.models.model_zoo import build
from repro_torch.optim.adamw import tree_leaves

torch.set_num_threads(1)

WORLDS = (2, 4)
SPAWN_TIMEOUT_S = 300
STEPS = 2
BATCH, SEQ = 8, 32
HYPER = dict(peak_lr=1e-3)
COL_MESH = {2: (1, 2), 4: (2, 2)}          # world -> (data, model)
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
CLI = ("--arch", "qwen3-4b", "--reduced", "--batch", "4", "--seq", "16",
       "--warmup", "2", "--ckpt-every", "3", "--log-every", "1",
       "--device", "cpu", "--mesh", "1x2")


def _qwen3_fp32():
    """Reduced qwen3-4b at fp32 compute with the naive attention (see
    tests/test_torch_data_parallel.py)."""
    cfg = get_config("qwen3-4b").reduced()
    return dataclasses.replace(cfg, compute_dtype="float32",
                               attention=dataclasses.replace(
                                   cfg.attention, impl="naive"))


def _olmoe():
    cfg = get_config("olmoe-1b-7b").reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


COL_CFGS = {"qwen3": lambda: get_config("qwen3-4b").reduced(),
            "olmoe": _olmoe}
FAMILY_ARCHS = ("zamba2-1.2b", "whisper-large-v3", "llama-3.2-vision-90b",
                "falcon-mamba-7b", "qwen2-7b", "kimi-k2-1t-a32b")
FAMILY_MESHES = {"2x2": (2, 2), "1x4": (1, 4)}


def _family_cfg(arch):
    """``arch`` at ``reduced()``, fp32 compute, the naive attention,
    remat on, a moe at capacity factor E / k."""
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, compute_dtype="float32", remat=True,
                              attention=dataclasses.replace(
                                  cfg.attention, impl="naive"))
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    return cfg


def _family_batch(bundle, index=0, count=1):
    """Slice ``index`` of ``count`` of a batch of 4 rows of 16 tokens and
    the family's extra inputs, drawn from seed 0."""
    rng = np.random.default_rng(0)
    out = {}
    for name, (shape, _) in bundle.train_inputs(4, 16).items():
        out[name] = torch.from_numpy(
            rng.integers(0, bundle.cfg.vocab_size, shape).astype(np.int32)
            if name == "tokens" else
            rng.normal(size=shape).astype(np.float32))
    return {k: _local(v, index, count) for k, v in out.items()}


def _family_step(arch, mesh=None):
    """(loss, gradient norm) of one train step of ``_family_cfg(arch)``
    from seed 0, on this process's slice of the batch under ``mesh``."""
    from repro_torch.launch.sharding import set_mesh

    bundle = build(_family_cfg(arch))
    state = init_train_state(bundle, torch.Generator().manual_seed(0), "cpu",
                             mesh=mesh)
    n = 1 if mesh is None else mesh.axis_size(mesh.dp_axes())
    batch = _family_batch(bundle, 0 if mesh is None else mesh.dp_rank(), n)
    set_mesh(mesh)
    try:
        _, m = make_train_step(bundle, TrainHyper())(state, batch)
    finally:
        set_mesh(None)
    return float(m["loss"]), float(m["grad_norm"])


def _batch(cfg, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)


def _local(batch, index, count):
    rows = batch.shape[0] // count
    return batch[index * rows:(index + 1) * rows]


def _flat(tree, prefix=""):
    return {f"{prefix}{'/'.join(p)}": x for p, x in _walk(tree)}


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    else:
        yield path, tree


def _state_bytes(state):
    """Bytes of the parameters and both moments."""
    opt = state["opt"]
    return sum(x.numel() * x.element_size() for t in (
        state["params"], opt.mu, opt.nu) for x in tree_leaves(t))


def _state_numpy(state):
    out = {}
    for name in ("params", "mu", "nu"):
        tree = state["params"] if name == "params" else getattr(
            state["opt"], name)
        for i, x in enumerate(tree_leaves(tree)):
            out[f"{name}/{i}"] = x.detach().float().numpy().copy()
    return out


def _run_steps(step_fn, state, batches, whole=lambda s: s):
    """Each batch through ``step_fn``: (losses, grad norms, the whole
    state after the first step, the whole state at the end)."""
    losses, norms, first = [], [], None
    for b in batches:
        state, m = step_fn(state, {"tokens": torch.from_numpy(b)})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if first is None:
            first = _state_numpy(whole(state))
    return losses, norms, first, _state_numpy(whole(state))


# ------------------------------------------------------------ the ranks --

def _gather_whole(state, cfg, mesh):
    """The whole state from every process's blocks (plain gathers along
    each split dim over its axes' group)."""
    from repro_torch.core.collectives import all_gather
    from repro_torch.models.convert import shard_dim
    from repro_torch.optim import AdamWState

    def tree(t):
        out = {}
        for path, x in _walk(t):
            for dim, axes in enumerate(shard_dim(path, cfg, mesh)):
                if axes:
                    x = all_gather(x.detach(), dim, mesh.axis_group(axes))
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = x
        return out

    opt = state["opt"]
    return {"params": tree(state["params"]),
            "opt": AdamWState(step=opt.step, mu=tree(opt.mu),
                              nu=tree(opt.nu))}


def _data_parallel_step(bundle, hyper):
    """The data-parallel step of whole replicated state: the model run
    with no mesh on this process's batch slice, every gradient summed
    over the data axes in rank order and averaged, AdamW on the whole
    leaves."""
    from repro_torch.launch import steps as S
    from repro_torch.launch.sharding import get_mesh, set_mesh

    grads_of = S._grads_fn(bundle, hyper)

    def step(state, batch):
        mesh = get_mesh()
        params, opt = state["params"], state["opt"]
        leaves = S._leaves_for_grad(params)
        set_mesh(None)
        try:
            loss, grads = grads_of(params, leaves,
                                   S.batch_to_device(batch, "cpu"))
        finally:
            set_mesh(mesh)
        loss, grads = S._group_mean(loss, grads, mesh, mesh.dp_axes())
        params, opt, m = S._apply(hyper, params, opt, grads, None)
        return {"params": params, "opt": opt}, {"loss": loss, **m}

    return step


def _reduce_scatter_checks(world):
    from repro_torch.core.collectives import (WIRE, all_reduce, group_rank,
                                              reduce_scatter)

    me = group_rank()
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(np.random.default_rng(me).normal(
            size=(4 * world, 2 * world, 3)).astype(np.float32)).to(dt)
        for dim in (0, 1):
            WIRE.reset()
            got = reduce_scatter(x, dim)
            wire = WIRE.totals()
            n = x.shape[dim] // world
            want = all_reduce(x, "sum").narrow(dim, me * n, n)
            out[(str(dt), dim)] = (got.float().numpy(), want.float().numpy(),
                                   wire, got.dtype == dt)
    return out


def _rank_checks(rank, world, tmp):
    from repro_torch.core.collectives import WIRE
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.launch.sharding import set_mesh
    from repro_torch.launch.steps import make_compressed_train_step
    from repro_torch.models.convert import init_lm, shard_params

    out = {"rs": _reduce_scatter_checks(world)}
    gen = lambda: torch.Generator().manual_seed(0)

    # FSDP: world x 1, without clipping against the data-parallel step of
    # whole state, and with clipping
    fcfg = _qwen3_fp32()
    fbundle = build(fcfg)
    batches = [_batch(fcfg, s) for s in range(STEPS)]
    mesh = make_train_mesh((world, 1), ("data", "model"), devices="cpu")
    local = [_local(b, mesh.dp_rank(), world) for b in batches]
    whole = lambda s: _gather_whole(s, fcfg, mesh)
    set_mesh(mesh)
    try:
        for name, clip in (("fsdp", None), ("fsdp_clip", 1.0)):
            hyper = TrainHyper(**HYPER, max_grad_norm=clip)
            state = init_train_state(fbundle, gen(), "cpu", mesh=mesh)
            out[f"{name}_bytes"] = _state_bytes(state)
            WIRE.reset()
            out[name] = _run_steps(make_train_step(fbundle, hyper), state,
                                   local, whole)
            out[f"{name}_wire"] = WIRE.totals()
        state = init_train_state(fbundle, gen(), "cpu")
        out["dp"] = _run_steps(
            _data_parallel_step(fbundle, TrainHyper(**HYPER,
                                                    max_grad_norm=None)),
            state, local)
    finally:
        set_mesh(None)

    # column-parallel on the model axis (and FSDP over data at world 4)
    d, m = COL_MESH[world]
    mesh = make_train_mesh((d, m), ("data", "model"), devices="cpu")
    set_mesh(mesh)
    try:
        for name, make in COL_CFGS.items():
            cfg = make()
            bundle = build(cfg)
            state = init_train_state(bundle, gen(), "cpu", mesh=mesh)
            WIRE.reset()
            out[f"col_{name}"] = _run_steps(
                make_train_step(bundle, TrainHyper(**HYPER)), state,
                [_local(_batch(cfg, 9 + s), mesh.dp_rank(), d)
                 for s in range(STEPS)],
                lambda s: _gather_whole(s, cfg, mesh))
            out[f"col_{name}_wire"] = WIRE.totals()
    finally:
        set_mesh(None)
    out["coords"] = dict(mesh.coords)

    if world == 4:
        # every other family on 2 x 2 and 1 x 4
        out["families"] = {}
        for mname, shape in FAMILY_MESHES.items():
            fmesh = make_train_mesh(shape, ("data", "model"), devices="cpu")
            for arch in FAMILY_ARCHS:
                out["families"][mname, arch] = _family_step(arch, fmesh)
        # the blocks of init_lm on the 2 x 2 mesh
        out["blocks"] = {}
        for name, make in COL_CFGS.items():
            cfg = make()
            lm = init_lm(cfg, gen(), "cpu", dtype=cfg.torch_param_dtype())
            out["blocks"][name] = {k: v.numpy() for k, v in
                                   _flat(shard_params(lm, mesh)).items()}
        # compressed: pod 2 x data 2, FSDP over data only
        cfg = get_config("qwen3-4b").reduced()
        bundle = build(cfg)
        mesh = make_train_mesh((2, 2, 1), ("pod", "data", "model"),
                               devices="cpu")
        step = make_compressed_train_step(bundle, TrainHyper(**HYPER), mesh)
        state = init_train_state(bundle, gen(), "cpu", mesh=step.mesh)
        state["comp"] = step.init_comp(state["params"])
        out["comp_shapes"] = {k: tuple(v.shape)
                              for k, v in _flat(state["params"]).items()}
        out["comp"] = _run_steps(
            step, state, [_local(_batch(cfg, s), mesh.dp_rank(), 4)
                          for s in range(STEPS)],
            lambda s: _gather_whole(s, cfg, step.mesh))

    if world == 2:
        # the CLI across two processes on the model axis: restart == straight
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
    return out


def _rank_main(rank, world, store, out_dir):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        torch.save(_rank_checks(rank, world, out_dir),
                   f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# ------------------------------------------- the reference's placement --

def _reference_placement(out_path):
    """Run in an interpreter with 8 forced host devices: per arch at
    ``reduced()`` and per mesh, each parameter leaf's dtype, whole shape,
    ``shard_shape`` and, on the 2 x 2 mesh, the indices of the block of
    the device at each mesh coordinate."""
    from jax.sharding import Mesh

    from repro.configs import get_config as ref_config
    from repro.launch.params import param_shardings
    from repro.models.model_zoo import build as ref_build

    devs = np.array(jax.devices()[:8], dtype=object)
    meshes = {name: Mesh(devs[:int(np.prod(shape))].reshape(shape), axes)
              for name, (shape, axes) in MESHES.items()}
    out = {}
    for arch in ALL_ARCHS:
        bundle = ref_build(ref_config(arch).reduced())
        abstract = jax.eval_shape(lambda: bundle.init(jax.random.PRNGKey(0)))
        flat, _ = jax.tree_util.tree_flatten_with_path(abstract)
        names = ["/".join(str(getattr(p, "key", p)) for p in path)
                 for path, _ in flat]
        rec = {n: {"dtype": str(leaf.dtype), "shape": list(leaf.shape)}
               for n, (_, leaf) in zip(names, flat)}
        for mname, mesh in meshes.items():
            shs = jax.tree_util.tree_leaves(param_shardings(mesh, abstract))
            for n, (_, leaf), sh in zip(names, flat, shs):
                rec[n][mname] = list(sh.shard_shape(leaf.shape))
                if mname != "2x2":
                    continue
                idx = sh.devices_indices_map(leaf.shape)
                rec[n]["blocks"] = {
                    ",".join(map(str, c)): [
                        list(s.indices(dim)[:2])
                        for s, dim in zip(idx[mesh.devices[c]], leaf.shape)]
                    for c in np.ndindex(*mesh.devices.shape)}
        out[arch] = rec
    Path(out_path).write_text(json.dumps(out))


# ---------------------------------------------------- the test process --

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("placement")
    dirs = {w: root / f"world{w}" for w in WORLDS}
    for d in dirs.values():
        d.mkdir()
    ctxs = {w: mp.spawn(_rank_main, nprocs=w, join=False,
                        args=(w, str(dirs[w] / "store"), str(dirs[w])))
            for w in WORLDS}
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [src, str(Path(__file__).parent)]
                   + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    ref_path = root / "reference.json"
    ref = subprocess.Popen(
        [sys.executable, "-c", "import test_torch_placement as t; "
         f"t._reference_placement({str(ref_path)!r})"], env=env)
    # the one-device runs meanwhile
    plain = {}
    hyper = TrainHyper(**HYPER)
    for name, cfg in (("fp32", _qwen3_fp32()),
                      ("bf16", get_config("qwen3-4b").reduced())):
        bundle = build(cfg)
        state = init_train_state(bundle, torch.Generator().manual_seed(0),
                                 "cpu")
        plain[name] = _run_steps(make_train_step(bundle, hyper), state,
                                 [_batch(cfg, s) for s in range(STEPS)])
    for name, make in COL_CFGS.items():
        cfg = make()
        bundle = build(cfg)
        state = init_train_state(bundle, torch.Generator().manual_seed(0),
                                 "cpu")
        plain[f"col_{name}"] = _run_steps(
            make_train_step(bundle, hyper), state,
            [_batch(cfg, 9 + s) for s in range(STEPS)])
    for arch in FAMILY_ARCHS:
        plain[arch] = _family_step(arch)
    out = {}
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    for w, ctx in ctxs.items():
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                ref.kill()
                pytest.fail(f"the world-{w} group ran past "
                            f"{SPAWN_TIMEOUT_S} s")
        out[w] = [torch.load(dirs[w] / f"rank{r}.pt", weights_only=False)
                  for r in range(w)]
    assert ref.wait(timeout=max(deadline - time.monotonic(), 1)) == 0
    return plain, out, json.loads(ref_path.read_text())


@pytest.fixture(scope="module")
def reference(runs):
    return runs[2]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_placement_equals_the_reference(reference, arch):
    """Each leaf's block of the parameters and both moments on an
    abstract 2 x 2 and pod 2 x data 2 x model 2 mesh == the reference's
    shard_shape, at the reference's dtype: a rank's bytes at rest are the
    reference device's."""
    from repro_torch.launch.mesh import make_abstract_mesh

    cfg = get_config(arch).reduced()
    bundle = build(cfg)
    ref = reference[arch]
    whole = _flat(bundle.init(None, "meta", dtype=cfg.torch_param_dtype()))
    assert {k: list(v.shape) for k, v in whole.items()} == {
        k: r["shape"] for k, r in ref.items()}
    od = cfg.torch_optimizer_dtype().itemsize
    for mname, (shape, axes) in MESHES.items():
        state = init_train_state(bundle, None, "meta",
                                 mesh=make_abstract_mesh(shape, axes))
        got = {name: _flat(tree) for name, tree in (
            ("params", state["params"]), ("mu", state["opt"].mu),
            ("nu", state["opt"].nu))}
        want_bytes = 0
        for k, r in ref.items():
            for name in got:
                assert list(got[name][k].shape) == r[mname], (mname, name, k)
            assert str(got["params"][k].dtype).replace("torch.", "") == \
                r["dtype"], k
            n = int(np.prod(r[mname]))
            want_bytes += n * np.dtype(r["dtype"]).itemsize + 2 * n * od
        assert _state_bytes(state) == want_bytes


@pytest.mark.parametrize("name", sorted(COL_CFGS))
def test_blocks_equal_the_reference_devices_indices(runs, name):
    """Each rank of the world-4 group (2 x 2) holds the block of
    init_lm that the reference's devices_indices_map gives the device
    at its mesh coordinates."""
    from repro_torch.models.convert import init_lm

    _, out, reference = runs
    cfg = COL_CFGS[name]()
    arch = "qwen3-4b" if name == "qwen3" else "olmoe-1b-7b"
    whole = {k: v.numpy() for k, v in _flat(init_lm(
        cfg, torch.Generator().manual_seed(0), "cpu",
        dtype=cfg.torch_param_dtype())).items()}
    split = 0
    for r in out[4]:
        c = r["coords"]
        key = f"{c.get('data', 0)},{c.get('model', 0)}"
        for k, block in r["blocks"][name].items():
            sl = tuple(slice(a, b) for a, b in
                       reference[arch][k]["blocks"][key])
            np.testing.assert_array_equal(block, whole[k][sl], err_msg=k)
            split += block.size < whole[k].size
    assert split > 0


@pytest.mark.parametrize("world", WORLDS)
def test_reduce_scatter_equals_all_reduce_block(runs, world):
    for r in runs[1][world]:
        for (dt, dim), (got, want, wire, same_dtype) in r["rs"].items():
            np.testing.assert_array_equal(got, want, err_msg=(dt, dim))
            assert same_dtype
            nbytes = got.size * (2 if "bfloat16" in dt else 4)
            assert wire[("reduce_scatter", dt.replace("torch.", ""))] == {
                "calls": 1, "bytes": nbytes * (world - 1)}


@pytest.mark.parametrize("world", WORLDS)
def test_fsdp_step_equals_data_parallel_step(runs, world):
    plain, out, _ = runs
    ranks = out[world]
    p_loss, _, p_first, p_last = plain["fp32"]
    for r in ranks:
        loss, _, first, last = r["fsdp"]
        d_loss, _, d_first, d_last = r["dp"]
        assert loss == d_loss
        for k in d_last:
            np.testing.assert_array_equal(first[k], d_first[k], err_msg=k)
            np.testing.assert_array_equal(last[k], d_last[k], err_msg=k)
        # gradients reduce-scattered onto the blocks, every leaf gathered
        assert r["fsdp_wire"][("reduce_scatter", "float32")]["calls"] > 0
        # a rank's state at rest: a share of the whole, not all of it
        assert r["fsdp_bytes"] < sum(v.nbytes for v in d_last.values())
        loss, _, first, last = r["fsdp_clip"]
        np.testing.assert_allclose(loss, p_loss, atol=1e-5)
        for k in p_first:
            if k.startswith("mu/"):
                scale = float(np.abs(p_first[k]).max())
                np.testing.assert_allclose(first[k], p_first[k], rtol=0,
                                           atol=1e-5 * scale, err_msg=k)
            np.testing.assert_allclose(last[k], p_last[k], atol=1e-4,
                                       rtol=0, err_msg=k)


@pytest.mark.parametrize("name", sorted(COL_CFGS))
@pytest.mark.parametrize("world", WORLDS)
def test_column_parallel_step_equals_one_device(runs, world, name):
    plain, out, _ = runs
    p_loss, _, p_first, _ = plain[f"col_{name}"]
    for r in out[world]:
        loss, _, first, last = r[f"col_{name}"]
        np.testing.assert_allclose(loss, p_loss, atol=1e-3)
        for k in p_first:
            if k.startswith("mu/"):
                scale = max(float(np.abs(p_first[k]).max()), 1e-12)
                np.testing.assert_allclose(first[k] / scale,
                                           p_first[k] / scale, atol=2e-2,
                                           err_msg=k)
        # the heads' sum over the model group on the compute dtype's wire
        assert r[f"col_{name}_wire"][("all_gather", "bfloat16")]["calls"] > 0
        # every process holds the same whole state
        for k in last:
            np.testing.assert_array_equal(last[k],
                                          out[world][0][f"col_{name}"][3][k])


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_every_family_placed_step_equals_one_device(runs, arch):
    plain, out, _ = runs
    p_loss, p_norm = plain[arch]
    for r in out[4]:
        for mname in FAMILY_MESHES:
            loss, norm = r["families"][mname, arch]
            assert abs(loss - p_loss) <= 1e-5, (mname, loss, p_loss)
            assert abs(norm - p_norm) <= 1e-4 * p_norm, (mname, norm, p_norm)


def test_compressed_step_tracks_plain_step(runs):
    plain, out, _ = runs
    p_loss, _, _, p_last = plain["bf16"]
    for r in out[4]:
        loss, _, _, last = r["comp"]
        assert abs(loss[-1] - p_loss[-1]) < 0.05
        d = max(float(np.abs(last[k] - p_last[k]).max())
                for k in p_last if k.startswith("params/"))
        assert d < 1e-3
        # FSDP over data only: the embedding's D split, its V whole
        assert r["comp_shapes"]["embed"] == (512, 32)


def test_train_cli_mesh_1x2_restart_equals_straight(runs):
    ranks = runs[1][2]
    for r in ranks:
        a, b = r["cli"]["straight"], r["cli"]["resumed"]
        assert sorted(a) == sorted(b) and len(a) > 10
        differ = [k for k in a if a[k] != b[k]]
        assert not differ, differ
    # the two processes hold different blocks of the state
    assert ranks[0]["cli"]["straight"] != ranks[1]["cli"]["straight"]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_collective_bytes_equal_wire_on_meta(arch):
    from repro_torch.core.collectives import WIRE
    from repro_torch.launch import roofline
    from repro_torch.launch.dryrun import _inputs
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.launch.sharding import set_mesh
    from repro_torch.launch.steps import make_compressed_train_step

    cfg = dataclasses.replace(get_config(arch).reduced(), remat=True)
    bundle = build(cfg)
    whole = bundle.init(None, "meta", dtype=cfg.torch_param_dtype())
    cases = [((2, 2, 2), ("pod", "data", "model"), kind)
             for kind in ("train", "prefill", "train_compressed")]
    cases.append(((1, 4), ("data", "model"), "train"))
    for shape, axes, kind in cases:
        mesh = make_abstract_mesh(shape, axes)
        rows = BATCH // mesh.axis_size(mesh.dp_axes())
        inputs = _inputs(bundle, rows, SEQ, "meta")
        step = (make_compressed_train_step(bundle, TrainHyper(), mesh)
                if kind == "train_compressed"
                else make_train_step(bundle, TrainHyper()))
        state = init_train_state(bundle, None, "meta",
                                 mesh=getattr(step, "mesh", mesh))
        if kind == "train_compressed":
            state["comp"] = step.init_comp(state["params"])
        WIRE.reset()
        set_mesh(mesh)
        try:
            if kind == "prefill":
                with torch.no_grad():
                    bundle.loss_fn(state["params"], inputs)
            else:
                step(state, inputs)
        finally:
            set_mesh(None)
        got = {}
        for (op, dt), v in WIRE.totals().items():
            got[(op, dt)] = got.get((op, dt), 0) + v["bytes"]
        want = roofline.collective_bytes(cfg, kind, BATCH, SEQ,
                                         dict(mesh.shape), params=whole)
        assert got == want["by_op"], (shape, kind)
        assert ("all_gather", "float32") in got


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_dry_run_holds_the_plan(arch):
    from repro_torch.launch.dryrun import state_bytes

    cfg = get_config(arch)
    params = build(cfg).init(None, "meta", dtype=cfg.torch_param_dtype())
    for mesh in ({"data": 32, "model": 8},
                 {"pod": 2, "data": 32, "model": 8}):
        sb = state_bytes(cfg, params, mesh)
        assert sb["held"] == sb["plan"], mesh
        assert sb["plan"]["fits_80gb"], mesh
