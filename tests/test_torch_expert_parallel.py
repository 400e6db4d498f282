"""The model axis of training across processes: the expert-parallel
``moe_ffn_a2a`` and ``row_parallel_matmul``, in gloo process groups on
the CPU, against the reference.

The port's counterparts of the reference's
``test_moe_a2a_equals_gspmd_dispatch`` and ``test_row_parallel_matmul``
(tests/test_launch.py, whose suite runs only under forced host devices),
at their own fixtures and bars, at world 2 (a 1 x 2 data x model mesh)
and world 4 (2 x 2, the reference's ``mesh4``):

  * the switch in ``moe_ffn`` takes the a2a dispatch (two ``all_to_all``
    forward, and back) and its output equals the reference's
    ``moe_ffn_gspmd`` at atol 1e-5; the gradients of sum(out^2) of
    ``w1`` / ``w2`` / ``w3`` (each rank's E / M experts, gathered) and of
    the replicated ``router`` (the same bits on every model rank) at
    1e-4;
  * inside a manual region (the sharded serving step) and without a mesh
    the switch keeps the one-device dispatch, with no collective; a rank
    holding E / M experts whose call cannot split raises;
  * ``row_parallel_matmul`` (each rank K / M rows of w) equals x @ w at
    atol 1e-4, its weight gradient at 5e-4;
  * ``models.convert.shard_params`` gives each rank its block of every
    leaf of the reference's ``init_lm`` parameters under the plan
    (``launch.params.param_plan``: the experts on E over the model axis
    and on D over the data axis, the router, the attention and the
    embeddings as the plan splits them).

Each world size spawns one group (``torch.multiprocessing`` with a
``file://`` store under the test's temporary directory) that runs every
check and saves what it saw; the tests read it.  The spawned ranks
import this module and need torch alone, so the reference is imported
inside the functions of the test process.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs.base import ModelConfig, MoEConfig

torch.set_num_threads(1)

WORLDS = {2: (1, 2), 4: (2, 2)}          # world -> (data, model)
SPAWN_TIMEOUT_S = 240
MOE_KW = dict(arch_id="t", family="moe", n_layers=1, d_model=32, n_heads=4,
              n_kv_heads=4, head_dim=8, d_ff=64, vocab_size=128,
              compute_dtype="float32")
MOE = dict(n_experts=8, top_k=2, capacity_factor=4.0)


def _port_cfg():
    return ModelConfig(**MOE_KW, moe=MoEConfig(**MOE))


# ------------------------------------------------------------ the ranks --

def _tensors(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            tree.items()}


def _rank_checks(world, fx):
    from repro_torch.core.collectives import WIRE, all_reduce
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.launch.sharding import manual_region, set_mesh
    from repro_torch.models import moe
    from repro_torch.models.convert import shard_params
    from repro_torch.models.layers import row_parallel_matmul

    d, m = WORLDS[world]
    mesh = make_train_mesh((d, m), ("data", "model"), devices="cpu")
    dp = mesh.dp_group()
    cfg = _port_cfg()
    full = _tensors(fx["moe_p"])
    # each rank's E / M experts, whole over the data axis and with the
    # whole router, as the layer computes with them
    experts = {k: v for k, v in full.items() if k != "router"}
    local = dict(shard_params({"moe": experts}, mesh.drop("data"))["moe"],
                 router=full["router"])
    x = torch.from_numpy(fx["moe_x"])
    rows = x.shape[0] // d
    x_loc = x[mesh.dp_rank() * rows:(mesh.dp_rank() + 1) * rows]
    out = {"coords": dict(mesh.coords),
           "expert_rows": {k: tuple(v.shape) for k, v in local.items()}}

    set_mesh(mesh)
    try:
        WIRE.reset()
        leaves = {k: v.clone().requires_grad_(True) for k, v in local.items()}
        y = moe.moe_ffn(x_loc, leaves, cfg)
        out["a2a_wire"] = WIRE.totals()
        grads = torch.autograd.grad((y ** 2).sum(), list(leaves.values()))
        # the global loss is the sum over the data ranks' rows
        out["moe_y"] = y.detach().numpy()
        out["moe_grads"] = {
            k: all_reduce(g, "sum", dp).numpy()
            for k, g in zip(leaves, grads)}
        # the one-device dispatch in a manual region, on every expert
        WIRE.reset()
        with manual_region():
            out["manual_y"] = moe.moe_ffn(x_loc, full, cfg).numpy()
        out["manual_wire"] = WIRE.totals()
        out["manual_gspmd"] = moe.moe_ffn_gspmd(x_loc, full, cfg).numpy()
        try:
            moe.moe_ffn(x_loc[:1, :1], local, cfg)  # 1 token over M ranks
            out["uneven"] = "no error"
        except ValueError as e:
            out["uneven"] = str(e)

        # row-parallel matmul: this rank's K / M rows of w
        xr = torch.from_numpy(fx["row_x"])
        rrows = xr.shape[0] // d
        xr_loc = xr[mesh.dp_rank() * rrows:(mesh.dp_rank() + 1) * rrows]
        w = torch.from_numpy(fx["row_w"])
        kk = w.shape[0] // m
        w_loc = w[mesh.axis_rank("model") * kk:
                  (mesh.axis_rank("model") + 1) * kk].clone()
        w_loc.requires_grad_(True)
        WIRE.reset()
        yr = row_parallel_matmul(xr_loc, w_loc, torch.float32)
        (gw,) = torch.autograd.grad((yr ** 2).sum(), [w_loc])
        out["row_wire"] = WIRE.totals()
        out["row_y"] = yr.detach().numpy()
        out["row_gw"] = all_reduce(gw, "sum", dp).numpy()
    finally:
        set_mesh(None)
    out["no_mesh_y"] = moe.moe_ffn(x_loc, full, cfg).numpy()

    # shard_params on a whole init_lm tree (the moe family)
    lm = shard_params(_tensors_tree(fx["lm"]), mesh)
    out["lm_shapes"] = {k: tuple(v.shape) for k, v in _flat(lm).items()}
    out["lm_w1"] = lm["blocks"]["moe"]["w1"].numpy()
    return out


def _tensors_tree(tree):
    if isinstance(tree, dict):
        return {k: _tensors_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _rank_main(rank, world, store, out_dir, fx):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        torch.save(_rank_checks(world, fx), f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------- the test process --

def _reference():
    """The reference's fixtures (tests/test_launch.py) and its results."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import ModelConfig as RefConfig
    from repro.configs.base import MoEConfig as RefMoE
    from repro.models import moe as ref_moe
    from repro.models.transformer import init_lm

    cfg = RefConfig(**MOE_KW, moe=RefMoE(**MOE))
    p = ref_moe.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, 32), jnp.float32)
    ref = ref_moe.moe_ffn_gspmd(x, p, cfg)
    g_ref = jax.grad(
        lambda p_: jnp.sum(ref_moe.moe_ffn_gspmd(x, p_, cfg) ** 2))(p)
    xr = jax.random.normal(jax.random.PRNGKey(0), (4, 8, 32), jnp.float32)
    w = jax.random.normal(jax.random.PRNGKey(1), (32, 16), jnp.float32)
    g_row = jax.grad(lambda w_: jnp.sum((xr @ w_) ** 2))(w)
    lm_cfg = dataclasses.replace(cfg, n_layers=2)
    lm = init_lm(lm_cfg, jax.random.PRNGKey(2))
    arr = lambda t: jax.tree.map(lambda a: np.array(a, np.float32), t)
    fx = dict(moe_p=arr(p), moe_x=np.array(x), row_x=np.array(xr),
              row_w=np.array(w), lm=arr(lm))
    want = dict(moe_y=np.array(ref), moe_grads=arr(g_ref),
                row_y=np.array(xr @ w), row_gw=np.array(g_row))
    return fx, want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    fx, want = _reference()
    dirs = {w: tmp_path_factory.mktemp(f"world{w}") for w in WORLDS}
    ctxs = {w: mp.spawn(_rank_main, nprocs=w, join=False,
                        args=(w, str(dirs[w] / "store"), str(dirs[w]), fx))
            for w in WORLDS}
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
    return fx, want, out


def _by_model_rank(ranks, m):
    """One rank of each model index (data index 0), in model order."""
    return [next(r for r in ranks if r["coords"].get("model", 0) == i
                 and r["coords"].get("data", 0) == 0) for i in range(m)]


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_a2a_forward_equals_reference_gspmd(runs, world):
    _, want, out = runs
    d, m = WORLDS[world]
    rows = want["moe_y"].shape[0] // d
    for r in out[world]:
        a2a = r["a2a_wire"]
        # two all_to_all forward (tokens, local expert ids) and one back;
        # the output's parts gathered once
        assert a2a[("all_to_all", "float32")]["calls"] == 2
        assert a2a[("all_to_all", "int64")]["calls"] == 1
        assert a2a[("all_gather", "float32")]["calls"] == 1
        i = r["coords"].get("data", 0)
        np.testing.assert_allclose(r["moe_y"],
                                   want["moe_y"][i * rows:(i + 1) * rows],
                                   atol=1e-5)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_a2a_gradients_equal_reference_gspmd(runs, world):
    _, want, out = runs
    d, m = WORLDS[world]
    ranks = _by_model_rank(out[world], m)
    for k in ("w1", "w2", "w3"):
        got = np.concatenate([r["moe_grads"][k] for r in ranks], axis=0)
        np.testing.assert_allclose(got, want["moe_grads"][k], atol=1e-4)
    for r in out[world]:
        assert r["expert_rows"]["w1"][0] == MOE["n_experts"] // m
        np.testing.assert_allclose(r["moe_grads"]["router"],
                                   want["moe_grads"]["router"], atol=1e-4)
        # the replicated router's gradient: the same bits on every rank
        np.testing.assert_array_equal(r["moe_grads"]["router"],
                                      out[world][0]["moe_grads"]["router"])


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_switch_keeps_gspmd_in_manual_region_and_without_mesh(runs, world):
    _, _, out = runs
    for r in out[world]:
        assert r["manual_wire"] == {}
        np.testing.assert_array_equal(r["manual_y"], r["manual_gspmd"])
        np.testing.assert_array_equal(r["no_mesh_y"], r["manual_gspmd"])
        assert "experts" in r["uneven"]


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_row_parallel_matmul_equals_plain(runs, world):
    _, want, out = runs
    d, m = WORLDS[world]
    rows = want["row_y"].shape[0] // d
    for r in out[world]:
        i = r["coords"].get("data", 0)
        np.testing.assert_allclose(r["row_y"],
                                   want["row_y"][i * rows:(i + 1) * rows],
                                   atol=1e-4)
        # one sum on the compute dtype's wire (fp32 here; bf16 in a
        # bf16 model), and nothing else forward or for w's gradient
        assert r["row_wire"] == {("all_gather", "float32"): {
            "calls": 1, "bytes": r["row_y"].nbytes}}
    ranks = _by_model_rank(out[world], m)
    got = np.concatenate([r["row_gw"] for r in ranks], axis=0)
    np.testing.assert_allclose(got, want["row_gw"], atol=5e-4)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_shard_params_slices_init_lm(runs, world):
    from repro_torch.launch.params import param_plan

    fx, _, out = runs
    d, m = WORLDS[world]
    sizes = {"data": d, "model": m}
    full = _flat(fx["lm"])
    e, dm = MOE["n_experts"], MOE_KW["d_model"]
    for r in out[world]:
        mi = r["coords"].get("model", 0)
        di = r["coords"].get("data", 0)
        for k, shape in r["lm_shapes"].items():
            plan = param_plan(tuple(k.split("/")), full[k].shape, sizes)
            assert shape == tuple(
                n // int(np.prod([sizes[a] for a in axes or ()]))
                for n, axes in zip(full[k].shape, plan)), k
        # the experts: E over the model axis, D over the data axis
        np.testing.assert_array_equal(
            r["lm_w1"], full["blocks/moe/w1"][:, mi * e // m:
                                              (mi + 1) * e // m,
                                              di * dm // d:
                                              (di + 1) * dm // d])


def test_mesh_registry_is_the_processs():
    """Autograd runs a card's backward (and a remat layer's recomputed
    forward) on its own threads: they see the mesh and the manual region
    the step's thread set."""
    import threading

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import (dp_axes, get_mesh,
                                             in_manual_region,
                                             manual_region, set_mesh)

    assert dp_axes() == ("data",)
    set_mesh(make_mesh((2, 1, 1), ("pod", "data", "model"), devices="cpu"))
    assert dp_axes() == ("pod", "data")
    seen = []
    mesh = object()
    set_mesh(mesh)
    try:
        with manual_region():
            t = threading.Thread(target=lambda: seen.append(
                (get_mesh(), in_manual_region())))
            t.start()
            t.join(timeout=30)
        assert not t.is_alive()
    finally:
        set_mesh(None)
    assert seen == [(mesh, True)]
    assert get_mesh() is None and not in_manual_region()
