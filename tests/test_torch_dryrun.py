"""The port's tooling on H100 terms against the reference, on the CPU:
``configs.SHAPES`` / ``shape_supported`` / ``ASSIGNED_ARCHS``,
``launch.roofline`` (``analytic_memory_bytes``, ``model_flops``,
``count_params``, the kernel bound and the attention ops' formulas,
``collective_bytes``), ``launch.params`` (the placement plan),
``launch.op_analysis`` and ``launch.dryrun``.

  * the shapes, the supported cells and the assigned archs equal the
    reference's key for key;
  * ``analytic_memory_bytes`` and ``model_flops`` equal the reference's
    for every arch x shape at both production device counts (256 and 512
    cards) and both model-axis widths (the port's 8, the reference's 16);
  * ``count_params`` of the port's ``meta`` build equals the reference's
    ``count_params`` of ``jax.eval_shape`` of its init, for all 11 archs
    at full width, and the two trees have the same leaves and shapes;
  * the plan's split axes equal the reference's ``_leaf_spec`` after its
    ``shard_if_divisible`` (on a jax mesh of one CPU device repeated to
    the production shape), leaf for leaf, on both production meshes, and
    the cache plan the reference's ``cache_shardings`` for four families;
  * ``op_analysis`` of a train step and of a decode call on ``meta``
    equals the CPU run's, FLOPs and bytes by op, for a reduced dense, moe
    and ssm config; a prefill forward equals a hand count (2 x the GEMM
    parameters x tokens, plus the attention ops' formula); with the naive
    attention (no attention op) it equals ``FlopCounterMode``'s total;
  * ``collective_bytes`` equals what ``core.collectives.WIRE`` logged on
    gloo world-2 steps, spawned as tests/test_torch_data_parallel.py
    spawns them: data parallel 2 x 1, compressed on pod 2, expert
    parallel 1 x 2 (remat off and on), the row-parallel ``w2`` of a
    dense model on 1 x 2; and the serving pool boundary's gather on an
    abstract 1 x 2 mesh, bf16 and int8 pools;
  * the kernel bound and formulas give the bounds PERF.md prints for the
    kernel table's rows 1-5 at chip_smoke.py's fixtures;
  * ``dryrun.main`` writes ok records on ``meta`` for a few cells and
    skips ``long_500k`` for full-attention archs only.
"""

import dataclasses
import json
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.configs import ALL_ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.launch import roofline as ref_roofline
from repro_torch.configs import get_config
from repro_torch.launch import op_analysis, roofline
from repro_torch.launch.dryrun import count_decode, count_prefill, \
    count_train_step
from repro_torch.launch.steps import TrainHyper, make_train_step
from repro_torch.models.model_zoo import build
from repro_torch.optim import adamw_init

torch.set_num_threads(1)

PROD = {"pod1": {"data": 32, "model": 8},
        "pod2": {"pod": 2, "data": 32, "model": 8}}
SPAWN_TIMEOUT_S = 300
BATCH, SEQ = 4, 32


# -------------------------------------------------- shapes and counts --

def test_shapes_and_archs_equal_the_reference():
    import repro.configs as ref
    import repro_torch.configs as port

    assert port.SHAPES == ref.SHAPES
    assert port.ASSIGNED_ARCHS == ref.ASSIGNED_ARCHS
    assert set(port.ALL_ARCHS) == set(ref.ALL_ARCHS)
    for arch in ref.ALL_ARCHS:
        for shape in ref.SHAPES:
            assert port.shape_supported(get_config(arch), shape) == \
                ref.shape_supported(ref_get_config(arch), shape), (arch,
                                                                    shape)


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_memory_model_and_model_flops_equal_the_reference(arch):
    from repro.configs import SHAPES

    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for shape, spec in SHAPES.items():
        for n_dev in (256, 512):
            for model_par in (8, 16):
                args = (spec["kind"], spec["global_batch"], spec["seq_len"],
                        n_dev, model_par)
                assert roofline.analytic_memory_bytes(cfg, *args) == \
                    ref_roofline.analytic_memory_bytes(rcfg, *args), (
                        shape, n_dev, model_par)
        for kind in ("train", "decode"):
            tokens = spec["global_batch"] * spec["seq_len"]
            args = (1.5e9, 0.7e9, rcfg.moe.top_k, rcfg.moe.n_experts, tokens)
            assert roofline.model_flops(*args, kind=kind) == \
                ref_roofline.model_flops(*args, kind=kind)


def _ref_abstract_params(arch):
    from repro.models.model_zoo import build as ref_build

    bundle = ref_build(ref_get_config(arch))
    return jax.eval_shape(lambda: bundle.init(jax.random.PRNGKey(0)))


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for path, leaf in flat:
        names = tuple(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path)
        out[names] = (path, leaf)
    return out


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_count_params_and_plan_equal_the_reference(arch):
    """count_params on the port's meta build == the reference's on
    jax.eval_shape; the same leaves and shapes; the plan's split axes ==
    the reference's _leaf_spec through shard_if_divisible, leaf for leaf,
    on both production meshes."""
    from jax.sharding import Mesh

    from repro.launch.params import _leaf_spec
    from repro.launch.sharding import shard_if_divisible
    from repro_torch.launch import params as P
    from repro_torch.launch.roofline import _walk

    cfg = get_config(arch)
    port = build(cfg).init(None, "meta", dtype=cfg.torch_param_dtype())
    ref = _ref_abstract_params(arch)
    assert roofline.count_params(port) == ref_roofline.count_params(ref)
    ref_leaves = _ref_leaves(ref)
    port_leaves = {path: tuple(leaf.shape) for path, leaf in _walk(port)}
    assert port_leaves == {k: tuple(v[1].shape)
                           for k, v in ref_leaves.items()}
    cpu = jax.devices("cpu")[0]
    for shape in PROD.values():
        mesh = Mesh(np.array([cpu] * int(np.prod(list(shape.values()))),
                             dtype=object).reshape(tuple(shape.values())),
                    tuple(shape))
        for names, (path, leaf) in ref_leaves.items():
            spec = shard_if_divisible(mesh, leaf.shape,
                                      *_leaf_spec(path, leaf)).spec
            want = tuple(None if e is None else
                         (e if isinstance(e, tuple) else (e,))
                         for e in tuple(spec) + (None,) * (
                             len(leaf.shape) - len(spec)))
            assert P.param_plan(names, leaf.shape, shape) == want, names


@pytest.mark.parametrize("arch", ["qwen3-4b", "falcon-mamba-7b",
                                  "zamba2-1.2b", "whisper-large-v3"])
def test_cache_plan_equals_the_reference(arch):
    from jax.sharding import Mesh

    from repro.launch.params import cache_shardings
    from repro.models.model_zoo import build as ref_build
    from repro_torch.launch import params as P

    cache = ref_build(ref_get_config(arch)).serve_inputs(128, 1024)["cache"]
    cpu = jax.devices("cpu")[0]
    shape = PROD["pod1"]
    mesh = Mesh(np.array([cpu] * 256, dtype=object).reshape(32, 8),
                tuple(shape))
    want = _ref_leaves(cache_shardings(mesh, cache))
    for names, (path, leaf) in _ref_leaves(cache).items():
        spec = tuple(want[names][1].spec)
        spec = tuple(None if e is None else
                     (e if isinstance(e, tuple) else (e,))
                     for e in spec + (None,) * (len(leaf.shape) - len(spec)))
        assert P.cache_plan(names, leaf.shape, shape) == spec, names


# ------------------------------------------------------- op_analysis --

def _cfg(arch, **kw):
    cfg = get_config(arch).reduced()
    return dataclasses.replace(cfg, **kw)


def _train_count(bundle, device):
    cfg = bundle.cfg
    gen = torch.Generator().manual_seed(0) if device == "cpu" else None
    params = bundle.init(gen, device, dtype=cfg.torch_param_dtype())
    state = {"params": params,
             "opt": adamw_init(params, cfg.torch_optimizer_dtype())}
    return count_train_step(bundle, state, BATCH, SEQ, device).as_dict()


def _decode_count(bundle, device):
    gen = torch.Generator().manual_seed(0) if device == "cpu" else None
    params = bundle.init(gen, device)
    return count_decode(bundle, params, BATCH, 40, 37, device).as_dict()


@pytest.mark.parametrize("arch", ["qwen3-4b", "olmoe-1b-7b",
                                  "falcon-mamba-7b"])
def test_op_analysis_on_meta_equals_the_cpu_run(arch):
    bundle = build(_cfg(arch, remat=True))
    for fn in (_train_count, _decode_count):
        cpu, meta = fn(bundle, "cpu"), fn(bundle, "meta")
        assert cpu == meta, fn.__name__
        assert cpu["flops"] > 0


def test_op_analysis_prefill_equals_a_hand_count():
    """The forward of loss_fn: 2 x (every projection's, the MLP's and the
    head's parameters) x tokens, plus each layer's attention op (PASA,
    causal, over the sequence padded to a block, its shift included)."""
    cfg = _cfg("qwen3-4b")
    bundle = build(cfg)
    params = bundle.init(None, "meta", dtype=cfg.torch_param_dtype())
    got = count_prefill(bundle, params, BATCH, SEQ, "meta")
    blocks = params["blocks"]
    gemm = sum(blocks["attn"][k].numel() for k in ("wq", "wk", "wv", "wo"))
    gemm += sum(blocks["mlp"][k].numel() for k in ("w1", "w2", "w3"))
    gemm += params["lm_head"].numel()
    tokens = BATCH * SEQ
    s_pad = -(-SEQ // cfg.attention.block_kv) * cfg.attention.block_kv
    _, f_att = roofline.attention_cost(BATCH, cfg.n_heads, s_pad,
                                       cfg.n_kv_heads, s_pad, cfg.head_dim,
                                       causal=True)
    _, f_shift = roofline.shift_kv_cost(
        BATCH * cfg.n_kv_heads * s_pad * cfg.head_dim, 2,
        cfg.attention.block_kv)
    assert got.flops == 2 * gemm * tokens + cfg.n_layers * (f_att + f_shift)
    assert got.calls_by_op["pasa_attention"] == cfg.n_layers


def test_op_analysis_without_attention_ops_equals_flop_counter_mode():
    from torch.utils.flop_counter import FlopCounterMode

    cfg = _cfg("qwen3-4b", attention=dataclasses.replace(
        get_config("qwen3-4b").attention, impl="naive"))
    bundle = build(cfg)
    counts = []
    for mode in ("op_analysis", "flop_counter"):
        params = bundle.init(torch.Generator().manual_seed(0), "cpu",
                             dtype=cfg.torch_param_dtype())
        state = {"params": params, "opt": adamw_init(params)}
        step = make_train_step(bundle, TrainHyper())
        tokens = {"tokens": torch.zeros((BATCH, SEQ + 1), dtype=torch.int32)}
        if mode == "op_analysis":
            with op_analysis.count() as c:
                step(state, tokens)
            counts.append(c.flops)
        else:
            with FlopCounterMode(display=False) as fc:
                step(state, tokens)
            counts.append(fc.get_total_flops())
    assert counts[0] == counts[1] > 0


def test_attention_ops_count_no_inner_ops_and_meta_needs_lengths():
    from repro_torch.core.precision import FP16
    from repro_torch.kernels import ops

    q = torch.empty((2, 4, 2, 64), dtype=torch.float16, device="meta")
    kc = torch.empty((2, 4, 256, 64), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="kv_len"):
        with op_analysis.count():
            ops.pasa_decode(q, kc, kc, kv, policy=FP16)
    with op_analysis.count(lengths={"kv_len": [100, 200]}) as c:
        out = ops.pasa_decode(q, kc, kc, kv, policy=FP16)
    assert out.shape == q.shape and out.device.type == "meta"
    assert c.flops_by_op == {"pasa_decode": roofline.decode_cost(
        2, 4, 2, 64, [100, 200])[1]}


# --------------------------------------------------- kernel bounds --

def test_kernel_bounds_reproduce_the_perf_table():
    """PERF.md's kernel table, rows 1-5 (bound ms to the printed digits)
    from the formulas at chip_smoke.py's fixtures: decode kv_len {1, 127,
    128, 1000, 4095}, KVH 4, G 7, D 128, a 32-page table a row; prefill 4
    x 28 heads x 512 queries at starts (0, 512, 1024, 0), lengths (512,
    1024, 1324, 0); shift-KV (4, 4, 1024, 128) bf16 keys, block 128;
    attention (4, 28 over 4, 1024, 128) causal."""
    lens = (1, 127, 128, 1000, 4095)
    table = len(lens) * 32
    rows = {
        "1": roofline.paged_decode_cost(5, 4, 7, 128, lens, table),
        "1q": roofline.paged_decode_cost(5, 4, 7, 128, lens, table,
                                         kv_itemsize=1, page=128),
        "2": roofline.paged_prefill_cost(
            4, 28, 512, 128, 4, (0, 512, 1024, 0), (512, 1024, 1324, 0),
            4 * 11),
        "3": roofline.decode_cost(5, 4, 7, 128, lens),
        "4": roofline.shift_kv_cost(4 * 4 * 1024 * 128, 2, 128),
        "5": roofline.attention_cost(4, 28, 1024, 4, 1024, 128,
                                     causal=True),
    }
    printed = {"1": ("0.00329", "bytes"), "1q": ("0.00171", "bytes"),
               "2": ("0.0168", "operations"), "3": ("0.00329", "bytes"),
               "4": ("0.00251", "bytes"), "5": ("0.0304", "operations")}
    for row, (nbytes, flops) in rows.items():
        b = roofline.bound(nbytes, flops)
        digits, by = printed[row]
        assert f"{b['bound_ms']:.{len(digits) - 2}f}".rstrip("0") == \
            digits.rstrip("0") or f"{b['bound_ms']:.3g}" == digits, (
                row, b["bound_ms"])
        assert b["bound_by"] == by, row


# ------------------------------------------- collective bytes == WIRE --

def _totals(wire):
    out = {}
    for (op, dt), v in wire.items():
        out[(op, dt)] = out.get((op, dt), 0) + v["bytes"]
    return out


def _rank_runs(rank, world):
    from repro_torch.core.collectives import WIRE
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.launch.sharding import set_mesh
    from repro_torch.launch.steps import (init_train_state,
                                          make_compressed_train_step)

    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (BATCH, SEQ + 1)).astype(np.int32))
    out = {}

    def run(name, cfg, shape, axes, compressed=False):
        mesh = make_train_mesh(shape, axes, devices="cpu")
        bundle = build(cfg)
        set_mesh(mesh)
        try:
            n_dp = mesh.axis_size(mesh.dp_axes())
            rows = BATCH // n_dp
            local = tokens[mesh.dp_rank() * rows:(mesh.dp_rank() + 1) * rows]
            if compressed:
                step = make_compressed_train_step(bundle, TrainHyper(), mesh)
            else:
                step = make_train_step(bundle, TrainHyper())
            # the compressed step's state is placed without the pod axis
            state = init_train_state(bundle, torch.Generator().manual_seed(0),
                                     "cpu", mesh=getattr(step, "mesh", mesh))
            if compressed:
                state["comp"] = step.init_comp(state["params"])
            WIRE.reset()
            step(state, {"tokens": local})
            out[name] = _totals(WIRE.totals())
        finally:
            set_mesh(None)

    q3, olmoe = _cfg("qwen3-4b"), _cfg("olmoe-1b-7b")
    run("dp", q3, (world, 1), ("data", "model"))
    run("compressed", q3, (world, 1, 1), ("pod", "data", "model"), True)
    run("ep", olmoe, (1, world), ("data", "model"))
    run("ep_remat", dataclasses.replace(olmoe, remat=True), (1, world),
        ("data", "model"))
    run("w2_remat", dataclasses.replace(q3, remat=True), (1, world),
        ("data", "model"))
    return out


def _rank_main(rank, world, store, out_dir):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        torch.save(_rank_runs(rank, world), f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def wire_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wire")
    ctx = mp.spawn(_rank_main, nprocs=2, join=False,
                   args=(2, str(d / "store"), str(d)))
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the world-2 group ran past {SPAWN_TIMEOUT_S} s")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


RUNS = {
    "dp": ("qwen3-4b", {}, "train", {"data": 2, "model": 1}),
    "compressed": ("qwen3-4b", {}, "train_compressed",
                   {"pod": 2, "data": 1, "model": 1}),
    "ep": ("olmoe-1b-7b", {}, "train", {"data": 1, "model": 2}),
    "ep_remat": ("olmoe-1b-7b", {"remat": True}, "train",
                 {"data": 1, "model": 2}),
    "w2_remat": ("qwen3-4b", {"remat": True}, "train",
                 {"data": 1, "model": 2}),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_collective_bytes_equal_wire_on_gloo(wire_runs, run):
    arch, kw, kind, shape = RUNS[run]
    cfg = _cfg(arch, **kw)
    params = build(cfg).init(None, "meta", dtype=cfg.torch_param_dtype())
    want = roofline.collective_bytes(cfg, kind, BATCH, SEQ, shape,
                                     params=params)
    for rank in wire_runs:
        assert rank[run] == want["by_op"], run
    assert want["total_bytes"] > 0


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8"])
def test_collective_bytes_equal_the_pool_gather(pool_dtype):
    from repro_torch.core.collectives import WIRE
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.models.transformer import init_paged_cache
    from repro_torch.runtime.engine import _PoolIO
    from repro_torch.runtime.paged_cache import pool_shardings, shard_pool

    cfg = _cfg("qwen3-4b")
    mesh = make_abstract_mesh((1, 2), ("data", "model"))
    pool = init_paged_cache(cfg, 9, 16, pool_dtype, device="meta")
    sharded = shard_pool(pool, pool_shardings(mesh, pool, cfg.n_kv_heads))
    io = _PoolIO(mesh.axis_group("model"), torch.device("meta"))
    WIRE.reset()
    full = io.expand(sharded)
    assert {k: v.shape for k, v in full.items()} == {
        k: v.shape for k, v in pool.items()}
    want = roofline.collective_bytes(cfg, "decode", 2, 64, mesh.shape,
                                     num_pages=9, page_size=16,
                                     pool_dtype=pool_dtype)
    assert _totals(WIRE.totals()) == want["by_op"]
    assert want["bytes"]["pool_gather"] > 0


# ---------------------------------------------------------- dry run --

def test_dryrun_cli_writes_meta_records(tmp_path):
    from repro_torch.launch import dryrun

    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    assert dryrun.main(["--arch", "zamba2-1.2b", "--shape", "long_500k",
                        "--multi-pod", "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "qwen3-4b__decode_32k__pod1.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["device"] == "meta"
    assert rec["mesh_axes"] == PROD["pod1"] and rec["batch_per_device"] == 4
    assert rec["flops_per_device"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    assert set(rec["state_bytes_per_device"]) == {"plan", "held"}
    # the state is placed by the plan: the held layout is the plan's
    assert rec["state_bytes_per_device"]["held"] == \
        rec["state_bytes_per_device"]["plan"]
    skip = json.loads((tmp_path / "qwen3-4b__long_500k__pod1.json")
                      .read_text())
    assert skip["status"] == "skipped"
    hybrid = json.loads((tmp_path / "zamba2-1.2b__long_500k__pod2.json")
                        .read_text())
    assert hybrid["status"] == "ok" and hybrid["n_devices"] == 512
