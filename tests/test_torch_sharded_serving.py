"""The model axis of the port: the kv-head-sharded pool, the sharded
paged ops, in gloo process groups on the CPU.

The port's counterparts of tests/test_sharded_serving.py (whose suite
runs only under eight forced host devices).
Each world size spawns one group per module (``torch.multiprocessing``
with a ``file://`` store under the test's temporary directory) that runs
every check of that size and saves what it saw; the tests below read it.
The one-device serves they are held to run in this process meanwhile.

  * tokens and every non-null page byte of a model-sharded serve equal
    the one-device port serve's, at bf16 and int8 pools, at world 2 and
    4; per-rank pool bytes x M == ``paged_bytes`` ==
    ``sharded_pool_device_bytes`` x M;
  * a 2 x 4 group (world 4, two replicas a rank) equals the one-device
    serve, and each replica's pages a one-device serve of its subset;
  * async == sync and telemetry on == off on the sharded pool; a sampled
    speculative serve equals its one-device serve; preempt-resume equals
    the request served alone;
  * the pool stays replicated where the kv heads do not divide M;
  * ``pasa_paged_decode_sharded`` / ``pasa_paged_prefill_sharded`` at KVH
    4 over M = 2 and 4 are bit-equal to the unsharded call; at KVH 3,
    which M does not divide, both take the replicated call (bit-equal
    too), debris past kv_len inert.

The spawned ranks import this module and need torch alone, so the
reference is imported inside the functions of the test process.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.core import FP32
from repro_torch.kernels import pasa_paged_decode, pasa_paged_prefill
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build
from repro_torch.runtime import (
    ServeEngine,
    chunked_cold_reference,
    paged_bytes,
    quantize_kv_page,
    sharded_pool_device_bytes,
)

torch.set_num_threads(1)

GEN = 4
PROMPT_LENS = (37, 21, 45, 12, 30, 9)
SERVE_KW = dict(max_batch=4, num_pages=48, page_size=8, max_seq_len=64,
                prefill_chunk=16)
GROUP_KW = dict(max_batch=3, num_pages=24, page_size=8, max_seq_len=64,
                prefill_chunk=16)
SPEC_KW = dict(temperature=0.8, top_k=8, sample_seed=3, speculate=2)
SPAWN_TIMEOUT_S = 240


# ----------------------------------------------------------- fixtures --

def _cfgs(arch, **over):
    """The reference's and the port's reduced config, block = page 8."""
    from repro.configs import get_config as ref_get_config

    out = []
    for get in (ref_get_config, get_config):
        c = dataclasses.replace(get(arch).reduced(), **over)
        out.append(dataclasses.replace(c, attention=dataclasses.replace(
            c.attention, block_kv=8)))
    return out


def _params(arch, **over):
    import jax

    from repro.models.model_zoo import build as ref_build

    rc, tc = _cfgs(arch, **over)
    rp = ref_build(rc).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.array(x, np.float32), rp)
    return tc, params_from_numpy(tree, tc, "cpu")


def _paged_case(seed, *, kvh, g, d=32, page=8, n_pages=9, quantized=False):
    """K/V of one sequence laid out as physical pages 1..n-1 (identity
    table), keys with a sequence bias; q (1, KVH, G, D) and prefill
    queries (1, KVH*G, 16, D)."""
    rng = np.random.default_rng(seed)
    mp_ = n_pages - 1
    s2 = mp_ * page
    f32 = np.float32
    raw_k = (rng.standard_normal((mp_, page, kvh, d)) + 2.0).astype(f32)
    raw_v = rng.standard_normal((mp_, page, kvh, d)).astype(f32)
    case = dict(
        q=torch.from_numpy(rng.standard_normal((1, kvh, g, d)).astype(f32)),
        qp=torch.from_numpy(
            rng.standard_normal((1, kvh * g, 16, d)).astype(f32)),
        table=torch.arange(1, n_pages, dtype=torch.int32).reshape(1, mp_),
        kv_len=torch.tensor([s2], dtype=torch.int32), quant={})
    if quantized:
        valid = torch.ones((mp_, page), dtype=torch.bool)
        kc, ksc, ksh = quantize_kv_page(torch.from_numpy(raw_k), valid, "int8")
        vc, vsc, vsh = quantize_kv_page(torch.from_numpy(raw_v), valid, "int8")

        def pad(x):
            return torch.cat([torch.zeros_like(x[:1]), x])
        case.update(kp=pad(kc), vp=pad(vc), quant=dict(
            k_scale=pad(ksc), k_shift=pad(ksh), v_scale=pad(vsc),
            v_shift=pad(vsh)))
    else:
        z = np.zeros((1, page, kvh, d), f32)
        case.update(kp=torch.from_numpy(np.concatenate([z, raw_k])),
                    vp=torch.from_numpy(np.concatenate([z, raw_v])))
    return case


def _ops_unsharded(case, policy):
    start = case["kv_len"] - 16
    dec = pasa_paged_decode(case["q"], case["kp"], case["vp"], case["table"],
                            case["kv_len"], policy=policy, **case["quant"])
    pre = pasa_paged_prefill(case["qp"], case["kp"], case["vp"],
                             case["table"], start, case["kv_len"],
                             policy=policy, **case["quant"])
    return dec, pre


def _workload(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n).tolist() for n in PROMPT_LENS]


# --------------------------------------------------- inside each rank --

def _serve(bundle, params, prompts, mesh=None, gen=GEN, **kw):
    kw = dict(SERVE_KW, **kw)
    eng = ServeEngine(bundle, params, mesh=mesh, **kw)
    reqs = [eng.submit(p, gen) for p in prompts]
    eng.run_to_completion()
    return [r.generated for r in reqs], eng


def _whole(pool):
    """Every leaf of a sharded pool gathered whole over the default group
    (every rank calls it)."""
    from repro_torch.core.collectives import all_gather

    sh = getattr(pool, "shardings", {})
    return {n: x if n not in sh or sh[n].is_fully_replicated
            else all_gather(x, sh[n].dim) for n, x in pool.items()}


def _engine_report(streams, eng):
    st = eng.stats()
    return dict(streams=streams, pool=_whole(eng.pool),
                local_bytes=st["cache_bytes_per_device"],
                total_bytes=st["cache_bytes"], inflight=st["inflight"],
                stage_calls=eng.pool_io.calls if eng.pool_io else 0)


def _rank_checks(world, models, prompts, cases):
    """Everything a group of ``world`` ranks checks; returns this rank's
    observations."""
    from repro_torch.kernels import (
        pasa_paged_decode_sharded,
        pasa_paged_prefill_sharded,
    )
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import EngineReplicaGroup, Telemetry

    bundle, params = build(models["qwen2"][0]), models["qwen2"][1]
    mesh = make_mesh((1, world), ("data", "model"), devices="cpu")
    out = {}
    for dtype in ("bf16", "int8"):
        out[f"serve_{dtype}"] = _engine_report(*_serve(
            bundle, params, prompts, mesh, cache_dtype=dtype))
    if world == 2:
        # at world 4 the 2 x 4 group's async and telemetry serves below
        out["async_bf16"] = _engine_report(*_serve(
            bundle, params, prompts, mesh, pipeline_depth=1))
        tel = Telemetry(tracing=True, metrics=True, numerics_every=1)
        rep = _engine_report(*_serve(bundle, params, prompts, mesh,
                                     cache_dtype="int8", pipeline_depth=1,
                                     telemetry=tel))
        snap = tel.metrics_snapshot()
        rep["finished"] = snap["counters"]["serve.requests_finished"]["value"]
        rep["probe_samples"] = snap["counters"]["numerics.samples"]["value"]
        out["telemetry_int8"] = rep
    # ops: kv-head split where it divides, else the replicated call
    for name, case in cases.items():
        policy = FP32
        start = case["kv_len"] - 16
        dec = pasa_paged_decode_sharded(
            case["q"], case["kp"], case["vp"], case["table"], case["kv_len"],
            mesh=mesh, policy=policy, **case["quant"])
        pre = pasa_paged_prefill_sharded(
            case["qp"], case["kp"], case["vp"], case["table"], start,
            case["kv_len"], mesh=mesh, policy=policy, **case["quant"])
        out[f"ops_{name}"] = (dec, pre)
    # debris past kv_len: 5 of 8 pages live, the dead tail poisoned
    case = cases["kvh3"]
    live = torch.tensor([40], dtype=torch.int32)
    dirty = []
    for kp, vp in ((case["kp"], case["vp"]),
                   (case["kp"].clone().index_fill_(0, torch.tensor([6, 7]),
                                                   float("inf")),
                    case["vp"].clone().index_fill_(0, torch.tensor([6]),
                                                   float("nan")))):
        dirty.append(pasa_paged_prefill_sharded(
            case["qp"], kp, vp, case["table"], live - 16, live, mesh=mesh,
            policy=FP32))
    out["kvh3_debris"] = dirty
    if world == 2:
        for dtype in ("bf16", "int8"):
            eng = ServeEngine(
                bundle, params, max_batch=2, num_pages=12, page_size=8,
                max_seq_len=64, prefill_chunk=16, prefix_cache=True,
                preemption=True, preempt_patience=2, cache_dtype=dtype,
                mesh=mesh)
            ra = eng.submit(prompts[2], 12)
            for _ in range(3):
                eng.step()
            rb = eng.submit(prompts[0], GEN)
            eng.run_to_completion()
            out[f"preempt_{dtype}"] = dict(
                streams=[ra.generated, rb.generated],
                preemptions=eng.preemptions)
        out["spec_sampled"] = _engine_report(*_serve(
            bundle, params, prompts, mesh, **SPEC_KW))
    if world == 4:
        grid = make_mesh((2, 4), ("data", "model"), devices="cpu")
        for dtype, depth, tel in (("bf16", 0, None), ("int8", 0, None),
                                  ("bf16", 1, None),
                                  ("bf16", 1, Telemetry(tracing=True,
                                                        metrics=True,
                                                        numerics_every=2))):
            grp = EngineReplicaGroup(bundle, params, grid, routing="rr",
                                     cache_dtype=dtype, pipeline_depth=depth,
                                     telemetry=tel, **GROUP_KW)
            reqs = [grp.submit(p, GEN) for p in prompts]
            grp.run_to_completion()
            key = f"grid_{dtype}_d{depth}" + ("_tel" if tel else "")
            out[key] = dict(
                streams=[r.generated for r in reqs],
                engines=[_engine_report(None, e) for e in grp.engines],
                finished=grp.stats()["finished"],
                plans={e.engine for e in tel.tracer.events()
                       if e.name == "plan"} if tel else None)
        # kv heads (2) that the axis (4) does not divide: replicated
        q3, q3p = models["qwen3"]
        streams, eng = _serve(build(q3), q3p, prompts[:3], mesh)
        out["replicated"] = dict(
            streams=streams, pool_io=eng.pool_io is None,
            local_bytes=eng.stats()["cache_bytes_per_device"],
            total_bytes=eng.stats()["cache_bytes"])
    return out


def _rank_main(rank, world, store, out_dir, models, prompts, cases):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        torch.save(_rank_checks(world, models, prompts, cases),
                   f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn(world, tmp, *args):
    store = tmp / "store"
    ctx = mp.spawn(_rank_main, args=(world, str(store), str(tmp)) + args,
                   nprocs=world, join=False)
    return ctx


def _join(ctx, tmp, world):
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the world-{world} group ran past "
                        f"{SPAWN_TIMEOUT_S} s")
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def setup():
    models = {"qwen2": _params("qwen2-7b", n_heads=8, n_kv_heads=4),
              "qwen3": _params("qwen3-4b")}
    prompts = _workload(models["qwen2"][0].vocab_size)
    cases = {"kvh4_raw": _paged_case(3, kvh=4, g=2),
             "kvh4_int8": _paged_case(4, kvh=4, g=2, quantized=True),
             "kvh3": _paged_case(11, kvh=3, g=2)}
    return models, prompts, cases


@pytest.fixture(scope="module")
def groups(setup, tmp_path_factory):
    """Both groups spawned at once; the one-device serves run here while
    they work."""
    models, prompts, cases = setup
    dirs = {w: tmp_path_factory.mktemp(f"world{w}") for w in (2, 4)}
    ctxs = {w: _spawn(w, dirs[w], models, prompts, cases) for w in (2, 4)}
    bundle, params = build(models["qwen2"][0]), models["qwen2"][1]
    ref = {}
    for dtype in ("bf16", "int8"):
        streams, eng = _serve(bundle, params, prompts, cache_dtype=dtype)
        ref[dtype] = dict(streams=streams, pool=eng.pool,
                          total=paged_bytes(eng.pool))
    streams, eng = _serve(bundle, params, prompts, **SPEC_KW)
    ref["spec_sampled"] = dict(streams=streams, pool=eng.pool)
    for dtype in ("bf16", "int8"):
        # round robin deals i::2; each replica alone on that subset
        ref[f"subset_{dtype}"] = [
            _serve(bundle, params, prompts[i::2], cache_dtype=dtype,
                   **GROUP_KW)[1].pool for i in range(2)]
    q3, q3p = models["qwen3"]
    ref["qwen3"] = _serve(build(q3), q3p, prompts[:3])[0]
    ref["cold"] = {(i, g): chunked_cold_reference(
        bundle, params, prompts[i], g, page_size=8, prefill_chunk=16,
        cache_dtype=dtype) for i, g in ((2, 12), (0, GEN))
        for dtype in ("bf16",)}
    ref["cold_int8"] = {(i, g): chunked_cold_reference(
        bundle, params, prompts[i], g, page_size=8, prefill_chunk=16,
        cache_dtype="int8") for i, g in ((2, 12), (0, GEN))}
    ref["ops"] = {name: _ops_unsharded(case, FP32)
        for name, case in cases.items()}
    got = {w: _join(ctxs[w], dirs[w], w) for w in (2, 4)}
    return got, ref, models


def _pages_equal(a, b):
    """Every leaf's bytes of every page but the null page 0 (the write
    sink of pad rows)."""
    assert set(a) == set(b)
    for name in a:
        x = a[name][:, 1:].contiguous().view(torch.uint8)
        y = b[name][:, 1:].contiguous().view(torch.uint8)
        assert torch.equal(x, y), name


# -------------------------------------------------------------- tests --

@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("world", [2, 4])
def test_model_sharded_serve_equals_one_device(groups, world, dtype):
    got, ref, models = groups
    cfg = models["qwen2"][0]
    for rank, res in enumerate(got[world]):
        rep = res[f"serve_{dtype}"]
        assert rep["streams"] == ref[dtype]["streams"], rank
        _pages_equal(rep["pool"], ref[dtype]["pool"])
        assert rep["local_bytes"] * world == rep["total_bytes"] \
            == ref[dtype]["total"]
        assert rep["local_bytes"] == sharded_pool_device_bytes(
            cfg.n_layers, SERVE_KW["num_pages"], 8, cfg.kv_dim, dtype,
            cfg.n_kv_heads, world)
        assert rep["stage_calls"] > 0


def test_model_sharded_async_equals_sync(groups):
    got, ref, _ = groups
    for res in got[2]:
        rep = res["async_bf16"]
        assert rep["streams"] == res["serve_bf16"]["streams"]
        _pages_equal(rep["pool"], res["serve_bf16"]["pool"])
        assert rep["inflight"] == 0


def test_model_sharded_telemetry_is_bit_neutral(groups):
    got, ref, _ = groups
    for res in got[2]:
        rep = res["telemetry_int8"]
        assert rep["streams"] == ref["int8"]["streams"]
        _pages_equal(rep["pool"], ref["int8"]["pool"])
        assert rep["finished"] == len(PROMPT_LENS)
        assert rep["probe_samples"] > 0


def test_sharded_sampled_speculation_equals_one_device(groups):
    got, ref, _ = groups
    for res in got[2]:
        rep = res["spec_sampled"]
        assert rep["streams"] == ref["spec_sampled"]["streams"]
        _pages_equal(rep["pool"], ref["spec_sampled"]["pool"])


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_sharded_preempt_resume_equals_alone(groups, dtype):
    got, ref, _ = groups
    cold = ref["cold"] if dtype == "bf16" else ref["cold_int8"]
    for res in got[2]:
        rep = res[f"preempt_{dtype}"]
        assert rep["preemptions"] >= 1
        assert rep["streams"] == [cold[(2, 12)], cold[(0, GEN)]]


@pytest.mark.parametrize("variant", ["bf16_d0", "int8_d0", "bf16_d1",
                                     "bf16_d1_tel"])
def test_2x4_group_equals_one_device(groups, variant):
    got, ref, _ = groups
    dtype = variant.split("_")[0]
    for res in got[4]:
        rep = res[f"grid_{variant}"]
        assert rep["streams"] == ref[dtype]["streams"]
        assert rep["finished"] == len(PROMPT_LENS)
        for i, eng in enumerate(rep["engines"]):
            _pages_equal(eng["pool"], ref[f"subset_{dtype}"][i])
            assert eng["local_bytes"] * 4 == eng["total_bytes"]
            assert eng["inflight"] == 0
        if variant.endswith("tel"):
            assert rep["plans"] == {0, 1}


def test_non_divisible_kv_heads_stay_replicated(groups):
    got, ref, _ = groups
    for res in got[4]:
        rep = res["replicated"]
        assert rep["streams"] == ref["qwen3"]
        assert rep["pool_io"]
        assert rep["local_bytes"] == rep["total_bytes"]


@pytest.mark.parametrize("case", ["kvh4_raw", "kvh4_int8"])
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_ops_are_bit_equal_to_the_unsharded_call(groups, world, case):
    got, ref, _ = groups
    for res in got[world]:
        for a, b in zip(res[f"ops_{case}"], ref["ops"][case]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("world", [2, 4])
def test_non_divisible_ops_take_the_replicated_call(groups, world):
    """KVH 3 over M = 2 and 4: decode and prefill both run the one-device
    call on the whole inputs (bit-equal to it), and the pages past kv_len
    stay inert."""
    got, ref, _ = groups
    for res in got[world]:
        for a, b in zip(res["ops_kvh3"], ref["ops"]["kvh3"]):
            assert torch.equal(a, b)
        clean, dirty = res["kvh3_debris"]
        assert bool(torch.isfinite(dirty).all())
        assert torch.equal(dirty, clean)
