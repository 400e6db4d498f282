"""The port's replica group (the data axis of the reference's ``(data,
model)`` mesh) and its exports.

  * **Routing** (host only, fake replicas): the port's
    ``EngineReplicaGroup._route`` picks the reference's replica at every
    step of the same load and probe sequences, in all three modes;
    ``RadixPrefixCache.probe_len`` is a pure read, equal to the
    reference's.
  * **The group equals one engine** (D = 2 and 3 replicas, model axis 1,
    in one process on the CPU): streams equal a single engine's in every
    routing mode, sync and at ``pipeline_depth=1``; each replica's
    non-null page bytes equal a one-device engine serving that replica's
    subset; ``stats()`` aggregates by the reference's three tuples;
    ``cancel()`` reaches the owner; a shared-prefix burst lands on the
    warm replica; one such serve's streams equal the reference's
    one-device engine's up to a near-tie.
  * **Exports**: the port's ``runtime``, ``core``, ``kernels``,
    ``optim``, ``data`` and ``checkpoint`` ``__all__`` hold the
    reference's, less the names of later items.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.runtime as ref_runtime
from repro.configs import get_config as ref_get_config
from repro.models.model_zoo import build as ref_build
from repro.runtime import EngineReplicaGroup as RefGroup
from repro.runtime import PageAllocator as RefAllocator
from repro.runtime import RadixPrefixCache as RefCache
from repro.runtime import ServeEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build
from repro_torch.runtime import (
    ROUTING_MODES,
    EngineReplicaGroup,
    PageAllocator,
    RadixPrefixCache,
    ServeEngine,
    Telemetry,
    chunked_cold_reference,
)
from repro_torch.runtime.engine import _STATS_CONFIG, _STATS_MAX, _STATS_SUM
from test_torch_engine import _ref_logits_along

torch.set_num_threads(1)

PAGE = 16
CHUNK = 32
GEN = 4
PROMPT_LENS = (37, 21, 45, 12, 30, 9)
KW = dict(max_batch=3, num_pages=24, page_size=PAGE, max_seq_len=64,
          prefill_chunk=CHUNK)
# a differing greedy token is accepted only where the reference's own
# top-1 / top-2 logit gap is below the two stacks' logit agreement
LOGIT_ATOL = 0.1


# ------------------------------------------------------------ exports --

@pytest.mark.parametrize("pkg", ["runtime", "core", "kernels", "optim",
                                 "data", "checkpoint"])
def test_exports_hold_the_references(pkg):
    import importlib

    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    missing = set(ref.__all__) - set(port.__all__)
    assert not missing, sorted(missing)
    for name in port.__all__:
        assert hasattr(port, name), name


def test_page_capture_helpers_are_exported():
    from repro_torch.runtime import capture_pages, restore_pages, touched_pages
    from repro_torch.runtime import paged_cache

    assert capture_pages is paged_cache.capture_pages
    assert restore_pages is paged_cache.restore_pages
    assert touched_pages is paged_cache.touched_pages


# ----------------------------------------------------------- routing --

class _FakeEngine:
    """The part of the engine routing reads: queue depth, slots held and
    the prefix trie."""

    def __init__(self, waiting=0, running=0, cache=None):
        self.waiting = [None] * waiting
        self.num_running = running
        self.prefix_cache = cache


def _group(cls, engines, routing):
    grp = cls.__new__(cls)
    grp.engines = list(engines)
    grp.routing = routing
    grp._rr = 0
    grp._req_counter = 0
    grp._owner = {}
    return grp


def _tries(page_size, prefixes):
    """The same tries in both packages: each of ``prefixes`` (token lists
    of whole pages) inserted on a fresh allocator."""
    out = []
    for alloc_cls, cache_cls in ((RefAllocator, RefCache),
                                 (PageAllocator, RadixPrefixCache)):
        if prefixes is None:
            out.append(None)
            continue
        alloc = alloc_cls(num_pages=64)
        cache = cache_cls(alloc, page_size=page_size)
        for toks in prefixes:
            cache.insert(toks, alloc.alloc(len(toks) // page_size))
        out.append(cache)
    return out


@pytest.mark.parametrize("routing", ROUTING_MODES)
def test_routing_matches_the_reference(routing):
    """The same load and probe sequence through both groups: the same
    replica at every one of 200 steps."""
    rng = np.random.default_rng(7)
    page = 4
    base = [list(rng.integers(0, 50, page * n)) for n in (3, 2, 4)]
    layouts = [[base[0]], [base[1], base[0][:page]], None, [base[2]]]
    pairs = [_tries(page, lay) for lay in layouts]
    ref_eng = [_FakeEngine(cache=r) for r, _ in pairs]
    port_eng = [_FakeEngine(cache=p) for _, p in pairs]
    ref = _group(RefGroup, ref_eng, routing)
    port = _group(EngineReplicaGroup, port_eng, routing)
    picks = []
    for _ in range(200):
        src = base[int(rng.integers(0, 3))]
        cut = int(rng.integers(0, len(src) + 1))
        tail = rng.integers(50, 99, int(rng.integers(1, 9)))
        prompt = src[:cut] + list(tail)
        a, b = ref._route(prompt), port._route(prompt)
        i = ref_eng.index(a)
        assert port_eng.index(b) == i
        picks.append(i)
        for engs in (ref_eng, port_eng):
            engs[i].waiting.append(None)
        # finishes and cancels: the same loads fall in both
        if rng.random() < 0.5:
            j = int(rng.integers(0, len(ref_eng)))
            for engs in (ref_eng, port_eng):
                if engs[j].waiting:
                    engs[j].waiting.pop()
    assert len(set(picks)) > 1


def test_equal_loads_deal_round_robin():
    for routing in ("least", "affinity"):
        engines = [_FakeEngine() for _ in range(3)]
        grp = _group(EngineReplicaGroup, engines, routing)
        picks = []
        for _ in range(6):
            eng = grp._route([1, 2, 3])
            eng.num_running += 1
            picks.append(engines.index(eng))
        assert picks == [0, 1, 2, 0, 1, 2], routing


def test_least_loaded_fills_the_gap_rr_does_not():
    engines = [_FakeEngine(waiting=2, running=1), _FakeEngine(),
               _FakeEngine(waiting=2, running=1)]
    assert _group(EngineReplicaGroup, engines, "least")._route([5]) \
        is engines[1]
    assert _group(EngineReplicaGroup, engines, "rr")._route([5]) \
        is engines[0]


def test_affinity_prefers_the_longest_cached_prefix():
    _, warm = _tries(4, [list(range(12))])
    _, short = _tries(4, [list(range(4))])
    engines = [_FakeEngine(cache=short),
               _FakeEngine(waiting=3, running=2, cache=warm),
               _FakeEngine()]
    grp = _group(EngineReplicaGroup, engines, "affinity")
    assert grp._route(list(range(16))) is engines[1]
    assert grp._route([99, 98, 97, 96]) in (engines[0], engines[2])


def test_probe_len_is_a_pure_read():
    ref, port = _tries(4, [list(range(8))])
    for cache in (ref, port):
        before = (cache.hits, cache.misses, cache.cached_pages,
                  cache.evictable_pages, cache._clock)
        for toks, want in ((list(range(8)), 8), (list(range(4)), 4),
                           ([42] * 8, 0), (list(range(10)), 8)):
            assert cache.probe_len(toks) == want
        assert (cache.hits, cache.misses, cache.cached_pages,
                cache.evictable_pages, cache._clock) == before
    # refcounts unchanged: every cached page is still evictable
    assert port.evict(2) == 2


def test_routing_and_mesh_validation(model):
    bundle, params = model["bundle"], model["tp"]
    assert ROUTING_MODES == ref_runtime.ROUTING_MODES
    bad = make_mesh((2, 1), ("pod", "model"), devices="cpu")
    with pytest.raises(ValueError):
        EngineReplicaGroup(bundle, params, bad, **KW)
    with pytest.raises(ValueError):
        EngineReplicaGroup(bundle, params, _mesh(2), routing="sticky", **KW)
    with pytest.raises(ValueError):
        make_mesh((2,), ("data", "model"), devices="cpu")
    with pytest.raises(RuntimeError, match="nproc-per-node 2"):
        make_mesh((1, 2), ("data", "model"), devices="cpu")
    with pytest.raises(NotImplementedError, match="A16"):
        make_production_mesh()
    # a ServeEngine serves the model axis only
    with pytest.raises(ValueError):
        ServeEngine(bundle, params, mesh=_mesh(2), **KW)


# ------------------------------------------------ the group, in-process --

def _cfgs():
    rc = ref_get_config("qwen2-7b").reduced()
    rc = dataclasses.replace(
        rc, attention=dataclasses.replace(rc.attention, block_kv=PAGE))
    tc = get_config("qwen2-7b").reduced()
    tc = dataclasses.replace(
        tc, attention=dataclasses.replace(tc.attention, block_kv=PAGE))
    return rc, tc


@pytest.fixture(scope="module")
def model():
    rc, tc = _cfgs()
    rb = ref_build(rc)
    rp = rb.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.array(x, np.float32), rp)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tc.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    return dict(rc=rc, rb=rb, rp=rp, bundle=build(tc),
                tp=params_from_numpy(tree, tc, "cpu"), prompts=prompts)


def _mesh(d):
    return make_mesh((d, 1), ("data", "model"), devices="cpu")


def _serve_one(model, prompts, **kw):
    args = dict(KW, max_batch=6, num_pages=48)
    args.update(kw)
    eng = ServeEngine(model["bundle"], model["tp"], **args)
    reqs = [eng.submit(p, GEN) for p in prompts]
    eng.run_to_completion()
    return [r.generated for r in reqs], eng


@pytest.fixture(scope="module")
def one_engine(model):
    return _serve_one(model, model["prompts"])


def _serve_group(model, d, routing, **kw):
    grp = EngineReplicaGroup(model["bundle"], model["tp"], _mesh(d),
                             routing=routing, **dict(KW, **kw))
    reqs = [grp.submit(p, GEN) for p in model["prompts"]]
    grp.run_to_completion()
    return grp, reqs


def _pages_equal(a, b):
    """Every leaf's bytes of every page but the null page 0."""
    assert set(a) == set(b)
    for name in a:
        x = a[name][:, 1:].contiguous().view(torch.uint8)
        y = b[name][:, 1:].contiguous().view(torch.uint8)
        assert torch.equal(x, y), name


@pytest.mark.parametrize("depth", [0, 1], ids=["sync", "async"])
@pytest.mark.parametrize("routing", ROUTING_MODES)
@pytest.mark.parametrize("d", [2, 3])
def test_group_streams_equal_one_engine(model, one_engine, d, routing, depth):
    grp, reqs = _serve_group(model, d, routing, pipeline_depth=depth)
    assert [r.generated for r in reqs] == one_engine[0]
    assert [r.req_id for r in reqs] == list(range(len(reqs)))
    assert all(e.stats()["inflight"] == 0 for e in grp.engines)
    # the weights: one copy on the one device
    assert all(e.params is model["tp"] for e in grp.engines)


@pytest.mark.parametrize("d", [2, 3])
def test_replica_pages_equal_a_one_engine_serve_of_its_subset(model, d):
    grp, reqs = _serve_group(model, d, "least")
    for i, eng in enumerate(grp.engines):
        subset = [r.prompt for r in reqs if grp._owner[r.req_id] is eng]
        assert subset == model["prompts"][i::d]       # equal loads: i::d
        _, alone = _serve_one(model, subset, **KW)
        _pages_equal(alone.pool, eng.pool)


def test_group_stats_aggregate_by_the_three_tuples(model):
    grp, _ = _serve_group(model, 2, "rr")
    assert (_STATS_SUM, _STATS_MAX, _STATS_CONFIG) == (
        ref_runtime.engine._STATS_SUM, ref_runtime.engine._STATS_MAX,
        ref_runtime.engine._STATS_CONFIG)
    st, per = grp.stats(), [e.stats() for e in grp.engines]
    assert st["replicas"] == 2 and st["engines"] == per
    for key in _STATS_SUM:
        assert st[key] == sum(s[key] for s in per), key
    for key in _STATS_MAX:
        assert st[key] == max(s[key] for s in per), key
    for key in _STATS_CONFIG:
        assert st[key] == per[0][key], key
    assert st["finished"] == len(model["prompts"])
    assert st["decode_calls"] == sum(s["decode_calls"] for s in per)
    assert set(st) - {"replicas", "engines"} == set(per[0])


def test_cancel_reaches_the_owner_and_least_fills_the_gap(model):
    """As the reference's regression test: after cancels empty replica 0,
    the next two requests land there, and every stream equals the
    request served alone."""
    bundle, params, prompts = model["bundle"], model["tp"], model["prompts"]
    grp = EngineReplicaGroup(bundle, params, _mesh(2), routing="least", **KW)
    first = [grp.submit(p, 12) for p in prompts[:4]]
    assert [grp.engines.index(grp._owner[r.req_id]) for r in first] \
        == [0, 1, 0, 1]
    grp.step()
    assert grp.cancel(first[0].req_id) and grp.cancel(first[2].req_id)
    assert not grp.cancel(99)
    assert grp.engines[0].cancellations == 2
    assert grp.engines[1].cancellations == 0
    late = [grp.submit(p, GEN) for p in prompts[4:6]]
    assert all(grp._owner[r.req_id] is grp.engines[0] for r in late)
    grp.run_to_completion()
    assert grp.stats()["cancellations"] == 2
    for r, w, g in ((first[1], 1, 12), (first[3], 3, 12),
                    (late[0], 4, GEN), (late[1], 5, GEN)):
        assert r.generated == chunked_cold_reference(
            bundle, params, prompts[w], g, page_size=PAGE,
            prefill_chunk=CHUNK)


def test_affinity_sends_a_shared_prefix_burst_to_the_warm_replica(model):
    bundle, params = model["bundle"], model["tp"]
    rng = np.random.default_rng(8)
    vocab = bundle.cfg.vocab_size
    system = list(rng.integers(0, vocab, 2 * PAGE))
    prompts = [system + list(rng.integers(0, vocab, 9)) for _ in range(4)]
    grp = EngineReplicaGroup(bundle, params, _mesh(2), routing="affinity",
                             prefix_cache=True, **dict(KW, max_batch=4))
    r0 = grp.submit(prompts[0], GEN)
    warm = grp._owner[r0.req_id]
    grp.run_to_completion()                 # donates the prefix pages
    burst = [grp.submit(p, GEN) for p in prompts[1:]]
    assert all(grp._owner[r.req_id] is warm for r in burst)
    cold = next(e for e in grp.engines if e is not warm)
    assert cold.prefix_cache.cached_pages == 0
    grp.run_to_completion()
    assert warm.prefix_cache.hits >= 2 * len(burst)
    for r, p in zip([r0] + burst, prompts):
        assert r.generated == chunked_cold_reference(
            bundle, params, p, GEN, page_size=PAGE, prefill_chunk=CHUNK)


def test_group_telemetry_aggregates_and_is_bit_neutral(model, one_engine):
    tel = Telemetry(tracing=True, metrics=True, numerics_every=2)
    grp, reqs = _serve_group(model, 2, "affinity", telemetry=tel,
                             pipeline_depth=1)
    assert [r.generated for r in reqs] == one_engine[0]
    snap = grp.metrics_snapshot()
    n = len(model["prompts"])
    assert snap["counters"]["serve.requests_finished"]["value"] == n
    assert snap["histograms"]["serve.ttft_steps"]["count"] == n
    assert {e.engine for e in tel.tracer.events() if e.name == "plan"} \
        == {0, 1}


def test_group_streams_match_the_reference_engine(model, one_engine):
    """One group serve (D = 2, affinity) against the reference's
    one-device engine on the same prompts and weights: equal streams, or
    a first difference where the reference's top-2 margin is a near-tie."""
    ref_eng = RefEngine(model["rb"], model["rp"], **dict(
        KW, max_batch=6, num_pages=48))
    ref_reqs = [ref_eng.submit(p, GEN) for p in model["prompts"]]
    ref_eng.run_to_completion()
    _, reqs = _serve_group(model, 2, "affinity")
    for mine, ref in zip(reqs, ref_reqs):
        if mine.generated == ref.generated:
            continue
        i = next(j for j, (a, b) in enumerate(zip(mine.generated,
                                                   ref.generated)) if a != b)
        logits = _ref_logits_along(model["rc"], model["rp"], ref.prompt,
                                   ref.generated)[i]
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] < LOGIT_ATOL, (ref.req_id, i, top2)


def test_cli_replicas_equal_one_engine(capsys):
    argv = ["--arch", "qwen2-7b", "--reduced", "--paged", "--page-size",
            "16", "--batch", "4", "--prompt-len", "40", "--gen", "6",
            "--device", "cpu"]
    one = serve_cli.main(argv)
    for routing in ROUTING_MODES:
        got = serve_cli.main(argv + ["--mesh", "2x1", "--routing", routing,
                                     "--prefix-cache"])
        np.testing.assert_array_equal(got, one)
    assert "2 replicas x model 1" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="torchrun"):
        serve_cli.main(argv + ["--mesh", "1x2"])
    with pytest.raises(NotImplementedError, match="A16"):
        serve_cli.main(argv + ["--mesh", "prod"])
    with pytest.raises(SystemExit):
        serve_cli.main([a for a in argv if a != "--paged"]
                       + ["--mesh", "2x1"])
