"""The port's telemetry against the reference's.

The port's counterpart of tests/test_telemetry.py.  The metrics layer is
host numpy in both packages, so the histogram, registry, aggregation,
ring-buffer and trace-shape cases feed the same observations to both and
their snapshots must be EQUAL.  On the same serve the two engines emit
the same lifecycle events (name, step, request), event for event, and
the same metrics snapshots (counters, the non-numerics gauges, TTFT in
steps).  The numerics probe's readings on the adversarial fixtures of
tests/adversarial_inputs.py equal the reference's within rtol 1e-5 (the
same numpy float32 arithmetic on the same pages).  Telemetry fully on
(tracing, metrics, the probe every step) is bit-neutral against fully off
at depths 0 and 1, bf16 and int8 pools, under preemption and cancel and
with speculation; the stats key set is pinned to schema 2 (plus the
port's three call counts); ``first_token_step`` has one stamp site.

Reduced qwen2-7b with ``block_kv == page_size == 8``; parameters come from
the reference's ``init_lm`` through numpy."""

import ast
import dataclasses
import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adversarial_inputs as adv
import repro.runtime as R
from repro.configs import get_config as ref_get_config
from repro.models.model_zoo import build as ref_build
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build
from repro_torch.runtime import (
    STATS_SCHEMA,
    Histogram,
    MetricsRegistry,
    NumericsProbe,
    ServeEngine,
    StepTracer,
    Telemetry,
    aggregate_snapshots,
)
from repro_torch.runtime.telemetry import LIFECYCLE_EVENTS

torch.set_num_threads(1)

PAGE = 8
GEN = 4
PROMPT_LENS = (37, 21, 45, 12)
SERVE_KW = dict(max_batch=4, num_pages=40, page_size=PAGE, max_seq_len=64,
                prefill_chunk=16)
PROBE_KEYS = ("kv_max_abs", "score_amp_max", "fp16_margin", "shift_mag_max",
              "resonance_max")


@pytest.fixture(scope="module")
def models():
    rc = ref_get_config("qwen2-7b").reduced()
    rc = dataclasses.replace(
        rc, attention=dataclasses.replace(rc.attention, block_kv=PAGE))
    tc = get_config("qwen2-7b").reduced()
    tc = dataclasses.replace(
        tc, attention=dataclasses.replace(tc.attention, block_kv=PAGE))
    rb = ref_build(rc)
    rp = rb.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.array(x, np.float32), rp)
    return dict(rb=rb, rp=rp, bundle=build(tc),
                tp=params_from_numpy(tree, tc, "cpu"))


@pytest.fixture(scope="module")
def prompts(models):
    rng = np.random.default_rng(0)
    vocab = models["bundle"].cfg.vocab_size
    return [rng.integers(0, vocab, n).tolist() for n in PROMPT_LENS]


def _serve(models, prompts, telemetry=None, **kw):
    eng = ServeEngine(models["bundle"], models["tp"], telemetry=telemetry,
                      **{**SERVE_KW, **kw})
    reqs = [eng.submit(p, GEN) for p in prompts]
    eng.run_to_completion()
    return reqs, eng


def _full(**kw):
    """Every layer on, the probe at every step."""
    kw.setdefault("numerics_every", 1)
    return Telemetry(tracing=True, metrics=True, **kw)


def _assert_pools_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for name in a:
        assert torch.equal(a[name][:, 1:].view(torch.uint8),
                           b[name][:, 1:].view(torch.uint8)), name


# ------------------------------------------------------ bit-neutrality --

@pytest.mark.parametrize("depth", [0, 1], ids=["sync", "async"])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_telemetry_is_bit_neutral(models, prompts, dtype, depth):
    """Tracing, metrics and a per-step probe change nothing: streams,
    first-token stamps and every non-null page byte (sidecars included)
    equal the uninstrumented serve's."""
    kw = dict(cache_dtype=dtype, pipeline_depth=depth, prefix_cache=True)
    ref, ref_eng = _serve(models, prompts, **kw)
    tel = _full()
    got, eng = _serve(models, prompts, telemetry=tel, **kw)
    assert [r.generated for r in got] == [r.generated for r in ref]
    assert ([r.first_token_step for r in got]
            == [r.first_token_step for r in ref])
    _assert_pools_equal(ref_eng.pool, eng.pool)
    snap = tel.metrics_snapshot()
    assert snap["counters"]["serve.requests_finished"]["value"] == len(prompts)
    assert snap["counters"]["numerics.samples"]["value"] > 0
    assert snap["gauges"]["numerics.fp16_margin"]["value"] is not None
    assert snap["histograms"]["serve.ttft_steps"]["count"] == len(prompts)
    assert tel.tracer.emitted > 0
    assert eng.metrics_snapshot() == snap


def test_telemetry_bit_neutral_under_preempt_and_cancel(models, prompts):
    """Preemption's drain and a mid-serve cancel with full telemetry:
    streams equal the uninstrumented serve's, and the counters and the
    trace see the events."""

    def run(tel):
        eng = ServeEngine(
            models["bundle"], models["tp"], max_batch=2, num_pages=12,
            page_size=PAGE, max_seq_len=64, prefill_chunk=16,
            prefix_cache=True, preemption=True, preempt_patience=2,
            pipeline_depth=1, telemetry=tel,
        )
        ra = eng.submit(prompts[2], 12)          # long straggler
        for _ in range(3):
            eng.step()
        rb = eng.submit(prompts[0], GEN)         # forces a preemption
        rc = eng.submit(prompts[1], GEN)
        eng.step()
        assert eng.cancel(rc.req_id)             # mid-serve cancel
        eng.run_to_completion()
        return (ra, rb), eng

    (ra0, rb0), eng0 = run(None)
    tel = _full()
    (ra1, rb1), eng1 = run(tel)
    assert eng0.preemptions >= 1, "the scenario must preempt"
    assert eng1.preemptions == eng0.preemptions
    assert ra1.generated == ra0.generated
    assert rb1.generated == rb0.generated
    snap = tel.metrics_snapshot()
    assert snap["counters"]["serve.preemptions"]["value"] >= 1
    assert snap["counters"]["serve.requests_cancelled"]["value"] == 1
    assert snap["counters"]["serve.resumes"]["value"] >= 1
    assert {"preempt", "resume", "cancel"} <= {
        e.name for e in tel.tracer.events()}


def test_spec_telemetry_bit_neutral_and_lazy(models):
    """The serve.spec.* instruments are bit-neutral, mirror the engine's
    own tallies, and are registered only by a serve that speculates."""
    spec_prompts = [[3, 5, 7, 9] * 4 + [3], [11, 12, 13] * 5]
    kw = dict(speculate=3, cache_dtype="int8")
    ref, ref_eng = _serve(models, spec_prompts, **kw)
    tel = _full()
    got, eng = _serve(models, spec_prompts, telemetry=tel, **kw)
    assert [r.generated for r in got] == [r.generated for r in ref]
    _assert_pools_equal(ref_eng.pool, eng.pool)
    st = eng.stats()["spec"]
    assert st["verify_steps"] >= 1, "the workload must speculate"
    c = tel.metrics_snapshot()["counters"]
    assert c["serve.spec.proposed"]["value"] == st["proposed"]
    assert c["serve.spec.accepted"]["value"] == st["accepted"]
    assert c["serve.spec.verify_steps"]["value"] == st["verify_steps"]
    assert c["serve.spec.rollback_pages"]["value"] >= 0
    h = tel.metrics_snapshot()["histograms"]["serve.spec.accepted_per_verify"]
    assert h["count"] == st["verify_steps"]
    assert h["sum"] == st["accepted"]
    tel_off = _full()
    _serve(models, spec_prompts, telemetry=tel_off)
    snap_off = tel_off.metrics_snapshot()
    assert not any(k.startswith("serve.spec.") for k in
                   list(snap_off["counters"]) + list(snap_off["histograms"]))


# ------------------------------------- the metrics layer, both packages --

def _both(fn):
    """Run ``fn`` on the port's module and on the reference's."""
    import repro_torch.runtime.telemetry as T
    import repro.runtime.telemetry as RTel

    return fn(T), fn(RTel)


def test_histogram_snapshots_equal_reference():
    def feed(mod):
        out = []
        for bounds, vals in (((1.0, 2.0, 4.0, 8.0), (0.5, 1.5, 1.5, 3.0, 7.0)),
                             ((1.0, 2.0), (100.0, 200.0)),
                             ((1.0, 2.0), ())):
            h = mod.Histogram("t", bounds=bounds)
            for v in vals:
                h.observe(v)
            out.append((h.snapshot(), [h.percentile(p) for p in
                                       (0, 25, 50, 99, 100)]))
        rng = np.random.default_rng(3)
        h = mod.Histogram("t")
        for v in rng.lognormal(-3.0, 2.0, 500):
            h.observe(float(v))
        out.append((h.snapshot(), None))
        return out

    mine, theirs = _both(feed)
    assert mine == theirs
    h = Histogram("t", bounds=(1.0, 2.0, 4.0, 8.0))
    for v in (0.5, 1.5, 1.5, 3.0, 7.0):
        h.observe(v)
    assert h.count == 5 and h.min == 0.5 and h.max == 7.0
    assert h.percentile(0) == 0.5 and h.percentile(100) == 7.0
    with pytest.raises(ValueError):
        h.percentile(101)
    with pytest.raises(ValueError):
        Histogram("bad", bounds=())
    with pytest.raises(ValueError):
        Histogram("bad", bounds=(2.0, 1.0))


def test_registry_snapshots_equal_reference():
    def feed(mod):
        m = mod.MetricsRegistry()
        c = m.counter("a")
        assert m.counter("a") is c
        with pytest.raises(ValueError):
            m.gauge("a")
        with pytest.raises(ValueError):
            c.inc(-1)
        c.inc(3)
        m.gauge("g").set(3)
        m.histogram("h").observe(1.0)
        m.histogram("h2", bounds=(1, 2, 4), unit="s").observe(3)
        return m.snapshot()

    mine, theirs = _both(feed)
    assert mine == theirs
    json.dumps(mine)


def test_aggregate_snapshots_equal_reference():
    def feed(mod):
        a, b, c, d = (mod.MetricsRegistry() for _ in range(4))
        for m, n in ((a, 3), (b, 5)):
            m.counter("c").inc(n)
            m.gauge("depth").set(n)
            m.gauge("clock_max").set(n)
            m.histogram("h", bounds=(1.0, 10.0)).observe(n)
        c.gauge("depth")
        d.histogram("h", bounds=(1.0, 2.0)).observe(1.0)
        merged = mod.aggregate_snapshots([a.snapshot(), b.snapshot()])
        merged2 = mod.aggregate_snapshots([a.snapshot(), c.snapshot()])
        with pytest.raises(ValueError):
            mod.aggregate_snapshots([a.snapshot(), d.snapshot()])
        # replicas: per-replica children aggregated by the parent
        tel = mod.Telemetry(tracing=True, metrics=True)
        kids = [tel.for_replica(i) for i in range(2)]
        for i, k in enumerate(kids):
            k.on_submit(i, 0)
            k.on_first_token(i, 0, 2 + i)
            k.on_finish(i, 5)
        snap = tel.metrics_snapshot()
        snap["histograms"].pop("serve.ttft_seconds")   # wall clocks differ
        return merged, merged2, snap

    mine, theirs = _both(feed)
    assert mine == theirs
    merged = mine[0]
    assert merged["counters"]["c"]["value"] == 8
    assert merged["gauges"]["depth"]["value"] == 8
    assert merged["gauges"]["clock_max"]["value"] == 5
    assert mine[1]["gauges"]["depth"]["value"] == 3


def test_ring_buffer_and_jsonl_equal_reference(tmp_path):
    def feed(mod):
        tr = mod.StepTracer(capacity=8)
        for i in range(20):
            tr.span("plan", i, 0.5 * i, 0.5 * i + 0.25, args={"live": i})
        path = tmp_path / f"{mod.__name__}.jsonl"
        n = tr.write_jsonl(str(path))
        lines = [json.loads(x) for x in path.read_text().splitlines()]
        lines[0].pop("meta")                       # the module's name
        return n, tr.emitted, tr.dropped, lines

    mine, theirs = _both(feed)
    assert mine == theirs
    n, emitted, dropped, lines = mine
    assert (n, emitted, dropped, len(lines)) == (8, 20, 12, 9)
    assert lines[1]["step"] == 12
    with pytest.raises(ValueError):
        StepTracer(capacity=0)


def test_chrome_trace_shape_equals_reference(tmp_path):
    def feed(mod):
        tr = mod.StepTracer()
        tr.span("plan", 0, 0.0, 0.001, args={"live": 2})
        tr.span("dispatch", 0, 0.001, 0.003, engine=1)
        tr.instant("submit", 0, args={"req_id": 7})
        tr.counter("engine", 0, {"waiting": 3})
        path = tmp_path / f"{mod.__name__}.json"
        n = tr.write_chrome_trace(str(path))
        doc = json.loads(path.read_text())
        doc["otherData"].pop("source")
        for e in doc["traceEvents"]:
            if e["ph"] in ("i", "C"):
                e.pop("ts")                        # the tracer's clock
        return n, doc

    mine, theirs = _both(feed)
    assert mine == theirs
    n, doc = mine
    assert n == 4
    span = next(e for e in doc["traceEvents"]
                if e["ph"] == "X" and e["name"] == "plan")
    assert span["dur"] == pytest.approx(1000.0)
    assert {e["pid"] for e in doc["traceEvents"] if e["ph"] != "M"} == {0, 1}


# ------------------------------------------- one serve, both engines --

def _traced(engine_cls, bundle, params, prompts, **kw):
    tel = (Telemetry if engine_cls is ServeEngine else R.Telemetry)(
        tracing=True, metrics=True, numerics_every=0)
    eng = engine_cls(bundle, params, telemetry=tel, **SERVE_KW,
                     prefix_cache=True, **kw)
    reqs = [eng.submit(p, GEN) for p in prompts]
    eng.run_to_completion()
    reqs.append(eng.submit(prompts[0], GEN))     # hits the donated prefix
    eng.run_to_completion()
    return tel, eng, reqs


@pytest.mark.parametrize("depth", [0, 1])
def test_lifecycle_and_metrics_equal_reference_engine(models, prompts, depth):
    """The same serve through both engines: the lifecycle instants
    (name, step, request) are equal event for event, and so are the
    counters, the gauges other than the probe's and the wall clock's, and
    the TTFT-in-steps histogram.  No count here depends on token values."""
    ref_tel, ref_eng, _ = _traced(R.ServeEngine, models["rb"], models["rp"],
                                  prompts, pipeline_depth=depth,
                                  cache_dtype=jnp.bfloat16)
    tel, eng, reqs = _traced(ServeEngine, models["bundle"], models["tp"],
                             prompts, pipeline_depth=depth)

    def life(t):
        return [(e.name, e.step, e.args["req_id"]) for e in t.tracer.events()
                if e.name in LIFECYCLE_EVENTS]

    assert life(tel) == life(ref_tel)
    assert len(life(tel)) == 5 * 4                 # no preempt, no cancel
    mine, theirs = tel.metrics_snapshot(), ref_tel.metrics_snapshot()
    assert mine["counters"] == theirs["counters"]
    assert mine["counters"]["prefix.hits"]["value"] > 0
    assert mine["histograms"]["serve.ttft_steps"] == \
        theirs["histograms"]["serve.ttft_steps"]
    assert set(mine["gauges"]) == set(theirs["gauges"])
    assert mine["gauges"] == theirs["gauges"]      # no probe: no numerics
    spans = [(e.name, e.step) for e in tel.tracer.events()
             if e.name in ("plan", "retire")]
    assert spans == [(n, s) for s in range(eng.steps)
                     for n in ("plan", "retire")]
    stamp = {e.args["req_id"]: e.step for e in tel.tracer.events()
             if e.name == "first_token"}
    assert stamp == {r.req_id: r.first_token_step for r in reqs}


# ------------------------------------------------------- stats schema --

ENGINE_STATS_KEYS = frozenset({
    "schema", "steps", "running", "waiting", "finished", "free_pages",
    "live_pages", "cache_bytes", "cache_bytes_per_device", "page_size",
    "pool_dtype", "chunked_prefill", "scheduler", "prefill_batch",
    "step_token_budget", "preemptions", "trimmed_pages", "temperature",
    "last_step_tokens", "max_step_tokens", "pipeline_depth", "inflight",
    "cancellations", "prefix_cache", "speculate", "spec",
})
PORT_KEYS = frozenset({"prefill_calls", "decode_calls", "verify_calls"})
PREFIX_CACHE_KEYS = frozenset({
    "cached_pages", "evictable_pages", "hits", "misses", "evictions",
    "donations",
})
SPEC_KEYS = frozenset({"proposed", "accepted", "rollbacks", "verify_steps"})


def test_engine_stats_schema_pinned(models, prompts):
    """Schema 2: exactly the reference's keys plus the port's three call
    counts, always all present."""
    _, eng = _serve(models, prompts[:2], prefix_cache=True)
    st = eng.stats()
    assert st["schema"] == STATS_SCHEMA == R.STATS_SCHEMA == 2
    assert frozenset(st) == ENGINE_STATS_KEYS | PORT_KEYS
    assert frozenset(st["prefix_cache"]) == PREFIX_CACHE_KEYS
    assert frozenset(st["spec"]) == SPEC_KEYS
    assert st["speculate"] == 0
    assert all(v == 0 for v in st["spec"].values())
    assert st["cache_bytes_per_device"] == st["cache_bytes"]
    _, eng_off = _serve(models, prompts[:1], prefix_cache=False)
    st_off = eng_off.stats()
    assert frozenset(st_off) == ENGINE_STATS_KEYS | PORT_KEYS
    assert st_off["prefix_cache"] is None
    json.dumps(st)


# ------------------------------------------------------------- TTFT --

def test_first_token_stamped_only_at_retirement():
    """``first_token_step`` is assigned in exactly one ServeEngine method,
    ``_retire_one``."""
    import repro_torch.runtime.engine as engine_mod

    tree = ast.parse(inspect.getsource(engine_mod))
    sites = []
    for cls in ast.walk(tree):
        if not (isinstance(cls, ast.ClassDef) and cls.name == "ServeEngine"):
            continue
        for fn in cls.body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and any(
                        isinstance(t, ast.Attribute)
                        and t.attr == "first_token_step"
                        for t in node.targets):
                    sites.append(fn.name)
    assert sites == ["_retire_one"], sites


def test_ttft_measured_from_original_submit_across_preemption(models,
                                                              prompts):
    """A preempted-then-resumed request keeps its first-token stamp, and
    the histogram observes each request once with that value."""
    tel = _full(numerics_every=0)
    eng = ServeEngine(
        models["bundle"], models["tp"], max_batch=2, num_pages=12,
        page_size=PAGE, max_seq_len=64, prefill_chunk=16, prefix_cache=True,
        preemption=True, preempt_patience=2, telemetry=tel,
    )
    ra = eng.submit(prompts[2], 12)
    for _ in range(3):
        eng.step()
    assert ra.generated, "the straggler must be mid-decode"
    first_stamp = ra.first_token_step
    assert first_stamp >= 0
    rb = eng.submit(prompts[0], GEN)
    eng.run_to_completion()
    assert ra.preempt_count >= 1, "the scenario must preempt"
    assert ra.first_token_step == first_stamp
    assert ra.first_token_step < ra.preempt_step
    h = tel.metrics.histogram("serve.ttft_steps")
    assert h.count == 2
    observed = {ra.first_token_step - ra.submit_step + 1,
                rb.first_token_step - rb.submit_step + 1}
    assert h.min in observed and h.max in observed


# ----------------------------------------------------- numerics probe --

def _pages_from_k(k_bshd, page=8):
    """(1, KVH, S, D) K -> a one-layer raw pool leaf (1, P, page, KVH*D)
    as numpy, and the probe's (page id, valid rows) list."""
    _, kvh, s, d = k_bshd.shape
    n = s // page
    pages = np.moveaxis(np.asarray(k_bshd, np.float32)[0], 0, 1)
    return pages.reshape(n, page, kvh * d)[None], [(i, page)
                                                  for i in range(n)], kvh


def _probe_both(pool_np, pages_valid, kvh, **kw):
    mine = NumericsProbe(every=1, **kw).sample(
        {n: torch.from_numpy(np.array(x)) for n, x in pool_np.items()},
        pages_valid, n_kv_heads=kvh)
    theirs = R.NumericsProbe(every=1, **kw).sample(
        {n: jnp.asarray(x) for n, x in pool_np.items()},
        pages_valid, n_kv_heads=kvh)
    return mine, theirs


def _assert_reading_equal(mine, theirs):
    assert mine["pages_sampled"] == theirs["pages_sampled"]
    for key in PROBE_KEYS:
        np.testing.assert_allclose(mine[key], theirs[key], rtol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("case", adv.ADVERSARIAL_CASES)
def test_probe_matches_reference_on_adversarial_fixtures(case):
    kvh, d, s = 2, 32, 64
    _, k, _ = adv.make_adversarial(
        case, jax.random.PRNGKey(0), q_shape=(1, kvh, 4, d),
        kv_shape=(1, kvh, s, d))
    leaf, pages_valid, kvh = _pages_from_k(k)
    mine, theirs = _probe_both({"k": leaf}, pages_valid, kvh, max_pages=4)
    _assert_reading_equal(mine, theirs)
    if case == "resonance_0":
        assert mine["score_amp_max"] > 65504.0
        assert mine["fp16_margin"] < 0.0
        assert mine["resonance_max"] > 0.9
    if case == "seq_bias":
        assert mine["shift_mag_max"] > 10.0


def test_probe_quantized_sidecars_match_reference():
    """An int8 pool: codes through the page's scale / shift sidecars, the
    shift gauge read from the sidecar; partial valid rows."""
    rng = np.random.default_rng(5)
    n, page, kvh, d = 6, 8, 2, 16
    codes = rng.integers(-127, 128, (1, n, page, kvh * d)).astype(np.int8)
    scale = rng.uniform(0.01, 0.2, (1, n, kvh)).astype(np.float32)
    shift = rng.normal(0.0, 3.0, (1, n, kvh * d)).astype(np.float32)
    pool = {"k": codes, "k_scale": scale, "k_shift": shift}
    pages_valid = [(i, 1 + (3 * i) % page) for i in range(n)]
    mine, theirs = _probe_both(pool, pages_valid, kvh, max_pages=8)
    _assert_reading_equal(mine, theirs)


def test_probe_masks_stale_tail_rows():
    """Inf debris past a page's valid rows changes no reading."""
    kvh, d, s = 2, 32, 64
    k = np.random.default_rng(3).standard_normal((1, kvh, s, d))
    leaf, pages_valid, _ = _pages_from_k(k)
    pv = [(i, 3) for i, _ in pages_valid]
    clean, _ = _probe_both({"k": leaf}, pv, kvh)
    dirty_leaf = leaf.copy()
    dirty_leaf[:, :, 3:] = np.inf
    dirty, theirs = _probe_both({"k": dirty_leaf}, pv, kvh)
    _assert_reading_equal(dirty, theirs)
    for key in PROBE_KEYS:
        assert np.isfinite(dirty[key])
        assert dirty[key] == pytest.approx(clean[key])


def test_probe_empty_and_validation():
    probe = NumericsProbe(every=4)
    zeros = {"k": torch.zeros((1, 2, 8, 4))}
    assert probe.sample(zeros, [], n_kv_heads=1) is None
    assert probe.sample(zeros, [(1, 0)], n_kv_heads=1) is None
    assert [probe.due(s) for s in (0, 1, 4, 7, 8)] == [
        True, False, True, False, True]
    with pytest.raises(ValueError):
        NumericsProbe(every=0)
    with pytest.raises(ValueError):
        NumericsProbe(every=1, max_pages=0)


def test_probe_reads_quantized_pool_live(models, prompts):
    """On a live int8 serve the probe's gauges are finite and benign, and
    its last reading equals the numpy probe on the same pages read back
    from the pool."""
    tel = _full()
    reqs, eng = _serve(models, prompts[:2], telemetry=tel, cache_dtype="int8")
    snap = tel.metrics_snapshot()
    assert snap["counters"]["numerics.samples"]["value"] > 0
    for key in PROBE_KEYS:
        v = snap["gauges"][f"numerics.{key}"]["value"]
        assert v is not None and np.isfinite(v)
    assert snap["gauges"]["numerics.fp16_margin"]["value"] > 0
    assert 0.0 <= snap["gauges"]["numerics.resonance_max"]["value"] <= 1.0
    assert snap["counters"]["numerics.fp16_overflow_risk"]["value"] == 0
    # the reference's probe on the same pool, read out as numpy
    pool_np = {n: x.numpy() for n, x in eng.pool.items()
               if n in ("k", "k_scale", "k_shift")}
    pages = [(p, PAGE) for p in range(1, 5)]
    mine, theirs = _probe_both(pool_np, pages,
                               models["bundle"].cfg.n_kv_heads)
    _assert_reading_equal(mine, theirs)
