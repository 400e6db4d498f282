"""The tenant policy in the port: ``TenantQuotaPolicy`` / ``TenantQuota``
held against the reference's on the same views (the counterparts of
tests/test_fleet.py's policy tests, plus seeded random view lists through
every hook), tenant scheduling through the port's engine (streams equal
the tenant-blind FCFS serve's at every pool and pipeline depth, the
schedule equal to the reference engine's, quota waits that never
preempt, preempt-resume and cancel under the policy, the per-tenant
telemetry series, ``submit`` validation), and the CLI's ``--scheduler
tenant --tenant-quotas`` beside the reference's.

Engine tests run the reduced qwen2-7b with ``block_kv == page_size == 8``
and the reference's ``init_lm`` parameters carried across through numpy
(``params_from_numpy``)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.runtime as R
from repro.configs import get_config as ref_get_config
from repro.launch import serve as ref_serve
from repro.models.model_zoo import build as ref_build
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build
from repro_torch.runtime import (
    DEFAULT_TENANT,
    POLICIES,
    PRIORITY_CLASSES,
    RequestView,
    SchedulerPolicy,
    ServeEngine,
    Telemetry,
    TenantQuota,
    TenantQuotaPolicy,
    chunked_cold_reference,
    get_scheduler,
)

torch.set_num_threads(1)

PAGE = 8
CHUNK = 16
GEN = 4
PROMPT_LENS = (37, 21, 45, 12)
TENANTS = ("bulk", "interactive", "bulk", "interactive")
PRIOS = ("throughput", "latency", "throughput", "latency")


# ------------------------------------------------------------ policy --

def _v(pkg, req_id, *, tenant=DEFAULT_TENANT, priority="throughput",
       prompt_len=64, remaining_prefill=None, remaining_decode=8,
       submit_step=0, admit_step=-1, slot=-1, pages_needed=4,
       preempt_count=0, preempt_step=-1):
    """A RequestView of package ``pkg`` (the reference's runtime or the
    port's), the fields of tests/test_fleet.py's helper."""
    return pkg.RequestView(
        req_id=req_id, prompt_len=prompt_len,
        remaining_prefill=(prompt_len if remaining_prefill is None
                           else remaining_prefill),
        remaining_decode=remaining_decode, submit_step=submit_step,
        admit_step=admit_step, slot=slot, pages_needed=pages_needed,
        preempt_count=preempt_count, preempt_step=preempt_step,
        tenant=tenant, priority=priority)


class _Port:
    RequestView = RequestView
    TenantQuota = TenantQuota
    TenantQuotaPolicy = TenantQuotaPolicy


def _ids(views):
    return [v.req_id for v in views]


# Each case: (package -> the decision), the decision tests/test_fleet.py
# expects (None: checked against the reference only).
def _admission_latency_first(pkg):
    pol = pkg.TenantQuotaPolicy(patience=100)
    ws = [_v(pkg, 1, priority="throughput", submit_step=0),
          _v(pkg, 2, priority="latency", submit_step=5),
          _v(pkg, 3, priority="throughput", submit_step=1),
          _v(pkg, 4, priority="latency", submit_step=2)]
    return _ids(pol.admission_order(ws, now=10))


def _aging_guard(pkg):
    pol = pkg.TenantQuotaPolicy(patience=16)
    ws = [_v(pkg, 1, priority="throughput", submit_step=0),
          _v(pkg, 2, priority="latency", submit_step=30),
          _v(pkg, 3, priority="throughput", submit_step=10),
          _v(pkg, 4, priority="latency", submit_step=31)]
    return _ids(pol.admission_order(ws, now=32))


def _aging_preempt_step(pkg):
    pol = pkg.TenantQuotaPolicy(patience=16)
    ws = [_v(pkg, 1, priority="throughput", submit_step=0, preempt_count=1,
             preempt_step=30),
          _v(pkg, 2, priority="latency", submit_step=29)]
    return _ids(pol.admission_order(ws, now=32))


def _quota_waiting(pkg):
    return [_v(pkg, 1, tenant="a", submit_step=0, pages_needed=4),
            _v(pkg, 2, tenant="a", submit_step=1, pages_needed=4),
            _v(pkg, 3, tenant="b", submit_step=2, pages_needed=40)]


def _admission_withholds(pkg):
    pol = pkg.TenantQuotaPolicy({"a": pkg.TenantQuota(max_pages=8)})
    running = [_v(pkg, 9, tenant="a", slot=0, admit_step=0, pages_needed=3)]
    return _ids(pol.plan_admission(_quota_waiting(pkg), running))


def _admission_quota_freed(pkg):
    pol = pkg.TenantQuotaPolicy({"a": pkg.TenantQuota(max_pages=8)})
    return _ids(pol.plan_admission(_quota_waiting(pkg), []))


def _prefill_token_cap(pkg):
    pol = pkg.TenantQuotaPolicy(
        {"flood": pkg.TenantQuota(max_step_tokens=24)})
    vs = [_v(pkg, 1, tenant="flood", remaining_prefill=16, pages_needed=2),
          _v(pkg, 2, tenant="flood", remaining_prefill=40, pages_needed=5),
          _v(pkg, 3, tenant="quiet", remaining_prefill=40, pages_needed=5)]
    return pol.plan_prefill(vs, n_decode=0, budget=64, chunk=16, page_size=8,
                            max_rows=4)


def _prefill_latency_first(pkg):
    pol = pkg.TenantQuotaPolicy()
    vs = [_v(pkg, 1, priority="throughput", remaining_prefill=8),
          _v(pkg, 2, priority="latency", remaining_prefill=40)]
    return pol.plan_prefill(vs, n_decode=0, budget=16, chunk=16, page_size=8,
                            max_rows=4)


def _victim(pkg):
    pol = pkg.TenantQuotaPolicy()
    running = [
        _v(pkg, 1, priority="latency", slot=0, admit_step=0, pages_needed=9),
        _v(pkg, 2, priority="throughput", slot=1, admit_step=1,
           pages_needed=3),
        _v(pkg, 3, priority="throughput", slot=2, admit_step=2,
           pages_needed=5)]
    return pol.choose_victim(running, now=5).req_id


def _victim_paid(pkg):
    pol = pkg.TenantQuotaPolicy()
    paid = [
        _v(pkg, 1, priority="latency", slot=0, admit_step=0, pages_needed=9),
        _v(pkg, 2, priority="throughput", slot=1, admit_step=1,
           pages_needed=3, preempt_count=1, preempt_step=3)]
    return pol.choose_victim(paid, now=5).req_id


def _victim_none(pkg):
    return pkg.TenantQuotaPolicy().choose_victim([], now=5)


def _speculation(pkg):
    """Latency rows draft first; each tenant's drafts capped at its
    max_step_tokens; then the leftover budget runs out."""
    pol = pkg.TenantQuotaPolicy({"bulk": pkg.TenantQuota(max_step_tokens=5)})
    vs = [_v(pkg, 1, tenant="bulk", remaining_decode=9, submit_step=0),
          _v(pkg, 2, tenant="bulk", remaining_decode=9, submit_step=1),
          _v(pkg, 3, tenant="chat", priority="latency", remaining_decode=3,
             submit_step=2),
          _v(pkg, 4, tenant="chat", priority="latency", remaining_decode=9,
             submit_step=3)]
    return (pol.plan_speculation(vs, k=4),
            pol.plan_speculation(vs, k=4, budget_left=7))


POLICY_CASES = {
    "admission_latency_class_first": (_admission_latency_first, [4, 2, 1, 3]),
    "aging_guard_beats_class_rank": (_aging_guard, [1, 3, 2, 4]),
    "aging_anchors_on_preempt_step": (_aging_preempt_step, [2, 1]),
    "plan_admission_withholds_over_quota": (_admission_withholds, [1, 3]),
    "plan_admission_quota_freed": (_admission_quota_freed, [1, 2, 3]),
    "plan_prefill_per_tenant_token_cap": (
        _prefill_token_cap, [(1, 16), (2, 8), (3, 16)]),
    "plan_prefill_latency_class_first": (_prefill_latency_first, [(2, 16)]),
    "choose_victim_class_aware": (_victim, 3),
    "choose_victim_after_paging_out": (_victim_paid, 1),
    "choose_victim_none_running": (_victim_none, None),
    "plan_speculation_latency_first_capped": (
        _speculation, ([(3, 2), (4, 4), (1, 4), (2, 1)],
                       [(3, 2), (4, 4), (1, 1)])),
}


@pytest.mark.parametrize("case", list(POLICY_CASES))
def test_policy_decisions_match_reference(case):
    decide, want = POLICY_CASES[case]
    got = decide(_Port)
    assert got == decide(R)
    assert got == want


def test_registry_and_validation():
    assert isinstance(get_scheduler("tenant"), TenantQuotaPolicy)
    assert sorted(POLICIES) == sorted(R.POLICIES)
    assert PRIORITY_CLASSES == R.PRIORITY_CLASSES
    assert DEFAULT_TENANT == R.DEFAULT_TENANT
    pol = TenantQuotaPolicy({"a": {"max_pages": 4}})
    assert pol.quotas["a"] == TenantQuota(max_pages=4)
    for bad in (dict(max_pages=0), dict(max_step_tokens=-1)):
        with pytest.raises(ValueError):
            TenantQuota(**bad)
    with pytest.raises(ValueError):
        TenantQuotaPolicy(patience=0)
    assert not TenantQuotaPolicy().hol_blocking
    # the base hook delegates to admission_order (running ignored)
    ws = [_v(_Port, 1), _v(_Port, 2)]
    assert _ids(SchedulerPolicy().plan_admission(ws, [_v(_Port, 9, slot=0)])) \
        == _ids(SchedulerPolicy().admission_order(ws))


def _random_views(rng, n):
    """Seeded view fields: tenants a / b / c, both classes, waiting or
    running, some paged out."""
    out = []
    for i in range(n):
        prompt = int(rng.integers(1, 200))
        running = bool(rng.random() < 0.5)
        paged_out = bool(rng.random() < 0.2)
        out.append(dict(
            req_id=i, tenant=str(rng.choice(["a", "b", "c"])),
            priority=str(rng.choice(PRIORITY_CLASSES)), prompt_len=prompt,
            remaining_prefill=int(rng.integers(0, prompt + 1)),
            remaining_decode=int(rng.integers(0, 12)),
            submit_step=int(rng.integers(0, 40)),
            admit_step=int(rng.integers(0, 50)) if running else -1,
            slot=i if running else -1,
            pages_needed=int(rng.integers(1, 12)),
            preempt_count=int(paged_out),
            preempt_step=int(rng.integers(0, 50)) if paged_out else -1))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_policy_hooks_match_reference_on_random_views(seed):
    """Every hook of the tenant policy, on the same seeded view lists
    under quotas with page and token caps: the port's plans equal the
    reference's."""
    rng = np.random.default_rng(seed)
    quotas = {"a": dict(max_pages=9, max_step_tokens=24),
              "b": dict(max_step_tokens=16), "c": dict(max_pages=14)}
    for _ in range(25):
        fields = _random_views(rng, int(rng.integers(1, 9)))
        now = int(rng.integers(0, 80))
        patience = int(rng.integers(1, 30))
        n_decode = int(rng.integers(0, 4))
        budget = [None, 48, 20][int(rng.integers(0, 3))]
        plans = []
        for pkg in (R, _Port):
            pol = pkg.TenantQuotaPolicy(quotas, patience=patience)
            views = [_v(pkg, **f) for f in fields]
            waiting = [v for v in views if v.slot < 0]
            running = [v for v in views if v.slot >= 0]
            victim = pol.choose_victim(running, now=now)
            plans.append((
                _ids(pol.admission_order(waiting, now=now)),
                _ids(pol.plan_admission(waiting, running, now=now)),
                _ids(pol.prefill_order(views)),
                pol.plan_prefill(views, n_decode=n_decode, budget=budget,
                                 chunk=32, page_size=8, max_rows=3),
                pol.plan_speculation(running, k=4, budget_left=None),
                pol.plan_speculation(running, k=4, budget_left=6),
                None if victim is None else victim.req_id,
            ))
        assert plans[0] == plans[1]


# ------------------------------------------------------------ engine --

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
def workload():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, n).tolist() for n in PROMPT_LENS]


def _policy(pkg):
    """bulk capped at 7 pages (its two requests need 6 and 7 at page 8,
    so they never run together) and 16 prefill tokens a step."""
    return pkg.TenantQuotaPolicy(
        {"bulk": pkg.TenantQuota(max_pages=7, max_step_tokens=16)},
        patience=64)


def _serve(engine_cls, bundle, params, prompts, *, tenants=None, **kw):
    for key, val in dict(max_batch=4, num_pages=40, page_size=PAGE,
                         max_seq_len=64, prefill_chunk=CHUNK).items():
        kw.setdefault(key, val)
    eng = engine_cls(bundle, params, **kw)
    reqs = [eng.submit(p, GEN,
                       tenant=tenants[i] if tenants else DEFAULT_TENANT,
                       priority=PRIOS[i] if tenants else "throughput")
            for i, p in enumerate(prompts)]
    eng.run_to_completion()
    return [list(r.generated) for r in reqs], reqs, eng


def _schedule(reqs, eng):
    """What the policy decided: per request its admission, first-token
    and finish steps and page-outs; the engine's steps and preemptions."""
    return ([(r.admit_step, r.first_token_step, r.finish_step,
              r.preempt_count) for r in reqs], eng.steps, eng.preemptions)


@pytest.mark.parametrize("depth", [0, 1], ids=["sync", "async"])
@pytest.mark.parametrize("dtype", ["bf16", "fp8_e4m3", "int8"])
def test_tenant_streams_equal_fcfs_and_schedule_equals_reference(
        models, workload, dtype, depth):
    """Quotas and classes reorder when work runs, never what it computes:
    the port's streams under the tenant policy equal its tenant-blind
    FCFS serve's, at every pool and depth; and the port's schedule (each
    request's admission, first-token and finish steps, the call counts)
    equals the reference engine's under the same policy."""
    bundle, tp = models["bundle"], models["tp"]
    want, _, _ = _serve(ServeEngine, bundle, tp, workload, cache_dtype=dtype)
    got, reqs, eng = _serve(ServeEngine, bundle, tp, workload,
                            tenants=TENANTS, scheduler=_policy(_Port),
                            cache_dtype=dtype, pipeline_depth=depth)
    assert got == want
    assert eng.stats()["inflight"] == 0
    _, ref_reqs, ref_eng = _serve(R.ServeEngine, models["rb"], models["rp"],
                                  workload, tenants=TENANTS,
                                  scheduler=_policy(R), cache_dtype=dtype,
                                  pipeline_depth=depth)
    assert _schedule(reqs, eng) == _schedule(ref_reqs, ref_eng)
    # the quota bit: bulk's second request waited for the first
    bulk = [r for r in reqs if r.tenant == "bulk"]
    assert bulk[1].admit_step >= bulk[0].finish_step


def test_quota_withheld_never_preempts(models, workload):
    """A request withheld by its tenant's page quota is not page-starved:
    with preemption armed at patience 1 and a pool of free pages it
    waits, nobody is paged out, and it serves as it would alone."""
    bundle, tp = models["bundle"], models["tp"]
    eng = ServeEngine(bundle, tp, max_batch=4, num_pages=40, page_size=PAGE,
                      max_seq_len=64, prefill_chunk=CHUNK,
                      scheduler=TenantQuotaPolicy(
                          {"bulk": TenantQuota(max_pages=7)}),
                      preemption=True, preempt_patience=1)
    ra = eng.submit(workload[2], GEN, tenant="bulk")   # 45 + 4 -> 7 pages
    rb = eng.submit(workload[0], GEN, tenant="bulk")   # 37 + 4 -> 6 pages
    for _ in range(4):
        eng.step()
    assert ra.state == "running" and rb.state == "waiting"
    assert rb.blocked_steps == 0                       # never page-starved
    assert eng.allocator.free_pages > rb.pages_needed(PAGE)
    eng.run_to_completion()
    assert eng.preemptions == 0
    for r, w in ((ra, 2), (rb, 0)):
        assert r.generated == chunked_cold_reference(
            bundle, tp, workload[w], GEN, page_size=PAGE,
            prefill_chunk=CHUNK)


def _preempt_run(engine_cls, bundle, params, workload, policy):
    eng = engine_cls(bundle, params, max_batch=2, num_pages=12,
                     page_size=PAGE, max_seq_len=64, prefill_chunk=CHUNK,
                     prefix_cache=True, preemption=True, preempt_patience=2,
                     scheduler=policy)
    ra = eng.submit(workload[2], 12, tenant="bulk", priority="throughput")
    for _ in range(3):
        eng.step()
    assert ra.generated, "the straggler decodes before the arrival"
    rb = eng.submit(workload[0], GEN, tenant="interactive",
                    priority="latency")
    eng.run_to_completion()
    return ra, rb, eng


def test_preempt_resume_under_tenant_policy(models, workload):
    """Real page starvation still preempts under the tenant policy: the
    class-aware victim is the throughput straggler, the latency arrival
    keeps its pages, the resumed stream equals the uninterrupted serve,
    and the page-out happens at the reference engine's step."""
    bundle, tp = models["bundle"], models["tp"]
    ra, rb, eng = _preempt_run(ServeEngine, bundle, tp, workload,
                               TenantQuotaPolicy())
    assert eng.preemptions >= 1 and ra.preempt_count >= 1
    assert rb.preempt_count == 0
    for r, prompt, gen in ((ra, workload[2], 12), (rb, workload[0], GEN)):
        assert r.generated == chunked_cold_reference(
            bundle, tp, prompt, gen, page_size=PAGE, prefill_chunk=CHUNK)
    rra, rrb, reng = _preempt_run(R.ServeEngine, models["rb"], models["rp"],
                                  workload, R.TenantQuotaPolicy())
    assert _schedule([ra, rb], eng) == _schedule([rra, rrb], reng)
    assert ra.preempt_step == rra.preempt_step


def test_cancel_releases_quota(models, workload):
    """Cancelling the running request frees its tenant's quota: the
    withheld sibling admits and serves as it would alone; no preemption."""
    bundle, tp = models["bundle"], models["tp"]
    eng = ServeEngine(bundle, tp, max_batch=4, num_pages=40, page_size=PAGE,
                      max_seq_len=64, prefill_chunk=CHUNK,
                      scheduler=TenantQuotaPolicy(
                          {"bulk": TenantQuota(max_pages=7)}),
                      preemption=True, preempt_patience=1)
    ra = eng.submit(workload[2], 12, tenant="bulk")
    rb = eng.submit(workload[0], GEN, tenant="bulk")
    for _ in range(4):
        eng.step()
    assert ra.state == "running" and rb.state == "waiting"
    assert eng.cancel(ra.req_id)
    eng.run_to_completion()
    assert eng.preemptions == 0
    assert ra.state == "cancelled" and rb.state == "finished"
    assert rb.generated == chunked_cold_reference(
        bundle, tp, workload[0], GEN, page_size=PAGE, prefill_chunk=CHUNK)


def _counts(snap):
    """The count-valued series of a metrics snapshot (wall-clock series
    left out): counters and the step-clock histograms' counts and sums."""
    out = {k: v["value"] for k, v in snap["counters"].items()}
    out.update({k: (v["count"], v["sum"]) for k, v in snap["histograms"].items()
                if k.endswith("ttft_steps")})
    return out


def test_per_tenant_telemetry_series(models, workload):
    """Per-tenant series exist for the named tenants only, count their
    traffic, sum to the serve.* aggregates, equal the reference engine's
    series on the same serve, and submit events carry the attribution; a
    default-tenant serve creates none."""
    bundle, tp = models["bundle"], models["tp"]
    tel = Telemetry(tracing=True, metrics=True)
    _serve(ServeEngine, bundle, tp, workload, tenants=TENANTS,
           scheduler=_policy(_Port), telemetry=tel)
    snap = tel.metrics_snapshot()
    c = snap["counters"]
    assert c["serve.tenant.bulk.submitted"]["value"] == 2
    assert c["serve.tenant.interactive.finished"]["value"] == 2
    assert c["serve.tenant.bulk.tokens_emitted"]["value"] == 2 * GEN
    for leaf, total in (("submitted", "serve.requests_submitted"),
                        ("finished", "serve.requests_finished"),
                        ("tokens_emitted", "serve.tokens_emitted")):
        assert sum(c[f"serve.tenant.{t}.{leaf}"]["value"]
                   for t in ("bulk", "interactive")) == c[total]["value"]
    assert snap["histograms"]["serve.tenant.interactive.ttft_steps"][
        "count"] == 2
    subs = [e for e in tel.tracer.events() if e.name == "submit"]
    assert {e.args.get("tenant") for e in subs} == {"bulk", "interactive"}
    ref_tel = R.Telemetry(tracing=False, metrics=True)
    _serve(R.ServeEngine, models["rb"], models["rp"], workload,
           tenants=TENANTS, scheduler=_policy(R), telemetry=ref_tel)
    tenant_series = lambda d: {k: v for k, v in d.items()
                               if k.startswith("serve.tenant.")}
    assert tenant_series(_counts(snap)) == tenant_series(
        _counts(ref_tel.metrics_snapshot()))
    tel2 = Telemetry(metrics=True)
    _serve(ServeEngine, bundle, tp, workload[:2], telemetry=tel2)
    assert not [k for k in tel2.metrics_snapshot()["counters"]
                if k.startswith("serve.tenant.")]


def test_submit_validation(models):
    eng = ServeEngine(models["bundle"], models["tp"], max_batch=1,
                      num_pages=8, page_size=PAGE, max_seq_len=32)
    for bad in (dict(tenant=""), dict(tenant=7), dict(priority="urgent")):
        with pytest.raises(ValueError):
            eng.submit([1, 2, 3], 2, **bad)
    r = eng.submit([1, 2, 3], 2, tenant="t", priority="latency")
    assert (r.tenant, r.priority) == ("t", "latency")
    r = eng.submit([1, 2, 3], 2)
    assert (r.tenant, r.priority) == (DEFAULT_TENANT, "throughput")


# --------------------------------------------------------------- CLI --

QUOTA_SPECS = ("bulk=8:32,interactive=16,best-effort=:64", " a=3 , ,b=:5",
               "x=")


@pytest.mark.parametrize("spec", QUOTA_SPECS)
def test_parse_tenant_quotas_matches_reference(spec):
    as_tuples = lambda q: {t: (v.max_pages, v.max_step_tokens)
                           for t, v in q.items()}
    got = serve.parse_tenant_quotas(spec)
    assert all(isinstance(v, TenantQuota) for v in got.values())
    assert as_tuples(got) == as_tuples(ref_serve.parse_tenant_quotas(spec))


@pytest.mark.parametrize("spec", ["bulk", "=3", "a=x", "a=1:y", "a=0"])
def test_parse_tenant_quotas_refuses_as_the_reference(spec):
    for parse in (serve.parse_tenant_quotas, ref_serve.parse_tenant_quotas):
        with pytest.raises(ValueError):
            parse(spec)


CLI_ARGS = ["--arch", "qwen2-7b", "--reduced", "--paged", "--page-size", "8",
            "--batch", "3", "--prompt-len", "40", "--gen", "4"]


def _cli_line(out: str):
    """The serve line's mode tag, TTFT in engine steps and preemptions."""
    import re

    (line,) = [x for x in out.splitlines() if x.startswith("[paged/")]
    return (line.split("]")[0] + "]",
            re.search(r"TTFT ([\d.]+) engine steps", line).group(1),
            int(re.search(r"(\d+) preemptions", line).group(1)))


def test_tenant_cli_matches_reference_cli(capsys):
    """``--scheduler tenant --tenant-quotas``: every request is the
    default tenant's, so a quota of 12 pages (two of the three 6-page
    requests at once) and 16 tokens a step shapes the schedule; the
    printed mode, TTFT in steps and preemptions equal the reference
    CLI's.  ``--tenant-quotas`` without ``--scheduler tenant`` raises in
    both."""
    argv = CLI_ARGS + ["--scheduler", "tenant", "--tenant-quotas",
                       "default=12:16", "--preemption"]
    out = serve.main(argv + ["--device", "cpu"])
    mine = _cli_line(capsys.readouterr().out)
    ref_out = ref_serve.main(argv)
    want = _cli_line(capsys.readouterr().out)
    assert out.shape == np.asarray(ref_out).shape == (3, 4)
    assert mine == want
    assert mine[0] == "[paged/chunked/sync/tenant]" and mine[2] == 0
    fcfs = serve.main(CLI_ARGS + ["--device", "cpu"])
    capsys.readouterr()
    np.testing.assert_array_equal(out, fcfs)
    bad = CLI_ARGS + ["--tenant-quotas", "default=12"]
    for run in (lambda: serve.main(bad + ["--device", "cpu"]),
                lambda: ref_serve.main(bad)):
        with pytest.raises(ValueError, match="--scheduler tenant"):
            run()
