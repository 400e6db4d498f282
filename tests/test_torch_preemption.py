"""Preemption and the scheduling policies in the port: a request paged
out mid-decode and resumed (prefix hit, re-prefill of the private tail,
replay of its recorded tokens through the decode call) equals its
uninterrupted serve bit for bit, with and without the prefix cache, at
bf16 and int8 pools; two requests that cannot coexist do not thrash; the
FCFS / SJF / Mixed policies decide as the reference's do on the same
seeded views; streams do not depend on the policy or the step token
budget, which is never overrun; and the engine preempts at the reference
engine's steps.

Reduced qwen2-7b with ``block_kv == page_size == 8``, the workload of the
reference's tests/test_scheduler.py; parameters come from the reference's
``init_lm`` through numpy (``params_from_numpy``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.runtime as R
from repro.configs import get_config as ref_get_config
from repro.models.model_zoo import build as ref_build
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build
from repro_torch.runtime import (
    POLICIES,
    RequestView,
    ServeEngine,
    SJFPolicy,
    chunked_cold_reference,
    get_scheduler,
)

torch.set_num_threads(1)

PAGE = 8
CHUNK = 16
GEN = 4
PROMPT_LENS = (37, 21, 45, 12)
# max_batch 2 and 11 allocatable pages: the 45-token straggler with 12
# tokens needs 7 pages, the 37-token request with 4 needs 5 (6 with 8)
PREEMPT_KW = dict(max_batch=2, num_pages=12, page_size=PAGE, max_seq_len=64,
                  prefill_chunk=CHUNK)


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


def _cold(models, prompt, gen, **kw):
    return chunked_cold_reference(models["bundle"], models["tp"], prompt, gen,
                                  page_size=PAGE, prefill_chunk=CHUNK, **kw)


def _preempt_serve(engine_cls, bundle, params, workload, patience=2, gen_b=GEN,
                   **kw):
    """The straggler (45 + 12 tokens) runs past its prefill; then a request
    that cannot fit beside it arrives."""
    eng = engine_cls(bundle, params, **PREEMPT_KW, preemption=True,
                     preempt_patience=patience, **kw)
    ra = eng.submit(workload[2], 12)
    for _ in range(3):
        eng.step()
    assert ra.generated, "the straggler should be decoding"
    rb = eng.submit(workload[0], gen_b)
    eng.run_to_completion(max_steps=500)
    return eng, ra, rb


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_preempt_resume_bit_identity(models, workload, dtype):
    eng, ra, rb = _preempt_serve(ServeEngine, models["bundle"], models["tp"],
                                 workload, prefix_cache=True,
                                 cache_dtype=dtype)
    assert eng.preemptions >= 1
    assert ra.preempt_count >= 1 and ra.preempt_step >= 0
    assert ra.generated == _cold(models, workload[2], 12, cache_dtype=dtype)
    assert rb.generated == _cold(models, workload[0], GEN, cache_dtype=dtype)
    # the first token came before the page-out and keeps its step
    assert ra.first_token_step < ra.preempt_step
    # the resume hit the straggler's donated prompt pages
    assert eng.stats()["prefix_cache"]["hits"] > 0


def test_preemption_without_prefix_cache(models, workload):
    """Nothing to donate into: the page-out frees everything and the
    resume re-prefills from scratch - still bit-identical."""
    eng, ra, rb = _preempt_serve(ServeEngine, models["bundle"], models["tp"],
                                 workload)
    assert eng.preemptions >= 1 and eng.stats()["prefix_cache"] is None
    assert ra.generated == _cold(models, workload[2], 12)
    assert rb.generated == _cold(models, workload[0], GEN)


def test_preemption_does_not_thrash(models, workload):
    """A request that was paged out itself never triggers another
    preemption: one page-out per conflicting pair."""
    eng, ra, rb = _preempt_serve(ServeEngine, models["bundle"], models["tp"],
                                 workload, patience=1, gen_b=8,
                                 prefix_cache=True)
    assert eng.preemptions == 1
    assert ra.state == "finished" and rb.state == "finished"


def test_no_preemption_that_cannot_unblock(models, workload):
    """The victim is paged out only when its pages (with the free and the
    evictable ones) cover the starved request: the youngest request's 2
    pages and 3 free pages cannot hold the 6-page arrival, so it waits
    until the older request can be paged out instead."""
    eng = ServeEngine(models["bundle"], models["tp"], max_batch=3,
                      num_pages=12, page_size=PAGE, max_seq_len=64,
                      prefill_chunk=CHUNK, prefix_cache=True,
                      preemption=True, preempt_patience=1)
    big = eng.submit(workload[0], 12)       # 6 pages
    small = eng.submit(workload[3], GEN)    # 2 pages
    late = eng.submit(workload[2], GEN)     # 6 pages: 3 free
    eng.run_to_completion(max_steps=500)
    assert small.preempt_count == 0 and big.preempt_count == 1
    assert late.admit_step > small.finish_step
    for r, n in ((big, 12), (small, GEN), (late, GEN)):
        assert r.generated == _cold(models, r.prompt, n)


@pytest.mark.parametrize("kw", [dict(prefix_cache=True), dict()],
                         ids=["prefix_cache", "no_cache"])
def test_preemption_steps_match_reference_engine(models, workload, kw):
    """Admission, the victim, the page-out and the resume depend on counts
    and token ids only: both engines preempt, admit, emit and finish at
    the same steps, with the same prefix-cache tallies."""
    eng, ra, rb = _preempt_serve(ServeEngine, models["bundle"], models["tp"],
                                 workload, **kw)
    ref_eng, ref_a, ref_b = _preempt_serve(
        R.ServeEngine, models["rb"], models["rp"], workload,
        cache_dtype=jnp.bfloat16, **kw)
    assert (eng.steps, eng.preemptions) == (ref_eng.steps, ref_eng.preemptions)
    for mine, ref in ((ra, ref_a), (rb, ref_b)):
        assert (mine.admit_step, mine.first_token_step, mine.finish_step,
                mine.preempt_count, mine.preempt_step) == (
                    ref.admit_step, ref.first_token_step, ref.finish_step,
                    ref.preempt_count, ref.preempt_step)
    st, rst = eng.stats(), ref_eng.stats()
    for key in ("free_pages", "live_pages", "preemptions", "prefix_cache",
                "max_step_tokens"):
        assert st[key] == rst[key], key


# ------------------------------------------------------- policy layer --

def _views(rng, n, now):
    """``n`` seeded request views as keyword dicts (both packages'
    RequestView take them)."""
    out = []
    for i in range(n):
        prompt = int(rng.integers(1, 200))
        submit = int(rng.integers(0, now + 1))
        preempted = rng.random() < 0.3
        out.append(dict(
            req_id=int(rng.integers(0, 1000)) * 10 + i,
            prompt_len=prompt,
            remaining_prefill=int(rng.integers(0, prompt + 1)),
            remaining_decode=int(rng.integers(0, 40)),
            submit_step=submit,
            admit_step=int(rng.integers(-1, now + 1)),
            slot=int(rng.integers(-1, 4)),
            pages_needed=int(rng.integers(1, 30)),
            preempt_count=int(rng.integers(1, 3)) if preempted else 0,
            preempt_step=int(rng.integers(submit, now + 1)) if preempted else -1,
        ))
    return out


def _decide(policy, view_cls, hook, views, rng_args):
    vs = [view_cls(**v) for v in views]
    if hook == "plan_admission":
        half = len(vs) // 2
        return [v.req_id for v in policy.plan_admission(
            vs[:half], vs[half:], now=rng_args["now"])]
    if hook == "choose_victim":
        v = policy.choose_victim(vs, now=rng_args["now"])
        return None if v is None else v.req_id
    return policy.plan_prefill(
        vs, n_decode=rng_args["n_decode"], budget=rng_args["budget"],
        chunk=rng_args["chunk"], page_size=PAGE,
        max_rows=rng_args["max_rows"])


@pytest.mark.parametrize("hook", ["plan_admission", "plan_prefill",
                                  "choose_victim"])
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_policy_decisions_match_reference(name, hook):
    """Each hook of each policy, on 200 seeded sets of views (queue order,
    aging, anti-thrash, budget arithmetic and page alignment all reached),
    decides as the reference's policy of that name."""
    mine, ref = get_scheduler(name), R.get_scheduler(name)
    assert (mine.name, mine.hol_blocking) == (ref.name, ref.hol_blocking)
    rng = np.random.default_rng(7)
    for _ in range(200):
        now = int(rng.integers(0, 200))
        views = _views(rng, int(rng.integers(0, 9)), now)
        args = dict(now=now, n_decode=int(rng.integers(0, 6)),
                    budget=(None if rng.random() < 0.3
                            else int(rng.integers(PAGE, 200))),
                    chunk=int(rng.choice([16, 32, 64])),
                    max_rows=int(rng.integers(1, 5)))
        assert _decide(mine, RequestView, hook, views, args) == _decide(
            ref, R.RequestView, hook, views, args), (views, args)


def test_policy_registry():
    assert sorted(POLICIES) == sorted(R.POLICIES) == ["fcfs", "mixed", "sjf",
                                                      "tenant"]
    for name, cls in POLICIES.items():
        assert isinstance(get_scheduler(name), cls)
        assert isinstance(get_scheduler(cls), cls)
        inst = cls()
        assert get_scheduler(inst) is inst
    with pytest.raises(ValueError):
        get_scheduler("lifo")
    with pytest.raises(TypeError):
        get_scheduler(42)
    with pytest.raises(ValueError):
        SJFPolicy(patience=0)


# ------------------------------------- policies and budget: same streams --

def _serve_all(models, workload, **kw):
    eng = ServeEngine(models["bundle"], models["tp"], max_batch=4,
                      num_pages=40, page_size=PAGE, max_seq_len=64,
                      prefill_chunk=CHUNK, **kw)
    reqs = [eng.submit(p, GEN) for p in workload]
    eng.run_to_completion()
    return [r.generated for r in reqs], eng


@pytest.fixture(scope="module")
def baseline_streams(models, workload):
    """Sequential FCFS (prefill_batch=1), no budget."""
    return {dtype: _serve_all(models, workload, prefill_batch=1,
                              cache_dtype=dtype)[0]
            for dtype in ("bf16", "int8")}


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("config", [
    dict(scheduler="sjf"),
    dict(scheduler="mixed", step_token_budget=24),
    dict(scheduler="fcfs", step_token_budget=9),
], ids=["sjf", "mixed_budget24", "fcfs_budget9"])
def test_streams_do_not_depend_on_policy_or_budget(
        models, workload, baseline_streams, config, dtype):
    out, eng = _serve_all(models, workload, cache_dtype=dtype, **config)
    assert out == baseline_streams[dtype]
    budget = config.get("step_token_budget")
    if budget is not None:
        assert eng.max_step_tokens <= budget
        assert eng.stats()["step_token_budget"] == budget


@pytest.mark.parametrize("scheduler", ["fcfs", "mixed"])
def test_step_token_budget_never_overrun(models, scheduler):
    """The reference's budget-edge case (tests/test_scheduler.py): A's
    12-token prompt decodes while B's 24-token prompt drains in 8-token
    grants under budget 9; the step whose grant ends B's prompt must not
    also decode B.  The spend is measured from the requests' cursors, not
    from the engine's own accounting; deferring B's first decode moves
    latency, never tokens."""
    budget = 9
    rng = np.random.default_rng(11)
    pa, pb = (rng.integers(0, 512, n).tolist() for n in (12, 24))

    def serve(**kw):
        eng = ServeEngine(models["bundle"], models["tp"], max_batch=4,
                          num_pages=16, page_size=PAGE, max_seq_len=48,
                          prefill_chunk=CHUNK, scheduler=scheduler, **kw)
        reqs = [eng.submit(pa, 8), eng.submit(pb, 4)]
        edge, max_spend = False, 0
        while not eng.idle:
            before = [(r.prefill_pos, len(r.generated)) for r in reqs]
            eng.step()
            spend, completed = 0, False
            for (p0, g0), r in zip(before, reqs):
                done_now = p0 < len(r.prompt) <= r.prefill_pos
                completed = completed or done_now
                spend += (max(r.prefill_pos - p0, 0)
                          + max(len(r.generated) - g0 - done_now, 0))
            if kw:
                assert spend == eng.last_step_tokens <= budget
                edge = edge or (spend == budget and completed)
            max_spend = max(max_spend, spend)
        return [r.generated for r in reqs], edge, max_spend, eng

    budgeted, edge, max_spend, eng = serve(step_token_budget=budget)
    assert edge, "the workload did not reach the budget edge"
    assert eng.max_step_tokens == max_spend <= budget
    assert budgeted == serve()[0]
