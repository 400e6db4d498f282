"""Async pipelined serving in the port against the reference.

The port's counterpart of tests/test_async_engine.py: splitting
``ServeEngine.step()`` into plan, dispatch and retirement and keeping a
step in flight (``pipeline_depth=1``) moves wall time, never bits - the
async engine's token streams and the bytes of every non-null pool page
equal the synchronous engine's under FCFS / SJF / Mixed at bf16 / int8 /
fp8_e4m3 pools, with speculation (K = 2) at depths 0 and 1, under
preempt-resume (the drain before the replay record) and with sampling.
Also: the streaming callback (order, lag), cancellation (page
conservation, donation, safety while a step is in flight), and the async
serve with a mid-stream cancel held against the reference engine on the
same schedule: streams (under the margin guard of the other stream
tests, ROADMAP C), cancellation tallies and ``stats()``.

Reduced qwen2-7b with ``block_kv == page_size == 8``; parameters come from
the reference's ``init_lm`` through numpy (``params_from_numpy``); the
workload is the reference test's (prompts of 37 / 21 / 45 / 12 tokens
drawn with numpy from seed 0)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import transformer as RT
from repro.models.model_zoo import build as ref_build
from repro.runtime import ServeEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build
from repro_torch.runtime import (
    CANCELLED,
    ServeEngine,
    chunked_cold_reference,
)

torch.set_num_threads(1)

PAGE = 8
CHUNK = 16
GEN = 4
PROMPT_LENS = (37, 21, 45, 12)
# a differing greedy token is accepted only at a near-tie of the
# reference's own logits (tests/test_torch_engine.py)
LOGIT_ATOL = 0.1
POLICY_KW = {
    "fcfs": dict(scheduler="fcfs"),
    "sjf": dict(scheduler="sjf"),
    "mixed": dict(scheduler="mixed", step_token_budget=24),
}
SERVE_KW = dict(max_batch=4, num_pages=40, page_size=PAGE, max_seq_len=64,
                prefill_chunk=CHUNK)
# the port's stats() keys beyond the reference's schema
PORT_KEYS = {"prefill_calls", "decode_calls", "verify_calls"}


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
    return dict(rc=rc, rb=rb, rp=rp, bundle=build(tc),
                tp=params_from_numpy(tree, tc, "cpu"))


@pytest.fixture(scope="module")
def workload(models):
    rng = np.random.default_rng(0)
    vocab = models["bundle"].cfg.vocab_size
    return [rng.integers(0, vocab, n).tolist() for n in PROMPT_LENS]


def _engine(models, **kw):
    return ServeEngine(models["bundle"], models["tp"], **{**SERVE_KW, **kw})


def _serve(models, prompts, gen=GEN, **kw):
    eng = _engine(models, **kw)
    reqs = [eng.submit(p, gen) for p in prompts]
    eng.run_to_completion()
    return [r.generated for r in reqs], eng


def _assert_pools_equal(a: dict, b: dict):
    """Page 0 is the write sink of idle rows; every other page must match
    bit for bit, codes and sidecars."""
    assert set(a) == set(b)
    for name in a:
        assert torch.equal(a[name][:, 1:].view(torch.uint8),
                           b[name][:, 1:].view(torch.uint8)), name


def _assert_retired(eng, reqs):
    """Every emission read back: no placeholder survives a drain."""
    assert eng.stats()["inflight"] == 0
    for r in reqs:
        assert r.pending == 0
        assert all(isinstance(t, int) for t in r.generated)


_SYNC = {}


def _sync(models, workload, key, **kw):
    """The depth-0 serve of a configuration, cached per key."""
    if key not in _SYNC:
        out, eng = _serve(models, workload, pipeline_depth=0, **kw)
        _SYNC[key] = (out, {k: v.clone() for k, v in eng.pool.items()})
    return _SYNC[key]


# ------------------------------------------------------- async == sync --

@pytest.mark.parametrize("dtype", ["bf16", "fp8_e4m3", "int8"])
@pytest.mark.parametrize("policy", ["fcfs", "sjf", "mixed"])
def test_async_matches_sync_bitwise(models, workload, policy, dtype):
    """The acceptance matrix: async streams and every non-null page byte
    equal the synchronous engine's, for every policy and pool dtype."""
    kw = dict(cache_dtype=dtype, **POLICY_KW[policy])
    ref, ref_pool = _sync(models, workload, (policy, dtype), **kw)
    got, eng = _serve(models, workload, pipeline_depth=1, **kw)
    assert got == ref
    _assert_pools_equal(ref_pool, eng.pool)
    assert eng.stats()["pipeline_depth"] == 1
    assert eng.stats()["inflight"] == 0


# the reference's speculation workload (repeating prompts, so that the
# n-gram drafter proposes)
SPEC_WORKLOAD = [([3, 5, 7, 9] * 6)[:17], [11, 12, 13] * 5, list(range(1, 12))]


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("depth", [0, 1])
def test_speculation_async_matches_sync_bitwise(models, dtype, depth):
    """Speculation (K = 2) at depths 0 and 1 against the plain depth-0
    serve: a verify row freezes until its retirement, and the drafter
    skips the tokens still on the device, so streams and page bytes stay
    equal.  The drafts do depend on the depth (the skip), and on a bf16
    pool the spec tallies and steps equal the reference engine's at the
    same depth where the streams agree."""
    kw = dict(cache_dtype=dtype)
    ref, ref_pool = _sync(models, SPEC_WORKLOAD, ("spec-off", dtype), gen=8,
                          **kw)
    got, eng = _serve(models, SPEC_WORKLOAD, gen=8, speculate=2,
                      pipeline_depth=depth, **kw)
    assert got == ref
    _assert_pools_equal(ref_pool, eng.pool)
    assert eng.stats()["spec"]["verify_steps"] >= 1, "must speculate"
    assert eng.stats()["live_pages"] == 0
    if dtype == "bf16":
        ref_eng = RefEngine(models["rb"], models["rp"],
                            cache_dtype=jnp.bfloat16, speculate=2,
                            pipeline_depth=depth, **SERVE_KW)
        ref_reqs = [ref_eng.submit(p, 8) for p in SPEC_WORKLOAD]
        ref_eng.run_to_completion()
        if [r.generated for r in ref_reqs] == got:
            assert eng.stats()["spec"] == ref_eng.stats()["spec"]
            assert eng.steps == ref_eng.steps


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_async_preempt_resume_bit_identity(models, workload, dtype):
    """Preemption under pipelining drains before the replay record; the
    resumed stream equals the uninterrupted serve alone."""
    eng = ServeEngine(
        models["bundle"], models["tp"], max_batch=2, num_pages=12,
        page_size=PAGE, max_seq_len=64, prefill_chunk=CHUNK,
        prefix_cache=True, preemption=True, preempt_patience=2,
        cache_dtype=dtype, pipeline_depth=1,
    )
    ra = eng.submit(workload[2], 12)     # long straggler: 45 + 12 = 7 pages
    for _ in range(3):
        eng.step()                       # past prefill, into decode
    rb = eng.submit(workload[0], GEN)    # 37 + 4 -> 5 pages: cannot coexist
    eng.run_to_completion()
    assert eng.preemptions >= 1
    assert ra.preempt_count >= 1
    for r, prompt, gen in ((ra, workload[2], 12), (rb, workload[0], GEN)):
        assert r.generated == chunked_cold_reference(
            models["bundle"], models["tp"], prompt, gen, page_size=PAGE,
            prefill_chunk=CHUNK, cache_dtype=dtype,
        )
    _assert_retired(eng, [ra, rb])


def test_async_sampling_mode_invariant(models, workload):
    """Sampled streams are keyed by (request id, token index), counts the
    host knows at dispatch: sampling survives pipelining bit for bit."""
    kw = dict(temperature=0.8, top_k=5, sample_seed=7)
    ref, _ = _serve(models, workload, pipeline_depth=0, **kw)
    got, _ = _serve(models, workload, pipeline_depth=1, **kw)
    assert got == ref


def test_pipeline_depth_validation(models):
    with pytest.raises(ValueError):
        ServeEngine(models["bundle"], models["tp"], max_batch=1,
                    num_pages=8, page_size=PAGE, max_seq_len=32,
                    pipeline_depth=-1)


# -------------------------------------------------- streaming emission --

@pytest.mark.parametrize("depth", [0, 1])
def test_on_token_streams_match_generated(models, workload, depth):
    """The callback delivers every generated token with its index, in
    order and gapless, and the streams it assembles are the final
    ``generated`` lists, at both depths."""
    got = {}

    def on_token(r, idx, tok):
        stream = got.setdefault(r.req_id, [])
        assert idx == len(stream)
        assert isinstance(tok, int)
        stream.append(tok)

    out, _ = _serve(models, workload, pipeline_depth=depth, on_token=on_token)
    assert [got[i] for i in sorted(got)] == out


def test_async_emission_lags_dispatch(models, workload):
    """At depth 1 the callback for step N fires at its retirement, after
    step N+1 was dispatched; drain() flushes the backlog."""
    seen = []
    eng = _engine(models, max_batch=1, num_pages=16,
                  pipeline_depth=1, on_token=lambda r, i, t: seen.append(i))
    r = eng.submit(workload[1], 6)
    while r.prefill_pos < len(r.prompt):
        eng.step()
    # the prompt completed: its first token is dispatched, not emitted
    assert len(r.generated) >= 1 and r.pending >= 1
    assert not seen
    eng.step()
    # one step in flight: emissions stay one step behind the host count
    assert len(seen) == len(r.generated) - r.pending < len(r.generated)
    eng.drain()
    assert r.pending == 0 and len(seen) == len(r.generated)


# ------------------------------------------------------- cancellation --

def test_cancel_running_conserves_pages(models, workload):
    """Cancel while a step is in flight: the pipeline drains, the slot
    frees, and after the survivor finishes and the cache is emptied every
    allocatable page is free again."""
    eng = _engine(models, max_batch=2, num_pages=24, prefix_cache=True,
                  pipeline_depth=1)
    allocatable = eng.num_pages - 1
    victim = eng.submit(workload[2], 12)
    survivor = eng.submit(workload[1], GEN)
    while not victim.generated and victim.pending == 0:
        eng.step()
    assert eng.stats()["inflight"] >= 1      # genuinely mid-flight
    assert eng.cancel(victim.req_id)
    assert victim.state == CANCELLED
    assert eng.stats()["inflight"] == 0      # cancel drained the pipeline
    assert not eng.cancel(victim.req_id)     # no longer live
    assert not eng.cancel(10_000)            # unknown id
    eng.run_to_completion()
    assert survivor.generated == chunked_cold_reference(
        models["bundle"], models["tp"], workload[1], GEN, page_size=PAGE,
        prefill_chunk=CHUNK)
    resident = eng.prefix_cache.cached_pages
    assert eng.allocator.free_pages + resident == allocatable
    eng.prefix_cache.evict(resident)
    assert eng.allocator.free_pages == allocatable
    assert eng.cancellations == 1


def test_cancel_donates_prefix_pages(models, workload):
    """A cancelled request's full prompt pages are donated: a later
    identical prompt hits them."""
    eng = _engine(models, max_batch=1, num_pages=24, prefix_cache=True,
                  pipeline_depth=1)
    r = eng.submit(workload[2], 12)          # 45-token prompt
    while r.prefill_pos < len(r.prompt):
        eng.step()
    eng.cancel(r.req_id)
    assert eng.prefix_cache.cached_pages >= len(workload[2]) // PAGE
    r2 = eng.submit(workload[2], GEN)
    eng.step()
    assert r2.cached_len > 0                 # served from donated pages
    eng.run_to_completion()
    assert r2.generated == chunked_cold_reference(
        models["bundle"], models["tp"], workload[2], GEN, page_size=PAGE,
        prefill_chunk=CHUNK)


def test_cancel_without_prefix_cache_frees_everything(models, workload):
    eng = _engine(models, max_batch=1, num_pages=16, pipeline_depth=1)
    allocatable = eng.num_pages - 1
    r = eng.submit(workload[0], 8)
    for _ in range(4):
        eng.step()
    assert eng.cancel(r.req_id)
    assert eng.allocator.free_pages == allocatable
    assert eng.idle


def test_cancel_waiting_request(models, workload):
    """A queued request cancels without owning a slot or a page; the
    queue unblocks behind it."""
    eng = _engine(models, max_batch=1, num_pages=16, pipeline_depth=1)
    ra = eng.submit(workload[0], GEN)
    rb = eng.submit(workload[1], GEN)        # waits behind ra (one slot)
    eng.step()
    assert rb.state == "waiting"
    assert eng.cancel(rb.req_id)
    assert rb.state == CANCELLED and not eng.waiting
    eng.run_to_completion()
    assert ra.generated == chunked_cold_reference(
        models["bundle"], models["tp"], workload[0], GEN, page_size=PAGE,
        prefill_chunk=CHUNK)


# ------------------------------------------------- against the reference --

def _ref_logits_along(rc, rp, prompt, stream):
    """The reference model's logits at every generated position of
    ``stream``, replayed for one request on a fresh pool (chunk-exact
    prefill is schedule-invariant and decode rows are independent)."""
    n_pages = math.ceil((len(prompt) + len(stream)) / PAGE)
    pool = RT.init_paged_cache(rc, n_pages + 1, PAGE)
    table = jnp.asarray([list(range(1, n_pages + 1))], jnp.int32)
    out = []
    for c0 in range(0, len(prompt), CHUNK):
        real = min(CHUNK, len(prompt) - c0)
        toks = np.zeros((1, CHUNK), np.int32)
        toks[0, :real] = prompt[c0:c0 + real]
        logits, pool = RT.prefill_step_paged(
            rp, rc, jnp.asarray(toks), jnp.asarray([c0], jnp.int32),
            jnp.asarray([c0 + real], jnp.int32),
            jnp.asarray([real - 1], jnp.int32), pool, table)
    out.append(np.asarray(logits[0]))
    for i, tok in enumerate(stream[:-1]):
        logits, pool = RT.serve_step_paged(
            rp, rc, jnp.asarray([tok], jnp.int32),
            jnp.asarray([len(prompt) + i], jnp.int32), pool, table)
        out.append(np.asarray(logits[0]))
    return out


def _cancel_serve(engine_cls, bundle, params, workload, **kw):
    """The four prompts at depth 1 with the prefix cache; request 0 is
    cancelled once it has 3 tokens (a count, the same in both engines)."""
    eng = engine_cls(bundle, params, **SERVE_KW, prefix_cache=True,
                     pipeline_depth=1, **kw)
    reqs = [eng.submit(p, 8) for p in workload]
    while len(reqs[0].generated) < 3:
        eng.step()
    assert eng.cancel(reqs[0].req_id)
    eng.run_to_completion()
    return reqs, eng


def test_async_cancel_matches_reference_engine(models, workload):
    """The same async serve with a mid-stream cancel through both
    engines: the same steps, request stamps, cancellation tallies and
    ``stats()`` (the reference's keys; the port adds its call counts),
    and the same streams where the reference's logits clear the margin
    guard."""
    ref_reqs, ref_eng = _cancel_serve(RefEngine, models["rb"], models["rp"],
                                      workload, cache_dtype=jnp.bfloat16)
    reqs, eng = _cancel_serve(ServeEngine, models["bundle"], models["tp"],
                              workload)
    for mine, ref in zip(reqs, ref_reqs):
        assert (mine.state, mine.submit_step, mine.admit_step,
                mine.first_token_step, mine.finish_step) == (
            ref.state, ref.submit_step, ref.admit_step,
            ref.first_token_step, ref.finish_step)
        assert len(mine.generated) == len(ref.generated)
        if mine.generated == ref.generated:
            continue
        i = next(j for j, (a, b) in enumerate(zip(mine.generated,
                                                   ref.generated)) if a != b)
        logits = _ref_logits_along(models["rc"], models["rp"], ref.prompt,
                                   ref.generated)[i]
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] < LOGIT_ATOL, (ref.req_id, i, top2)
    assert reqs[0].state == CANCELLED
    mine, ref = eng.stats(), ref_eng.stats()
    assert set(mine) == set(ref) | PORT_KEYS
    assert {k: mine[k] for k in ref} == ref
    assert mine["cancellations"] == 1 and mine["inflight"] == 0
    _assert_retired(eng, reqs)


# ---------------------------------------------------------------- CLI --

@pytest.mark.parametrize("fmt", ["chrome", "jsonl"])
def test_serve_cli_async_matches_reference_cli(fmt, tmp_path, capsys):
    """``--async --stream --disconnect-after --trace --metrics
    --numerics-probe`` on the paged CLI beside the reference CLI on the
    same arguments: the mode tag, the cancellation, the padded row, the
    prefix-cache line, the trace's lifecycle events and the metrics
    counters depend on counts only (the weights differ) and are equal."""
    import json
    import re

    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve

    def run(main, path, extra):
        argv = ["--arch", "qwen2-7b", "--reduced", "--paged", "--page-size",
                "8", "--batch", "3", "--prompt-len", "40", "--gen", "8",
                "--prefix-cache", "--async", "--stream",
                "--disconnect-after", "3", "--trace", str(path),
                "--trace-format", fmt, "--metrics", "--numerics-probe", "2"]
        out = np.asarray(main(argv + extra))
        text = capsys.readouterr().out
        (line,) = [x for x in text.splitlines() if x.startswith("[paged/")]
        cache = [x for x in text.splitlines() if x.startswith("[prefix-cache]")]
        blob = text[text.index("[metrics]") + len("[metrics]"):]
        metrics = json.JSONDecoder().raw_decode(blob.strip())[0]
        if fmt == "chrome":
            evs = [(e["name"], e["args"]["step"], e["args"].get("req_id"))
                   for e in json.loads(path.read_text())["traceEvents"]
                   if e["ph"] == "i"]
        else:
            evs = [(e["name"], e["step"], (e["args"] or {}).get("req_id"))
                   for e in map(json.loads, path.read_text().splitlines()[1:])
                   if e["kind"] == "instant"]
        streamed = [x for x in text.splitlines() if x.startswith("[stream] req")]
        return dict(
            tag=line.split("]")[0] + "]",
            cancellations=int(re.search(r"(\d+) cancellations",
                                        line).group(1)),
            padded=(out == -1).sum(axis=1).tolist(), cache=cache,
            events=[e for e in evs if e[0] != "numerics_probe"],
            probes=sum(e[0] == "numerics_probe" for e in evs),
            counters={k: v for k, v in metrics["counters"].items()},
            streamed=len(streamed))

    mine = run(serve.main, tmp_path / f"mine.{fmt}", ["--device", "cpu"])
    want = run(ref_serve.main, tmp_path / f"ref.{fmt}", [])
    assert mine == want
    assert mine["tag"] == "[paged/chunked/async/fcfs]"
    assert mine["cancellations"] == 1 and mine["padded"][0] > 0
    assert mine["probes"] > 0
