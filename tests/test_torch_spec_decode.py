"""Speculative decoding in the port against the reference.

Parity of the parts: the n-gram drafter (hypothesis-drawn histories and
the reference's own unit cases), ``get_drafter``, the policies'
``plan_speculation``, the page snapshots ``touched_pages`` /
``capture_pages`` / ``restore_pages`` on the same numpy pools (raw and
int8 with sidecars), and ``pasa_paged_verify`` against the reference's
``use_kernel=False`` path, each column bit-equal to the port's one-token
decode.

The engine: speculation on == off in token streams and in the bytes of
every non-null page, at bf16 / int8 / fp8_e4m3 pools under FCFS / SJF /
Mixed; ``stats()["spec"]`` equal to the reference engine's on the same
workload where the greedy streams clear the margin guard; an oracle
drafter accepts everything and a wrong one rolls everything back;
preempt-resume under speculation; sampled speculation; the validation
errors; pages conserved.

Reduced qwen2-7b with ``block_kv == page_size == 8``; parameters come from
the reference's ``init_lm`` through numpy (``params_from_numpy``); the
workload is the reference's tests/test_spec_decode.py's (repeating
prompts, so that the n-gram drafter proposes)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.kernels as RK
import repro.runtime.paged_cache as RPC
from repro.configs import get_config as ref_get_config
from repro.core import FP16 as REF_FP16
from repro.models import transformer as RT
from repro.models.model_zoo import build as ref_build
from repro.runtime import ServeEngine as RefEngine
from repro.runtime import scheduler as RS
from repro.runtime import spec_decode as RSD
from repro_torch.configs import get_config
from repro_torch.core.precision import FP16
from repro_torch.kernels import ops
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build
from repro_torch.runtime import (
    DRAFTERS,
    NULL_PAGE,
    POLICIES,
    DraftProposer,
    NgramProposer,
    RequestView,
    ServeEngine,
    chunked_cold_reference,
    get_drafter,
)
from repro_torch.runtime import paged_cache as TPC

torch.set_num_threads(1)

PAGE = 8
CHUNK = 16
GEN = 8
SPEC_K = 3
DECODE_TOL = dict(atol=3e-3, rtol=3e-2)   # tests/test_paged.py
BETA = 0.9375                             # the reference's verify test
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


# the reference's workload: the first two rows draft well (full and
# partial accepts), the arithmetic row mostly rolls back
WORKLOAD = [([3, 5, 7, 9] * 6)[:17], [11, 12, 13] * 5, list(range(1, 12))]


def _serve(models, prompts=WORKLOAD, gen=GEN, **kw):
    eng = ServeEngine(models["bundle"], models["tp"], **{**SERVE_KW, **kw})
    reqs = [eng.submit(p, gen) for p in prompts]
    eng.run_to_completion()
    return [r.generated for r in reqs], eng


_OFF = {}


def _off(models, policy, dtype):
    """The speculation-off serve, cached per (policy, dtype)."""
    if (policy, dtype) not in _OFF:
        out, eng = _serve(models, cache_dtype=dtype, **POLICY_KW[policy])
        _OFF[policy, dtype] = (out, {k: v.clone() for k, v in eng.pool.items()},
                               eng.stats())
    return _OFF[policy, dtype]


def _assert_pools_equal(a: dict, b: dict):
    """Page 0 is the write sink of idle rows; every other page must match
    bit for bit, codes and sidecars."""
    assert set(a) == set(b)
    for name in a:
        assert torch.equal(a[name][:, 1:].view(torch.uint8),
                           b[name][:, 1:].view(torch.uint8)), name


# ------------------------------------------------------ the n-gram drafter --

def _history(seed, n, alpha):
    return np.random.default_rng(seed).integers(0, alpha, n).tolist()


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 10 ** 6), n=st.integers(0, 40),
       alpha=st.integers(1, 6), k=st.integers(0, 6), skip=st.integers(0, 3),
       min_ngram=st.integers(1, 3), extra=st.integers(0, 3))
def test_ngram_proposer_matches_reference(seed, n, alpha, k, skip, min_ngram,
                                          extra):
    hist = _history(seed, n, alpha)
    mine = NgramProposer(min_ngram, min_ngram + extra)
    ref = RSD.NgramProposer(min_ngram, min_ngram + extra)
    assert mine.propose(hist, k, skip=skip) == ref.propose(hist, k, skip=skip)


@pytest.mark.parametrize("hist,k,skip,want", [
    # longest suffix first: [1,2,3] recurs at the start
    ([1, 2, 3, 4, 1, 2, 3], 3, 0, [4, 1, 2]),
    # the most recent occurrence wins
    ([1, 2, 5, 1, 2, 7, 1, 2], 1, 0, [7]),
    # skip offsets into the continuation
    ([1, 2, 3, 1, 2], 2, 0, [3, 1]),
    ([1, 2, 3, 1, 2], 2, 1, [1, 2]),
    # short or unmatched histories draft nothing
    ([5], 3, 0, []), ([], 3, 0, []), ([1, 2, 3, 4, 5], 3, 0, []),
    # never more than k (the continuation ends with the history)
    ([7, 8] * 10, 4, 0, [7, 8]), ([7, 8] * 10, 0, 0, []),
], ids=lambda x: str(x)[:20])
def test_ngram_reference_unit_cases(hist, k, skip, want):
    """The reference's six NgramProposer cases, on both packages."""
    assert NgramProposer().propose(hist, k, skip=skip) == want
    assert RSD.NgramProposer().propose(hist, k, skip=skip) == want


def test_get_drafter_resolution():
    assert isinstance(get_drafter("ngram"), NgramProposer)
    assert isinstance(get_drafter(NgramProposer), NgramProposer)
    inst = NgramProposer(max_ngram=2)
    assert get_drafter(inst) is inst
    assert sorted(DRAFTERS) == sorted(RSD.DRAFTERS) == ["ngram"]
    assert issubclass(NgramProposer, DraftProposer)
    with pytest.raises(ValueError):
        get_drafter("no-such-drafter")
    with pytest.raises(ValueError):
        NgramProposer(3, 2)
    with pytest.raises(NotImplementedError):
        DraftProposer().propose([1], 1)


# ------------------------------------------------------ plan_speculation --

@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("seed", range(6))
def test_plan_speculation_matches_reference(policy, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 6))
    fields = [dict(req_id=int(i), prompt_len=int(rng.integers(1, 40)),
                   remaining_prefill=0,
                   remaining_decode=int(rng.integers(0, 9)),
                   submit_step=int(rng.integers(0, 5)), admit_step=0, slot=i,
                   pages_needed=3) for i in range(n)]
    mine = POLICIES[policy]()
    ref = RS.POLICIES[policy]()
    k = int(rng.integers(1, 6))
    for budget in (None, 0, 1, 3, 7, 40):
        assert mine.plan_speculation(
            [RequestView(**f) for f in fields], k=k, budget_left=budget
        ) == ref.plan_speculation(
            [RS.RequestView(**f) for f in fields], k=k, budget_left=budget
        ), budget


def test_plan_speculation_reference_cases():
    """The reference's base-policy case: min(k, remaining - 1) greedily,
    clipped by the leftover budget."""
    views = [RequestView(req_id=i, prompt_len=16, remaining_prefill=0,
                         remaining_decode=r, submit_step=0)
             for i, r in ((1, 8), (2, 2), (3, 1))]
    pol = POLICIES["fcfs"]()
    assert pol.plan_speculation(views, k=4) == [(1, 4), (2, 1)]
    assert pol.plan_speculation(views, k=4, budget_left=5) == [(1, 4), (2, 1)]
    assert pol.plan_speculation(views, k=4, budget_left=3) == [(1, 3)]
    assert pol.plan_speculation(views, k=4, budget_left=0) == []


# ------------------------------------------------------ page snapshots --

def _np_pool(seed, quantized):
    rng = np.random.default_rng(seed)
    L, P, page, kvh, d = 2, 7, 4, 2, 8
    pool = {"k": rng.standard_normal((L, P, page, kvh * d)).astype(np.float32),
            "v": rng.standard_normal((L, P, page, kvh * d)).astype(np.float32)}
    if quantized:
        for side in ("k", "v"):
            pool[side] = rng.integers(-127, 128, (L, P, page, kvh * d)
                                      ).astype(np.int8)
            pool[f"{side}_scale"] = rng.random((L, P, kvh)).astype(np.float32)
            pool[f"{side}_shift"] = rng.standard_normal(
                (L, P, kvh * d)).astype(np.float32)
    return pool


@pytest.mark.parametrize("quantized", [False, True], ids=["raw", "int8"])
def test_page_snapshots_match_reference(quantized):
    pool = _np_pool(3, quantized)
    table = np.array([[3, 5, 0], [2, 6, 4], [0, 0, 0], [1, 0, 0]], np.int32)
    pos = np.array([5, 9, 0, 2], np.int32)
    phys_ref = RPC.touched_pages(jnp.asarray(table), jnp.asarray(pos), 4)
    phys = TPC.touched_pages(torch.from_numpy(table), torch.from_numpy(pos), 4)
    np.testing.assert_array_equal(phys.numpy(), np.asarray(phys_ref))
    assert phys.tolist() == [5, 4, NULL_PAGE, 1]

    jpool = {k: jnp.asarray(v) for k, v in pool.items()}
    tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    pre_ref = RPC.capture_pages(jpool, phys_ref)
    pre = TPC.capture_pages(tpool, phys)
    for name in pool:
        np.testing.assert_array_equal(pre[name].numpy(),
                                      np.asarray(pre_ref[name]))
    # the capture is a copy: overwrite the captured pages in place
    for leaf in tpool.values():
        leaf[:, phys.long()] = 0
    for name in pool:
        np.testing.assert_array_equal(pre[name].numpy(),
                                      np.asarray(pre_ref[name]))
    scribbled = {k: v.clone() for k, v in tpool.items()}
    undo = np.array([True, False, True, True])
    got = TPC.restore_pages(tpool, phys, pre, torch.from_numpy(undo))
    assert got is tpool
    want = RPC.restore_pages(
        {k: jnp.asarray(v.numpy()) for k, v in scribbled.items()},
        phys_ref, pre_ref, jnp.asarray(undo))
    for name in pool:
        # page 0: unspecified (several kept rows write it); never attended
        np.testing.assert_array_equal(tpool[name][:, 1:].numpy(),
                                      np.asarray(want[name])[:, 1:])
    # the undone pages hold the pre-image again, the kept one not
    for name in pool:
        np.testing.assert_array_equal(tpool[name][:, [5, 1]].numpy(),
                                      pool[name][:, [5, 1]])
        assert not tpool[name][:, 4].any()


# -------------------------------------------------- pasa_paged_verify --

def _verify_case(seed=0, b=3, kvh=2, g=4, d=32, page=8, w=3):
    rng = np.random.default_rng(seed)
    kv_lens = np.array([20, 13, 4], np.int32)
    n_pages = [math.ceil(n / page) for n in kv_lens]
    mp = max(n_pages) + 1
    total = 1 + sum(n_pages) + 2
    ids = rng.permutation(np.arange(1, total))
    table = np.zeros((b, mp), np.int32)
    k = np.full((total, page, kvh, d), np.nan, np.float32)
    v = np.full((total, page, kvh, d), np.nan, np.float32)
    nxt = 0
    for bi, (n, npg) in enumerate(zip(kv_lens, n_pages)):
        for j in range(npg):
            pid = int(ids[nxt])
            nxt += 1
            table[bi, j] = pid
            rows = min(page, n - j * page)
            k[pid, :rows] = rng.standard_normal((rows, kvh, d)) + 2.0
            v[pid, :rows] = rng.standard_normal((rows, kvh, d))
    q = (rng.standard_normal((b, kvh, g, w, d)) + 1.0).astype(np.float32)
    # column j attends positions < start + 1 + j, all inside the valid rows
    return q, k, v, table, kv_lens - w


@pytest.mark.parametrize("beta", [0.0, BETA])
def test_paged_verify_matches_reference_and_decode(beta):
    q, k, v, table, start = _verify_case()
    ref = RK.pasa_paged_verify(
        *(jnp.asarray(x) for x in (q, k, v, table, start)), beta=beta,
        policy=REF_FP16, use_kernel=False)
    tq, tk, tv, tt, ts = (torch.from_numpy(x) for x in (q, k, v, table, start))
    ops.reset_launches()
    got = ops.pasa_paged_verify(tq, tk, tv, tt, ts, beta=beta, policy=FP16)
    assert got.shape == q.shape
    assert ops.pasa_paged_decode.launches == 0     # plain versions on the CPU
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               **DECODE_TOL)
    for j in range(q.shape[3]):
        col = ops.pasa_paged_decode(tq[:, :, :, j], tk, tv, tt, ts + 1 + j,
                                    beta=beta, policy=FP16)
        assert torch.equal(got[:, :, :, j], col), j
    with pytest.raises(ValueError):
        ops.pasa_paged_verify(tq[:, :, :, 0], tk, tv, tt, ts)


def test_paged_verify_is_exported():
    import repro_torch.kernels as kernels

    assert kernels.pasa_paged_verify is ops.pasa_paged_verify
    assert "pasa_paged_verify" in kernels.__all__
    assert "pasa_paged_verify" in RK.__all__


# --------------------------------------------------------- the engine --

@pytest.mark.parametrize("policy", sorted(POLICY_KW))
@pytest.mark.parametrize("dtype", ["bf16", "int8", "fp8_e4m3"])
def test_spec_matches_plain_bitwise(models, policy, dtype):
    """Speculation on == off: token streams and the bytes of every
    non-null page (all requests are admitted at step 0, so page contents
    line up too).  No page is allocated by speculation."""
    ref, ref_pool, ref_stats = _off(models, policy, dtype)
    got, eng = _serve(models, cache_dtype=dtype, speculate=SPEC_K,
                      **POLICY_KW[policy])
    assert got == ref
    _assert_pools_equal(ref_pool, eng.pool)
    st = eng.stats()
    assert st["speculate"] == SPEC_K and st["verify_calls"] >= 1
    assert st["spec"]["verify_steps"] >= 1
    assert st["spec"]["proposed"] >= st["spec"]["accepted"] >= 1
    assert ref_stats["spec"] == dict(proposed=0, accepted=0, rollbacks=0,
                                     verify_steps=0)
    assert ref_stats["verify_calls"] == 0
    assert st["free_pages"] == ref_stats["free_pages"] == SERVE_KW["num_pages"] - 1
    assert st["live_pages"] == 0
    # every token is either a plain decode or a verify emission
    assert st["steps"] <= ref_stats["steps"]
    if policy == "mixed":
        assert st["max_step_tokens"] <= POLICY_KW["mixed"]["step_token_budget"]


def _ref_logits_along(rc, rp, prompt, stream):
    """The reference model's logits at each generated position of
    ``stream``, replayed for one request on a fresh pool (the logits the
    reference engine chose from)."""
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


def test_spec_stats_match_reference_engine(models):
    """The same workload through the reference engine with speculation:
    where the greedy streams agree, the drafts and the accepted counts are
    the same, so the tallies and the step counts are too.  A stream may
    part from the reference's only at a near-tie of its own logits."""
    ref_eng = RefEngine(models["rb"], models["rp"], cache_dtype=jnp.bfloat16,
                        speculate=SPEC_K, **SERVE_KW)
    ref_reqs = [ref_eng.submit(p, GEN) for p in WORKLOAD]
    ref_eng.run_to_completion()
    got, eng = _serve(models, speculate=SPEC_K)
    ref = [r.generated for r in ref_reqs]
    for prompt, mine, theirs in zip(WORKLOAD, got, ref):
        if mine == theirs:
            continue
        i = next(j for j, (a, b) in enumerate(zip(mine, theirs)) if a != b)
        logits = _ref_logits_along(models["rc"], models["rp"], prompt,
                                   theirs)[i]
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] < LOGIT_ATOL, (i, top2)
    if got == ref:
        assert eng.stats()["spec"] == ref_eng.stats()["spec"]
        assert eng.steps == ref_eng.steps
        assert eng.stats()["spec"]["accepted"] >= 1


class OracleDrafter(DraftProposer):
    """Proposes the true continuation: every draft is accepted."""

    name = "oracle"

    def __init__(self, trajectories):
        self.trajectories = trajectories

    def propose(self, history, k, skip=0):
        for traj in self.trajectories:
            if history == traj[:len(history)]:
                return traj[len(history) + skip:len(history) + skip + k]
        return []


class WrongDrafter(OracleDrafter):
    """Proposes the true continuation plus one: every draft is rejected."""

    name = "wrong"

    def __init__(self, trajectories, vocab):
        super().__init__(trajectories)
        self.vocab = vocab

    def propose(self, history, k, skip=0):
        return [(t + 1) % self.vocab for t in super().propose(history, k, skip)]


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_oracle_and_wrong_drafters(models, dtype):
    ref, ref_pool, ref_stats = _off(models, "fcfs", dtype)
    trajs = [p + g for p, g in zip(WORKLOAD, ref)]
    got, eng = _serve(models, cache_dtype=dtype, speculate=SPEC_K,
                      draft=OracleDrafter(trajs))
    assert got == ref
    _assert_pools_equal(ref_pool, eng.pool)
    st = eng.stats()["spec"]
    assert st["proposed"] == st["accepted"] >= 1 and st["rollbacks"] == 0
    assert eng.steps < ref_stats["steps"]
    got, eng = _serve(models, cache_dtype=dtype, speculate=SPEC_K,
                      draft=WrongDrafter(trajs, models["bundle"].cfg.vocab_size))
    assert got == ref
    _assert_pools_equal(ref_pool, eng.pool)
    st = eng.stats()["spec"]
    assert st["accepted"] == 0
    assert st["rollbacks"] == st["verify_steps"] >= 1
    assert st["proposed"] > st["verify_steps"]


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_preempt_resume_under_speculation(models, dtype):
    """A speculating request paged out and resumed (prefix hit, re-prefill,
    replay with speculation suspended) equals its uninterrupted serve, and
    the allocator conserves pages across the rollbacks."""
    long_p = [3, 5, 7, 9] * 11          # 44 tokens, drafts well
    med_p = [11, 12, 13] * 12           # 36 tokens
    eng = ServeEngine(
        models["bundle"], models["tp"], max_batch=2, num_pages=12,
        page_size=PAGE, max_seq_len=64, prefill_chunk=CHUNK,
        prefix_cache=True, preemption=True, preempt_patience=2,
        cache_dtype=dtype, speculate=SPEC_K,
    )
    ra = eng.submit(long_p, 12)
    for _ in range(3):
        eng.step()
    rb = eng.submit(med_p, GEN)
    eng.run_to_completion(max_steps=500)
    assert eng.preemptions >= 1 and ra.preempt_count >= 1
    assert eng.stats()["spec"]["verify_steps"] >= 1
    for r, prompt, gen in ((ra, long_p, 12), (rb, med_p, GEN)):
        assert r.generated == chunked_cold_reference(
            models["bundle"], models["tp"], prompt, gen, page_size=PAGE,
            prefill_chunk=CHUNK, cache_dtype=dtype)
    allocatable = eng.num_pages - 1
    resident = eng.prefix_cache.cached_pages
    assert eng.allocator.free_pages + resident == allocatable
    eng.prefix_cache.evict(resident)
    assert eng.allocator.free_pages == allocatable


def test_sampled_speculation_matches_sampled_plain(models):
    """Each verify sub-step samples with the key the one-token path would
    use (request id, token index), so sampled streams are unchanged."""
    kw = dict(temperature=0.8, top_k=8, sample_seed=7)
    ref, ref_eng = _serve(models, **kw)
    for dtype in ("bf16", "int8"):
        plain, _ = _serve(models, cache_dtype=dtype, **kw)
        got, eng = _serve(models, cache_dtype=dtype, speculate=SPEC_K, **kw)
        assert got == plain
        assert eng.stats()["spec"]["verify_steps"] >= 1
    greedy, _ = _off(models, "fcfs", "bf16")[:2]
    assert ref != greedy


def test_speculate_validation(models):
    kw = dict(max_batch=1, num_pages=8, page_size=PAGE, max_seq_len=32)
    b, p = models["bundle"], models["tp"]
    with pytest.raises(ValueError):
        ServeEngine(b, p, speculate=-1, **kw)
    with pytest.raises(ValueError):
        ServeEngine(b, p, speculate=2, chunked_prefill=False, **kw)
    with pytest.raises(ValueError):
        ServeEngine(b, p, speculate=2, draft="bogus", **kw)
    eng = ServeEngine(b, p, **kw)
    st = eng.stats()
    assert st["speculate"] == 0 and st["verify_calls"] == 0
    assert set(st["spec"]) == {"proposed", "accepted", "rollbacks",
                               "verify_steps"}
