"""Sampling in the port's engine (temperature / top-k, counter-keyed).

jax's PRNG cannot be reproduced in torch, so sampled streams are held to
the reference's invariances, proved inside the port: the noise is an
integer counter hash of (seed, request id, token index, vocabulary
index), exact and a pure function of its key; a request's sampled stream
is reproducible and does not depend on the batch, the chunk schedule, the
policy, the step token budget or a preemption, at bf16 and int8 pools;
another seed changes it; ``top_k = 1`` is greedy at any temperature and a
``top_k`` past the vocabulary truncates nothing; the sampler's
frequencies match ``softmax(logits / T)`` after top-k (a chi-squared test
over 20,000 keys).  At ``temperature = 0`` the engine is its greedy self,
and its streams equal the reference engine's greedy streams (or part
only at a near-tie of the reference's own logits).

Reduced qwen2-7b with ``block_kv == page_size == 8``; parameters come from
the reference's ``init_lm`` through numpy (``params_from_numpy``)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from scipy import stats as sps

from repro.configs import get_config as ref_get_config
from repro.models import transformer as RT
from repro.models.model_zoo import build as ref_build
from repro.runtime import ServeEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build
from repro_torch.runtime import ServeEngine, chunked_cold_reference
from repro_torch.runtime.engine import make_sampler, sample_uniforms

torch.set_num_threads(1)

PAGE = 8
CHUNK = 16
GEN = 6
PROMPT_LENS = (37, 21, 45, 12)
SAMPLE = dict(temperature=0.8, top_k=50, sample_seed=7)
SERVE_KW = dict(max_batch=4, num_pages=40, page_size=PAGE, max_seq_len=64,
                prefill_chunk=CHUNK)
LOGIT_ATOL = 0.1          # the margin guard of tests/test_torch_engine.py
M32 = 0xFFFFFFFF


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
def workload():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 512, n).tolist() for n in PROMPT_LENS]


def _serve(models, prompts, gen=GEN, **kw):
    eng = ServeEngine(models["bundle"], models["tp"], **{**SERVE_KW, **kw})
    reqs = [eng.submit(p, gen) for p in prompts]
    eng.run_to_completion(max_steps=500)
    return [r.generated for r in reqs], eng


_CACHE = {}


def _base(models, workload, dtype="bf16", **kw):
    """The batched sampled serve (or greedy, ``temperature=0``), cached."""
    key = (dtype, tuple(sorted(kw.items())))
    if key not in _CACHE:
        _CACHE[key] = _serve(models, workload, cache_dtype=dtype, **kw)[0]
    return _CACHE[key]


# ---------------------------------------------------------- the hash --

def _mix_np(x):
    x = x ^ (x >> np.uint64(16))
    x = (x * np.uint64(0x045D9F3B)) & np.uint64(M32)
    x = x ^ (x >> np.uint64(16))
    x = (x * np.uint64(0x045D9F3B)) & np.uint64(M32)
    return x ^ (x >> np.uint64(16))


def _uniforms_np(seed, rid, idx, vocab):
    """The hash and its uniforms in numpy uint64 (no product passes
    2**63): the independent statement of the key -> bits map."""
    base = _mix_np(np.uint64(seed & M32))
    key = _mix_np(_mix_np(base ^ np.uint64(rid)) ^ np.uint64(idx))
    key2 = _mix_np(key ^ np.uint64(0x6A09E667))
    v = np.arange(vocab, dtype=np.uint64)
    h = _mix_np((v * np.uint64(0x27D4EB2F) + key) & np.uint64(M32))
    h = _mix_np(h ^ key2)
    top = (h >> np.uint64(9)).astype(np.float32)
    return (top + np.float32(0.5)) * np.float32(2.0 ** -23)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 40), rid=st.integers(0, 2 ** 31 - 1),
       idx=st.integers(0, 2 ** 31 - 1))
def test_hash_is_integer_exact(seed, rid, idx):
    got = sample_uniforms(seed, torch.tensor([rid], dtype=torch.int32),
                          torch.tensor([idx], dtype=torch.int32), 700)
    want = _uniforms_np(seed, rid, idx, 700)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert 0.0 < float(got.min()) and float(got.max()) < 1.0


def test_hash_is_a_pure_function_of_its_key():
    """A row's uniforms depend on its (seed, request id, token index)
    alone: not on the other rows, their order or the batch size; distinct
    keys give distinct rows."""
    rids = torch.tensor([3, 0, 3, 9, 2 ** 31 - 1], dtype=torch.int32)
    idxs = torch.tensor([1, 0, 2, 1, 5], dtype=torch.int32)
    u = sample_uniforms(11, rids, idxs, 300)
    for i in range(len(rids)):
        alone = sample_uniforms(11, rids[i:i + 1], idxs[i:i + 1], 300)
        assert torch.equal(alone[0], u[i])
    perm = torch.tensor([4, 2, 0, 3, 1])
    assert torch.equal(sample_uniforms(11, rids[perm], idxs[perm], 300),
                       u[perm])
    assert torch.equal(sample_uniforms(11, rids, idxs, 300), u)
    flat = u.reshape(len(rids), -1)
    assert len({tuple(r.tolist()) for r in flat}) == len(rids)
    assert not torch.equal(sample_uniforms(12, rids, idxs, 300), u)
    # a vocabulary prefix is the same hash
    assert torch.equal(sample_uniforms(11, rids, idxs, 100), u[:, :100])


@pytest.mark.parametrize("temperature,top_k", [(0.7, 8), (1.3, 0)])
def test_sampler_frequencies_chi_squared(temperature, top_k):
    """Over 20,000 keys the sampler's frequencies on fixed logits match
    softmax(logits / T) restricted to the top k (p > 1e-3), and no token
    outside the top k is drawn."""
    rng = np.random.default_rng(2)
    vocab, n = 12, 20000
    logits = torch.from_numpy(rng.standard_normal(vocab).astype(np.float32) * 2)
    sample = make_sampler(temperature, top_k, seed=5)
    rids = torch.arange(n, dtype=torch.int32) // 7
    idxs = torch.arange(n, dtype=torch.int32) % 7
    toks = sample(logits.expand(n, vocab), rids, idxs)
    counts = np.bincount(toks.numpy(), minlength=vocab)
    lg = logits.double().numpy() / temperature
    keep = np.ones(vocab, bool)
    if top_k:
        keep[np.argsort(-lg)[top_k:]] = False
    p = np.exp(lg - lg.max()) * keep
    p /= p.sum()
    assert counts[~keep].sum() == 0
    chi2 = ((counts[keep] - n * p[keep]) ** 2 / (n * p[keep])).sum()
    assert sps.chi2.sf(chi2, keep.sum() - 1) > 1e-3, (chi2, counts, n * p)


def test_sampler_keeps_ties_at_the_kth_value():
    """Ties at the k-th largest logit stay in, as in the reference."""
    logits = torch.tensor([[0.0, 2.0, 1.0, 1.0, -1.0]])
    sample = make_sampler(1.0, 2, seed=0)
    n = 3000
    toks = sample(logits.expand(n, 5), torch.arange(n, dtype=torch.int32),
                  torch.zeros(n, dtype=torch.int32))
    assert set(toks.tolist()) == {1, 2, 3}


# ----------------------------------------------------------- the engine --

def test_top_k_one_is_greedy_at_any_temperature(models, workload):
    greedy = _base(models, workload)
    for t in (0.5, 3.0):
        got, _ = _serve(models, workload, temperature=t, top_k=1,
                        sample_seed=3)
        assert got == greedy, t


def test_top_k_past_the_vocabulary_truncates_nothing(models, workload):
    full = _base(models, workload, **{**SAMPLE, "top_k": 0})
    vocab = models["bundle"].cfg.vocab_size
    for k in (vocab, 10 * vocab):
        got, eng = _serve(models, workload, **{**SAMPLE, "top_k": k})
        assert got == full
        assert eng.top_k == vocab


def test_temperature_zero_is_the_greedy_engine(models, workload):
    """``temperature=0`` is the argmax path, whatever top_k and the seed;
    its streams equal the reference engine's greedy streams, or part at a
    near-tie of the reference's own logits."""
    greedy = _base(models, workload)
    got, eng = _serve(models, workload, temperature=0.0, top_k=5,
                      sample_seed=9)
    assert got == greedy
    assert eng.stats()["temperature"] == 0.0
    ref_eng = RefEngine(models["rb"], models["rp"], cache_dtype=jnp.bfloat16,
                        **SERVE_KW)
    ref_reqs = [ref_eng.submit(p, GEN) for p in workload]
    ref_eng.run_to_completion()
    for prompt, mine, r in zip(workload, greedy, ref_reqs):
        if mine == r.generated:
            continue
        i = next(j for j, (a, b) in enumerate(zip(mine, r.generated))
                 if a != b)
        top2 = np.sort(_ref_logits_at(models, prompt, r.generated, i))[-2:]
        assert top2[1] - top2[0] < LOGIT_ATOL, (i, top2)


def _ref_logits_at(models, prompt, stream, i):
    """The reference model's logits at generated position ``i`` of
    ``stream``, replayed for one request on a fresh pool."""
    rc, rp = models["rc"], models["rp"]
    n_pages = math.ceil((len(prompt) + len(stream)) / PAGE)
    pool = RT.init_paged_cache(rc, n_pages + 1, PAGE)
    table = jnp.asarray([list(range(1, n_pages + 1))], jnp.int32)
    for c0 in range(0, len(prompt), CHUNK):
        real = min(CHUNK, len(prompt) - c0)
        toks = np.zeros((1, CHUNK), np.int32)
        toks[0, :real] = prompt[c0:c0 + real]
        logits, pool = RT.prefill_step_paged(
            rp, rc, jnp.asarray(toks), jnp.asarray([c0], jnp.int32),
            jnp.asarray([c0 + real], jnp.int32),
            jnp.asarray([real - 1], jnp.int32), pool, table)
    for j, tok in enumerate(stream[:i]):
        logits, pool = RT.serve_step_paged(
            rp, rc, jnp.asarray([tok], jnp.int32),
            jnp.asarray([len(prompt) + j], jnp.int32), pool, table)
    return np.asarray(logits[0])


VARIANTS = {
    "max_batch_1": dict(max_batch=1),
    "max_batch_2": dict(max_batch=2, prefill_batch=1),
    "chunk_8": dict(prefill_chunk=8),
    "chunk_32": dict(prefill_chunk=32),
    "sjf": dict(scheduler="sjf"),
    "mixed_budget": dict(scheduler="mixed", step_token_budget=16),
    "fcfs_budget": dict(step_token_budget=12),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_sampled_streams_are_schedule_invariant(models, workload, dtype,
                                                variant):
    want = _base(models, workload, dtype, **SAMPLE)
    got, eng = _serve(models, workload, cache_dtype=dtype,
                      **VARIANTS[variant], **SAMPLE)
    assert got == want
    budget = VARIANTS[variant].get("step_token_budget")
    if budget is not None:
        assert eng.stats()["max_step_tokens"] <= budget


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_sampled_streams_are_reproducible_and_seeded(models, workload, dtype):
    want = _base(models, workload, dtype, **SAMPLE)
    again, _ = _serve(models, workload, cache_dtype=dtype, **SAMPLE)
    assert again == want
    other, _ = _serve(models, workload, cache_dtype=dtype,
                      **{**SAMPLE, "sample_seed": 8})
    assert other != want
    assert want != _base(models, workload, dtype)     # not the greedy stream


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_sampled_preempt_resume(models, workload, dtype):
    """A sampled request paged out mid-decode and resumed (its replayed
    tokens keep their keys) equals its uninterrupted serve, as does the
    request that displaced it."""
    eng = ServeEngine(models["bundle"], models["tp"], max_batch=2,
                      num_pages=12, page_size=PAGE, max_seq_len=64,
                      prefill_chunk=CHUNK, preemption=True,
                      preempt_patience=2, prefix_cache=True,
                      cache_dtype=dtype, **SAMPLE)
    ra = eng.submit(workload[2], 12)
    for _ in range(3):
        eng.step()
    rb = eng.submit(workload[0], GEN)
    eng.run_to_completion(max_steps=500)
    assert eng.preemptions >= 1 and ra.preempt_count >= 1
    for r, gen in ((ra, 12), (rb, GEN)):
        assert r.generated == chunked_cold_reference(
            models["bundle"], models["tp"], r.prompt, gen, page_size=PAGE,
            prefill_chunk=CHUNK, cache_dtype=dtype, req_id=r.req_id,
            **SAMPLE)


def test_sampling_validation(models):
    kw = dict(max_batch=1, num_pages=8, page_size=PAGE, max_seq_len=32)
    b, p = models["bundle"], models["tp"]
    with pytest.raises(ValueError):
        ServeEngine(b, p, temperature=-0.1, **kw)
    with pytest.raises(ValueError):
        ServeEngine(b, p, temperature=0.5, top_k=-1, **kw)
    eng = ServeEngine(b, p, temperature=0.5, top_k=3, **kw)
    assert eng.stats()["temperature"] == 0.5 and eng.top_k == 3


def test_serve_cli_samples_and_speculates(capsys):
    """The CLI's sampling and speculation flags reach the paged engine:
    the acceptance command prints the ``[speculate k=3/ngram]`` line; at
    ``--temperature 0`` the streams are the greedy serve's."""
    from repro_torch.launch import serve

    base = ["--arch", "qwen2-7b", "--reduced", "--paged", "--batch", "4",
            "--prompt-len", "16", "--gen", "8", "--device", "cpu"]
    out = serve.main(base + ["--speculate", "3", "--temperature", "0.8",
                             "--top-k", "8", "--sample-seed", "1",
                             "--draft", "ngram"])
    text = capsys.readouterr().out
    assert out.shape == (4, 8)
    (line,) = [x for x in text.splitlines() if x.startswith("[speculate ")]
    assert line.startswith("[speculate k=3/ngram] ")
    plain = serve.main(base + ["--speculate", "3"])
    greedy = serve.main(base)
    assert (plain == greedy).all()
    assert not (out == greedy).all()
