"""The port's radix prefix cache against the reference's, and the
prefix-cached engine: the trie's behaviours run as one operation sequence
on both packages' caches; inside the port, a cache hit equals a cold serve
bit for bit (tokens and page bytes, sidecars included) at every pool
dtype; against the reference engine on one workload, the host control
plane is equal and the greedy streams are equal where the reference's
decisions are not near-ties.

Reduced qwen2-7b with ``block_kv == page_size == 8``; parameters come from
the reference's ``init_lm`` through numpy (``params_from_numpy``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import transformer as RT
from repro.models.model_zoo import build as ref_build
from repro.runtime import PageAllocator as RefAllocator
from repro.runtime import RadixPrefixCache as RefCache
from repro.runtime import ServeEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build
from repro_torch.runtime import (
    PageAllocator,
    RadixPrefixCache,
    ServeEngine,
    chunked_cold_reference,
)

torch.set_num_threads(1)

PAGE = 8
CHUNK = 16
# the guard of tests/test_torch_dense_route.py: the two stacks' logits
# differ by a few 1e-2, so streams are compared where every top-2 margin
# of the reference's decisions exceeds this
STREAM_MARGIN = 0.05


# ------------------------------------------------------------ radix trie --
# Each scenario drives one cache through the operations of a reference
# test (tests/test_prefix_cache.py) and returns what it observed; both
# packages' caches must observe the same.

def _pages(nodes):
    return [n.page for n in nodes]


def _refs(nodes):
    return [n.refcount for n in nodes]


def _raises(fn):
    try:
        fn()
    except ValueError:
        return "ValueError"
    return "no error"


def _match_release(alloc, pc):
    pages = alloc.alloc(3)
    toks = list(range(12))
    obs = [pc.insert(toks, pages)]
    nodes = pc.match(toks)
    obs += [_pages(nodes), _refs(nodes)]
    again = pc.match(toks)
    obs.append(_refs(nodes))
    pc.release(nodes)
    pc.release(again)
    obs += [_refs(nodes), _raises(lambda: pc.release(nodes))]
    return obs


def _longest_prefix(alloc, pc):
    pages = alloc.alloc(2)
    pc.insert(list(range(8)), pages)
    nodes = pc.match([0, 1, 2, 3, 99, 98, 97, 96])
    obs = [_pages(nodes)]
    pc.release(nodes)
    return obs + [_pages(pc.match([0, 1, 2]))]


def _max_tokens_cap(alloc, pc):
    pages = alloc.alloc(3)
    toks = list(range(12))
    pc.insert(toks, pages)
    nodes = pc.match(toks, max_tokens=len(toks) - 1)
    obs = [_pages(nodes)]
    pc.release(nodes)
    return obs


def _adopts_new_suffix(alloc, pc):
    p1 = alloc.alloc(2)
    pc.insert(list(range(8)), p1)
    p2 = alloc.alloc(3)
    obs = [pc.insert(list(range(12)), p2), p2]
    alloc.free(p2[:2])
    return obs + [pc.cached_pages, alloc.free_pages, alloc.live_pages]


def _lru_eviction(alloc, pc):
    pa, pb = alloc.alloc(2), alloc.alloc(2)
    pc.insert(list(range(8)), pa)
    pc.insert([9, 9, 9, 9, 8, 8, 8, 8], pb)
    held = pc.match(list(range(8)))
    obs = [alloc.free_pages, pc.evictable_pages, pc.evict(10),
           alloc.free_pages, pc.cached_pages]
    pc.release(held)
    obs += [pc.evict(1), pc.cached_pages, pc.evict(10), pc.cached_pages,
            alloc.live_pages]
    return obs


def _interior_nodes(alloc, pc):
    pages = alloc.alloc(3)
    pc.insert([1, 2, 3, 4, 5, 6], pages)
    nodes = pc.match([1, 2, 3, 4, 5, 6])
    pc.release(nodes[:2])
    obs = [pc.evict(10), pc.cached_pages]
    pc.release(nodes[2:])
    return obs + [pc.evict(10), pc.cached_pages]


def _probe_traversals(alloc, pc):
    pc.insert([1, 2, 3, 4], alloc.alloc(2))
    pc.insert([1, 2, 9, 9], alloc.alloc(2))
    held = pc.match([1, 2, 3, 4])
    obs = [[pc.evictable_pages for _ in range(100)], pc.traversals,
           pc.evict(1), pc.traversals]
    pc.release(held)
    obs += [[pc.evictable_pages for _ in range(100)], pc.traversals,
            pc.evict(2), pc.traversals]
    return obs


def _random_workload(alloc, pc):
    """300 seeded match / release / insert / evict operations; the O(1)
    counter against the trie walk after each."""
    rng = np.random.default_rng(42)
    held, obs = [], []
    for _ in range(300):
        op = rng.integers(0, 4)
        if op == 0 and alloc.free_pages >= 3:
            toks = list(rng.integers(0, 3, 6))
            pages = alloc.alloc(3)
            adopted = pc.insert(toks, pages)
            alloc.free([p for p in pages if p not in adopted])
            obs.append(adopted)
        elif op == 1:
            nodes = pc.match(list(rng.integers(0, 3, 6)))
            obs.append(_pages(nodes))
            if nodes:
                held.append(nodes)
        elif op == 2 and held:
            pc.release(held.pop(rng.integers(0, len(held))))
        elif op == 3:
            obs.append(pc.evict(int(rng.integers(1, 3))))
        assert pc.evictable_pages == pc._evictable_pages_dfs()
        obs.append(pc.evictable_pages)
    while held:
        pc.release(held.pop())
    return obs + [pc.evictable_pages, pc.cached_pages]


SCENARIOS = {
    "match_release": (16, 4, _match_release),
    "longest_prefix": (16, 4, _longest_prefix),
    "max_tokens_cap": (16, 4, _max_tokens_cap),
    "adopts_new_suffix": (16, 4, _adopts_new_suffix),
    "lru_eviction": (16, 4, _lru_eviction),
    "interior_nodes": (16, 2, _interior_nodes),
    "probe_traversals": (16, 2, _probe_traversals),
    "random_workload": (64, 2, _random_workload),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_trie_matches_reference(name):
    num_pages, page, scenario = SCENARIOS[name]

    def run(alloc_cls, cache_cls):
        alloc = alloc_cls(num_pages)
        pc = cache_cls(alloc, page)
        obs = scenario(alloc, pc)
        return obs, pc.stats(), alloc.free_pages, alloc.live_pages

    mine, ref = run(PageAllocator, RadixPrefixCache), run(RefAllocator, RefCache)
    assert mine == ref


# --------------------------------------------------------- engine level --

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


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).tolist() for n in lens]


def _pool_pages(pool, pages):
    """Every pool leaf (K, V and the sidecars of an 8-bit pool) at the
    given physical pages, as bytes."""
    idx = torch.tensor(pages, dtype=torch.long)
    return {k: v[:, idx].contiguous().view(torch.uint8).clone()
            for k, v in pool.items()}


@pytest.mark.parametrize("dtype", ["bf16", "int8", "fp8_e4m3"])
def test_cache_hit_bit_identical_to_cold(models, dtype):
    """The same prompt served twice through one prefix-cached engine: the
    second (every shareable page a hit) serve equals the first and the
    cold serve of a fresh engine at another chunk size, and the cached
    pages' bytes do not change (the hit only references them)."""
    bundle, tp = models["bundle"], models["tp"]
    (prompt,) = _prompts(3, [37])
    eng = ServeEngine(bundle, tp, max_batch=1, num_pages=16, page_size=PAGE,
                      max_seq_len=64, prefix_cache=True, cache_dtype=dtype)
    r1 = eng.submit(prompt, 6)
    eng.run_to_completion()
    n_cached = eng.prefix_cache.cached_pages
    assert n_cached == len(prompt) // PAGE
    cached = [n.page for n in eng.prefix_cache._walk(prompt)]
    before = _pool_pages(eng.pool, cached)
    r2 = eng.submit(prompt, 6)
    eng.run_to_completion()
    assert r2.generated == r1.generated
    assert r2.cached_len == (len(prompt) - 1) // PAGE * PAGE
    st = eng.stats()["prefix_cache"]
    assert st["evictions"] == 0 and st["hits"] == r2.cached_len // PAGE
    assert r1.generated == chunked_cold_reference(
        bundle, tp, prompt, 6, page_size=PAGE, prefill_chunk=32,
        cache_dtype=dtype)
    after = _pool_pages(eng.pool, cached)
    for leaf in before:
        assert torch.equal(before[leaf], after[leaf]), leaf


def test_partial_prefix_hit_and_divergent_suffix(models):
    """Two prompts sharing their first two pages: the second hits exactly
    those, recomputes its own suffix, and equals its cold serve."""
    bundle, tp = models["bundle"], models["tp"]
    shared, sa, sb = _prompts(4, [16, 9, 12])
    pa, pb = shared + sa, shared + sb
    eng = ServeEngine(bundle, tp, max_batch=2, num_pages=24, page_size=PAGE,
                      max_seq_len=64, prefix_cache=True)
    ra = eng.submit(pa, 5)
    eng.run_to_completion()
    rb = eng.submit(pb, 5)
    eng.run_to_completion()
    assert rb.cached_len == 16
    for r, p in ((ra, pa), (rb, pb)):
        assert r.generated == chunked_cold_reference(bundle, tp, p, 5,
                                                     page_size=PAGE)


def test_refcount_protects_shared_pages_under_interleaved_finish(models):
    """A donates and finishes while B (same prefix) is mid-flight under
    eviction pressure: B's references pin the shared pages, so the
    unrelated C waits until B finishes instead of evicting them."""
    bundle, tp = models["bundle"], models["tp"]
    shared, pc_ = _prompts(5, [16, 17])
    pa, pb = shared + [7], shared + [11, 12, 13]
    eng = ServeEngine(bundle, tp, max_batch=2, num_pages=5, page_size=PAGE,
                      max_seq_len=32, prefix_cache=True)
    ra = eng.submit(pa, 3)
    eng.run_to_completion()
    assert eng.prefix_cache.cached_pages == 2
    rb = eng.submit(pb, 6)
    for _ in range(2):
        eng.step()
    assert rb.state == "running" and rb.cached_len == 16
    rc = eng.submit(pc_, 3)
    eng.step()
    assert rc.state == "waiting"
    assert eng.prefix_cache.stats()["evictions"] == 0
    eng.run_to_completion()
    assert rc.state == "finished" and rc.admit_step >= rb.finish_step
    assert eng.prefix_cache.stats()["evictions"] >= 1
    for r, p, n in ((ra, pa, 3), (rb, pb, 6), (rc, pc_, 3)):
        assert r.generated == chunked_cold_reference(bundle, tp, p, n,
                                                     page_size=PAGE)


def test_eviction_only_when_it_covers_the_shortfall(models):
    """A page-starved admission evicts cached pages only when that frees
    enough for it: C (6 pages) cannot fit beside B in 2 free + 2
    evictable pages, so A's cached prefix stays until B finishes."""
    bundle, tp = models["bundle"], models["tp"]
    pa, pb, pc_ = _prompts(6, [17, 30, 40])
    eng = ServeEngine(bundle, tp, max_batch=2, num_pages=9, page_size=PAGE,
                      max_seq_len=48, prefix_cache=True)
    eng.submit(pa, 3)
    eng.run_to_completion()
    rb, rc = eng.submit(pb, 3), eng.submit(pc_, 3)
    eng.step()
    assert rb.state == "running" and rc.state == "waiting"
    st = eng.stats()
    assert st["free_pages"] == 2 and st["prefix_cache"]["evictable_pages"] == 2
    assert st["prefix_cache"]["evictions"] == 0
    eng.run_to_completion()
    assert rc.state == "finished" and eng.prefix_cache.evictions > 0
    assert rc.generated == chunked_cold_reference(bundle, tp, pc_, 3,
                                                  page_size=PAGE)


# ------------------------------------------- against the reference engine --

GEN = 5
# a 24-token shared prefix (three pages), three suffixes, and the first
# prompt again (a full hit).  As in tests/test_torch_dense_route.py the
# prompts are drawn from a seed whose reference decisions all clear
# STREAM_MARGIN (smallest 0.088), which the stream test checks first.
WORKLOAD_SEED = 20


def _shared_workload():
    shared, *suffixes = _prompts(WORKLOAD_SEED, [24, 13, 5, 20])
    return [shared + s for s in suffixes]


def _serve_shared(eng):
    """The first prompt cold, the other two together, the first again."""
    prompts = _shared_workload()
    reqs = [eng.submit(prompts[0], GEN)]
    eng.run_to_completion()
    reqs += [eng.submit(p, GEN) for p in prompts[1:]]
    eng.run_to_completion()
    reqs.append(eng.submit(prompts[0], GEN))
    eng.run_to_completion()
    return reqs


ENGINE_KW = dict(max_batch=2, num_pages=24, page_size=PAGE, max_seq_len=64,
                 prefill_chunk=CHUNK, prefix_cache=True)


def _ref_margins(models, prompt, stream):
    """The smallest top-2 logit margin of the reference model's greedy
    decisions along ``stream``, replayed for one request on a fresh pool
    (chunk-exact prefill is schedule-invariant, so these are the logits
    the reference engine chose from)."""
    rc, rp = models["rc"], models["rp"]
    mp = 8
    pool = RT.init_paged_cache(rc, mp + 1, PAGE)
    table = jnp.asarray([list(range(1, mp + 1))], jnp.int32)
    prefill = jax.jit(lambda *a: RT.prefill_step_paged(rp, rc, *a))
    decode = jax.jit(lambda *a: RT.serve_step_paged(rp, rc, *a))
    for c0 in range(0, len(prompt), CHUNK):
        real = min(CHUNK, len(prompt) - c0)
        toks = np.zeros((1, CHUNK), np.int32)
        toks[0, :real] = prompt[c0:c0 + real]
        logits, pool = prefill(
            jnp.asarray(toks), jnp.asarray([c0], jnp.int32),
            jnp.asarray([c0 + real], jnp.int32),
            jnp.asarray([real - 1], jnp.int32), pool, table)
    margins = []
    for i, tok in enumerate(stream):
        top2 = np.sort(np.asarray(logits[0]))[-2:]
        margins.append(top2[1] - top2[0])
        if i + 1 < len(stream):
            logits, pool = decode(jnp.asarray([tok], jnp.int32),
                                  jnp.asarray([len(prompt) + i], jnp.int32),
                                  pool, table)
    return float(min(margins))


@pytest.fixture(scope="module")
def shared_serves(models):
    ref_eng = RefEngine(models["rb"], models["rp"], cache_dtype=jnp.bfloat16,
                        **ENGINE_KW)
    eng = ServeEngine(models["bundle"], models["tp"], **ENGINE_KW)
    return ref_eng, _serve_shared(ref_eng), eng, _serve_shared(eng)


def test_host_control_plane_matches_reference_engine(shared_serves):
    """No EOS: admission, prefix matches, donation and finish depend on
    token ids and counts only, so both engines take the same steps."""
    ref_eng, ref_reqs, eng, reqs = shared_serves
    assert eng.steps == ref_eng.steps
    for mine, ref in zip(reqs, ref_reqs):
        assert (mine.submit_step, mine.admit_step, mine.first_token_step,
                mine.finish_step, mine.cached_len) == (
                    ref.submit_step, ref.admit_step, ref.first_token_step,
                    ref.finish_step, ref.cached_len)
    assert [r.cached_len for r in reqs] == [0, 24, 24, 32]
    st, rst = eng.stats(), ref_eng.stats()
    for key in ("free_pages", "live_pages", "preemptions", "prefix_cache"):
        assert st[key] == rst[key], key
    assert st["prefix_cache"]["hits"] == 10


def test_streams_match_reference_engine(models, shared_serves):
    _, ref_reqs, _, reqs = shared_serves
    for mine, ref in zip(reqs, ref_reqs):
        assert _ref_margins(models, ref.prompt, ref.generated) > STREAM_MARGIN
        assert mine.generated == ref.generated, ref.req_id
    # the full hit repeats the cold serve, inside each package
    assert reqs[3].generated == reqs[0].generated
