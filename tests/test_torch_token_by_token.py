"""The paged engine's token-by-token mode (``chunked_prefill=False``) in
the port: inside the port it equals ``dense_greedy_reference`` - the
dense B=1 cache, none of the paged machinery - token for token; the
port's oracle equals the reference's where the reference's decisions are
not near-ties; the engine's host control plane takes the reference
engine's steps; and the constructor refuses what the reference's refuses,
with the same messages.

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
from repro.runtime import ServeEngine as RefEngine
from repro.runtime import dense_greedy_reference as ref_dense_greedy
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build
from repro_torch.runtime import ServeEngine, dense_greedy_reference

torch.set_num_threads(1)

PAGE = 8
GEN = 6
PROMPT_LENS = (17, 9, 24)
# As in tests/test_torch_dense_route.py: the two stacks' logits differ by
# a few 1e-2, so the packages' streams are compared where every top-2
# margin of the reference's decisions exceeds STREAM_MARGIN; the prompts
# come from a seed whose decisions all clear it (smallest 0.094), which
# the test checks first.
STREAM_MARGIN = 0.05
PROMPT_SEED = 3
ENGINE_KW = dict(max_batch=2, num_pages=20, page_size=PAGE,
                 chunked_prefill=False)


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


def _prompts():
    rng = np.random.default_rng(PROMPT_SEED)
    return [rng.integers(0, 512, n).tolist() for n in PROMPT_LENS]


def _serve_staggered(eng):
    """Two requests at step 0, the third after five steps (it waits for a
    slot: max_batch is 2)."""
    prompts = _prompts()
    reqs = [eng.submit(p, GEN) for p in prompts[:2]]
    for _ in range(5):
        eng.step()
    reqs.append(eng.submit(prompts[2], GEN))
    eng.run_to_completion()
    return reqs


@pytest.fixture(scope="module")
def serves(models):
    ref_eng = RefEngine(models["rb"], models["rp"], cache_dtype=jnp.bfloat16,
                        **ENGINE_KW)
    eng = ServeEngine(models["bundle"], models["tp"], **ENGINE_KW)
    return ref_eng, _serve_staggered(ref_eng), eng, _serve_staggered(eng)


def test_engine_equals_dense_greedy_reference(models, serves):
    """Bit for bit inside the port: each request served token by token
    among others through the paged decode equals the dense B=1 oracle."""
    _, _, eng, reqs = serves
    for r in reqs:
        assert r.generated == dense_greedy_reference(
            models["bundle"], models["tp"], r.prompt, GEN), r.req_id
    st = eng.stats()
    assert st["chunked_prefill"] is False
    assert st["prefill_calls"] == 0 and st["prefix_cache"] is None
    assert st["decode_calls"] == eng.steps
    assert st["max_step_tokens"] == 2 and st["live_pages"] == 0


def test_host_control_plane_matches_reference_engine(serves):
    """Teacher forcing and finish depend on counts only: both engines
    admit, emit and finish at the same steps."""
    ref_eng, ref_reqs, eng, reqs = serves
    assert eng.steps == ref_eng.steps
    for mine, ref in zip(reqs, ref_reqs):
        assert (mine.submit_step, mine.admit_step, mine.first_token_step,
                mine.finish_step) == (ref.submit_step, ref.admit_step,
                                      ref.first_token_step, ref.finish_step)
        assert mine.first_token_step - mine.admit_step == len(mine.prompt) - 1
    assert reqs[2].admit_step > 5        # waited for a slot


def _ref_dense_margin(models, prompt, stream):
    """The smallest top-2 logit margin of the reference's dense
    token-by-token decisions along ``stream``."""
    rc, rp = models["rc"], models["rp"]
    step = jax.jit(lambda *a: RT.serve_step(rp, rc, *a))
    cache = RT.init_cache(rc, 1, len(prompt) + len(stream))
    feed = list(prompt) + list(stream)
    margins = []
    for i in range(len(feed) - 1):
        logits, cache = step(jnp.asarray([feed[i]], jnp.int32),
                             jnp.full((1,), i, jnp.int32), cache)
        if i + 1 >= len(prompt):
            top2 = np.sort(np.asarray(logits[0]))[-2:]
            margins.append(top2[1] - top2[0])
    return float(min(margins))


def test_dense_greedy_reference_matches_reference(models, serves):
    """The two packages' oracles, and the reference engine's token-by-token
    streams, on the same prompts."""
    _, ref_reqs, _, reqs = serves
    for mine, ref_r in zip(reqs, ref_reqs):
        want = ref_dense_greedy(models["rb"], models["rp"], ref_r.prompt, GEN)
        assert ref_r.generated == want
        assert _ref_dense_margin(models, ref_r.prompt, want) > STREAM_MARGIN
        assert dense_greedy_reference(
            models["bundle"], models["tp"], mine.prompt, GEN) == want


# (constructor keyword arguments) -> the reference's ValueError
BAD_KWARGS = {
    "prefix_cache_without_chunks": dict(chunked_prefill=False,
                                        prefix_cache=True),
    "budget_below_page": dict(step_token_budget=PAGE - 1),
    "patience_zero": dict(preemption=True, preempt_patience=0),
    "trim_high_alone": dict(prefix_cache=True, trim_high=0.9),
    "trim_without_cache": dict(trim_high=0.9, trim_low=0.5),
    "trim_low_above_high": dict(prefix_cache=True, trim_high=0.5,
                                trim_low=0.9),
    "chunk_not_page_multiple": dict(prefill_chunk=PAGE + 1),
    "unknown_scheduler": dict(scheduler="lottery"),
}


@pytest.mark.parametrize("case", list(BAD_KWARGS))
def test_constructor_errors_match_reference(models, case):
    kw = dict(max_batch=2, num_pages=8, page_size=PAGE, **BAD_KWARGS[case])
    with pytest.raises(ValueError) as want:
        RefEngine(models["rb"], models["rp"], **kw)
    with pytest.raises(ValueError) as got:
        ServeEngine(models["bundle"], models["tp"], **kw)
    assert str(got.value) == str(want.value)
