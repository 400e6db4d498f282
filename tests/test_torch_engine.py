"""The port's ServeEngine: batched serving equals one-request serving bit
for bit inside the port, greedy streams equal the reference engine's (or
differ only at a near-tie of the reference's own logits), and the host
control plane (admission, chunk grants, finish) takes the same steps as
the reference's."""

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
from repro_torch.models.convert import init_lm, params_from_numpy
from repro_torch.models.model_zoo import build
from repro_torch.runtime import ServeEngine, chunked_cold_reference

torch.set_num_threads(1)

PAGE = 16
CHUNK = 32
GEN = 6
PROMPT_LENS = (40, 23, 57, 9)
ENGINE_KW = dict(max_batch=3, num_pages=20, page_size=PAGE,
                 prefill_chunk=CHUNK, prefill_batch=2)
# A differing greedy token is accepted only at a near-tie: the reference's
# own top-1/top-2 logit gap there must be below the logit agreement of the
# two stacks (tests/test_torch_model.py: 0.1 absolute).
LOGIT_ATOL = 0.1


def _cfgs():
    rc = ref_get_config("qwen2-7b").reduced()
    rc = dataclasses.replace(
        rc, attention=dataclasses.replace(rc.attention, block_kv=PAGE))
    tc = get_config("qwen2-7b").reduced()
    tc = dataclasses.replace(
        tc, attention=dataclasses.replace(tc.attention, block_kv=PAGE))
    return rc, tc


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 512, n).tolist() for n in PROMPT_LENS]


def _serve_staggered(eng):
    """Two requests at step 0, one after two steps, one a step later."""
    prompts = _prompts()
    reqs = [eng.submit(p, GEN) for p in prompts[:2]]
    eng.step()
    eng.step()
    reqs.append(eng.submit(prompts[2], GEN))
    eng.step()
    reqs.append(eng.submit(prompts[3], GEN))
    eng.run_to_completion()
    return reqs


@pytest.fixture(scope="module")
def served():
    rc, tc = _cfgs()
    rb = ref_build(rc)
    rp = rb.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.array(x, np.float32), rp)
    bundle = build(tc)
    tp = params_from_numpy(tree, tc, "cpu")
    ref_eng = RefEngine(rb, rp, cache_dtype=jnp.bfloat16, **ENGINE_KW)
    ref_reqs = _serve_staggered(ref_eng)
    eng = ServeEngine(bundle, tp, **ENGINE_KW)
    reqs = _serve_staggered(eng)
    return dict(rc=rc, rp=rp, bundle=bundle, tp=tp, ref_eng=ref_eng,
                ref_reqs=ref_reqs, eng=eng, reqs=reqs)


def _ref_logits_along(rc, rp, prompt, stream):
    """The reference model's logits at every generated position of
    ``stream``, replayed for one request on a fresh pool (chunk-exact
    prefill is schedule-invariant and decode rows are independent, so
    these are the logits the reference engine chose from)."""
    n_pages = math.ceil((len(prompt) + len(stream)) / PAGE)
    pool = RT.init_paged_cache(rc, n_pages + 1, PAGE)
    table = jnp.asarray([list(range(1, n_pages + 1))], jnp.int32)
    prefill = jax.jit(lambda *a: RT.prefill_step_paged(rp, rc, *a))
    decode = jax.jit(lambda *a: RT.serve_step_paged(rp, rc, *a))
    out = []
    for c0 in range(0, len(prompt), CHUNK):
        real = min(CHUNK, len(prompt) - c0)
        toks = np.zeros((1, CHUNK), np.int32)
        toks[0, :real] = prompt[c0:c0 + real]
        logits, pool = prefill(
            jnp.asarray(toks), jnp.asarray([c0], jnp.int32),
            jnp.asarray([c0 + real], jnp.int32),
            jnp.asarray([real - 1], jnp.int32), pool, table)
    out.append(np.asarray(logits[0]))
    for i, tok in enumerate(stream[:-1]):
        logits, pool = decode(jnp.asarray([tok], jnp.int32),
                              jnp.asarray([len(prompt) + i], jnp.int32),
                              pool, table)
        out.append(np.asarray(logits[0]))
    return out


def test_batched_serve_equals_chunked_cold_reference(served):
    """Inside the port, bit for bit: each request served among staggered
    others equals the same request served alone."""
    for r in served["reqs"]:
        alone = chunked_cold_reference(
            served["bundle"], served["tp"], r.prompt, GEN, page_size=PAGE,
            prefill_chunk=CHUNK)
        assert r.generated == alone, r.req_id


def test_greedy_streams_match_reference_engine(served):
    for mine, ref in zip(served["reqs"], served["ref_reqs"]):
        assert mine.prompt == ref.prompt
        if mine.generated == ref.generated:
            continue
        i = next(j for j, (a, b) in enumerate(zip(mine.generated,
                                                   ref.generated)) if a != b)
        logits = _ref_logits_along(served["rc"], served["rp"], ref.prompt,
                                   ref.generated)[i]
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] < LOGIT_ATOL, (ref.req_id, i, top2)


def test_host_control_plane_matches_reference(served):
    """No EOS: admission, chunk grants and finish depend on counts only,
    so both engines take identical steps."""
    assert served["eng"].steps == served["ref_eng"].steps
    for mine, ref in zip(served["reqs"], served["ref_reqs"]):
        assert (mine.submit_step, mine.admit_step, mine.first_token_step,
                mine.finish_step) == (ref.submit_step, ref.admit_step,
                                      ref.first_token_step, ref.finish_step)
        assert len(mine.generated) == GEN


def test_pages_and_slots_are_released(served):
    st = served["eng"].stats()
    assert st["running"] == 0 and st["waiting"] == 0 and st["finished"] == 4
    assert st["live_pages"] == 0
    assert st["free_pages"] == ENGINE_KW["num_pages"] - 1
    assert st["prefill_calls"] > 0 and st["decode_calls"] > 0
    # the reference's name of the pool dtype
    assert st["pool_dtype"] == served["ref_eng"].stats()["pool_dtype"] == "bf16"


def test_entry_points_need_cuda_or_explicit_cpu():
    """Entry points default to the card; with none, they raise unless the
    caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.launch import serve

    _, tc = _cfgs()
    with pytest.raises(RuntimeError):
        init_lm(tc, torch.Generator())
    with pytest.raises(RuntimeError):
        serve.main(["--arch", "qwen2-7b", "--reduced", "--paged"])
    out = serve.main(["--arch", "qwen2-7b", "--reduced", "--paged",
                      "--batch", "2", "--prompt-len", "20", "--gen", "3",
                      "--page-size", "16", "--prefill-chunk", "16",
                      "--device", "cpu"])
    assert out.shape == (2, 3) and ((out >= 0) & (out < tc.vocab_size)).all()


CLI_BASE = ["--arch", "qwen2-7b", "--reduced", "--paged", "--page-size", "8",
            "--batch", "2"]
CLI_CASES = {
    "token_by_token": ["--no-chunked-prefill", "--prompt-len", "12",
                       "--gen", "4"],
    # 2 requests of 40 + 8 tokens (6 pages each) in 8 allocatable pages:
    # the second is page-starved, the first is paged out and resumes
    "prefix_cache_preemption": ["--prompt-len", "40", "--gen", "8",
                                "--num-pages", "9", "--prefix-cache",
                                "--preemption", "--preempt-patience", "1"],
    "preemption": ["--prompt-len", "40", "--gen", "8", "--num-pages", "9",
                   "--preemption", "--preempt-patience", "1"],
    "mixed_budget": ["--prompt-len", "40", "--gen", "4", "--scheduler",
                     "mixed", "--step-token-budget", "16",
                     "--no-prefix-cache"],
}


def _cli_report(out: str):
    """The serve line's mode tag and preemption count, and the
    prefix-cache line, as the CLI printed them."""
    import re

    (line,) = [x for x in out.splitlines() if x.startswith("[paged/")]
    tag = line.split("]")[0] + "]"
    pre = int(re.search(r"(\d+) preemptions", line).group(1))
    cache = [x for x in out.splitlines() if x.startswith("[prefix-cache]")]
    return tag, pre, cache


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_serve_cli_modes_match_reference_cli(case, capsys):
    """The paged CLI's token-by-token mode, prefix cache, preemption and
    policies: the printed mode, preemption count and prefix-cache tallies
    (hits, misses, evictions, donations) equal the reference CLI's on the
    same arguments (they depend on counts only; the weights differ)."""
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve

    argv = CLI_BASE + CLI_CASES[case]
    out = serve.main(argv + ["--device", "cpu"])
    mine = _cli_report(capsys.readouterr().out)
    ref_out = ref_serve.main(argv)
    want = _cli_report(capsys.readouterr().out)
    assert out.shape == np.asarray(ref_out).shape == (2, int(argv[argv.index(
        "--gen") + 1]))
    assert mine == want
    tag, pre, cache = mine
    assert tag == ("[paged/token-by-token/sync/fcfs]"
                   if case == "token_by_token" else
                   "[paged/chunked/sync/mixed]" if case == "mixed_budget"
                   else "[paged/chunked/sync/fcfs]")
    assert pre == (1 if "preemption" in case else 0)
    assert bool(cache) == (case == "prefix_cache_preemption")
