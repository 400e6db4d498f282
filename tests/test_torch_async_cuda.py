"""Async pipelining on a CUDA card (skipped without one).

A two-layer model at head_dim 128 serves the same streams and leaves the
same non-null page bytes at ``pipeline_depth`` 0 and 1, from bf16, int8
and fp8_e4m3 pools, with the same kernel launches; and neither depth makes
a synchronizing CUDA call outside the engine's drain points
(``torch.cuda.set_sync_debug_mode("warn")``,
``launch.profile_steps.count_syncs``), with telemetry on as well.  Run on
the card:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_async_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.profile_steps import count_syncs
from repro_torch.models.convert import init_lm
from repro_torch.models.model_zoo import build
from repro_torch.runtime import ServeEngine, Telemetry


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _small_model(dev):
    base = get_config("qwen2-7b")
    cfg = dataclasses.replace(
        base, n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=128,
        d_ff=512, vocab_size=512,
        attention=dataclasses.replace(base.attention, block_kv=64),
    )
    return build(cfg), init_lm(cfg, torch.Generator(device=dev).manual_seed(0),
                               dev)


def _serve(bundle, params, prompts, depth, dtype, telemetry=None):
    eng = ServeEngine(bundle, params, max_batch=4, num_pages=16, page_size=64,
                      prefill_chunk=128, cache_dtype=dtype,
                      pipeline_depth=depth, telemetry=telemetry)
    reqs = [eng.submit(p, 12) for p in prompts]
    ops.reset_launches()
    with count_syncs(eng) as syncs:
        eng.run_to_completion()
    launches = {n: getattr(ops, n).launches
                for n in ("pasa_paged_prefill", "pasa_paged_decode")}
    return [r.generated for r in reqs], eng, launches, syncs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "int8", "fp8_e4m3"])
def test_async_equals_sync_on_card(dtype):
    dev = _card()
    bundle, params = _small_model(dev)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 512, n).tolist() for n in (150, 40, 100, 65)]
    _serve(bundle, params, prompts[:1], 0, dtype)              # first calls
    sync, e0, l0, s0 = _serve(bundle, params, prompts, 0, dtype)
    got, e1, l1, s1 = _serve(bundle, params, prompts, 1, dtype)
    assert got == sync
    assert l1 == l0 and l0["pasa_paged_decode"] == 2 * e0.decode_calls
    assert (e1.prefill_calls, e1.decode_calls) == (e0.prefill_calls,
                                                   e0.decode_calls)
    for name in e0.pool:
        assert torch.equal(e0.pool[name][:, 1:].view(torch.uint8),
                           e1.pool[name][:, 1:].view(torch.uint8)), name
    assert s0["outside"] == 0, s0
    assert s1["outside"] == 0, s1


@pytest.mark.cuda
def test_telemetry_makes_no_sync_outside_drain_points():
    dev = _card()
    bundle, params = _small_model(dev)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 512, n).tolist() for n in (150, 40, 100, 65)]
    plain, e0, _, _ = _serve(bundle, params, prompts, 1, "int8")
    tel = Telemetry(tracing=True, metrics=True, numerics_every=2)
    got, e1, _, syncs = _serve(bundle, params, prompts, 1, "int8", tel)
    assert got == plain
    assert syncs["outside"] == 0, syncs
    assert tel.metrics_snapshot()["counters"]["numerics.samples"]["value"] > 0
    for name in e0.pool:
        assert torch.equal(e0.pool[name][:, 1:].view(torch.uint8),
                           e1.pool[name][:, 1:].view(torch.uint8)), name
