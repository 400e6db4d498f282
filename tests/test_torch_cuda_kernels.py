"""The port on a CUDA card: both kernels against their plain versions and
the engine's bit contract at a small size.  Every test is marked ``cuda``
and skips without a card.  The file imports neither jax nor the reference
package, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        -m cuda tests/test_torch_cuda_kernels.py
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.precision import FP16, FP16_FP32, FP32
from repro_torch.kernels import ops
from repro_torch.kernels import pasa_paged_decode as dmod
from repro_torch.kernels import pasa_paged_prefill as pmod
from repro_torch.models.convert import init_lm
from repro_torch.models.model_zoo import build
from repro_torch.runtime import ServeEngine

BETA = 0.984497
# the reference's kernel-vs-oracle bars: decode (tests/test_paged.py),
# prefill (tests/test_prefix_cache.py)
DECODE_TOL = dict(atol=3e-3, rtol=3e-2)
PREFILL_TOL = dict(atol=1e-2, rtol=3e-2)


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pool(rng, seq_lens, kvh, page, dev, d=128):
    """Shuffled-page bf16 pool, one sequence per length; stale positions
    and unreferenced pages are NaN."""
    n_pages = [max(1, math.ceil(n / page)) for n in seq_lens]
    total = 1 + sum(n_pages) + 2
    ids = rng.permutation(np.arange(1, total))
    table = np.zeros((len(seq_lens), max(n_pages) + 1), np.int32)
    k = np.full((total, page, kvh, d), np.nan, np.float32)
    v = np.full((total, page, kvh, d), np.nan, np.float32)
    nxt = 0
    for b, (n, npg) in enumerate(zip(seq_lens, n_pages)):
        for j in range(npg):
            pid = int(ids[nxt])
            nxt += 1
            table[b, j] = pid
            rows = max(0, min(page, n - j * page))
            k[pid, :rows] = rng.standard_normal((rows, kvh, d)) + 2.0
            v[pid, :rows] = rng.standard_normal((rows, kvh, d))
    to = lambda a, dt: torch.from_numpy(a).to(device=dev, dtype=dt)
    return to(k, torch.bfloat16), to(v, torch.bfloat16), to(table, torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("page", [64, 128])
@pytest.mark.parametrize("beta", [0.0, BETA])
@pytest.mark.parametrize("policy", [FP16, FP16_FP32])
def test_kernels_match_plain_versions(policy, beta, page):
    dev = _card()
    rng = np.random.default_rng(5)
    kvh, g = 4, 7
    kv_len = [300, page, 1]
    kp, vp, table = _pool(rng, kv_len, kvh, page, dev)
    q = torch.from_numpy(
        rng.standard_normal((3, kvh, g, 128)).astype(np.float32)
    ).to(dev, torch.float16)
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    got = ops.pasa_paged_decode(q, kp, vp, table, kvl, beta=beta, policy=policy)
    want = dmod.paged_decode_plain(q, kp, vp, table, kvl, beta=beta,
                                   policy=policy, block_kv=page)
    torch.testing.assert_close(got.float(), want.float(), **DECODE_TOL)

    start = [0, 128, 0]
    plen = [128, 300, 0]                       # row 2: a dead pad row
    kp, vp, table = _pool(rng, plen, kvh, page, dev)
    table[2] = 0
    q = torch.from_numpy(
        rng.standard_normal((3, kvh * g, 200, 128)).astype(np.float32)
    ).to(dev, torch.float16)
    st = torch.tensor(start, dtype=torch.int32, device=dev)
    pl = torch.tensor(plen, dtype=torch.int32, device=dev)
    got = ops.pasa_paged_prefill(q, kp, vp, table, st, pl, beta=beta,
                                 policy=policy)
    want = pmod.paged_prefill_plain(q, kp, vp, table, st, pl, beta=beta,
                                    policy=policy)
    torch.testing.assert_close(got.float(), want.float(), **PREFILL_TOL)
    assert not got[2].any()


@pytest.mark.cuda
def test_unsupported_inputs_raise_instead_of_falling_back():
    dev = _card()
    rng = np.random.default_rng(6)
    kp, vp, table = _pool(rng, [10], 4, 128, dev)
    q = torch.zeros((1, 4, 7, 128), dtype=torch.float16, device=dev)
    kvl = torch.tensor([10], dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError):
        ops.pasa_paged_decode(q, kp, vp, table, kvl, policy=FP32)
    with pytest.raises(ValueError):
        ops.pasa_paged_decode(q, kp, vp, table, kvl, block_kv=64)
    with pytest.raises(NotImplementedError):
        ops.pasa_paged_decode(q[..., :64], kp[..., :64].contiguous(),
                              vp[..., :64].contiguous(), table, kvl)


@pytest.mark.cuda
def test_engine_on_card_batched_equals_one_at_a_time():
    """A two-layer dense model at head_dim 128 served on the card: every
    attention call goes through the kernels (28 -> 2 launches per call
    here), and each request's stream among staggered others equals its
    stream served alone by an identically configured engine."""
    dev = _card()
    base = get_config("qwen2-7b")
    cfg = dataclasses.replace(
        base, n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=128,
        d_ff=512, vocab_size=512,
        attention=dataclasses.replace(base.attention, block_kv=64),
    )
    bundle = build(cfg)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    kw = dict(max_batch=3, num_pages=24, page_size=64, prefill_chunk=128,
              prefill_batch=2)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 512, n).tolist() for n in (150, 40, 260, 9)]

    ops.reset_launches()
    eng = ServeEngine(bundle, params, **kw)
    reqs = [eng.submit(p, 6) for p in prompts[:2]]
    eng.step()
    reqs += [eng.submit(p, 6) for p in prompts[2:]]
    eng.run_to_completion()
    assert ops.pasa_paged_prefill.launches == cfg.n_layers * eng.prefill_calls
    assert ops.pasa_paged_decode.launches == cfg.n_layers * eng.decode_calls
    for p, r in zip(prompts, reqs):
        alone = ServeEngine(bundle, params, **kw)
        solo = alone.submit(p, 6)
        alone.run_to_completion()
        assert solo.generated == r.generated
