"""The paged attention ops of repro_torch.kernels against the reference's
``repro.kernels.ops`` - both its XLA gather path (``use_kernel=False``)
and its Pallas kernel in interpret mode - on shuffled page tables, ragged
lengths and NaN-filled stale pages.  On the CPU the port's ops run their
plain PyTorch versions; tests/test_torch_cuda_kernels.py compares the CUDA
kernels with those plain versions on a card.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as RK
from repro.core import FP16 as REF_FP16
from repro_torch.core.precision import FP16
from repro_torch.kernels import ops

torch.set_num_threads(1)

BETA = 0.984497
# decode: atol 3e-3 / rtol 3e-2 (tests/test_paged.py); prefill: 1e-2 / 3e-2
# (tests/test_prefix_cache.py).  Same expressions on two stacks, equal to
# rounding, not to the bit (XLA may keep fp16 intermediates wider).
DECODE_TOL = dict(atol=3e-3, rtol=3e-2)
PREFILL_TOL = dict(atol=1e-2, rtol=3e-2)


def _pool(rng, seq_lens, kvh, d, page, k_mean=2.0, extra=2):
    """Shuffled-page float32 pool with one sequence per entry of seq_lens;
    positions at or past a sequence's length, and unreferenced pages, are
    NaN."""
    n_pages = [max(1, math.ceil(n / page)) for n in seq_lens]
    mp = max(n_pages) + 1
    total = 1 + sum(n_pages) + extra
    ids = rng.permutation(np.arange(1, total))
    table = np.zeros((len(seq_lens), mp), np.int32)
    k = np.full((total, page, kvh, d), np.nan, np.float32)
    v = np.full((total, page, kvh, d), np.nan, np.float32)
    nxt = 0
    for b, (n, npg) in enumerate(zip(seq_lens, n_pages)):
        for j in range(npg):
            pid = int(ids[nxt])
            nxt += 1
            table[b, j] = pid
            rows = max(0, min(page, n - j * page))
            k[pid, :rows] = rng.standard_normal((rows, kvh, d)) + k_mean
            v[pid, :rows] = rng.standard_normal((rows, kvh, d))
    return k, v, table


def _t(*arrs):
    return [torch.from_numpy(np.asarray(a)) for a in arrs]


def _decode_case(seed=0):
    rng = np.random.default_rng(seed)
    kvh, g, d, page = 2, 3, 32, 16
    kv_len = np.array([37, 16, 1], np.int32)
    k, v, table = _pool(rng, kv_len, kvh, d, page)
    q = (rng.standard_normal((3, kvh, g, d)) + 1.0).astype(np.float32)
    return q, k, v, table, kv_len


def _prefill_case(seed=1):
    """Rows at chunk starts 0 / 16 / 32 with a ragged last chunk, plus a
    dead pad row (kv_len 0, all-null table)."""
    rng = np.random.default_rng(seed)
    h, kvh, cs, d, page = 4, 2, 16, 32, 16
    start = np.array([0, 16, 32, 0], np.int32)
    kv_len = np.array([16, 32, 41, 0], np.int32)
    k, v, table = _pool(rng, kv_len, kvh, d, page)
    table[3] = 0
    q = (rng.standard_normal((4, h, cs, d)) + 1.0).astype(np.float32)
    return q, k, v, table, start, kv_len


@pytest.mark.parametrize("beta", [0.0, BETA])
@pytest.mark.parametrize("ref_route", ["xla", "pallas_interpret"])
def test_decode_plain_matches_reference(ref_route, beta):
    q, k, v, table, kv_len = _decode_case()
    kw = (dict(use_kernel=False) if ref_route == "xla"
          else dict(interpret=True))
    ref = RK.pasa_paged_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(kv_len), beta=beta, policy=REF_FP16, **kw,
    )
    got = ops.pasa_paged_decode(*_t(q, k, v, table, kv_len), beta=beta,
                                policy=FP16)
    got = got.float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), **DECODE_TOL)


@pytest.mark.parametrize("beta", [0.0, BETA])
@pytest.mark.parametrize("ref_route", ["xla", "pallas_interpret"])
def test_prefill_plain_matches_reference(ref_route, beta):
    q, k, v, table, start, kv_len = _prefill_case()
    kw = (dict(use_kernel=False) if ref_route == "xla"
          else dict(interpret=True, block_q=16))
    ref = RK.pasa_paged_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(start), jnp.asarray(kv_len), beta=beta, policy=REF_FP16,
        **kw,
    )
    got = ops.pasa_paged_prefill(*_t(q, k, v, table, start, kv_len),
                                 beta=beta, policy=FP16)
    got = got.float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[3], 0.0)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), **PREFILL_TOL)


def test_prefill_is_bit_invariant_to_chunk_schedule():
    """One 48-token prompt (41 valid) prefilled in one chunk, or split at
    page-aligned cuts: every output row is bit-identical."""
    _, k, v, table, _, _ = _prefill_case()
    rng = np.random.default_rng(7)
    q = torch.from_numpy(
        (rng.standard_normal((1, 4, 48, 32)) + 1.0).astype(np.float32))
    k, v, table = _t(k, v, table[2:3])
    n = torch.tensor([41])
    run = lambda qq, s0, kvl: ops.pasa_paged_prefill(
        qq, k, v, table, torch.tensor([s0]), kvl, beta=BETA, policy=FP16)
    one = run(q, 0, n)
    for cut in (16, 32):
        a = run(q[:, :, :cut], 0, torch.tensor([cut]))
        c = run(q[:, :, cut:], cut, n)
        assert torch.equal(torch.cat([a, c], dim=2), one), cut


def test_stale_pages_are_inert():
    """Replacing every stale byte (NaN) by other garbage changes nothing."""
    q, k, v, table, kv_len = _decode_case()
    a = ops.pasa_paged_decode(*_t(q, k, v, table, kv_len), beta=BETA,
                              policy=FP16)
    k2 = np.where(np.isnan(k), 1e4, k).astype(np.float32)
    v2 = np.where(np.isnan(v), -7.0, v).astype(np.float32)
    b = ops.pasa_paged_decode(*_t(q, k2, v2, table, kv_len), beta=BETA,
                              policy=FP16)
    assert torch.equal(a, b)


def test_unported_modes_raise():
    q, k, v, table, kv_len = _t(*_decode_case())
    sc = torch.zeros(k.shape[0], k.shape[2])
    with pytest.raises(NotImplementedError):
        ops.pasa_paged_decode(q, k, v, table, kv_len, k_scale=sc,
                              k_shift=sc, v_scale=sc, v_shift=sc)
