"""The exact in-order fold behind the decode kernels' split over blocks.

The CUDA paged decode kernel reduces the pages of one (sequence, kv head)
to per-page partials in parallel - row pseudo-average, local max, local
sum and P V at the accumulator dtype, none of which reads the running
state - and then folds them strictly in page order.  On the CPU the same
split is ``core.pasa.block_partials`` / ``fold_partials``: here every
page's partials are computed first, in the order the kernel's CTAs take
them when a pair's blocks outnumber its 8 CTAs (page j on CTA j mod 8),
then folded in page order.
The result must equal the sequential walk of ``paged_decode_plain`` bit
for bit, at three policies, from a bf16 and an int8 pool, at kv_len on
either side of a page and of 8 pages; and it must agree
with the reference's gather fallback at the decode tolerance.  The
contiguous decode kernel's split over a strided dense cache is held the
same way against ``decode_plain`` and the reference's contiguous decode
kernel (interpret mode).
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as RK
from repro.core import FP16 as REF_FP16
from repro.core import FP16_FP32 as REF_FP16_FP32
from repro.core import FP32 as REF_FP32
from repro.runtime import paged_cache as RPC
from repro_torch.core.pasa import (
    block_partials,
    finalize_state,
    fold_partials,
    prepare_blocks,
)
from repro_torch.core.precision import FP16, FP16_FP32, FP32

# the kernel modules (the package binds these names to the ops)
cmod = importlib.import_module("repro_torch.kernels.pasa_decode")
dmod = importlib.import_module("repro_torch.kernels.pasa_paged_decode")

torch.set_num_threads(1)

BETA = 0.984497
PAGE = 16
CTAS = 8             # CTAs of a (sequence, kv head), each taking every 8th block
KVH, G, D = 2, 3, 32
# the reference's kernel-vs-oracle bar for decode (tests/test_paged.py)
DECODE_TOL = dict(atol=3e-3, rtol=3e-2)
POLICIES = {"fp16": (FP16, REF_FP16), "fp16_fp32": (FP16_FP32, REF_FP16_FP32),
            "fp32": (FP32, REF_FP32)}
KV_LENS = [1, PAGE - 1, PAGE, PAGE + 1, CTAS * PAGE, CTAS * PAGE + 1]


def _case(kv_len, pool, seed=0):
    """One sequence of ``kv_len`` tokens in a shuffled pool whose table
    holds exactly its live pages (NaN past kv_len and on spare pages).
    Returns numpy q, the port's pool tensors, the reference's pool arrays,
    the table and the sidecars of both (empty for bf16)."""
    rng = np.random.default_rng(seed + kv_len)
    n_live = math.ceil(kv_len / PAGE)
    total = 1 + n_live + 2
    ids = rng.permutation(np.arange(1, total))[:n_live]
    k = np.full((total, PAGE, KVH, D), np.nan, np.float32)
    v = np.full((total, PAGE, KVH, D), np.nan, np.float32)
    valid = np.zeros((total, PAGE), bool)
    for j, pid in enumerate(ids):
        rows = min(PAGE, kv_len - j * PAGE)
        k[pid, :rows] = rng.standard_normal((rows, KVH, D)) + 2.0
        v[pid, :rows] = rng.standard_normal((rows, KVH, D))
        valid[pid, :rows] = True
    table = ids[None, :].astype(np.int32)
    q = rng.standard_normal((1, KVH, G, D)).astype(np.float32)
    if pool == "bf16":
        kt, vt = (torch.from_numpy(x).to(torch.bfloat16) for x in (k, v))
        # the reference sees the same bf16-rounded values
        kr, vr = (jnp.asarray(x.float().numpy()) for x in (kt, vt))
        return q, kt, vt, kr, vr, table, {}, {}
    raw = [np.where(valid[..., None, None], x, 0.0) for x in (k, v)]
    (kr, ks, kh), (vr, vs, vh) = (
        RPC.quantize_kv_page(jnp.asarray(x), jnp.asarray(valid), "int8")
        for x in raw)
    ref_quant = dict(k_scale=ks, k_shift=kh, v_scale=vs, v_shift=vh)
    port_quant = {n: torch.from_numpy(np.array(x)) for n, x in ref_quant.items()}
    kt, vt = (torch.from_numpy(np.array(x)) for x in (kr, vr))
    return q, kt, vt, kr, vr, table, port_quant, ref_quant


def _fold_of_partials(q, kp, vp, table, kv_len, policy, quant):
    """paged_decode_plain with its block loop split in two: every page's
    partials first (CTA by CTA, as the kernel's CTAs take them),
    then the fold in page order."""
    dt = policy.input_dtype
    scales = lambda side: (quant.get(f"{side}_scale"), quant.get(f"{side}_shift"))
    ks = dmod._gather_dequant(kp, *scales("k"), table, dt).movedim(2, 1)
    vs = dmod._gather_dequant(vp, *scales("v"), table, dt).movedim(2, 1)
    prob = prepare_blocks(
        q.to(dt), ks, vs, beta=BETA, policy=policy, block_kv=PAGE,
        causal=False, kv_len=kv_len.reshape(-1, 1), use_gemm_shift=False,
        shift_mask_valid=True,
    )
    n = prob.n_blocks
    parts = {}
    for cta in range(CTAS):
        for j in range(cta, n, CTAS):
            parts[j] = block_partials(policy=policy, **prob.block_args(j))
    state = prob.init_state(policy)
    for j in range(n):
        state = fold_partials(state, parts[j], inva=prob.inva, policy=policy)
    return finalize_state(state, policy)


@pytest.mark.parametrize("kv_len", KV_LENS)
@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_fold_of_page_partials_equals_sequential_walk(policy, pool, kv_len):
    pol, ref_pol = POLICIES[policy]
    q, kt, vt, kr, vr, table, quant, ref_quant = _case(kv_len, pool)
    qt, tt = torch.from_numpy(q), torch.from_numpy(table)
    kvl = torch.tensor([kv_len], dtype=torch.int32)
    folded = _fold_of_partials(qt, kt, vt, tt, kvl, pol, quant)
    walk = dmod.paged_decode_plain(qt, kt, vt, tt, kvl, beta=BETA,
                                   policy=pol, block_kv=PAGE, **quant)
    assert torch.isfinite(folded.float()).all()
    assert torch.equal(folded, walk)

    ref = RK.pasa_paged_decode(
        jnp.asarray(q), kr, vr, jnp.asarray(table),
        jnp.asarray([kv_len], jnp.int32), beta=BETA, policy=ref_pol,
        use_kernel=False, **ref_quant)
    np.testing.assert_allclose(folded.float().numpy(),
                               np.asarray(ref, np.float32), **DECODE_TOL)


# The contiguous decode kernel runs the same split over a strided
# (B, KVH, S2, D) view of the dense route's (B, S2, KVH, D) cache: block j
# is rows [j * block, (j + 1) * block), only the live blocks (j * block <
# kv_len) are reduced, and S2 need not be a multiple of the block.
S2 = 1040                      # the dense serve's cache: 1000 + 32 + 8 rows
CONTIGUOUS_KV_LENS = [1, 127, 128, 1002]


def _strided_case(kv_len, seed=0):
    """One sequence's bf16 cache (1, S2, KVH, D), NaN past kv_len, seen as
    (1, KVH, S2, D) through strides; numpy q and the zero-filled float32
    cache (1, KVH, S2, D) that the reference's kernel is given."""
    rng = np.random.default_rng(seed + kv_len)
    k = (rng.standard_normal((1, S2, KVH, D)) + 2.0).astype(np.float32)
    v = rng.standard_normal((1, S2, KVH, D)).astype(np.float32)
    k[:, kv_len:] = np.nan
    v[:, kv_len:] = np.nan
    kt, vt = (torch.from_numpy(x).to(torch.bfloat16).transpose(1, 2)
              for x in (k, v))
    q = rng.standard_normal((1, KVH, G, D)).astype(np.float32)
    ref_k, ref_v = (np.nan_to_num(x.float().numpy()) for x in (kt, vt))
    return q, kt, vt, ref_k, ref_v


def _fold_of_block_partials(q, kc, vc, kv_len, policy, block):
    """decode_plain with its block loop split in two, over the live blocks
    only: every block's partials first (CTA by CTA, as the kernel's CTAs
    take them), then the fold in block order."""
    dt = policy.input_dtype
    cast = lambda x: x.to(dt).contiguous()
    prob = prepare_blocks(
        cast(q), cast(kc), cast(vc), beta=BETA, policy=policy,
        block_kv=block, causal=False, kv_len=kv_len.reshape(-1, 1),
        use_gemm_shift=False, shift_mask_valid=True,
    )
    n_live = math.ceil(int(kv_len[0]) / block)
    parts = {}
    for cta in range(CTAS):
        for j in range(cta, n_live, CTAS):
            parts[j] = block_partials(policy=policy, **prob.block_args(j))
    state = prob.init_state(policy)
    for j in range(n_live):
        state = fold_partials(state, parts[j], inva=prob.inva, policy=policy)
    return finalize_state(state, policy)


@pytest.mark.parametrize("kv_len", CONTIGUOUS_KV_LENS)
@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_fold_of_block_partials_over_strided_cache_equals_walk(policy, block,
                                                               kv_len):
    pol, ref_pol = POLICIES[policy]
    q, kc, vc, ref_k, ref_v = _strided_case(kv_len)
    qt = torch.from_numpy(q)
    kvl = torch.tensor([kv_len], dtype=torch.int32)
    folded = _fold_of_block_partials(qt, kc, vc, kvl, pol, block)
    walk = cmod.decode_plain(qt, kc, vc, kvl, beta=BETA, policy=pol,
                             block_kv=block)
    assert torch.isfinite(folded.float()).all()
    assert torch.equal(folded, walk)

    ref = RK.pasa_decode(
        jnp.asarray(q), jnp.asarray(ref_k), jnp.asarray(ref_v),
        jnp.asarray([kv_len], jnp.int32), beta=BETA, policy=ref_pol,
        block_kv=block, interpret=True)
    np.testing.assert_allclose(folded.float().numpy(),
                               np.asarray(ref, np.float32), **DECODE_TOL)
