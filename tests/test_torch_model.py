"""The port's dense transformer paged steps against the reference's, on the
reduced qwen2-7b with the reference's ``init_lm`` parameters carried
across through numpy (``params_from_numpy``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import transformer as RT
from repro.models.model_zoo import build as ref_build
from repro_torch.configs import get_config
from repro_torch.models import transformer as TT
from repro_torch.models.convert import init_lm, params_from_numpy

torch.set_num_threads(1)

PAGE = 16
N_PAGES = 12
# Logits: both stacks run the layers at bf16 (8 significant bits) and round
# the same expressions at different places (XLA fuses, torch rounds per
# op), so hidden states agree to a few bf16 ulps; logits of magnitude <= 4
# then agree within 0.1 absolute (measured max 0.024 on this fixture).
LOGIT_ATOL = 0.1


def _cfgs():
    rc = ref_get_config("qwen2-7b").reduced()
    rc = dataclasses.replace(
        rc, attention=dataclasses.replace(rc.attention, block_kv=PAGE))
    tc = get_config("qwen2-7b").reduced()
    tc = dataclasses.replace(
        tc, attention=dataclasses.replace(tc.attention, block_kv=PAGE))
    return rc, tc


@pytest.fixture(scope="module")
def models():
    rc, tc = _cfgs()
    rp = ref_build(rc).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.array(x, np.float32), rp)
    tp = params_from_numpy(tree, tc, "cpu")
    return rc, rp, tc, tp


def _prefill_inputs():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (3, 32)).astype(np.int32)
    start = np.array([0, 0, 0], np.int32)
    kv_len = np.array([32, 21, 0], np.int32)          # row 2: dead pad row
    last = np.maximum(kv_len - 1, 0).astype(np.int32)
    table = np.array([[3, 1, 0, 0], [5, 2, 0, 0], [0, 0, 0, 0]], np.int32)
    return tokens, start, kv_len, last, table


def _to_torch(pool):
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
            for k, v in pool.items()}


def _ref_prefill(rc, rp, pool, args):
    fn = jax.jit(lambda p, *a: RT.prefill_step_paged(p, rc, *a))
    tokens, start, kv_len, last, table = args
    return fn(rp, jnp.asarray(tokens), jnp.asarray(start), jnp.asarray(kv_len),
              jnp.asarray(last), pool, jnp.asarray(table))


def _bf16_ulp(x):
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def test_prefill_logits_and_pool_bytes_match_reference(models):
    rc, rp, tc, tp = models
    args = _prefill_inputs()
    ref_logits, ref_pool = _ref_prefill(
        rc, rp, RT.init_paged_cache(rc, N_PAGES, PAGE), args)
    pool = TT.init_paged_cache(tc, N_PAGES, PAGE, device="cpu")
    logits, pool = TT.prefill_step_paged(
        tp, tc, *[torch.from_numpy(a) for a in args[:4]], pool,
        torch.from_numpy(args[4]))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits[:2].numpy(), np.asarray(ref_logits)[:2],
                               atol=LOGIT_ATOL, rtol=0)
    # K/V written by prefill (page 0 is the write sink, skipped).  Layer
    # 0's K/V depend only on the embedding, the projections and RoPE: within
    # one bf16 ulp (measured: bit-identical).  Deeper layers project hidden
    # states that already differ at the attention tolerance, so they are
    # held to the logits' absolute bar instead (measured max 0.031).
    for name in ("k", "v"):
        want = np.asarray(ref_pool[name], np.float32)[:, 1:]
        got = pool[name].float().numpy()[:, 1:]
        ulp = _bf16_ulp(np.maximum(np.abs(got[0]), np.abs(want[0])))
        assert (np.abs(got[0] - want[0]) <= ulp).all(), name
        np.testing.assert_allclose(got[1:], want[1:], atol=LOGIT_ATOL, rtol=0)


def test_decode_logits_match_reference_at_same_pool(models):
    rc, rp, tc, tp = models
    args = _prefill_inputs()
    ref_logits, ref_pool = _ref_prefill(
        rc, rp, RT.init_paged_cache(rc, N_PAGES, PAGE), args)
    token = np.argmax(np.asarray(ref_logits), -1).astype(np.int32)
    pos = np.array([32, 21, 0], np.int32)
    table = args[4]
    step = jax.jit(lambda p, *a: RT.serve_step_paged(p, rc, *a))
    want, _ = step(rp, jnp.asarray(token), jnp.asarray(pos), ref_pool,
                   jnp.asarray(table))
    got, pool = TT.serve_step_paged(
        tp, tc, torch.from_numpy(token), torch.from_numpy(pos),
        _to_torch(ref_pool), torch.from_numpy(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)
    assert torch.isfinite(got).all()


def test_params_from_numpy_stores_the_dtype_of_use(models):
    _, _, tc, tp = models
    assert tp["lm_head"].dtype == torch.float32
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["blocks"]["attn"]["wq"].shape == (tc.n_layers, tc.d_model, tc.q_dim)
    assert tp["blocks"]["attn"]["bk"].dtype == torch.bfloat16
    assert tp["blocks"]["mlp"]["w2"].shape == (tc.n_layers, tc.d_ff, tc.d_model)


def test_init_lm_has_reference_layout_and_scales(models):
    rc, rp, tc, tp = models
    mine = init_lm(tc, torch.Generator().manual_seed(0), "cpu")
    shapes = lambda t: jax.tree.map(lambda x: tuple(x.shape), t)
    assert shapes(mine) == shapes(jax.tree.map(np.asarray, rp))
    wq = mine["blocks"]["attn"]["wq"].float()
    assert abs(float(wq.std()) * np.sqrt(tc.d_model) - 1.0) < 0.1
    assert abs(float(mine["embed"].float().std()) - 1.0) < 0.05
    assert torch.equal(mine["blocks"]["ln1"].float(),
                       torch.ones_like(mine["blocks"]["ln1"].float()))


def test_few_row_products_and_norms_do_not_depend_on_the_row_count():
    """A decode step's rows (one per sequence) go through the norms and
    products padded to MIN_ROWS rows: row i alone gives the bits it gives
    among four, and the values are the plain product's and norm's."""
    from repro_torch.models import layers as L

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 1, 64)).astype(np.float32)
                         ).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32)
                         ).to(torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal(64).astype(np.float32)
                         ).to(torch.bfloat16)
    (y,) = L.matmuls(x, w)
    n = L.rms_norm(x, g, 1e-6)
    assert y.shape == (4, 1, 48) and n.shape == x.shape
    torch.testing.assert_close(y.float(), (x.float() @ w.float()),
                               atol=0.1, rtol=2e-2)
    xf = x.float()
    plain = (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
             ).to(torch.bfloat16) * g
    assert torch.equal(n, plain)
    for i in range(4):
        assert torch.equal(L.matmuls(x[i:i + 1], w)[0][0], y[i])
        assert torch.equal(L.rms_norm(x[i:i + 1], g, 1e-6)[0], n[i])
