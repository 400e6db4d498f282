"""Paged serving at every page size the reference serves, against the
reference.

The reference's served decode shifts in blocks of ``block_kv`` rows of the
page-table view whatever the page size (``paged_decode_xla(block_kv=)``),
its served prefill in one block a page (chunk-exact), and its CLI takes
any ``--page-size`` of 1 or more without touching ``block_kv``.  Held
here on the CPU (the plain versions): the paged decode op at pages 1, 8,
16, 48, 128 and 256 and blocks 64 and 128 from raw, int8 and fp8_e4m3
pools against ``paged_decode_xla``; the plain decode invariant to the page
size at a fixed block; the paged prefill op at pages 1, 8, 16, 24, 256,
300 and 512 against the reference's XLA path and its Pallas kernel in
interpret mode (300 and 512 also from int8 and fp8_e4m3 pools against the
XLA path), and bit-invariant to the chunk schedule; the engine at page 8
(block 128) against the reference engine, and at page 512 invariant to
its chunk schedule with prefix hits equal to cold serves; the CLI keeping
``block_kv``; the cost formula counting an 8-bit pool's sidecars per
page.
tests/test_torch_cuda_kernels.py holds the CUDA kernels at these pages to
the plain versions on a card.
"""

import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.kernels as RK
from repro.configs import get_config as ref_get_config
from repro.core import FP16 as REF_FP16
from repro.kernels.pasa_paged_decode import paged_decode_xla
from repro.kernels.pasa_paged_prefill import paged_prefill_xla
from repro.models import transformer as RT
from repro.models.model_zoo import build as ref_build
from repro.runtime import ServeEngine as RefEngine
from repro.runtime import paged_cache as RPC
from repro_torch.configs import get_config
from repro_torch.core.precision import FP16
from repro_torch.kernels import cost, ops
from repro_torch.kernels.pasa_decode import decode_plain
from repro_torch.launch import op_analysis, serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build
from repro_torch.runtime import ServeEngine

torch.set_num_threads(1)

BETA = 0.984497
# the bars of tests/test_torch_paged_kernels.py (the reference's own:
# decode tests/test_paged.py, prefill tests/test_prefix_cache.py)
DECODE_TOL = dict(atol=3e-3, rtol=3e-2)
PREFILL_TOL = dict(atol=1e-2, rtol=3e-2)
DECODE_PAGES = (1, 8, 16, 48, 128, 256)
DECODE_BLOCKS = (64, 128)
POOLS = ("raw", "int8", "fp8_e4m3")
PREFILL_PAGES = (1, 8, 16, 24, 256, 300, 512)
WIDE_PAGES = (300, 512)     # one PASA block a page over 256 rows
KV_LENS = (300, 77)


# ------------------------------------------------------------- fixtures --

def _contiguous(seed=0, kvh=2, g=3, d=32, lens=KV_LENS):
    """q (B, KVH, G, D) and a (B, KVH, S2, D) cache of keys of mean 2,
    NaN past each row's length."""
    rng = np.random.default_rng(seed)
    s2 = max(lens)
    k = rng.standard_normal((len(lens), kvh, s2, d)) + 2.0
    v = rng.standard_normal((len(lens), kvh, s2, d))
    dead = np.arange(s2)[None, None, :, None] >= np.asarray(lens)[:, None,
                                                                   None, None]
    k, v = (np.where(dead, np.nan, x).astype(np.float32) for x in (k, v))
    q = (rng.standard_normal((len(lens), kvh, g, d)) + 1.0).astype(np.float32)
    return q, k, v, np.asarray(lens, np.int32)


def _paged(k, v, lens, page, seed=1, extra=2):
    """The cache's rows in a shuffled pool of ``page``-row pages (page 0
    and ``extra`` pages unreferenced, NaN); returns k_pages, v_pages
    (P, page, KVH, D), the table and the valid-row mask of every page."""
    b, kvh, _, d = k.shape
    n_pages = [max(1, math.ceil(n / page)) for n in lens]
    total = 1 + sum(n_pages) + extra
    ids = np.random.default_rng(seed).permutation(np.arange(1, total))
    table = np.zeros((b, max(n_pages) + 1), np.int32)
    kp = np.full((total, page, kvh, d), np.nan, np.float32)
    vp = np.full((total, page, kvh, d), np.nan, np.float32)
    valid = np.zeros((total, page), bool)
    nxt = 0
    for bi, (n, npg) in enumerate(zip(lens, n_pages)):
        for j in range(npg):
            pid = int(ids[nxt])
            nxt += 1
            table[bi, j] = pid
            rows = max(0, min(page, n - j * page))
            kp[pid, :rows] = np.moveaxis(k[bi, :, j * page:j * page + rows], 0, 1)
            vp[pid, :rows] = np.moveaxis(v[bi, :, j * page:j * page + rows], 0, 1)
            valid[pid, :rows] = True
    return kp, vp, table, valid


def _quantize(kp, vp, valid, dtype):
    """Per-page codes and sidecars by the reference's quantizer (stale
    rows zeroed first: the quantizer reads the valid rows only)."""
    side = {}
    codes = []
    for name, x in (("k", kp), ("v", vp)):
        x = np.where(valid[..., None, None], x, 0.0).astype(np.float32)
        c, sc, sh = RPC.quantize_kv_page(jnp.asarray(x), jnp.asarray(valid),
                                         dtype)
        codes.append(c)
        side[f"{name}_scale"], side[f"{name}_shift"] = sc, sh
    return codes[0], codes[1], side


def _to_torch(x) -> torch.Tensor:
    """A reference array (fp8 codes as bytes) as a CPU tensor."""
    a = np.asarray(x)
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a))


def _decode_inputs(page, pool):
    """(reference arrays, port tensors) of one decode case: q, the pools,
    the table, kv_len and the sidecars of an 8-bit pool."""
    q, k, v, lens = _contiguous()
    kp, vp, table, valid = _paged(k, v, lens, page)
    if pool == "raw":
        ref = (q, kp.astype(np.float16), vp.astype(np.float16), table, lens,
               {})
    else:
        kq, vq, side = _quantize(kp, vp, valid, pool)
        ref = (q, kq, vq, table, lens, side)
    q_r, kp_r, vp_r, table_r, lens_r, side_r = ref
    port = (torch.from_numpy(q_r), _to_torch(kp_r), _to_torch(vp_r),
            torch.from_numpy(table_r), torch.from_numpy(lens_r),
            {name: _to_torch(x) for name, x in side_r.items()})
    return ref, port


# --------------------------------------------------------------- decode --

@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("block", DECODE_BLOCKS)
@pytest.mark.parametrize("page", DECODE_PAGES)
def test_decode_matches_reference_at_any_page(page, block, pool):
    """The paged decode op (its plain version on the CPU) at page ``page``
    and shift block ``block`` against the reference's
    ``paged_decode_xla(block_kv=block)`` on the same pool: a block spans
    pages (page < block), shares one (page > block) or both at once
    (page 48); NaN past kv_len and on unreferenced pages."""
    ref, port = _decode_inputs(page, pool)
    q, kp, vp, table, lens, side = ref
    want = paged_decode_xla(
        jnp.asarray(q).astype(jnp.float16), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(lens), beta=BETA, policy=REF_FP16,
        block_kv=block, **side)
    qt, kt, vt, tt, lt, st = port
    got = ops.pasa_paged_decode(qt, kt, vt, tt, lt, beta=BETA, policy=FP16,
                                block_kv=block, **st)
    got = got.float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **DECODE_TOL)


@pytest.mark.parametrize("block", DECODE_BLOCKS)
@pytest.mark.parametrize("page", DECODE_PAGES)
def test_decode_plain_is_page_invariant(page, block):
    """At a fixed block the paged plain version reads the same rows at
    every page size: bit for bit the contiguous decode's plain version on
    the cache (the contract the card holds between the kernels)."""
    q, k, v, lens = _contiguous()
    kp, vp, table, _ = _paged(k, v, lens, page)
    half = lambda x: torch.from_numpy(x).to(torch.float16)
    got = ops.pasa_paged_decode(
        torch.from_numpy(q), half(kp), half(vp), torch.from_numpy(table),
        torch.from_numpy(lens), beta=BETA, policy=FP16, block_kv=block)
    want = decode_plain(torch.from_numpy(q), half(k), half(v),
                        torch.from_numpy(lens), beta=BETA, policy=FP16,
                        block_kv=block)
    assert torch.equal(got, want)


def test_decode_block_defaults_to_the_page():
    """Without ``block_kv`` the op shifts one block a page, as the
    reference's ``pasa_paged_decode`` does."""
    ref, port = _decode_inputs(16, "raw")
    qt, kt, vt, tt, lt, _ = port
    assert torch.equal(
        ops.pasa_paged_decode(qt, kt, vt, tt, lt, beta=BETA, policy=FP16),
        ops.pasa_paged_decode(qt, kt, vt, tt, lt, beta=BETA, policy=FP16,
                              block_kv=16))
    q, kp, vp, table, lens, _ = ref
    want = RK.pasa_paged_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lens), beta=BETA, policy=REF_FP16, use_kernel=False)
    got = ops.pasa_paged_decode(qt, kt, vt, tt, lt, beta=BETA, policy=FP16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **DECODE_TOL)


# -------------------------------------------------------------- prefill --

def _prefill_case(page, seed=3, h=4, kvh=2, cs=32, d=32):
    """Rows at chunk start 0 (kv 32) and at start ``page`` (a ragged kv of
    page + 27), and a dead pad row (kv_len 0, all-null table)."""
    rng = np.random.default_rng(seed)
    start = np.array([0, page, 0], np.int32)
    lens = np.array([cs, page + cs - 5, 0], np.int32)
    s2 = int(lens.max())
    k = (rng.standard_normal((3, kvh, s2, d)) + 2.0).astype(np.float32)
    v = rng.standard_normal((3, kvh, s2, d)).astype(np.float32)
    kp, vp, table, _ = _paged(k, v, lens, page, seed=seed)
    table[2] = 0
    q = (rng.standard_normal((3, h, cs, d)) + 1.0).astype(np.float32)
    return q, kp, vp, table, start, lens


def _t(*arrs):
    return [torch.from_numpy(np.asarray(a)) for a in arrs]


@pytest.mark.parametrize("beta", [0.0, BETA])
@pytest.mark.parametrize("ref_route", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("page", PREFILL_PAGES)
def test_prefill_matches_reference_at_page(page, ref_route, beta):
    """The paged prefill op (one PASA block a page, chunk-exact) at page
    ``page`` against the reference's XLA path and its Pallas kernel in
    interpret mode; the pad row is zeros."""
    q, kp, vp, table, start, lens = _prefill_case(page)
    kw = (dict(use_kernel=False) if ref_route == "xla"
          else dict(interpret=True, block_q=16))
    want = RK.pasa_paged_prefill(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(start), jnp.asarray(lens), beta=beta, policy=REF_FP16,
        **kw)
    got = ops.pasa_paged_prefill(*_t(q, kp, vp, table, start, lens),
                                 beta=beta, policy=FP16).float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[2], 0.0)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **PREFILL_TOL)


@pytest.mark.parametrize("page,cuts", [(1, (0, 5, 17, 40)),
                                       (8, (0, 24, 40, 64)),
                                       (16, (0, 32, 48, 64)),
                                       (24, (0, 24, 72, 100)),
                                       (256, (0, 256, 300)),
                                       (512, (0, 512, 700))])
def test_prefill_is_bit_invariant_to_the_chunk_schedule(page, cuts):
    """One prompt prefilled in one chunk, or in chunks cut at page
    boundaries: every row bit for bit the same."""
    n = cuts[-1]
    rng = np.random.default_rng(5)
    k = (rng.standard_normal((1, 2, n, 32)) + 2.0).astype(np.float32)
    v = rng.standard_normal((1, 2, n, 32)).astype(np.float32)
    kp, vp, table, _ = _paged(k, v, [n], page, seed=6)
    q = torch.from_numpy(
        (rng.standard_normal((1, 4, n, 32)) + 1.0).astype(np.float32))
    kp, vp, table = _t(kp, vp, table)
    run = lambda c0, c1: ops.pasa_paged_prefill(
        q[:, :, c0:c1], kp, vp, table, torch.tensor([c0]), torch.tensor([c1]),
        beta=BETA, policy=FP16)
    whole = run(0, n)
    parts = torch.cat([run(c0, c1) for c0, c1 in zip(cuts, cuts[1:])], 2)
    assert torch.equal(whole, parts)


@pytest.mark.parametrize("pool", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("page", WIDE_PAGES)
def test_quantized_prefill_matches_reference_at_wide_page(page, pool):
    """The paged prefill op from an 8-bit pool (the reference's quantizer,
    per page) at a page over 256 rows against the reference's
    ``paged_prefill_xla`` on the same codes and sidecars, fp16 PASA; the
    pad row is zeros."""
    q, kp, vp, table, start, lens = _prefill_case(page)
    valid = np.isfinite(kp[:, :, 0, 0])
    kq, vq, side = _quantize(kp, vp, valid, pool)
    want = paged_prefill_xla(
        jnp.asarray(q), kq, vq, jnp.asarray(table), jnp.asarray(start),
        jnp.asarray(lens), beta=BETA, policy=REF_FP16, **side)
    got = ops.pasa_paged_prefill(
        *_t(q), _to_torch(kq), _to_torch(vq), *_t(table, start, lens),
        beta=BETA, policy=FP16,
        **{name: _to_torch(x) for name, x in side.items()}).float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[2], 0.0)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **PREFILL_TOL)


# --------------------------------------------------------------- engine --

ENGINE_PAGE = 8
CHUNK = 32
GEN = 6
PROMPT_LENS = (40, 23, 57, 9)
ENGINE_KW = dict(max_batch=3, num_pages=40, page_size=ENGINE_PAGE,
                 prefill_chunk=CHUNK, prefill_batch=2)
# a greedy token may differ only at a near-tie: the reference's own
# top-1 / top-2 gap under the two stacks' logit agreement
# (tests/test_torch_engine.py)
LOGIT_ATOL = 0.1


@pytest.fixture(scope="module")
def engines():
    """The reduced qwen2-7b at its block_kv of 128 in both packages, the
    reference's weights carried across; both engines serve the same
    staggered requests at page 8."""
    rc = ref_get_config("qwen2-7b").reduced()
    tc = get_config("qwen2-7b").reduced()
    assert rc.attention.block_kv == tc.attention.block_kv == 128
    rb = ref_build(rc)
    rp = rb.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.array(x, np.float32), rp)
    tp = params_from_numpy(tree, tc, "cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 512, n).tolist() for n in PROMPT_LENS]

    def staggered(eng):
        reqs = [eng.submit(p, GEN) for p in prompts[:2]]
        eng.step()
        reqs.append(eng.submit(prompts[2], GEN))
        eng.step()
        reqs.append(eng.submit(prompts[3], GEN))
        eng.run_to_completion()
        return [r.generated for r in reqs]

    ref = staggered(RefEngine(rb, rp, cache_dtype=jnp.bfloat16, **ENGINE_KW))
    calls = []
    decode = ops.pasa_paged_decode

    def spy(*args, **kw):
        calls.append((args[1].shape[1], kw.get("block_kv")))
        return decode(*args, **kw)

    ops.pasa_paged_decode = spy
    try:
        got = staggered(ServeEngine(build(tc), tp, **ENGINE_KW))
    finally:
        ops.pasa_paged_decode = decode
    return dict(rc=rc, rp=rp, prompts=prompts, ref=ref, got=got, calls=calls)


def _ref_logits_along(rc, rp, prompt, stream):
    """The reference model's logits at every generated position of
    ``stream``, replayed for one request on a fresh pool of 8-row pages
    (chunk-exact prefill is schedule-invariant and decode rows are
    independent: the logits the reference engine chose from)."""
    n_pages = math.ceil((len(prompt) + len(stream)) / ENGINE_PAGE)
    pool = RT.init_paged_cache(rc, n_pages + 1, ENGINE_PAGE)
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


def test_engine_at_page_8_matches_reference_engine(engines):
    """Page 8, block_kv 128 in both packages: each greedy stream equals
    the reference engine's, or first differs where the reference's own
    top-2 gap lies under LOGIT_ATOL (a near-tie the two stacks' rounding
    may flip, as tests/test_torch_engine.py guards it)."""
    equal = 0
    for prompt, mine, ref in zip(engines["prompts"], engines["got"],
                                 engines["ref"]):
        assert len(mine) == len(ref) == GEN
        if mine == ref:
            equal += 1
            continue
        i = next(j for j, (a, b) in enumerate(zip(mine, ref)) if a != b)
        logits = _ref_logits_along(engines["rc"], engines["rp"], prompt,
                                   ref)[i]
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] < LOGIT_ATOL, (i, top2)
    assert equal >= 2


def test_engine_decodes_in_blocks_of_block_kv(engines):
    """Every decode call of the page-8 engine reads 8-row pages and shifts
    in blocks of the config's 128 rows."""
    assert engines["calls"]
    assert set(engines["calls"]) == {(ENGINE_PAGE, 128)}


WIDE_ENGINE_PAGE = 512
WIDE_SHARED, WIDE_SUFFIXES, WIDE_GEN = 600, (150, 40), 4


def test_engine_at_page_512_chunk_schedule_and_prefix_hits():
    """The reduced qwen2-7b engine at 512-row pages (one PASA block a page,
    block_kv 128): requests of 750 and 640 tokens give the same greedy
    streams with prefill chunks of 512 and 1024 rows; with the prefix
    cache on, two prompts sharing a 600-token prefix hit its one full page
    (cached_len 512) and every stream, cold and hit, equals
    ``chunked_cold_reference`` (a fresh engine, cache off)."""
    from repro_torch.runtime import chunked_cold_reference

    tc = get_config("qwen2-7b").reduced()
    bundle = build(tc)
    params = bundle.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(12)
    shared = rng.integers(0, tc.vocab_size, WIDE_SHARED).tolist()
    prompts = [shared + rng.integers(0, tc.vocab_size, n).tolist()
               for n in WIDE_SUFFIXES]
    kw = dict(page_size=WIDE_ENGINE_PAGE, prefill_chunk=WIDE_ENGINE_PAGE)
    streams = {}
    for chunk in (WIDE_ENGINE_PAGE, 2 * WIDE_ENGINE_PAGE):
        eng = ServeEngine(bundle, params, max_batch=2, num_pages=8,
                          prefill_batch=2, **dict(kw, prefill_chunk=chunk))
        reqs = [eng.submit(p, WIDE_GEN) for p in prompts]
        eng.run_to_completion()
        streams[chunk] = [r.generated for r in reqs]
    assert streams[WIDE_ENGINE_PAGE] == streams[2 * WIDE_ENGINE_PAGE]
    eng = ServeEngine(bundle, params, max_batch=1, num_pages=8,
                      prefix_cache=True, **kw)
    reqs = []
    for p in prompts:
        reqs.append(eng.submit(p, WIDE_GEN))
        eng.run_to_completion()
    assert [r.cached_len for r in reqs] == [0, WIDE_ENGINE_PAGE]
    for p, r in zip(prompts, reqs):
        assert r.generated == chunked_cold_reference(bundle, params, p,
                                                     WIDE_GEN, **kw)
    assert streams[WIDE_ENGINE_PAGE] == [r.generated for r in reqs]


# ------------------------------------------------------------------ CLI --

def test_serve_cli_page_size_keeps_block_kv(capsys):
    """``--paged --page-size 8``: the pool's pages are 8 rows and every
    decode call shifts in the config's 128-row blocks, as the reference's
    CLI serves them (it passes the page size to the engine alone)."""
    calls = []
    decode = ops.pasa_paged_decode

    def spy(*args, **kw):
        calls.append((args[1].shape[1], kw.get("block_kv")))
        return decode(*args, **kw)

    ops.pasa_paged_decode = spy
    try:
        out = serve.main(["--arch", "qwen2-7b", "--reduced", "--paged",
                          "--page-size", "8", "--batch", "2", "--prompt-len",
                          "20", "--gen", "4", "--device", "cpu"])
    finally:
        ops.pasa_paged_decode = decode
    assert out.shape == (2, 4)
    assert calls and set(calls) == {(8, 128)}
    assert "pages of 8" in capsys.readouterr().out


# ----------------------------------------------------------------- cost --

@pytest.mark.parametrize("page", [8, 128])
def test_cost_counts_sidecars_per_page(page):
    """The count of a decode call from an 8-bit pool adds one sidecar set
    (scale and D shifts, K and V) per page each row's length touches:
    ceil(n / page) pages a row."""
    ref, port = _decode_inputs(page, "int8")
    qt, kt, vt, tt, lt, st = port
    b, kvh, g, d = qt.shape
    with op_analysis.count() as c:
        ops.pasa_paged_decode(qt, kt, vt, tt, lt, beta=BETA, policy=FP16,
                              block_kv=128, **st)
    pages = sum(math.ceil(n / page) for n in KV_LENS)
    raw, _ = cost.paged_decode_cost(b, kvh, g, d, KV_LENS, tt.numel(),
                                    kv_itemsize=1, q_itemsize=4)
    assert c.bytes_by_op["pasa_paged_decode"] == raw + 2 * pages * kvh * (
        1 + d) * 4
