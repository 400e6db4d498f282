"""The kernels at the GQA groups of the dense configs, on a CUDA card
(skipped without one): qwen3-4b's G 4 (KVH 8), qwen3-14b's G 5, qwen3-32b's
G 8 and qwen1.5-32b's G 1 (KVH 40), head_dim 128, fp16 PASA.  Paged decode
(raw and 8-bit pools), contiguous decode (bit for bit equal to paged
decode on the same rows), paged prefill, shift-KV on 8 kv heads and the
causal attention kernel (both layouts of its plain version), each
against its plain version at the reference's bars; and a two-layer
qwen3-4b (qk-norm) serving the same streams batched and one at a time on
both routes.  The file imports neither jax nor the reference package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_dense_configs_cuda.py
"""

import dataclasses
import importlib
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.precision import FP16
from repro_torch.kernels import ops
from repro_torch.launch.steps import make_serve_step
from repro_torch.models.model_zoo import build
from repro_torch.runtime import ServeEngine, quantize_kv_page

amod, cmod, dmod, pmod, smod = (
    importlib.import_module(f"repro_torch.kernels.{name}")
    for name in ("pasa_attention", "pasa_decode", "pasa_paged_decode",
                 "pasa_paged_prefill", "shift_kv"))

BETA = 0.984497
# the reference's kernel-vs-oracle bars: decode (tests/test_paged.py),
# prefill (tests/test_prefix_cache.py), shift-KV and causal attention
# (tests/test_kernels.py)
DECODE_TOL = dict(atol=3e-3, rtol=3e-2)
PREFILL_TOL = dict(atol=1e-2, rtol=3e-2)
SHIFT_TOL = dict(atol=1e-2, rtol=0.0)
ATTN_CAUSAL_TOL = dict(atol=2e-3, rtol=2e-2)
# (KVH, G) of qwen3-4b, qwen3-14b, qwen3-32b, qwen1.5-32b
GROUPS = [(8, 4), (8, 5), (8, 8), (40, 1)]
PAGE = 128


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pool(rng, seq_lens, kvh, dev, key_mean):
    """Shuffled-page bf16 pool (D 128, page 128), one sequence per length;
    stale positions and unreferenced pages are NaN."""
    d = 128
    n_pages = [max(1, math.ceil(n / PAGE)) for n in seq_lens]
    total = 1 + sum(n_pages) + 2
    ids = rng.permutation(np.arange(1, total))
    table = np.zeros((len(seq_lens), max(n_pages)), np.int32)
    k = np.full((total, PAGE, kvh, d), np.nan, np.float32)
    v = np.full((total, PAGE, kvh, d), np.nan, np.float32)
    nxt = 0
    for b, (n, npg) in enumerate(zip(seq_lens, n_pages)):
        for j in range(npg):
            pid = int(ids[nxt])
            nxt += 1
            table[b, j] = pid
            rows = max(0, min(PAGE, n - j * PAGE))
            k[pid, :rows] = rng.standard_normal((rows, kvh, d)) + key_mean
            v[pid, :rows] = rng.standard_normal((rows, kvh, d))
    to = lambda a, dt: torch.from_numpy(a).to(device=dev, dtype=dt)
    return to(k, torch.bfloat16), to(v, torch.bfloat16), to(table, torch.int32)


def _randn(rng, shape, mean, dev, dtype=torch.float16):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32) + mean).to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kvh,g", GROUPS, ids=[f"g{g}" for _, g in GROUPS])
def test_decodes_at_the_dense_groups(kvh, g):
    """Paged decode (raw pool, and int8 / fp8_e4m3 pools at G 4) and
    contiguous decode over the same rows at a serve's lengths, keys of
    mean 30, queries of mean 0: each within the decode bars of its plain
    version, contiguous == paged bit for bit."""
    dev = _card()
    rng = np.random.default_rng(g)
    lens = [1002, 519, 302, 131]
    b = len(lens)
    kp, vp, table = _pool(rng, lens, kvh, dev, 30.0)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = _randn(rng, (b, kvh, g, 128), 0.0, dev)
    got = ops.pasa_paged_decode(q, kp, vp, table, kv_len, beta=BETA,
                                policy=FP16)
    want = dmod.paged_decode_plain(q, kp, vp, table, kv_len, beta=BETA,
                                   policy=FP16, block_kv=PAGE)
    torch.testing.assert_close(got.float(), want.float(), **DECODE_TOL)
    n = table.shape[1] * PAGE
    kview = kp[table.long()].reshape(b, n, kvh, 128).transpose(1, 2)
    vview = vp[table.long()].reshape(b, n, kvh, 128).transpose(1, 2)
    contiguous = ops.pasa_decode(q, kview, vview, kv_len, beta=BETA,
                                 policy=FP16, block_kv=PAGE)
    assert torch.equal(contiguous, got)
    torch.testing.assert_close(
        contiguous.float(),
        cmod.decode_plain(q, kview, vview, kv_len, beta=BETA, policy=FP16,
                          block_kv=PAGE).float(), **DECODE_TOL)
    if g != 4:
        return
    valid = torch.zeros(kp.shape[:2], dtype=torch.bool, device=dev)
    for i, n_i in enumerate(lens):
        for j in range(math.ceil(n_i / PAGE)):
            valid[int(table[i, j]), :min(PAGE, n_i - j * PAGE)] = True
    for dtype in ("int8", "fp8_e4m3"):
        kq, ks, kh = quantize_kv_page(kp, valid, dtype)
        vq, vs, vh = quantize_kv_page(vp, valid, dtype)
        side = dict(k_scale=ks, k_shift=kh, v_scale=vs, v_shift=vh)
        got = ops.pasa_paged_decode(q, kq, vq, table, kv_len, beta=BETA,
                                    policy=FP16, **side)
        want = dmod.paged_decode_plain(q, kq, vq, table, kv_len, beta=BETA,
                                       policy=FP16, block_kv=PAGE, **side)
        torch.testing.assert_close(got.float(), want.float(), **DECODE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kvh,g", GROUPS, ids=[f"g{g}" for _, g in GROUPS])
def test_paged_prefill_at_the_dense_groups(kvh, g):
    """4 rows x G * KVH heads x 512 queries (mean 1) at starts 0 / 512 /
    1024 and a pad row, keys of mean 2: within the prefill bars of the
    plain version; the pad row is zero."""
    dev = _card()
    rng = np.random.default_rng(10 + g)
    starts, kv_lens = [0, 512, 1024, 0], [512, 1024, 1324, 0]
    kp, vp, table = _pool(rng, kv_lens, kvh, dev, 2.0)
    table[3] = 0
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    kv_len = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    q = _randn(rng, (4, kvh * g, 512, 128), 1.0, dev)
    got = ops.pasa_paged_prefill(q, kp, vp, table, start, kv_len, beta=BETA,
                                 policy=FP16)
    want = pmod.paged_prefill_plain(q, kp, vp, table, start, kv_len,
                                    beta=BETA, policy=FP16)
    torch.testing.assert_close(got.float(), want.float(), **PREFILL_TOL)
    assert got[3].abs().max() == 0


@pytest.mark.cuda
def test_shift_and_attention_at_group_4():
    """qwen3-4b's dense prefill call: shift-KV on bf16 keys (4, 8, 1024,
    128) read through strides, and the causal attention kernel at H 32
    over KVH 8, against its plain version in the expanded and the grouped
    layout (the kernel's bits do not depend on the flag)."""
    dev = _card()
    rng = np.random.default_rng(4)
    keys = _randn(rng, (4, 1024, 8, 128), 5.0, dev,
                  torch.bfloat16).transpose(1, 2)
    m = smod.device_matrix(PAGE, 128, BETA, torch.float16, dev)
    torch.testing.assert_close(
        ops.shift_kv(keys, beta=BETA, block_kv=PAGE, policy=FP16).float(),
        smod.shift_kv_plain(m, keys.half(), PAGE,
                            out_dtype=torch.float16).float(), **SHIFT_TOL)
    q = _randn(rng, (4, 32, 1024, 128), 0.0, dev)
    k = _randn(rng, (4, 8, 1024, 128), 2.0, dev)
    v = _randn(rng, (4, 8, 1024, 128), 0.0, dev)
    got = ops.pasa_attention(q, k, v, beta=BETA, policy=FP16, causal=True)
    want = amod.attention_plain(q, k, v, beta=BETA, policy=FP16,
                                block_kv=PAGE, causal=True)
    torch.testing.assert_close(got.float(), want.float(), **ATTN_CAUSAL_TOL)


def _two_layer_qwen3(dev):
    """qwen3-4b at full width cut to two layers (qk-norm, G 4, head_dim
    128), random weights from seed 0."""
    cfg = dataclasses.replace(get_config("qwen3-4b"), n_layers=2)
    bundle = build(cfg)
    return bundle, bundle.init(torch.Generator(device=dev).manual_seed(0),
                               dev)


@pytest.mark.cuda
def test_qwen3_serves_batched_equal_one_at_a_time():
    """A two-layer qwen3-4b on the card: the paged engine and the dense
    route each give every prompt the same stream batched as alone (norms
    over few rows, q's and k's qk-norm included, run padded), every
    kernel launched 2 times per call."""
    dev = _card()
    bundle, params = _two_layer_qwen3(dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, bundle.cfg.vocab_size, n).tolist()
               for n in (300, 129, 17)]
    gen = 8

    def paged(batch):
        eng = ServeEngine(bundle, params, max_batch=len(batch), page_size=PAGE,
                          prefill_chunk=256, num_pages=1 + 3 * len(batch),
                          max_seq_len=320)
        reqs = [eng.submit(p, gen) for p in batch]
        eng.run_to_completion()
        return [r.generated for r in reqs], eng

    ops.reset_launches()
    streams, eng = paged(prompts)
    assert ops.pasa_paged_decode.launches == 2 * eng.decode_calls
    assert ops.pasa_paged_prefill.launches == 2 * eng.prefill_calls
    for p, want in zip(prompts, streams):
        assert paged([p])[0] == [want]

    step = make_serve_step(bundle)

    def dense(tokens):
        b, s = tokens.shape
        cache = bundle.init_cache(b, s + gen + 8, device=dev)
        logits, cache = bundle.prefill(params, tokens, cache)
        tok = torch.argmax(logits, -1).to(torch.int32)
        out = [tok]
        for i in range(s, s + gen - 1):
            tok, _, cache = step(params, tok, torch.full(
                (b,), i, dtype=torch.int32, device=dev), cache)
            out.append(tok)
        return torch.stack(out, 1)

    tokens = torch.from_numpy(rng.integers(
        0, bundle.cfg.vocab_size, (3, 200)).astype(np.int32)).to(dev)
    ops.reset_launches()
    batched = dense(tokens)
    assert ops.pasa_attention.launches == 2
    assert ops.pasa_decode.launches == 2 * (gen - 1)
    for i in range(3):
        assert torch.equal(dense(tokens[i:i + 1])[0], batched[i])
