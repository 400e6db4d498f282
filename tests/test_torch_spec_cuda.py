"""Speculation and sampling on a CUDA card (skipped without one).

``pasa_paged_verify`` launches the paged decode kernel once per column,
and each column equals a one-token kernel decode at its position bit for
bit, from raw and 8-bit pools; a two-layer model at head_dim 128 serves
the same streams and leaves the same non-null page bytes with speculation
on and off (the verify's sub-steps on the kernels, its rollback of
rejected sub-steps exact), and its sampled streams equal the
one-at-a-time serve's.  The sampler's uniforms on the card equal the
CPU's bit for bit.  Run on the card:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_spec_cuda.py
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.precision import FP16
from repro_torch.kernels import ops
from repro_torch.models.convert import init_lm
from repro_torch.models.model_zoo import build
from repro_torch.runtime import ServeEngine, quantize_kv_page
from repro_torch.runtime.engine import sample_uniforms

BETA = 0.984497
DECODE_TOL = dict(atol=3e-3, rtol=3e-2)   # tests/test_paged.py


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _verify_pool(rng, kv_lens, kvh, page, d, dev, dtype):
    """Shuffled bf16 pages (or their 8-bit codes with sidecars) holding
    each sequence's ``kv_lens`` rows."""
    n_pages = [math.ceil(n / page) for n in kv_lens]
    total = 1 + sum(n_pages) + 2
    ids = rng.permutation(np.arange(1, total))
    table = np.zeros((len(kv_lens), max(n_pages) + 1), np.int32)
    k = np.zeros((total, page, kvh, d), np.float32)
    v = np.zeros((total, page, kvh, d), np.float32)
    valid = np.zeros((total, page), bool)
    nxt = 0
    for b, (n, npg) in enumerate(zip(kv_lens, n_pages)):
        for j in range(npg):
            pid = int(ids[nxt])
            nxt += 1
            table[b, j] = pid
            rows = min(page, n - j * page)
            k[pid, :rows] = rng.standard_normal((rows, kvh, d)) + 2.0
            v[pid, :rows] = rng.standard_normal((rows, kvh, d))
            valid[pid, :rows] = True
    kt, vt = (torch.from_numpy(x).to(dev) for x in (k, v))
    table = torch.from_numpy(table).to(dev)
    if dtype == "bf16":
        return kt.bfloat16(), vt.bfloat16(), table, {}
    vm = torch.from_numpy(valid).to(dev)
    code = torch.int8 if dtype == "int8" else torch.float8_e4m3fn
    kq, ks, kh = quantize_kv_page(kt, vm, code)
    vq, vs, vh = quantize_kv_page(vt, vm, code)
    return kq, vq, table, dict(k_scale=ks, k_shift=kh.contiguous(),
                               v_scale=vs, v_shift=vh.contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "int8", "fp8_e4m3"])
def test_verify_columns_equal_kernel_decode(dtype):
    dev = _card()
    rng = np.random.default_rng(4)
    kv_lens = np.array([300, 131, 70], np.int32)
    w = 5
    kp, vp, table, quant = _verify_pool(rng, kv_lens, 4, 128, 128, dev, dtype)
    q = torch.from_numpy((rng.standard_normal((3, 4, 7, w, 128))).astype(
        np.float32)).to(dev, torch.float16)
    start = torch.from_numpy(kv_lens - w).to(dev)
    ops.reset_launches()
    got = ops.pasa_paged_verify(q, kp, vp, table, start, beta=BETA,
                                policy=FP16, **quant)
    assert ops.pasa_paged_decode.launches == w
    for j in range(w):
        col = ops.pasa_paged_decode(q[:, :, :, j], kp, vp, table,
                                    start + 1 + j, beta=BETA, policy=FP16,
                                    **quant)
        assert torch.equal(got[:, :, :, j], col), j
    cpu = {k: x.cpu() for k, x in quant.items()}
    plain = ops.pasa_paged_verify(q.cpu(), kp.cpu(), vp.cpu(), table.cpu(),
                                  start.cpu(), beta=BETA, policy=FP16, **cpu)
    torch.testing.assert_close(got.float().cpu(), plain.float(), **DECODE_TOL)


def _small_model(dev):
    base = get_config("qwen2-7b")
    cfg = dataclasses.replace(
        base, n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=128,
        d_ff=512, vocab_size=512,
        attention=dataclasses.replace(base.attention, block_kv=64),
    )
    return build(cfg), init_lm(cfg, torch.Generator(device=dev).manual_seed(0),
                               dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_speculation_on_card_matches_plain(dtype):
    dev = _card()
    bundle, params = _small_model(dev)
    seg = np.random.default_rng(8).integers(0, 512, 24).tolist()
    prompts = [(seg * 8)[:n] for n in (150, 40, 100)]
    kw = dict(max_batch=4, num_pages=16, page_size=64, prefill_chunk=128,
              cache_dtype=dtype)

    def run(**extra):
        eng = ServeEngine(bundle, params, **kw, **extra)
        reqs = [eng.submit(p, 12) for p in prompts]
        ops.reset_launches()
        eng.run_to_completion()
        return [r.generated for r in reqs], eng

    plain, e0 = run()
    spec, e1 = run(speculate=4)
    assert spec == plain
    assert e1.verify_calls >= 1 and e1.stats()["spec"]["proposed"] >= 1
    assert ops.pasa_paged_decode.launches == 2 * (e1.decode_calls
                                                  + 5 * e1.verify_calls)
    for name in e0.pool:
        assert torch.equal(e0.pool[name][:, 1:].view(torch.uint8),
                           e1.pool[name][:, 1:].view(torch.uint8)), name
    sampled, _ = run(temperature=0.8, top_k=50, sample_seed=7)
    sampled_spec, _ = run(temperature=0.8, top_k=50, sample_seed=7,
                          speculate=4)
    assert sampled_spec == sampled != plain
    for i, p in enumerate(prompts):
        eng = ServeEngine(bundle, params, **{**kw, "max_batch": 1},
                          temperature=0.8, top_k=50, sample_seed=7)
        r = eng.submit(p, 12, req_id=i)
        eng.run_to_completion()
        assert r.generated == sampled[i]


@pytest.mark.cuda
def test_sampler_uniforms_equal_on_card_and_cpu():
    dev = _card()
    rids = torch.tensor([0, 7, 2 ** 31 - 1, 5], dtype=torch.int32)
    idxs = torch.tensor([0, 3, 9, 2 ** 20], dtype=torch.int32)
    cpu = sample_uniforms(123, rids, idxs, 152064)
    card = sample_uniforms(123, rids.to(dev), idxs.to(dev), 152064)
    assert torch.equal(card.cpu(), cpu)
