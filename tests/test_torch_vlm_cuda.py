"""The kernels at llama-3.2-vision-90b's image cross-attention call, on a
CUDA card (skipped without one): shift-KV on the cross keys (4, 8, 1664,
128) (1,601 image tokens padded to whole blocks, bf16 keys, fp16
operands), the attention kernel on one query row padded to 64 (64 query
heads over 8 kv heads, G 8) against those keys with the column limit
kv_valid 1601, and contiguous decode at G 8 (the self layers' call), each
against its plain version at the reference's bars; and a one-group vlm
(one cross and four self layers, head_dim 128, G 8, 1,601 image tokens)
serving the same streams batched and one at a time, every kernel launched
as its layers say.  The file imports neither jax nor the reference
package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_vlm_cuda.py
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.precision import FP16
from repro_torch.kernels import ops
from repro_torch.models.model_zoo import build

amod, cmod, dmod, smod = (
    importlib.import_module(f"repro_torch.kernels.{name}")
    for name in ("pasa_attention", "pasa_decode", "pasa_paged_decode",
                 "shift_kv"))

BETA = 0.984497
# the reference's kernel-vs-oracle bars: shift-KV and non-causal
# attention (tests/test_kernels.py), decode (tests/test_paged.py)
SHIFT_TOL = dict(atol=1e-2, rtol=0.0)
ATTN_TOL = dict(atol=8e-3, rtol=2e-2)
DECODE_TOL = dict(atol=3e-3, rtol=3e-2)
# the cross call: batch 4, 8 kv heads at G 8, 1,601 image tokens in 1,664
# rows (13 blocks of 128), head_dim 128
B, KVH, G, D = 4, 8, 8, 128
N_IMAGE, S2 = 1601, 1664


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _randn(rng, shape, mean, dev, dtype=torch.float16):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32) + mean).to(dev, dtype)


def _padded_rows(x, n):
    return torch.nn.functional.pad(x, (0, 0, 0, n - x.shape[2]))


@pytest.mark.cuda
def test_shift_kv_at_the_cross_keys():
    """bf16 keys (B, S, KVH, D) read through strides, fp16 operands, block
    128, as the cross layer's attention hands them over."""
    dev = _card()
    rng = np.random.default_rng(0)
    k = _padded_rows(_randn(rng, (B, N_IMAGE, KVH, D), 2.0, dev,
                            torch.bfloat16).transpose(1, 2), S2)
    ops.reset_launches()
    got = ops.shift_kv(k, beta=BETA, block_kv=128, policy=FP16)
    m = smod.device_matrix(128, D, BETA, torch.float16, dev)
    want = smod.shift_kv_plain(m, k.half(), 128, out_dtype=torch.float16)
    torch.testing.assert_close(got.float(), want.float(), **SHIFT_TOL)
    assert ops.shift_kv.launches_by_mode == {
        smod.mode_name(torch.bfloat16, torch.float16, 128): 1}


@pytest.mark.cuda
@pytest.mark.parametrize("beta", [0.0, BETA])
def test_attention_at_the_cross_call(beta):
    """One query row padded to 64 rows (block_q 64) over the image keys,
    not causal, kv_valid 1601: against the plain version on the real row;
    NaN values past kv_valid leave the output unchanged bit for bit."""
    dev = _card()
    rng = np.random.default_rng(1)
    q = _padded_rows(_randn(rng, (B, KVH * G, 1, D), 0.0, dev), 64)
    k = _padded_rows(_randn(rng, (B, KVH, N_IMAGE, D), 2.0, dev), S2)
    v = _padded_rows(_randn(rng, (B, KVH, N_IMAGE, D), 0.0, dev), S2)
    kw = dict(policy=FP16, block_q=64, kv_valid=N_IMAGE)
    run = (lambda vv: ops.pasa_attention(q, k, vv, beta=beta, **kw)) if beta \
        else (lambda vv: ops.flash_attention(q, k, vv, **kw))
    got = run(v)
    want = amod.attention_plain(q, k, v, beta=beta, policy=FP16, block_kv=128,
                                kv_valid=N_IMAGE)
    torch.testing.assert_close(got[:, :, :1].float(), want[:, :, :1].float(),
                               **ATTN_TOL)
    v_nan = v.clone()
    v_nan[:, :, N_IMAGE:] = float("nan")
    assert torch.equal(run(v_nan), got)


@pytest.mark.cuda
def test_decode_at_group_8():
    """The self layers' decode: (B, 8, G 8, 128) queries over a bf16
    (B, max_len, 1024) cache read through strides, kv 33."""
    dev = _card()
    rng = np.random.default_rng(2)
    max_len, n = 72, 33
    cache_k = _randn(rng, (B, max_len, KVH * D), 2.0, dev, torch.bfloat16)
    cache_v = _randn(rng, (B, max_len, KVH * D), 0.0, dev, torch.bfloat16)
    kview, vview = (c.view(B, max_len, KVH, D).transpose(1, 2)
                    for c in (cache_k, cache_v))
    q = _randn(rng, (B, KVH, G, D), 0.0, dev)
    kv_len = torch.full((B,), n, dtype=torch.int32, device=dev)
    ops.reset_launches()
    got = ops.pasa_decode(q, kview, vview, kv_len, beta=BETA, policy=FP16,
                          block_kv=128)
    want = cmod.decode_plain(q, kview, vview, kv_len, beta=BETA, policy=FP16,
                             block_kv=128)
    torch.testing.assert_close(got.float(), want.float(), **DECODE_TOL)
    assert ops.pasa_decode.launches_by_mode == {
        dmod.mode_name(FP16, torch.bfloat16): 1}


def _one_group_vlm(dev):
    """llama-3.2-vision-90b cut to one group (a cross layer and four self
    layers) and narrowed (d 1024, 8 / 1 heads of 128: G 8, d_ff 2048,
    vocab 2048), 1,601 image tokens of width 1280; the gates non-zero."""
    cfg = dataclasses.replace(
        get_config("llama-3.2-vision-90b"), n_layers=5, d_model=1024,
        n_heads=8, n_kv_heads=1, d_ff=2048, vocab_size=2048)
    bundle = build(cfg)
    params = bundle.init(torch.Generator(device=dev).manual_seed(0), dev)
    params["cross"]["gate_attn"].fill_(0.5)
    params["cross"]["gate_mlp"].fill_(0.5)
    return bundle, params


@pytest.mark.cuda
def test_vlm_serves_batched_equal_one_at_a_time():
    """Three prompts with their images, token by token on the card: per
    step 4 contiguous decodes, one shift-KV and one attention launch, all
    at head_dim 128 fp16 PASA; each prompt alone from its image gives its
    batched stream."""
    from repro_torch.launch.serve import token_by_token

    dev = _card()
    bundle, params = _one_group_vlm(dev)
    cfg = bundle.cfg
    rng = np.random.default_rng(3)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (3, 12)).astype(np.int32)).to(dev)
    vis = _randn(rng, (3, cfg.n_image_tokens, cfg.vision_dim), 0.0, dev,
                 torch.bfloat16)
    gen = 6

    def run(rows, v):
        cache = bundle.init_cache(rows.shape[0], 24, device=dev)
        return token_by_token(bundle, params, rows, gen, cache,
                              vision_embeds=v)[0]

    ops.reset_launches()
    batched = run(prompts, vis)
    steps = prompts.shape[1] + gen - 1
    assert ops.pasa_decode.launches == 4 * steps
    assert ops.shift_kv.launches == ops.pasa_attention.launches == steps
    assert ops.pasa_paged_decode.launches == ops.pasa_paged_prefill.launches == 0
    assert ops.pasa_attention.launches_by_mode == {
        dmod.mode_name(FP16, torch.bfloat16): steps}
    for i in range(3):
        alone = run(prompts[i:i + 1], vis[i:i + 1])
        np.testing.assert_array_equal(alone[0], batched[i])
