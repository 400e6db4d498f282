"""The training path's attention on a CUDA card (skipped without one):
``kernels.train_attention.KernelAttention`` at qwen2-7b's training call
(batch 2, 28 query heads over 4 kv heads, 1,024 rows, head_dim 128,
causal; bf16 inputs), fp16 PASA at beta 0.984497 and FlashAttention-2 at
bf16_fp32 - its output equal to the op's and its gradients equal to
autograd of the plain version, bit for bit, one launch of the attention
kernel (and, for PASA, of the shift kernel) a forward - and a two-layer
train step on the card launching both per layer in the forward and
again in the remat recompute.  The file imports neither jax nor the
reference package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_train_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.precision import BF16_FP32, FP16
from repro_torch.kernels import ops
from repro_torch.kernels.pasa_attention import attention_plain
from repro_torch.kernels.train_attention import kernel_attention

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="needs a CUDA card: the kernels have no CPU "
                              "mode (their plain versions are held on the "
                              "CPU in tests/test_torch_train_step.py)"),
]

BETA = 0.984497
SHAPE = (2, 28, 4, 1024, 128)      # B, H, KVH, S, D


def _inputs(seed):
    b, h, kvh, s, d = SHAPE
    rng = np.random.default_rng(seed)
    draw = lambda *shape, mean=0.0: torch.from_numpy(
        (rng.standard_normal(shape) + mean).astype(np.float32)).to(
            "cuda", torch.bfloat16)
    return draw(b, h, s, d), draw(b, kvh, s, d, mean=2.0), draw(b, kvh, s, d)


@pytest.mark.parametrize("flash,beta,policy", [
    (False, BETA, FP16), (True, 0.0, BF16_FP32)], ids=["pasa_fp16",
                                                       "flash_bf16_fp32"])
def test_kernel_attention_at_the_training_call(flash, beta, policy):
    q, k, v = _inputs(0)
    ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ops.reset_launches()
    out = kernel_attention(*ins, flash=flash, beta=beta, policy=policy,
                           causal=True)
    op = ops.flash_attention if flash else ops.pasa_attention
    assert op.launches == 1
    assert ops.shift_kv.launches == (0 if flash else 1)
    kw = {} if flash else {"beta": beta}
    with torch.no_grad():
        assert torch.equal(out, op(q, k, v, policy=policy, causal=True, **kw))
    g = torch.randn(out.shape, device="cuda", dtype=out.dtype,
                    generator=torch.Generator("cuda").manual_seed(1))
    got = torch.autograd.grad(out, ins, g)
    pins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(attention_plain(
        *pins, beta=beta, policy=policy, block_kv=128, causal=True), pins, g)
    for a, b in zip(got, want):
        assert torch.isfinite(a.float()).all() and torch.equal(a, b)


def test_train_step_launches_per_layer():
    from repro_torch.launch.steps import (TrainHyper, init_train_state,
                                          make_train_step)
    from repro_torch.models.model_zoo import build

    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=2,
                              d_model=512, d_ff=1024, vocab_size=4096,
                              n_heads=4, n_kv_heads=1)
    bundle = build(cfg)
    state = init_train_state(
        bundle, torch.Generator("cuda").manual_seed(0), "cuda")
    step = make_train_step(bundle, TrainHyper(warmup_steps=1, total_steps=2))
    from repro_torch.data import synthetic_batch

    ops.reset_launches()
    for i in range(2):
        state, m = step(state, synthetic_batch(0, i, 2, 256, cfg.vocab_size))
        assert np.isfinite(float(m["loss"]))
    assert ops.pasa_attention.launches == ops.shift_kv.launches == 2 * 2 * 2
    assert ops.flash_attention.launches == 0
