"""``models/moe.py`` on a CUDA card (skipped without one): ``moe_ffn`` at
olmoe-1b-7b's E 64 / top-8 against its own CPU result within one bf16
ulp, at the published capacity factor 1.25 (slots dropped) and at E / k
(none), on fixtures whose k-th and (k+1)-th router probabilities are
apart; two calls on the card are equal bit for bit (each token's k
contributions are summed in a fixed order, no atomics); and at E / k a
row's output equals its output alone bit for bit (the buffer's rows are
padded to MIN_ROWS either way).  The file imports neither jax nor the
reference package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_moe_cuda.py
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import moe as TM

BF16_ATOL = 2e-2
TOPK_MARGIN = 1e-4
# (d_model, d_ff, x shape, seed): the reduced widths with 32 tokens, and
# olmoe's own widths with a decode-sized call
CASES = {"narrow": (64, 128, (4, 8), 12), "olmoe": (2048, 1024, (4, 1), 0)}


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _fixture(case, cf):
    """olmoe's config at ``cf`` and the case's widths, x (B, S, D) N(0, 1)
    rounded to bf16, router N(0, 1/D) fp32, experts N(0, 1/fan_in) in
    bf16; the top-k margin guarded, the dropped slots counted."""
    d, f, shape, seed = CASES[case]
    cfg = get_config("olmoe-1b-7b")
    cfg = dataclasses.replace(cfg, d_model=d, d_ff=f, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape + (d,)).astype(
        np.float32)).to(torch.bfloat16)
    draw = lambda *s: torch.from_numpy(
        (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32))
    p = {"router": draw(d, e), "w1": draw(e, d, f).to(torch.bfloat16),
         "w3": draw(e, d, f).to(torch.bfloat16),
         "w2": draw(e, f, d).to(torch.bfloat16)}
    probs = torch.softmax(x.reshape(-1, d).double() @ p["router"].double(),
                          -1)
    top = probs.sort(-1, descending=True).values
    assert float((top[:, k - 1] - top[:, k]).min()) > TOPK_MARGIN
    t = probs.shape[0]
    cap = max(math.ceil(t * k / e * cf), 1)
    counts = torch.bincount(probs.topk(k, -1).indices.reshape(-1),
                            minlength=e)
    return cfg, x, p, int((counts - cap).clamp(min=0).sum())


def _on(dev, x, p):
    return x.to(dev), {n: v.to(dev) for n, v in p.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("cf", ["1.25", "e/k"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_on_the_card_matches_the_cpu(case, cf):
    dev = _card()
    cfg, x, p, dropped = _fixture(case, 1.25 if cf == "1.25" else 8.0)
    assert (dropped > 0) == (cf == "1.25")
    want = TM.moe_ffn(x, p, cfg).float()
    xd, pd = _on(dev, x, p)
    got = TM.moe_ffn(xd, pd, cfg)
    again = TM.moe_ffn(xd, pd, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float().cpu(), want, atol=BF16_ATOL,
                               rtol=0)


@pytest.mark.cuda
def test_rows_without_drops_equal_their_rows_alone():
    """At capacity factor E / k a 4-row decode call's rows equal the same
    rows served one at a time, bit for bit, at olmoe's widths."""
    dev = _card()
    cfg, x, p, dropped = _fixture("olmoe", 8.0)
    assert dropped == 0
    xd, pd = _on(dev, x, p)
    batched = TM.moe_ffn(xd, pd, cfg)
    for i in range(x.shape[0]):
        assert torch.equal(TM.moe_ffn(xd[i:i + 1], pd, cfg), batched[i:i + 1])
