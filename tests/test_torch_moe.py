"""The moe family in the port: ``MoEConfig``, the olmoe-1b-7b and
kimi-k2-1t-a32b configs, ``models/moe.py`` and the moe branch of the
transformer, each held against the reference.

The reference drops tokens by expert capacity: ``cap = ceil(T k / E *
capacity_factor)`` over all T rows of a call, later rows first, so at the
published capacity factor 1.25 a row's output depends on the other rows
of its call.  The port keeps those semantics; at a capacity factor of
E / k nothing is dropped.  Every fixture guards the margin between the
k-th and the (k+1)-th router probability of its tokens (``torch.topk``
and ``jax.lax.top_k`` may order ties differently) and, at 1.25, that it
drops at least one slot."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import moe as RM
from repro.models import transformer as RT
from repro.models.model_zoo import build as ref_build
from repro.runtime import ServeEngine as RefEngine
from repro_torch.configs import ALL_ARCHS, MoEConfig, get_config
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models.convert import init_lm, params_from_numpy
from repro_torch.models.model_zoo import build
from repro_torch.runtime import ServeEngine

torch.set_num_threads(1)

ARCHS = ("olmoe-1b-7b", "kimi-k2-1t-a32b")
BLOCK = 16
# the reference's a2a-vs-gspmd bar at fp32 (tests/test_launch.py); one
# bf16 ulp of the layer's outputs at bf16
FFN_ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
TOPK_MARGIN = 1e-4
# as tests/test_torch_dense_configs.py: two bf16 stacks agree within 0.1
LOGIT_ATOL = 0.1
STREAM_MARGIN = 0.05


def _shared_fields(port_obj, ref_obj):
    """The port's fields of a config dataclass, from both packages."""
    names = [f.name for f in dataclasses.fields(port_obj)]
    pick = lambda o: {n: getattr(o, n) for n in names}
    mine, want = pick(port_obj), pick(ref_obj)
    for sub in names:
        if dataclasses.is_dataclass(mine[sub]):
            mine[sub], want[sub] = _shared_fields(mine[sub], want[sub])
    return mine, want


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    assert arch in ALL_ARCHS
    mine, ref = get_config(arch), ref_get_config(arch)
    for got, want in ((mine, ref), (mine.reduced(), ref.reduced())):
        a, b = _shared_fields(got, want)
        assert a == b
        got.validate()
    assert isinstance(mine.moe, MoEConfig)
    assert (mine.reduced().moe.n_experts, mine.reduced().moe.top_k) == (4, 2)
    assert mine.param_dtype == ("bfloat16" if arch.startswith("kimi")
                                else "float32")
    bundle = build(mine)
    assert bundle.supports_paged and bundle.supports_chunked_prefill
    assert bundle.prefill is not None
    with pytest.raises(ValueError, match="n_experts"):
        dataclasses.replace(mine, moe=MoEConfig()).validate()


def test_init_lm_has_the_reference_layout():
    """``init_lm`` draws the moe leaves in the reference's layout (the
    router fp32, the experts at the compute dtype, no ``mlp``), at its
    scales; ``params_from_numpy`` keeps the router in fp32."""
    rc, tc = ref_get_config("olmoe-1b-7b").reduced(), _cfg("olmoe-1b-7b")
    rp = ref_build(rc).init(jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    mine = init_lm(dataclasses.replace(tc, d_model=256, d_ff=512), gen, "cpu")
    small = init_lm(tc, torch.Generator().manual_seed(0), "cpu")
    shapes = lambda t: jax.tree.map(lambda x: tuple(x.shape), t)
    assert shapes(small) == shapes(jax.tree.map(np.asarray, rp))
    moe = mine["blocks"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert {moe[n].dtype for n in ("w1", "w2", "w3")} == {torch.bfloat16}
    for name, fan_in in (("router", 256), ("w1", 256), ("w3", 256),
                         ("w2", 512)):
        std = float(moe[name].float().std())
        assert abs(std * math.sqrt(fan_in) - 1.0) < 0.05, name
    tree = jax.tree.map(lambda x: np.array(x, np.float32), rp)
    tp = params_from_numpy(tree, tc, "cpu")
    assert tp["blocks"]["moe"]["router"].dtype == torch.float32
    np.testing.assert_array_equal(tp["blocks"]["moe"]["router"].numpy(),
                                  tree["blocks"]["moe"]["router"])


# ------------------------------------------------------------ moe_ffn --

def _cfg(arch, pkg="port", **moe):
    cfg = (get_config if pkg == "port" else ref_get_config)(arch).reduced()
    cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, block_kv=BLOCK))
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe)) \
        if moe else cfg


# (E, k, seed): the reduced olmoe, and olmoe's published E / top-k at
# the reduced widths (d 64, f 128)
FFN_CASES = {"e4k2": (4, 2, 3), "e64k8": (64, 8, 12)}


def _ffn_fixture(e, k, seed, cf, dtype, shape=(4, 8)):
    """Both packages' configs and the numpy inputs of one moe layer:
    x (B, S, 64) N(0, 1), router N(0, 1/D), w1 / w3 N(0, 1/D), w2
    N(0, 1/F).  Guards the top-k margin and returns the dropped slots
    at ``cf``."""
    d, f = 64, 128
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape + (d,)).astype(np.float32)
    p = {"router": rng.standard_normal((d, e)) / np.sqrt(d),
         "w1": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w3": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w2": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    p = {n: v.astype(np.float32) for n, v in p.items()}
    moe = dict(n_experts=e, top_k=k, capacity_factor=cf)
    cfgs = {pkg: dataclasses.replace(_cfg("olmoe-1b-7b", pkg, **moe),
                                     compute_dtype=dtype)
            for pkg in ("port", "ref")}
    xr = np.asarray(jnp.asarray(x).astype(dtype).astype(jnp.float32),
                    np.float64).reshape(-1, d)
    logits = xr @ p["router"].astype(np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top = -np.sort(-probs, -1)
    assert (top[:, k - 1] - top[:, k]).min() > TOPK_MARGIN
    top_e = np.argsort(-probs, -1)[:, :k]
    t = xr.shape[0]
    cap = max(math.ceil(t * k / e * cf), 1)
    counts = np.bincount(top_e.reshape(-1), minlength=e)
    return cfgs, x, p, int(np.maximum(counts - cap, 0).sum()), top_e


def _ffn(pkg, cfg, x, p):
    if pkg == "ref":
        out = RM.moe_ffn(jnp.asarray(x), {n: jnp.asarray(v) for n, v in
                                          p.items()}, cfg)
        return np.asarray(out.astype(jnp.float32))
    return TM.moe_ffn(torch.from_numpy(x), {n: torch.from_numpy(v)
                                            for n, v in p.items()},
                      cfg).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", ["1.25", "e/k"])
@pytest.mark.parametrize("case", list(FFN_CASES))
def test_moe_ffn_matches_reference(case, cf, dtype):
    """``moe_ffn`` against the reference's (on one device its gspmd
    dispatch) on the same numpy inputs: within 1e-5 at fp32 - equal
    outputs there mean equal drop sets - and within one bf16 ulp at bf16;
    the 1.25 fixtures drop slots, the E / k ones none."""
    e, k, seed = FFN_CASES[case]
    factor = 1.25 if cf == "1.25" else e / k
    cfgs, x, p, dropped, _ = _ffn_fixture(e, k, seed, factor, dtype)
    assert (dropped > 0) == (cf == "1.25")
    want = _ffn("ref", cfgs["ref"], x, p)
    got = _ffn("port", cfgs["port"], x, p)
    assert got.shape == x.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=FFN_ATOL[dtype], rtol=0)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_capacity_makes_rows_depend_on_their_call(pkg):
    """A 4-row decode call at olmoe's E 64 / top-8 (cap 1 at 1.25): in
    both packages row 0 equals its result alone, and every later row that
    lost a slot to an earlier one differs from it; at capacity factor
    E / k (cap = T) every row equals its result alone (in the port bit
    for bit: the buffer's rows are padded to MIN_ROWS either way)."""
    for cf in (1.25, 8.0):
        cfgs, x, p, dropped, top_e = _ffn_fixture(64, 8, 4, cf, "bfloat16",
                                                  shape=(4, 1))
        batched = _ffn(pkg, cfgs[pkg], x, p)
        alone = np.concatenate([_ffn(pkg, cfgs[pkg], x[i:i + 1], p)
                                for i in range(4)])
        gap = np.abs(batched - alone).reshape(4, -1).max(-1)
        if cf == 8.0:
            assert dropped == 0
            if pkg == "port":
                np.testing.assert_array_equal(batched, alone)
            else:
                assert gap.max() <= FFN_ATOL["bfloat16"], gap
            continue
        # each row loses the slots an earlier row holds (cap 1)
        lost = [len(set(top_e[i]) & set(top_e[:i].reshape(-1)))
                for i in range(4)]
        assert lost[0] == 0 and all(n > 0 for n in lost[1:]), lost
        assert gap[0] == 0
        assert (gap[1:] > 0.05).all(), gap


def test_aux_load_balance_loss_matches_reference():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((32, 64)).astype(np.float32)
    top_e = np.argsort(-logits, -1)[:, :8].astype(np.int32)
    want = float(RM.aux_load_balance_loss(jnp.asarray(logits),
                                          jnp.asarray(top_e), 64))
    got = float(TM.aux_load_balance_loss(torch.from_numpy(logits),
                                         torch.from_numpy(top_e), 64))
    assert abs(got - want) < 1e-6


# ------------------------------------------------------------- models --

def _models(arch):
    """Both packages' reduced configs (block 16) with the reference's
    ``init_lm`` parameters carried across through numpy, the qk-norm
    weights drawn as 1 + 0.1 N(0, 1) where the config has them."""
    rc, tc = _cfg(arch, "ref"), _cfg(arch)
    rp = ref_build(rc).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.array(x, np.float32), rp)
    rng = np.random.default_rng(7)
    attn = tree["blocks"]["attn"]
    for name in ("q_norm", "k_norm"):
        if name in attn:
            attn[name] = (1.0 + 0.1 * rng.standard_normal(
                attn[name].shape)).astype(np.float32)
    return rc, jax.tree.map(jnp.asarray, tree), tc, params_from_numpy(
        tree, tc, "cpu")


@pytest.fixture(scope="module")
def models():
    return {arch: _models(arch) for arch in ARCHS}


def _routes(pkg, cfg, params, tokens, gen=3):
    """Prefill logits and the first decode's logits of the dense route
    (fused prefill, then ``serve_step``) and of the paged route (one
    prefill chunk into a fresh pool, then ``serve_step_paged``)."""
    b, s = tokens.shape
    pages = -(-(s + gen) // BLOCK)
    table = np.arange(1, 1 + b * pages, dtype=np.int32).reshape(b, pages)
    pos = np.full(b, s, np.int32)
    zeros = np.zeros(b, np.int32)
    if pkg == "ref":
        M, conv = RT, jnp.asarray
        argmax = lambda lg: jnp.argmax(lg, -1).astype(jnp.int32)
        cache = M.init_cache(cfg, b, s + gen)
        pool = M.init_paged_cache(cfg, 1 + b * pages, BLOCK)
    else:
        M, conv = TT, torch.from_numpy
        argmax = lambda lg: torch.argmax(lg, -1).to(torch.int32)
        cache = M.init_cache(cfg, b, s + gen, device="cpu")
        pool = M.init_paged_cache(cfg, 1 + b * pages, BLOCK, device="cpu")
    out = {}
    lg, cache = M.prefill_logits(params, cfg, conv(tokens), cache)
    out["prefill_logits"] = np.asarray(lg)
    lg, _ = M.serve_step(params, cfg, argmax(lg), conv(pos), cache)
    out["serve_step"] = np.asarray(lg)
    lg, pool = M.prefill_step_paged(params, cfg, conv(tokens), conv(zeros),
                                    conv(pos), conv(pos - 1), pool,
                                    conv(table))
    out["prefill_step_paged"] = np.asarray(lg)
    lg, _ = M.serve_step_paged(params, cfg, argmax(lg), conv(pos), pool,
                               conv(table))
    out["serve_step_paged"] = np.asarray(lg)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_reference(models, arch):
    """The reduced config (E 4, top-2, capacity factor 1.25) on both
    routes and the paged calls: logits within LOGIT_ATOL of the
    reference's."""
    rc, rp, tc, tp = models[arch]
    tokens = np.random.default_rng(4).integers(0, 512, (3, 40)).astype(
        np.int32)
    want = _routes("ref", rc, rp, tokens)
    got = _routes("port", tc, tp, tokens)
    for name, w in want.items():
        assert np.isfinite(got[name]).all(), name
        np.testing.assert_allclose(got[name], w, atol=LOGIT_ATOL, rtol=0,
                                   err_msg=name)


# ------------------------------------------------------------- engine --

PAGE, CHUNK = 16, 32
ENGINE_KW = dict(max_batch=3, num_pages=20, page_size=PAGE,
                 prefill_chunk=CHUNK, prefill_batch=2)
# request 0 finishes first: its dead slot 0 keeps routing its stale token
# ahead of the live rows and takes capacity from them
PROMPT_LENS, GENS = (40, 23, 57), (2, 8, 8)
PROMPT_SEED = 30


def _tap(out, record, rows):
    logits, pool = out
    record(logits, rows)
    return logits, pool


def _recorded(bundle, record):
    """The bundle with its paged steps handing ``record`` each call's
    logits and which rows emit a token from them (live decode rows: pos >
    0; prefill rows whose chunk ends their prompt)."""
    return dataclasses.replace(
        bundle,
        paged_serve_step=lambda p, t, pos, c, pt: _tap(
            bundle.paged_serve_step(p, t, pos, c, pt), record, pos > 0),
        paged_prefill_step=lambda p, t, st, kvl, li, c, pt: _tap(
            bundle.paged_prefill_step(p, t, st, kvl, li, c, pt), record,
            sum(kvl == n for n in PROMPT_LENS) > 0))


def _serve(eng, prompts):
    reqs = [eng.submit(p, n) for p, n in zip(prompts, GENS)]
    eng.run_to_completion()
    return [r.generated for r in reqs]


def _emitted_margin(calls):
    """The smallest top-2 logit gap over the rows that emitted a token."""
    gaps = []
    for logits, rows in calls:
        lg, rows = np.asarray(logits, np.float32), np.asarray(rows)
        top2 = np.sort(lg[rows], -1)[:, -2:]
        gaps.extend(top2[:, 1] - top2[:, 0])
    return float(np.min(gaps))


def _idle_row_drops(calls, routes, n_layers, cap):
    """Over the decode calls: the slots of decoding rows dropped because
    a row that is not decoding (a dead or still-prefilling slot, fed its
    stale token) held one of the expert's ``cap`` places ahead of them."""
    n, drops = 0, 0
    for logits, rows in calls:
        layers, n = routes[n:n + n_layers], n + n_layers
        rows = np.asarray(rows)
        if layers[0].shape[0] != rows.shape[0]:
            continue                                  # a prefill call
        for top_e in layers:
            for e in np.unique(top_e):
                order = [i for i in range(len(rows)) if e in top_e[i]]
                if not rows[order[:cap]].all():
                    drops += int(rows[order[cap:]].sum())
    return drops


def test_engine_streams_match_reference_engine(models, monkeypatch):
    """The engine at the published capacity factor 1.25 (cap 2 of a
    3-row decode call), bf16 pool, request 0 finishing first: the port's
    greedy streams equal the reference engine's, and rows that were not
    decoding took capacity from decoding ones.  The reference's logits
    are recorded through ``jax.debug.callback`` and its emitted top-2
    margins guarded."""
    rc, rp, tc, tp = models["olmoe-1b-7b"]
    assert rc.moe.capacity_factor == 1.25
    rng = np.random.default_rng(PROMPT_SEED)
    prompts = [rng.integers(0, 512, n).tolist() for n in PROMPT_LENS]
    ref_calls, calls, routes = [], [], []

    def ref_record(logits, rows):
        jax.debug.callback(lambda lg, r: ref_calls.append((lg, r)),
                           logits, rows)

    want = _serve(RefEngine(_recorded(ref_build(rc), ref_record), rp,
                            cache_dtype=jnp.bfloat16, **ENGINE_KW), prompts)
    jax.effects_barrier()
    route = TM.route

    def tap_route(xf, router, k):
        gate, top_e = route(xf, router, k)
        routes.append(top_e.numpy())
        return gate, top_e

    monkeypatch.setattr(TM, "route", tap_route)
    got = _serve(ServeEngine(_recorded(build(tc), lambda *a: calls.append(a)),
                             tp, **ENGINE_KW), prompts)
    assert [len(s) for s in got] == list(GENS)
    assert _emitted_margin(ref_calls) > STREAM_MARGIN
    assert len(calls) == len(ref_calls)
    assert _idle_row_drops(calls, routes, tc.n_layers, cap=2) > 0
    assert got == want
