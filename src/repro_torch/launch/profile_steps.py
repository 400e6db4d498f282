"""Where the device time of the serving calls and of a train step goes,
on the card.

Builds ``--arch`` (qwen2-7b by default; full width, ``--layers`` cuts
depth) with random weights and profiles the device calls of its serving
routes.  The dense family (qwen2-7b, qwen3-4b, ...; the two 32B configs
need ``--layers`` to fit one card) and the moe family (olmoe-1b-7b; its
expert products land in "gemm", the routing and dispatch in "other"),
both routes:

  * paged: four prompts of 1000/517/300/129 tokens prefilled in 512-token
    chunks through ``prefill_step_paged`` exactly as ``ServeEngine``
    batches them, then decoded (``serve_step_paged``);
  * dense (the default route of ``launch/serve.py``): four prompts of
    1000 tokens in one fused prefill (``prefill_logits``), then decoded on
    the dense cache (``serve_step``) from kv 1001.

``--arch zamba2-1.2b`` (the hybrid family, served token by token on the
dense cache): four prompts of 200 tokens fed through ``serve_step`` into
a 240-row cache, then the decode call (``hybrid_decode``) from kv 201.
``--arch whisper-large-v3`` (the audio family, the same route): one
encode of four clips of 1500 frame embeddings (``whisper_encode``, the
call profiled as such), its output written into the cache's ``enc_out``,
four prompts of 64 tokens fed through ``serve_step`` into a 104-row
cache, then the decode call (``whisper_decode``) from kv 66.
``--arch llama-3.2-vision-90b --layers 20`` (the vlm family, the same
route; 100 layers do not fit one card, and ``--layers`` must be a
multiple of its ``cross_attn_every``, 5): image inputs (4, 1601, 1280)
drawn N(0, 1) in bf16, four prompts of 32 tokens fed through
``serve_step`` into a 72-row cache, then the decode call (``vlm_decode``:
the image projection, the cross K/V of every cross layer, every layer's
step) from kv 33.  ``--arch falcon-mamba-7b`` (the ssm family, the same
route, no attention kernel): four prompts of 64 tokens, then the decode
call (``ssm_decode``) from the state after them.

``--speculate K`` (the dense family) adds the paged route's verify call
(``runtime.engine.paged_verify_step``, what ``ServeEngine(speculate=K)``
runs as its decode when a row has drafts): K + 1 chained
``serve_step_paged`` sub-steps with every row drafting K tokens (the
model's own previous choice repeated, so most are rejected and rolled
back), profiled as ``verify`` beside the plain decode call at the same
batch and pool.

``--engine-steps N`` (the dense family) profiles the paged ENGINE instead of
bare calls: ``ServeEngine`` serves the four paged prompts at each
``--pipeline-depth`` (0 = synchronous, 1 = async; both by default).  Two
windows per depth, each ended by ``drain()`` and a synchronize: the first
step (the batched prefill call, then the decode call of the rows whose
prompt ended) and N steady decode steps (from the third step on).  For
each it prints the wall time per step (timed without the profiler), the
device busy time and the device's idle share, and the synchronizing CUDA
calls per step outside the engine's drain points (counted under
``torch.cuda.set_sync_debug_mode("warn")``, :func:`count_syncs`).

``--kv-dtype int8`` or ``fp8_e4m3`` serves the paged route from a
quantized page pool (the quantized mode of the paged kernels; the
quantize-on-write and tail-page re-quantization ops land in "other");
the dense route, which has no quantized cache, is then left out.

``--train`` profiles one training step instead (``launch.steps.
make_train_step`` at the smoke's phase 15 shape: ``--arch`` at full
width, ``--layers`` 8 by default, remat on, fp32 parameters and AdamW
moments, batch 2 x 1,024 tokens from ``DataPipeline``): after two warm
steps, one step timed without the profiler (wall, peak memory), then one
under it, its device time split into GEMMs, the PASA kernels (shift-KV
and attention, the forward and its remat recompute), the plain
attention's backward (every kernel run inside
``KernelAttention.backward``: the plain version's recompute and its
autograd, GEMMs included), the AdamW update (every kernel inside
``adamw_update``) and the rest; in the unprofiled step each annotated
window is also timed with CUDA events around it (the device's time from
the window's first queued kernel to its last, idle gaps included).

The first prefill call and ``--decode-calls`` decode calls of each route
run under ``torch.profiler`` (CPU + CUDA activities, after a warm-up of
each).  For each call type it prints the wall time per call (timed once
without the profiler, then under it), the device time per call by kernel
category (each PASA kernel, GEMMs, the rest) and the device's idle share
of the unprofiled wall time, and writes the Chrome traces under ``--out``.

Run on one card from the repository root:
  PYTHONPATH=src python -m repro_torch.launch.profile_steps --out build/profile
  PYTHONPATH=src python -m repro_torch.launch.profile_steps \
      --arch qwen3-4b --out build/profile_qwen3
  PYTHONPATH=src python -m repro_torch.launch.profile_steps \
      --arch zamba2-1.2b --out build/profile_hybrid
  PYTHONPATH=src python -m repro_torch.launch.profile_steps \
      --arch whisper-large-v3 --out build/profile_whisper
  PYTHONPATH=src python -m repro_torch.launch.profile_steps \
      --arch llama-3.2-vision-90b --layers 20 --out build/profile_vlm
  PYTHONPATH=src python -m repro_torch.launch.profile_steps \
      --arch falcon-mamba-7b --out build/profile_ssm
  PYTHONPATH=src python -m repro_torch.launch.profile_steps \
      --arch olmoe-1b-7b --out build/profile_olmoe
  PYTHONPATH=src python -m repro_torch.launch.profile_steps --kv-dtype int8 \
      --out build/profile_int8
  PYTHONPATH=src python -m repro_torch.launch.profile_steps --speculate 4 \
      --out build/profile_verify
  PYTHONPATH=src python -m repro_torch.launch.profile_steps \
      --engine-steps 16 --pipeline-depth 0 1 --out build/profile_engine
  PYTHONPATH=src python -m repro_torch.launch.profile_steps --train \
      --out build/profile_train
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import warnings
from pathlib import Path

from repro_torch.configs import ALL_ARCHS

PROMPTS = (1000, 517, 300, 129)
CHUNK = 512
PAGE = 128
DENSE_BATCH, DENSE_PROMPT = 4, 1000
# token-by-token families: (batch, prompt tokens, cache rows) of each
TOKEN_BY_TOKEN = {"hybrid": (4, 200, 240), "audio": (4, 64, 104),
                  "vlm": (4, 32, 72), "ssm": (4, 64, 104)}

# --train: the smoke's phase 15 shape
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = 8, 2, 1024
# the windows of a train step profiled apart (record_function labels)
TRAIN_WINDOWS = ("plain_attention_backward", "adamw_update")

# kernel-name fragment -> category, first match wins
_KERNELS = (
    # split_decode_kernel<DecodeBlocks..>: the instances of both decode
    # ops (paged and contiguous), told apart by the call profiled
    ("split_decode_kernel", "pasa_decode"),
    ("paged_prefill_kernel", "pasa_paged_prefill"),
    ("contiguous_decode_kernel", "pasa_decode"),  # the walk (not on a path)
    ("shift_kv_kernel", "shift_kv"),
    ("pasa_attention_kernel", "pasa_attention"),
)


def _category(name: str) -> str:
    low = name.lower()
    for fragment, cat in _KERNELS:
        if fragment in low:
            return cat
    if any(s in low for s in ("gemm", "gemv", "cutlass", "xmma", "nvjet",
                              "cublas", "sm90_")):
        return "gemm"
    return "other"


def _busy_us(prof) -> float:
    """Device busy time of a profile: the union of its kernel intervals
    (one stream: they do not overlap)."""
    import torch

    return _busy_us_of([e for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA])


def _busy_us_of(events) -> float:
    """The union of the events' device intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -math.inf
    for s, e in spans:
        if s >= end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


@contextlib.contextmanager
def count_syncs(*engines):
    """Count the synchronizing CUDA calls made while the block runs, under
    ``torch.cuda.set_sync_debug_mode("warn")``: yields a dict whose
    ``"outside"`` is the count outside the drain points of ``engines``
    (``_retire_one``, ``drain`` and, with telemetry, the numerics probe),
    ``"all"`` the count in all and ``"where"`` their sites, filled when
    the block exits.  The mode flags blocking copies and readbacks
    (``.cpu()``, ``.item()``, a ``.to(device)`` from pageable memory),
    not ``torch.cuda.synchronize()`` or an event's ``synchronize()``."""
    import torch

    counts = {"outside": 0, "all": 0}
    inside = {"depth": 0, "n": 0}
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")

        def marked(fn):
            def run(*a, **kw):
                n0 = len(seen)
                inside["depth"] += 1
                try:
                    return fn(*a, **kw)
                finally:
                    inside["depth"] -= 1
                    if inside["depth"] == 0:
                        inside["n"] += len(seen) - n0
            return run

        wrapped = []
        for eng in engines:
            wrapped += [(eng, "_retire_one"), (eng, "drain")]
            probe = getattr(eng.telemetry, "probe", None)
            if probe is not None:
                wrapped.append((probe, "sample"))
        for obj, name in wrapped:
            setattr(obj, name, marked(getattr(obj, name)))
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield counts
        finally:
            torch.cuda.set_sync_debug_mode(prev)
            for obj, name in wrapped:
                delattr(obj, name)
            # the mode's own one-time notice ("a prototype feature ...")
            # is not a synchronizing call
            syncs = [w for w in seen if "called a synchronizing CUDA "
                     "operation" in str(w.message)]
            counts["all"] = len(syncs)
            counts["outside"] = len(syncs) - inside["n"]
            counts["where"] = sorted({f"{w.filename}:{w.lineno}"
                                      for w in syncs})


def _profile(fn, n_calls: int, trace: Path) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_calls):
        fn()
    torch.cuda.synchronize()
    plain_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    prof.export_chrome_trace(str(trace))
    by_cat = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        cat = _category(e.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + e.time_range.elapsed_us()
    busy = _busy_us(prof)
    # the profiler slows the host; the idle share is taken against the
    # wall time of the same calls run without it
    return {
        "calls": n_calls,
        "wall_ms_per_call": plain_us / n_calls / 1e3,
        "wall_ms_per_call_profiled": wall_us / n_calls / 1e3,
        "device_busy_ms_per_call": busy / n_calls / 1e3,
        "device_idle_share": 1.0 - busy / plain_us,
        "device_ms_per_call": {k: v / n_calls / 1e3 for k, v in
                               sorted(by_cat.items())},
        "trace": str(trace),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-7b", choices=ALL_ARCHS)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers (default: all)")
    ap.add_argument("--decode-calls", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/profile")
    ap.add_argument("--kv-dtype", default="bf16",
                    choices=("bf16", "fp8_e4m3", "int8"),
                    help="the paged route's pool dtype (a quantized one "
                         "leaves the dense route out)")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="also profile the paged route's verify call with "
                         "K drafts per row (the dense family)")
    ap.add_argument("--engine-steps", type=int, default=0, metavar="N",
                    help="profile the paged engine's first step and N "
                         "steady decode steps instead of bare calls "
                         "(the dense family)")
    ap.add_argument("--train", action="store_true",
                    help="profile one train step (the smoke's phase 15 "
                         "shape) instead of the serving calls")
    ap.add_argument("--pipeline-depth", type=int, nargs="+", default=[0, 1],
                    choices=(0, 1),
                    help="--engine-steps: the engine's pipeline depths "
                         "(default: both)")
    args = ap.parse_args(argv)
    if args.speculate < 0:
        ap.error("--speculate must be >= 0")
    if args.engine_steps < 0:
        ap.error("--engine-steps must be >= 0")

    import numpy as np
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build

    dev = resolve_device("cuda")
    cfg = get_config(args.arch)
    if args.train:
        report = _profile_train(args, cfg, dev, Path(args.out))
        print(json.dumps(report))
        return report
    if args.layers:
        if cfg.family == "vlm" and args.layers % cfg.cross_attn_every:
            ap.error(f"--layers must be a multiple of cross_attn_every "
                     f"({cfg.cross_attn_every}) for {cfg.arch_id}")
        cfg = dataclasses.replace(
            cfg, n_layers=args.layers,
            n_encoder_layers=min(cfg.n_encoder_layers, args.layers))
    bundle = build(cfg)
    params = bundle.init(torch.Generator(device=dev).manual_seed(args.seed), dev)
    rng = np.random.default_rng(args.seed)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if bundle.prefill is None:
        report = _profile_token_by_token(args, bundle, params, rng, dev, out)
        print(json.dumps(report))
        return report
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in PROMPTS]
    if args.engine_steps:
        report = _profile_engine(args, bundle, params, prompts, out)
        print(json.dumps(report))
        return report
    # each profiled call type runs 2 * --decode-calls + 1 times (warm-up,
    # unprofiled, profiled): decode calls, then verify calls writing up to
    # K + 1 positions each
    calls = 2 * args.decode_calls + 1
    grow = calls * (1 + (args.speculate + 1 if args.speculate else 0))
    n_pages = [math.ceil((n + grow + 8) / PAGE) for n in PROMPTS]
    pool = bundle.init_paged_cache(1 + sum(n_pages), PAGE, args.kv_dtype,
                                   device=dev)
    mp = max(n_pages)
    table = np.zeros((len(PROMPTS), mp), np.int32)
    nxt = 1
    for b, n in enumerate(n_pages):
        table[b, :n] = np.arange(nxt, nxt + n)
        nxt += n
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    table_t = to(table)

    def prefill_inputs(c0):
        b = len(PROMPTS)
        tokens = np.zeros((b, CHUNK), np.int32)
        start = np.zeros(b, np.int32)
        kv_len = np.zeros(b, np.int32)
        last = np.zeros(b, np.int32)
        rows = np.zeros((b, mp), np.int32)
        for i, p in enumerate(prompts):
            real = max(0, min(CHUNK, len(p) - c0))
            if real:
                tokens[i, :real] = p[c0:c0 + real]
                start[i], kv_len[i], last[i] = c0, c0 + real, real - 1
                rows[i] = table[i]
        return [to(x) for x in (tokens, start, kv_len, last)] + [to(rows)]

    first = prefill_inputs(0)
    call_prefill = lambda: bundle.paged_prefill_step(
        params, *first[:4], pool, first[4])
    call_prefill()                                   # warm-up
    report = {"arch": cfg.arch_id, "layers": cfg.n_layers,
              "device": torch.cuda.get_device_name(0),
              "kv_dtype": args.kv_dtype}
    report["prefill"] = _profile(call_prefill, 1, out / "trace_prefill.json")
    for c0 in range(CHUNK, max(PROMPTS), CHUNK):      # finish every prompt
        nxt_in = prefill_inputs(c0)
        bundle.paged_prefill_step(params, *nxt_in[:4], pool, nxt_in[4])
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
    token = torch.zeros(len(PROMPTS), dtype=torch.int32, device=dev)

    def call_decode():
        nonlocal pos, token
        logits, _ = bundle.paged_serve_step(params, token, pos, pool, table_t)
        token = torch.argmax(logits, -1).to(torch.int32)
        pos = pos + 1

    call_decode()                                    # warm-up
    kv_start = [int(x) + 1 for x in pos.tolist()]
    report["decode"] = _profile(call_decode, args.decode_calls,
                                out / "trace_decode.json")
    report["decode"]["kv_len_at_first_call"] = kv_start
    if args.speculate:
        report["verify"] = _profile_verify(args, bundle, params, pool,
                                           table_t, pos, token, out)
    del pool
    if args.kv_dtype != "bf16":
        print(json.dumps(report))
        return report

    # the dense route: one fused prefill, then decode on the dense cache
    dense = rng.integers(0, cfg.vocab_size, (DENSE_BATCH, DENSE_PROMPT))
    dense = to(dense.astype(np.int32))
    max_len = DENSE_PROMPT + args.decode_calls + 16
    cache = bundle.init_cache(DENSE_BATCH, max_len, device=dev)
    call_dense_prefill = lambda: bundle.prefill(params, dense, cache)
    call_dense_prefill()                             # warm-up
    report["dense_prefill"] = _profile(call_dense_prefill, 1,
                                       out / "trace_dense_prefill.json")
    dpos = torch.full((DENSE_BATCH,), DENSE_PROMPT, dtype=torch.int32,
                      device=dev)
    dtok = torch.zeros(DENSE_BATCH, dtype=torch.int32, device=dev)

    def call_dense_decode():
        nonlocal dpos, dtok
        logits, _ = bundle.serve_step(params, dtok, dpos, cache)
        dtok = torch.argmax(logits, -1).to(torch.int32)
        dpos = dpos + 1

    call_dense_decode()                              # warm-up
    dkv = int(dpos[0]) + 1
    report["dense_decode"] = _profile(call_dense_decode, args.decode_calls,
                                      out / "trace_dense_decode.json")
    report["dense_decode"]["kv_len_at_first_call"] = [dkv] * DENSE_BATCH
    print(json.dumps(report))
    return report


def _profile_engine(args, bundle, params, prompts, out: Path) -> dict:
    """The paged engine at each ``--pipeline-depth``: the first step and
    ``--engine-steps`` steady decode steps, each window ended by
    ``drain()`` and a synchronize; timed, then profiled on a fresh engine
    serving the same requests (the same work), then counted for
    synchronizing calls on a third."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime import ServeEngine

    n = args.engine_steps
    gen = n + 4
    kw = dict(max_batch=len(PROMPTS), page_size=PAGE, prefill_chunk=CHUNK,
              num_pages=1 + sum(math.ceil((len(p) + gen) / PAGE)
                                for p in prompts),
              max_seq_len=max(len(p) for p in prompts) + gen,
              cache_dtype=args.kv_dtype)
    warm = ServeEngine(bundle, params, **kw)
    warm.submit(prompts[-1][:64].tolist(), 4)
    warm.run_to_completion()                         # first calls
    del warm

    def windows(depth, wrap):
        """[(steps, wall_s, wrap's result)] of the two windows."""
        eng = ServeEngine(bundle, params, pipeline_depth=depth, **kw)
        for p in prompts:
            eng.submit(p.tolist(), gen)
        res = []
        for i, steps in enumerate((1, n)):
            if i:
                eng.step()                           # the second prefill chunk
                eng.drain()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with wrap(eng) as w:
                for _ in range(steps):
                    eng.step()
                eng.drain()
                torch.cuda.synchronize()
            res.append((steps, time.perf_counter() - t0, w))
            if i == 0 and eng.prefill_calls != 1:
                raise AssertionError("the first step made no prefill call")
        if eng.prefill_calls != 2 or eng.decode_calls != 2 + n:
            raise AssertionError(f"calls {eng.prefill_calls} prefill, "
                                 f"{eng.decode_calls} decode")
        return res

    @contextlib.contextmanager
    def nothing(eng):
        yield None

    def profiled(eng):
        return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    report = {"arch": bundle.cfg.arch_id, "layers": bundle.cfg.n_layers,
              "device": torch.cuda.get_device_name(0),
              "kv_dtype": args.kv_dtype, "prompts": list(PROMPTS),
              "engine_steps": n}
    for depth in args.pipeline_depth:
        timed = windows(depth, nothing)
        profs = windows(depth, profiled)
        syncs = windows(depth, count_syncs)
        rep = {}
        for name, (steps, wall, _), (_, _, prof), (_, _, cnt) in zip(
                ("first_step", "decode_steps"), timed, profs, syncs):
            prof.export_chrome_trace(str(out / f"trace_engine_d{depth}_"
                                               f"{name}.json"))
            busy = _busy_us(prof) / 1e6
            rep[name] = {
                "steps": steps, "wall_ms_per_step": 1e3 * wall / steps,
                "device_busy_ms_per_step": 1e3 * busy / steps,
                "device_idle_share": 1.0 - busy / wall,
                "syncs_per_step_outside_drain_points": cnt["outside"] / steps,
                "syncs_per_step_all": cnt["all"] / steps,
                "sync_sites": cnt["where"],
            }
        report[f"depth_{depth}"] = rep
    return report


def _profile_verify(args, bundle, params, pool, table, pos, token, out):
    """``--decode-calls`` verify calls (after a warm-up) from where the
    decode calls left the pool: every row active at all K + 1 sub-steps,
    its drafts the model's previous token repeated; each call advances
    the rows by their accepted counts, on the device."""
    import torch

    from repro_torch.runtime.engine import _argmax, paged_verify_step

    k = args.speculate
    active = torch.ones((pos.shape[0], k + 1), dtype=torch.bool,
                        device=pos.device)
    state = {"pos": pos, "token": token, "accepted": []}

    def call_verify():
        tokens = state["token"][:, None].expand(-1, k + 1).contiguous()
        nxt, _, m, _ = paged_verify_step(
            bundle.paged_serve_step, params, tokens, state["pos"], active,
            pool, table, page_size=PAGE, choose=lambda lg, i: _argmax(lg))
        state["pos"] = state["pos"] + m
        state["token"] = nxt
        state["accepted"].append(m)

    call_verify()                                    # warm-up
    kv = [int(x) + 1 for x in state["pos"].tolist()]
    state["accepted"].clear()
    rep = _profile(call_verify, args.decode_calls, out / "trace_verify.json")
    rep["k"] = k
    rep["sub_steps_per_call"] = k + 1
    rep["kv_len_at_first_call"] = kv
    rep["tokens_accepted_per_call"] = (
        torch.stack(state["accepted"]).sum().item() / len(state["accepted"]))
    return rep


def _profile_token_by_token(args, bundle, params, rng, dev, out: Path) -> dict:
    """A family served token by token (``TOKEN_BY_TOKEN``): its prompts
    through ``serve_step`` into its cache, then ``--decode-calls`` decode
    calls under the profiler (after one warm-up call).  For the audio
    family first one ``whisper_encode`` call (profiled after a warm-up),
    whose output fills the cache's ``enc_out``; the vlm family's steps
    take image inputs drawn N(0, 1)."""
    import numpy as np
    import torch

    cfg = bundle.cfg
    batch, prompt, max_len = TOKEN_BY_TOKEN[cfg.family]
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, prompt)).astype(np.int32)).to(dev)
    cache = bundle.init_cache(batch, max_len, device=dev)
    report = {"arch": cfg.arch_id, "layers": cfg.n_layers,
              "device": torch.cuda.get_device_name(0)}
    name = "whisper" if cfg.family == "audio" else cfg.family
    extras = {}
    if cfg.family == "vlm":
        extras["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.n_image_tokens, cfg.vision_dim)).astype(np.float32)
        ).to(dev, torch.bfloat16)
    if cfg.family == "audio":
        from repro_torch.models.multimodal import whisper_encode

        frames = torch.from_numpy(rng.standard_normal(
            (batch, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)).to(dev)
        call_encode = lambda: whisper_encode(params, cfg, frames)
        call_encode()                                # warm-up
        report["encoder_layers"] = cfg.n_encoder_layers
        report["whisper_encode"] = _profile(call_encode, 1,
                                            out / "trace_whisper_encode.json")
        cache["enc_out"].copy_(call_encode())
    pos = torch.zeros(batch, dtype=torch.int32, device=dev)
    for i in range(prompt):
        logits, cache = bundle.serve_step(params, prompts[:, i], pos, cache,
                                          **extras)
        pos = pos + 1
    token = torch.argmax(logits, -1).to(torch.int32)

    def call_decode():
        nonlocal pos, token
        logits, _ = bundle.serve_step(params, token, pos, cache, **extras)
        token = torch.argmax(logits, -1).to(torch.int32)
        pos = pos + 1

    call_decode()                                    # warm-up
    if int(pos[0]) + args.decode_calls > max_len:
        raise ValueError(f"--decode-calls {args.decode_calls} overruns the "
                         f"{max_len}-row cache")
    kv = int(pos[0]) + 1
    report[f"{name}_decode"] = _profile(call_decode, args.decode_calls,
                                        out / f"trace_{name}_decode.json")
    report[f"{name}_decode"]["kv_len_at_first_call"] = [kv] * batch
    return report



@contextlib.contextmanager
def _train_windows(marks: dict):
    """``KernelAttention.backward`` and the trainer's ``adamw_update``
    run inside ``torch.profiler.record_function`` ranges named after
    TRAIN_WINDOWS, and between two CUDA events each, appended to
    ``marks[label]``."""
    import torch

    from repro_torch.kernels.train_attention import KernelAttention
    from repro_torch.launch import steps

    def wrap(fn, label):
        def run(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            with torch.profiler.record_function(label):
                out = fn(*a, **kw)
            end.record()
            marks.setdefault(label, []).append((start, end))
            return out
        return run

    backward, update = KernelAttention.backward, steps.adamw_update
    KernelAttention.backward = staticmethod(
        wrap(backward, "plain_attention_backward"))
    steps.adamw_update = wrap(update, "adamw_update")
    try:
        yield
    finally:
        KernelAttention.backward = staticmethod(backward)
        steps.adamw_update = update


def _profile_train(args, cfg, dev, out: Path) -> dict:
    """One train step at the smoke's phase 15 shape (see the module
    docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import DataPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models.model_zoo import build

    layers = args.layers or TRAIN_LAYERS
    cfg = dataclasses.replace(cfg, n_layers=layers)
    bundle = build(cfg)
    state = steps.init_train_state(
        bundle, torch.Generator(device=dev).manual_seed(args.seed), dev)
    out.mkdir(parents=True, exist_ok=True)
    pipe = DataPipeline(batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                        vocab=cfg.vocab_size, seed=args.seed)
    step = steps.make_train_step(bundle, steps.TrainHyper(
        peak_lr=3e-4, warmup_steps=2, total_steps=8))
    for _ in range(2):                                # warm-up
        state, m = step(state, next(pipe))
    float(m["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    marks = {}
    with _train_windows(marks):
        t0 = time.perf_counter()
        state, m = step(state, next(pipe))
        loss = float(m["loss"])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    launches = {w.__name__: w.launches for w in ops.WRAPPERS}
    with _train_windows({}), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, m = step(state, next(pipe))
        float(m["loss"])
        torch.cuda.synchronize()
    pipe.close()
    trace = out / "trace_train_step.json"
    prof.export_chrome_trace(str(trace))
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    windows = {label: [] for label in TRAIN_WINDOWS}
    kernels = []
    for e in events:
        if e.name in windows:
            windows[e.name].append((e.time_range.start, e.time_range.end))
        else:
            kernels.append(e)
    by_cat = {}
    for e in kernels:
        cat = next((label for label, spans in windows.items()
                    if any(s <= e.time_range.start < t for s, t in spans)),
                   None)
        if cat is None:
            cat = _category(e.name)
            if cat in ("shift_kv", "pasa_attention"):
                cat = "pasa_kernels"
        by_cat[cat] = by_cat.get(cat, 0.0) + e.time_range.elapsed_us()
    busy = _busy_us_of(kernels)
    return {
        "arch": cfg.arch_id, "layers": layers, "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "remat": cfg.remat,
        "device": torch.cuda.get_device_name(0), "loss": loss,
        "wall_ms": wall_us / 1e3,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "device_ms": {k: v / 1e3 for k, v in sorted(by_cat.items())},
        "window_event_ms": {label: sum(a.elapsed_time(b) for a, b in ms)
                            for label, ms in marks.items()},
        "annotated_windows": {k: len(v) for k, v in windows.items()},
        "launches": launches,
        "trace": str(trace),
    }


if __name__ == "__main__":
    main()
