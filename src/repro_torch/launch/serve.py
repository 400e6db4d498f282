"""Serving entry point: random weights, random prompts, greedy decode.

Counterpart of ``repro.launch.serve``: builds the model, draws its
weights on the device from ``--seed`` and ``--batch`` prompts of
``--prompt-len`` tokens from ``np.random.default_rng(seed)`` (as the
reference does), then serves them on one of two routes:

  * dense (the default, as in the reference): one ``(L, B, max_len,
    kv_dim)`` cache; the whole prompt in ONE fused prefill call
    (``bundle.prefill``), then ``gen - 1`` greedy decode steps
    (``launch.steps.make_serve_step``).  A family without a fused prefill
    (``bundle.prefill is None``: the hybrid zamba2, the vlm
    llama-3.2-vision, the ssm falcon-mamba, the audio whisper) takes the
    family-generic token-by-token route instead: every prompt token is
    fed through the decode step, ``prompt_len + gen - 1`` steps, TTFT at
    the first sampled token.  The vlm is served from zero
    ``vision_embeds`` (B, 1601, 1280) in bf16, as the reference's CLI
    serves it;
  * paged (``--paged``): :class:`repro_torch.runtime.ServeEngine` -
    chunked prefill (default) or token by token (``--no-chunked-prefill``),
    with the radix prefix cache (``--prefix-cache``), preemption
    (``--preemption``, ``--preempt-patience``), a scheduling policy
    (``--scheduler fcfs|sjf|mixed|tenant``, with ``--tenant-quotas``
    for the tenant policy; every request is the default tenant's, as in
    the reference's CLI), a per-step token budget
    (``--step-token-budget``), sampling (``--temperature``, ``--top-k``,
    ``--sample-seed``; 0 = greedy) and self-speculative decoding
    (``--speculate K``, ``--draft ngram``), the last two on this route
    only, as in the reference; async pipelining (``--async``: one step in
    flight, streams equal to ``--sync``), streaming (``--stream`` prints
    each token as it is read back; ``--disconnect-after N`` cancels
    request 0 after N tokens, between steps) and telemetry (``--trace
    FILE`` with ``--trace-format chrome|jsonl``, ``--metrics``,
    ``--numerics-probe N``; bit-neutral).  ``--mesh DxM`` (default
    ``1x1``) serves D engine replicas fed from one queue
    (:class:`repro_torch.runtime.EngineReplicaGroup`, ``--routing
    affinity|least|rr``), each pool kv-head-sharded over M ranks of the
    model axis; M > 1 runs one process per rank, started with ``torchrun
    --standalone --nproc-per-node M`` (a gloo group; without it the CLI
    raises); the streams equal the ``1x1`` serve's.  A family without a
    paged interface (zamba2, llama-3.2-vision, falcon-mamba, whisper)
    refuses it with the engine's ValueError.

Runs on the GPU by default (``--device cpu`` for the plain PyTorch path).

Examples (one H100, full-width qwen2-7b, random weights):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
      --batch 4 --prompt-len 1000 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
      --paged --batch 4 --prompt-len 512 --gen 32 --prefill-chunk 512
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
      --paged --kv-dtype int8 --batch 4 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
      --batch 4 --prompt-len 200 --gen 32 --max-len 240
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
      --batch 4 --prompt-len 64 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
      --paged --batch 4 --prompt-len 512 --gen 32 --prefill-chunk 512
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
      --paged --mesh 2x1 --routing affinity --prefix-cache --batch 4 \
      --prompt-len 512 --gen 32 --prefill-chunk 512
(llama-3.2-vision-90b at its 100 layers does not fit one card: serve it
at --reduced, or profile it with ``launch.profile_steps --layers 20``.)
CPU smoke at the reduced config:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
      --reduced --batch 4 --prompt-len 16 --gen 8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
      --reduced --batch 2 --prompt-len 12 --gen 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch llama-3.2-vision-90b --reduced --batch 2 --prompt-len 12 \
      --gen 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
      --reduced --batch 2 --prompt-len 12 --gen 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
      --reduced --batch 2 --prompt-len 12 --gen 4 --device cpu  # + --paged
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
      --reduced --paged --page-size 8 --batch 2 --prompt-len 40 --gen 8 \
      --num-pages 9 --prefix-cache --preemption --preempt-patience 1 \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
      --reduced --paged --batch 4 --prompt-len 16 --gen 8 --speculate 3 \
      --temperature 0.8 --top-k 8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
      --reduced --paged --page-size 8 --batch 4 --prompt-len 40 --gen 8 \
      --scheduler tenant --tenant-quotas 'default=12:16' --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
      --reduced --paged --page-size 8 --batch 4 --prompt-len 40 --gen 12 \
      --prefix-cache --async --stream --disconnect-after 4 \
      --trace /tmp/t.json --metrics --numerics-probe 4 --device cpu
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
      -m repro_torch.launch.serve --arch qwen2-7b --reduced --paged \
      --page-size 8 --batch 4 --prompt-len 40 --gen 8 --mesh 1x2 \
      --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time


def parse_tenant_quotas(spec):
    """Parse a ``--tenant-quotas`` spec into ``{tenant: TenantQuota}``:
    comma-separated ``tenant=max_pages[:max_step_tokens]`` entries, an
    empty field meaning unlimited, e.g. ``bulk=8:32,interactive=16,
    best-effort=:64``."""
    from repro_torch.runtime import TenantQuota

    quotas = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, sep, body = entry.partition("=")
        name = name.strip()
        if not sep or not name:
            raise ValueError(
                f"bad --tenant-quotas entry {entry!r}: expected "
                "tenant=max_pages[:max_step_tokens]"
            )
        pages_s, _, toks_s = body.partition(":")
        try:
            max_pages = int(pages_s) if pages_s.strip() else None
            max_toks = int(toks_s) if toks_s.strip() else None
        except ValueError:
            raise ValueError(
                f"bad --tenant-quotas entry {entry!r}: fields must be ints"
            ) from None
        quotas[name] = TenantQuota(max_pages=max_pages,
                                   max_step_tokens=max_toks)
    return quotas


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="the tiny same-family config of the CPU tests")
    ap.add_argument("--paged", action="store_true",
                    help="serve through the paged-KV engine (default: the "
                         "dense-cache route)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=None,
                    help="dense route: cache length (default: prompt-len "
                         "+ gen + 8)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--page-size", type=int, default=None,
                    help="tokens per KV page (default: the PASA block "
                         "length); decode shifts in blocks of the config's "
                         "block_kv whatever the page size")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="physical pages in the pool (default: sized to "
                         "fit the requested batch exactly)")
    ap.add_argument("--chunked-prefill", dest="chunked_prefill",
                    action="store_true", default=True,
                    help="paged route: prefill prompts in chunks through "
                         "the paged prefill call (default)")
    ap.add_argument("--no-chunked-prefill", dest="chunked_prefill",
                    action="store_false",
                    help="paged route: consume prompts token by token "
                         "through the decode call")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="per-row chunk width of the batched prefill call; "
                         "a multiple of the page size (default: 8 pages)")
    ap.add_argument("--scheduler", default="fcfs",
                    choices=("fcfs", "sjf", "mixed", "tenant"),
                    help="paged route: scheduling policy - fcfs (arrival "
                         "order, head-of-line blocking; default), sjf "
                         "(shortest-job-first, aging guard), mixed "
                         "(fair-share token-budget mixing), tenant "
                         "(per-tenant quotas and latency / throughput "
                         "classes; see --tenant-quotas); outputs are "
                         "identical across policies")
    ap.add_argument("--tenant-quotas", default=None, metavar="SPEC",
                    help="per-tenant quotas for --scheduler tenant: "
                         "comma-separated tenant=max_pages[:max_step_"
                         "tokens] entries, e.g. 'bulk=8:32,interactive=16'"
                         " (empty field = unlimited)")
    ap.add_argument("--prefill-batch", type=int, default=None,
                    help="still-prefilling requests per prefill call "
                         "(default: --batch)")
    ap.add_argument("--step-token-budget", type=int, default=None,
                    help="paged route: per-step token budget split between "
                         "decode rows (1 each) and prefill chunk tokens "
                         "(default: unlimited)")
    ap.add_argument("--preemption", action="store_true",
                    help="paged route: let a page-starved admission page a "
                         "running request out to the prefix cache (its "
                         "resumed stream equals an uninterrupted serve)")
    ap.add_argument("--preempt-patience", type=int, default=4,
                    help="consecutive page-starved steps before a "
                         "preemption may trigger")
    ap.add_argument("--prefix-cache", dest="prefix_cache",
                    action="store_true", default=False,
                    help="paged route: share identical prompt-prefix KV "
                         "pages across requests (radix cache; needs "
                         "chunked prefill)")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false",
                    help="no prompt-prefix page sharing (default)")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="paged route: self-speculative decoding - propose "
                         "up to K draft tokens per decoding row from a "
                         "host-side prompt-lookup drafter and verify them "
                         "in ONE widened device step; greedy accept keeps "
                         "the longest prefix matching argmax, so streams "
                         "AND page bytes are bit-identical to K=0. "
                         "Requires chunked prefill (0 = off)")
    ap.add_argument("--draft", default="ngram", choices=("ngram",),
                    help="--speculate draft proposer: ngram = longest-"
                         "suffix prompt/output lookup (no second model)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="paged route: sampling temperature (0 = greedy "
                         "argmax, bit-exact default)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="paged route: top-k truncation for sampling "
                         "(0 = full distribution; needs --temperature > 0 "
                         "to matter)")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="base seed for per-request sampling keys")
    ap.add_argument("--kv-dtype", default="bf16",
                    choices=("bf16", "fp8_e4m3", "int8"),
                    help="paged route: KV page pool storage dtype; "
                         "fp8_e4m3/int8 store shift-centered 8-bit codes "
                         "with per-page scale/shift sidecars")
    ap.add_argument("--kv-quant-scale", default="absmax",
                    choices=("absmax", "quantile"),
                    help="quantized pools: the page scale statistic, absmax "
                         "(exact range, the default) or quantile (clipped "
                         "absmax: finer bulk resolution, worse attention "
                         "on outlier-heavy pages)")
    ap.add_argument("--async", dest="pipelined", action="store_true",
                    default=False,
                    help="paged route: async pipelined serving "
                         "(pipeline_depth=1) - the host plans step N+1 "
                         "while step N runs; streams stay bit-identical "
                         "to --sync")
    ap.add_argument("--sync", dest="pipelined", action="store_false",
                    help="paged route: synchronous stepping (default)")
    ap.add_argument("--stream", action="store_true",
                    help="paged route: print each token as it is read "
                         "back (the on_token callback)")
    ap.add_argument("--disconnect-after", type=int, default=0,
                    help="paged route: request 0's client disconnects "
                         "after N tokens - the serve loop cancels it between "
                         "steps (pages freed, prompt pages donated to the "
                         "prefix cache)")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="paged route: write the step trace (plan / "
                         "dispatch / retire spans and request lifecycle "
                         "events) to FILE - Chrome trace_event JSON for "
                         "Perfetto, or JSON lines with --trace-format "
                         "jsonl; bit-neutral")
    ap.add_argument("--trace-format", default="chrome",
                    choices=("chrome", "jsonl"),
                    help="--trace file format (default: chrome)")
    ap.add_argument("--metrics", action="store_true",
                    help="paged route: collect the metrics registry and "
                         "print its JSON snapshot after the serve")
    ap.add_argument("--numerics-probe", type=int, default=0, metavar="N",
                    help="paged route: sample the numerics probe every N "
                         "engine steps (0 = off) - score amplitude against "
                         "the fp16 ceiling, per-page PASA shift magnitude, "
                         "K resonance on live pages, read at drain points")
    ap.add_argument("--mesh", default="1x1",
                    help="paged route: DxM - D engine replicas fed from one "
                         "queue, each pool kv-head-sharded over M ranks of "
                         "the model axis (M > 1: start with torchrun "
                         "--standalone --nproc-per-node M); streams equal "
                         "the 1x1 serve's")
    ap.add_argument("--routing", default="affinity",
                    choices=("affinity", "least", "rr"),
                    help="replica routing with D > 1: affinity (the "
                         "replica holding the longest cached prompt prefix, "
                         "least-loaded among ties; default), least "
                         "(least-loaded, round-robin tiebreak), rr (strict "
                         "rotation); never changes a stream")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def make_cli_mesh(spec: str, device):
    """The ``--mesh DxM`` mesh.  M > 1 needs the process group of a
    ``torchrun`` launch of M processes, joined here (gloo: it takes two
    ranks on one card) when the launcher's environment names one."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh, refuse_production_mesh

    if spec == "prod":
        refuse_production_mesh(spec)
    try:
        d, m = (int(x) for x in spec.split("x"))
    except ValueError:
        raise ValueError(f"--mesh must be DxM, got {spec!r}") from None
    if m > 1 and not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "1")) != m:
            raise RuntimeError(
                f"--mesh {spec}: a model axis of {m} runs one process per "
                f"rank; start the CLI with torchrun --standalone "
                f"--nproc-per-node {m}")
        dist.init_process_group("gloo")
    return make_mesh((d, m), ("data", "model"),
                     devices=None if device.type == "cuda" else device)


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.kv_dtype != "bf16" and not args.paged:
        ap.error("--kv-dtype applies to the paged route (--paged)")

    import numpy as np
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build

    dev = resolve_device(args.device)
    if args.mesh != "1x1" and not args.paged:
        ap.error("--mesh applies to the paged route (--paged)")
    mesh = make_cli_mesh(args.mesh, dev) if args.paged else None
    if mesh is not None:
        # this rank's first cell: the replicas of its other cells copy
        # the weights only onto a device that does not hold them
        dev = mesh.devices.reshape(-1, mesh.shape["model"])[
            0, mesh.axis_rank("model")]
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.kv_quant_scale != cfg.attention.kv_quant_scale:
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, kv_quant_scale=args.kv_quant_scale))
    bundle = build(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = bundle.init(gen, dev)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32
    )
    if args.paged:
        return _serve_paged(args, bundle, params, prompts, dev, mesh)
    return _serve_dense(args, bundle, params, prompts, dev)


def cache_bytes(cache) -> int:
    """Bytes of every tensor of a (nested) cache dict."""
    if isinstance(cache, dict):
        return sum(cache_bytes(x) for x in cache.values())
    return cache.numel() * cache.element_size()


def serve_extras(cfg, batch: int, device) -> dict:
    """The extra inputs of a family's decode step as the CLI serves them:
    the vlm's ``vision_embeds``, zeros (B, n_image_tokens, vision_dim) in
    bf16 (the reference's CLI); nothing for the other families."""
    import torch

    if cfg.family != "vlm":
        return {}
    return {"vision_embeds": torch.zeros(
        (batch, cfg.n_image_tokens, cfg.vision_dim), dtype=torch.bfloat16,
        device=device)}


def token_by_token(bundle, params, prompts, gen: int, cache, *, step=None,
                   **extras):
    """The family-generic token-by-token route on the dense cache: every
    token of ``prompts`` (B, S), on the device, through the decode step
    (with ``extras``, e.g. the vlm's ``vision_embeds``), then ``gen``
    greedy tokens - ``S + gen - 1`` steps, a step that samples ending in
    its token's readback.  Returns (generated (B, gen) int32 numpy,
    cache, the ``time.perf_counter()`` at each readback)."""
    import torch

    from repro_torch.launch.steps import make_serve_step

    step = step or make_serve_step(bundle)
    b, s = prompts.shape
    tok = prompts[:, 0]
    out, times = [], []
    for i in range(s + gen - 1):
        pos = torch.full((b,), i, dtype=torch.int32, device=prompts.device)
        nxt, _, cache = step(params, tok, pos, cache, **extras)
        if i + 1 < s:
            tok = prompts[:, i + 1]
        else:
            out.append(nxt.cpu())
            times.append(time.perf_counter())
            tok = nxt
    return torch.stack(out, dim=1).numpy(), cache, times


def _serve_dense(args, bundle, params, prompts, dev):
    """Fused prefill, then ``gen - 1`` decode steps on the dense cache; or,
    for a family without a fused prefill, every prompt token through the
    decode step (``prompt_len + gen - 1`` steps)."""
    import torch

    from repro_torch.launch.steps import make_serve_step

    max_len = args.max_len or (args.prompt_len + args.gen + 8)
    cache = bundle.init_cache(args.batch, max_len, device=dev)
    step = make_serve_step(bundle)
    prompt_t = torch.from_numpy(prompts).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    if bundle.prefill is not None:
        route = "dense"
        logits, cache = bundle.prefill(params, prompt_t, cache)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        generated = [tok.cpu()]              # the readback ends the call
        t_first = time.perf_counter() - t0
        for i in range(args.prompt_len, args.prompt_len + args.gen - 1):
            pos = torch.full((args.batch,), i, dtype=torch.int32, device=dev)
            tok, _, cache = step(params, tok, pos, cache)
            generated.append(tok.cpu())
        out = torch.stack(generated, dim=1).numpy()
        n_steps = args.gen
    else:
        route = "dense/token-by-token"
        out, cache, times = token_by_token(
            bundle, params, prompt_t, args.gen, cache, step=step,
            **serve_extras(bundle.cfg, args.batch, dev))
        t_first = times[0] - t0
        n_steps = args.prompt_len + args.gen - 1
    dt = time.perf_counter() - t0
    print(f"[{route}] {dev} generated {out.shape} tokens in {dt:.3f}s "
          f"({1000 * dt / max(n_steps, 1):.1f} ms/step over {n_steps} steps, "
          f"{out.size / max(dt, 1e-9):.1f} tok/s wall-clock incl. first-call "
          f"set-up), cache {max_len} rows {cache_bytes(cache) / 1e6:.2f} MB, "
          f"TTFT {1000 * t_first:.1f} ms")
    print("sample:", out[0][:16])
    return out


def _serve_paged(args, bundle, params, prompts, dev, mesh):
    """The same workload through the paged-KV engine, or through a replica
    group over ``mesh`` when it is larger than 1x1 (every rank of the
    model axis serves; rank 0 prints)."""
    import numpy as np

    from repro_torch.runtime import EngineReplicaGroup, ServeEngine, Telemetry

    n_data, n_model = mesh.shape["data"], mesh.shape["model"]
    # the page size goes to the engine alone: decode shifts in blocks of
    # the config's block_kv, prefill in one block a page, as the
    # reference's CLI serves them
    page_size = (args.page_size if args.page_size is not None
                 else bundle.cfg.attention.block_kv)
    if page_size < 1:
        raise ValueError(f"--page-size must be >= 1, got {page_size}")
    total = args.prompt_len + args.gen
    batch_per = math.ceil(args.batch / n_data)
    num_pages = args.num_pages or math.ceil(total / page_size) * batch_per + 1
    scheduler = args.scheduler
    if args.tenant_quotas is not None:
        if args.scheduler != "tenant":
            raise ValueError("--tenant-quotas requires --scheduler tenant")
        from repro_torch.runtime import TenantQuotaPolicy

        scheduler = TenantQuotaPolicy(
            parse_tenant_quotas(args.tenant_quotas),
            patience=max(args.preempt_patience, 1),
        )
    # telemetry: one per serve, its layers switched by the flags
    telemetry = None
    if args.trace or args.metrics or args.numerics_probe:
        telemetry = Telemetry(tracing=args.trace is not None,
                              metrics=args.metrics,
                              numerics_every=args.numerics_probe)
    # streaming: tokens arrive through on_token as they are read back (one
    # step behind dispatch with --async).  The callback only flags request
    # 0's disconnect; the serve loop cancels between steps, never inside a
    # retirement.
    hangup = []
    on_token = None
    if args.stream or args.disconnect_after:
        def on_token(r, idx, tok):
            if args.stream and not quiet:
                print(f"[stream] req {r.req_id} #{idx}: {tok}")
            if (args.disconnect_after and r.req_id == 0
                    and idx + 1 >= args.disconnect_after and not hangup):
                hangup.append(0)
    kw = dict(
        max_batch=batch_per, num_pages=num_pages,
        page_size=page_size, max_seq_len=total,
        chunked_prefill=args.chunked_prefill,
        prefill_chunk=args.prefill_chunk, prefix_cache=args.prefix_cache,
        cache_dtype=args.kv_dtype, scheduler=scheduler,
        prefill_batch=args.prefill_batch,
        step_token_budget=args.step_token_budget,
        preemption=args.preemption, preempt_patience=args.preempt_patience,
        temperature=args.temperature, top_k=args.top_k,
        sample_seed=args.sample_seed, speculate=args.speculate,
        draft=args.draft, pipeline_depth=1 if args.pipelined else 0,
        on_token=on_token,
    )
    if n_data > 1 or n_model > 1:
        eng = EngineReplicaGroup(bundle, params, mesh, routing=args.routing,
                                 telemetry=telemetry, **kw)
        placement = f"{n_data} replicas x model {n_model}"
    else:
        eng = ServeEngine(bundle, params, telemetry=telemetry, **kw)
        placement = "1 device"
    quiet = mesh.axis_rank("model") > 0
    reqs = [eng.submit(list(p), args.gen) for p in prompts]
    t0 = time.perf_counter()
    if on_token is not None:
        cancelled = set()
        while not eng.idle:
            eng.step()
            while hangup:
                rid = hangup.pop()
                if rid not in cancelled and eng.cancel(rid):
                    cancelled.add(rid)
                    if not quiet:
                        print(f"[stream] req {rid} client disconnected -> "
                              "cancelled (pages reclaimed)")
        eng.drain()       # the stream's boundary: the last tokens
    else:
        eng.run_to_completion()
    dt = time.perf_counter() - t0
    st = eng.stats()
    # a cancelled request's stream is short: its row is right-padded with
    # -1, one row per submitted request
    out = np.asarray([list(r.generated) + [-1] * (args.gen - len(r.generated))
                      for r in reqs], np.int32)
    n_tokens = int(sum(len(r.generated) for r in reqs))
    # from submission, so queueing counts; a resumed request keeps the
    # step of its first emission; a request cancelled before its first
    # token has none
    ttft = [r.first_token_step - r.submit_step + 1 for r in reqs
            if r.first_token_step >= 0]
    mode = "chunked" if args.chunked_prefill else "token-by-token"
    mode += "/async" if args.pipelined else "/sync"
    if quiet:
        return out
    print(f"[paged/{mode}/{st['scheduler']}] {dev} generated "
          f"{out.shape} tokens in {dt:.3f}s "
          f"({1000 * dt / max(st['steps'], 1):.1f} ms/step, "
          f"{n_tokens / max(dt, 1e-9):.1f} tok/s wall-clock incl. first-call "
          f"set-up), {st['prefill_calls']} prefill + {st['decode_calls']} "
          f"decode + {st['verify_calls']} verify calls, pool "
          f"{st['cache_bytes'] / 1e6:.2f} MB {st['pool_dtype']} "
          f"({st['cache_bytes_per_device'] / 1e6:.2f} MB a device; "
          f"{placement}; {num_pages} pages of {page_size} a replica), TTFT "
          f"{np.mean(ttft):.1f} engine steps, {st['preemptions']} "
          f"preemptions, {st['cancellations']} cancellations")
    if args.speculate:
        sp = st["spec"]
        print(f"[speculate k={args.speculate}/{args.draft}] "
              f"{sp['proposed']} drafts proposed, {sp['accepted']} accepted "
              f"({sp['accepted'] / max(sp['proposed'], 1):.2f} accept rate), "
              f"{sp['verify_steps']} verify steps, "
              f"{sp['rollbacks']} rollbacks; "
              f"{st['steps'] / max(n_tokens, 1):.2f} engine steps/token")
    if st["prefix_cache"] is not None:
        pc = st["prefix_cache"]
        print(f"[prefix-cache] {pc['cached_pages']} pages cached, "
              f"{pc['hits']} page hits / {pc['misses']} misses, "
              f"{pc['evictions']} evictions, {pc['donations']} donations")
    if telemetry is not None:
        _report_telemetry(args, telemetry)
    print("sample:", out[0][:16])
    return out


def _report_telemetry(args, telemetry):
    """Write the trace file and print the metrics snapshot and the
    probe's last reading, as the flags ask."""
    import json

    if args.trace:
        if args.trace_format == "jsonl":
            n = telemetry.tracer.write_jsonl(args.trace)
        else:
            n = telemetry.tracer.write_chrome_trace(args.trace)
        print(f"[trace] {n} events -> {args.trace} ({args.trace_format}; "
              f"{telemetry.tracer.dropped} dropped by the ring)")
    if args.metrics:
        print("[metrics]", json.dumps(telemetry.metrics_snapshot(), indent=2,
                                      sort_keys=True))
    # a replica group's probes live in its per-replica children
    probes = [telemetry.probe] + [c.probe for c in telemetry._children]
    last = next((p.last for p in probes if p is not None and p.last), None)
    if last is not None:
        print(f"[numerics] fp16_margin={last['fp16_margin']:.1f} "
              f"score_amp_max={last['score_amp_max']:.1f} "
              f"shift_mag_max={last['shift_mag_max']:.3f} "
              f"resonance_max={last['resonance_max']:.3f} "
              f"({last['pages_sampled']} pages sampled)")


if __name__ == "__main__":
    main()
