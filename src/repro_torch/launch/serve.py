"""Paged serving entry point: random weights, random prompts, greedy decode.

Counterpart of the ``--paged`` route of ``repro.launch.serve``: builds the
model, draws its weights on the device from ``--seed``, draws
``--batch`` prompts of ``--prompt-len`` tokens from
``np.random.default_rng(seed)`` (as the reference does) and serves them
through :class:`repro_torch.runtime.ServeEngine`.  Runs on the GPU by
default (``--device cpu`` for the plain PyTorch path).

Example (one H100, full-width qwen2-7b, random weights):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
      --paged --batch 4 --prompt-len 512 --gen 32 --prefill-chunk 512
CPU smoke at the reduced config:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
      --reduced --paged --batch 4 --prompt-len 16 --gen 8 --page-size 16 \
      --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="the tiny same-family config of the CPU tests")
    ap.add_argument("--paged", action="store_true", required=True,
                    help="serve through the paged-KV engine (the only "
                         "route ported so far)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--page-size", type=int, default=None,
                    help="tokens per KV page (default: the PASA block "
                         "length; the CUDA decode kernel requires it)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="physical pages in the pool (default: sized to "
                         "fit the requested batch exactly)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="per-row chunk width of the batched prefill call; "
                         "a multiple of the page size (default: 8 pages)")
    ap.add_argument("--prefill-batch", type=int, default=None,
                    help="still-prefilling requests per prefill call "
                         "(default: --batch)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build
    from repro_torch.runtime import ServeEngine

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    page_size = (
        args.page_size if args.page_size is not None
        else cfg.attention.block_kv
    )
    if page_size != cfg.attention.block_kv:
        cfg = dataclasses.replace(
            cfg, attention=dataclasses.replace(cfg.attention, block_kv=page_size)
        )
    bundle = build(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = bundle.init(gen, dev)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32
    )

    total = args.prompt_len + args.gen
    num_pages = args.num_pages or math.ceil(total / page_size) * args.batch + 1
    eng = ServeEngine(
        bundle, params, max_batch=args.batch, num_pages=num_pages,
        page_size=page_size, max_seq_len=total,
        prefill_chunk=args.prefill_chunk, prefill_batch=args.prefill_batch,
    )
    reqs = [eng.submit(list(p), args.gen) for p in prompts]
    t0 = time.perf_counter()
    eng.run_to_completion()
    dt = time.perf_counter() - t0
    st = eng.stats()
    out = np.asarray([r.generated for r in reqs], np.int32)
    ttft = [r.first_token_step - r.submit_step + 1 for r in reqs]
    print(f"[paged/{st['scheduler']}] {dev} generated {out.shape} tokens in "
          f"{dt:.3f}s ({1000 * dt / max(st['steps'], 1):.1f} ms/step, "
          f"{out.size / max(dt, 1e-9):.1f} tok/s wall-clock incl. first-call "
          f"set-up), {st['prefill_calls']} prefill + {st['decode_calls']} "
          f"decode calls, pool {st['cache_bytes'] / 1e6:.2f} MB "
          f"{st['pool_dtype']}, TTFT {np.mean(ttft):.1f} engine steps")
    print("sample:", out[0][:16])
    return out


if __name__ == "__main__":
    main()
