"""End-to-end serving CLI of the PyTorch port: seeded requests through
one engine on one device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --variant reduced --device cpu --requests 8 --max-new 12

The device is CUDA unless ``--device cpu`` is given; without a CUDA
device the CLI exits with an error instead of running on the CPU.
Weights are made from ``--seed``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.configs import ARCHS, get_arch
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.model import build
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request
from repro_torch.serving.sampler import Sampler


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="llama3.2-1b")
    ap.add_argument("--variant", default="reduced")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="prompt lengths are drawn from "
                         "[prompt_len // 2, prompt_len]")
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--prefill-chunk", type=int, default=-1,
                    help="prompt tokens of one admitting request fused "
                         "into each step (0 = the whole prompt in one "
                         "chunk, -1 keeps cfg.prefill_chunk)")
    ap.add_argument("--sync-every", type=int, default=8,
                    help="decode steps between host polls")
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default="",
                    help="optional path to dump latency stats as JSON")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions "
                         "of the kernels)")
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"error: {err}")
    cfg = get_arch(args.arch, variant=args.variant)
    model = build(cfg, device)
    params = model.init(args.seed)
    engine = Engine(model, params, max_batch=args.max_batch,
                    cache_len=args.cache_len,
                    sampler=Sampler(temperature=args.temperature, top_k=32),
                    seed=args.seed, sync_every=args.sync_every,
                    prefill_chunk=None if args.prefill_chunk < 0
                    else args.prefill_chunk)

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for uid in range(args.requests):
        L = int(rng.integers(max(2, args.prompt_len // 2),
                             args.prompt_len + 1))
        engine.submit(Request(uid=uid, prompt=rng.integers(0, cfg.vocab, L),
                              max_new_tokens=args.max_new))
    responses = engine.run()
    wall = time.perf_counter() - t0
    stats = engine.latency_stats()
    print(f"arch={cfg.name} device={device} requests={args.requests} "
          f"batch={args.max_batch}")
    print(f"finished={stats['n_finished']} "
          f"tokens={stats['tokens_generated']} wall={wall:.2f}s "
          f"({stats['tokens_generated'] / wall:,.1f} tok/s)")
    # latency keys are absent when a stream has no samples: print NaN
    g = lambda k: stats.get(k, float("nan"))  # noqa: E731
    print(f"decode ms/step: mean={g('decode_ms_mean'):.2f} "
          f"p50={g('decode_ms_p50'):.2f} p99={g('decode_ms_p99'):.2f}")
    print(f"ttft ms: mean={g('ttft_ms_mean'):.1f} "
          f"p50={g('ttft_ms_p50'):.1f} p95={g('ttft_ms_p95'):.1f} "
          f"p99={g('ttft_ms_p99'):.1f}")
    print(f"itl ms: mean={g('itl_ms_mean'):.2f} "
          f"p50={g('itl_ms_p50'):.2f} p95={g('itl_ms_p95'):.2f} "
          f"p99={g('itl_ms_p99'):.2f}")
    n_ok = sum(1 for r in responses.values() if r.ok)
    print(f"ok={n_ok}/{len(responses)} chunk={stats['prefill_chunk']} "
          f"chunked admissions={stats['chunked_admissions']}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"arch": cfg.name, "device": str(device),
                       "wall_s": wall, **stats}, f, indent=2)
    return responses, stats


if __name__ == "__main__":
    main()
