"""End-to-end serving CLI of the PyTorch port: seeded requests through
one engine on one device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --variant reduced --device cpu --requests 8 --max-new 12 \\
      [--paged --page-size 8] [--quant int8|int4] [--kv-cache-dtype int8] \\
      [--faults nan_logits@12/1,page_alloc@30x2] [--deadline 2.0] \\
      [--trace-out trace.json] [--trace-dir prof/] \\
      [--metrics-jsonl run.jsonl] [--log-every 1.0]

``--variant reduced+edge`` (or ``edge`` at full width) serves the edge
profile: int4 weights and an int8 KV cache. ``--arch mamba2-780m``
serves the attention-free SSM family (contiguous state only: no
``--paged``, and no quantization yet). The device is CUDA unless
``--device cpu`` is given; without a CUDA device the CLI exits with an
error instead of running on the CPU. Weights are made from ``--seed``
and quantized after they are made, as ``cfg.quant`` says.

``--faults`` injects a deterministic fault schedule
(``serving/faults.py``; '' defers to ``REPRO_FAULTS``), ``--deadline``
gives every request a deadline, ``--trace-out`` writes the request
lifecycle as a Chrome trace, ``--trace-dir`` a ``torch.profiler`` trace
of the first steps, and ``--metrics-jsonl`` / ``--log-every`` write and
print registry summaries while serving.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.configs import ARCHS, get_arch
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.model import build
from repro_torch.quant import quantize_for_cfg, quantized_stats
from repro_torch.serving.engine import Engine
from repro_torch.serving.faults import Faults
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
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: a page pool with per-slot block "
                         "tables instead of per-slot rings")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=0,
                    help="pool size in pages (0 = default sizing)")
    ap.add_argument("--quant", choices=["", "none", "int8", "int4"],
                    default="",
                    help="weight-only quantization of the served params: "
                         "int8/int4 override the config's cfg.quant, "
                         "'none' forces full precision even for quantized "
                         "variants (edge), '' keeps the config's setting")
    ap.add_argument("--kv-cache-dtype", choices=["", "int8"], default="",
                    help="int8 = quantized KV cache (edge memory profile)")
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default="",
                    help="optional path to dump latency stats as JSON")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions "
                         "of the kernels)")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome trace-event JSON of the run "
                         "(request-lifecycle spans; load in Perfetto)")
    ap.add_argument("--metrics-jsonl", default="",
                    help="append periodic registry snapshots as JSONL "
                         "(training/metrics.MetricsLogger format)")
    ap.add_argument("--trace-dir", default="",
                    help="write a torch.profiler Chrome trace of the "
                         "first engine steps into this directory")
    ap.add_argument("--log-every", type=float, default=0.0,
                    help="seconds between one-line progress summaries "
                         "while serving (0 = off)")
    ap.add_argument("--faults", default="",
                    help="deterministic fault schedule, e.g. "
                         "'nan_logits@12/1,page_alloc@30x2' (grammar: "
                         "site[@step][/slot][xN][+delay][%%prob]; see "
                         "repro_torch/serving/faults.py). '' defers to "
                         "the REPRO_FAULTS environment variable")
    ap.add_argument("--faults-seed", type=int, default=0,
                    help="seed for the --faults schedule's dice")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="per-request deadline in seconds (0 = none); "
                         "expired requests finish with reason 'timeout'")
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"error: {err}")
    cfg = get_arch(args.arch, variant=args.variant)
    if args.quant:
        cfg = cfg.replace(quant="" if args.quant == "none" else args.quant)
    model = build(cfg, device)
    params = quantize_for_cfg(model.init(args.seed), cfg)
    engine = Engine(model, params, max_batch=args.max_batch,
                    cache_len=args.cache_len,
                    sampler=Sampler(temperature=args.temperature, top_k=32),
                    seed=args.seed, sync_every=args.sync_every,
                    prefill_chunk=None if args.prefill_chunk < 0
                    else args.prefill_chunk,
                    paged=args.paged, page_size=args.page_size,
                    num_pages=args.num_pages or None,
                    kv_cache_dtype=args.kv_cache_dtype,
                    recorder=bool(args.trace_out), trace_dir=args.trace_dir,
                    faults=(Faults.parse(args.faults, seed=args.faults_seed)
                            if args.faults else None))

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for uid in range(args.requests):
        L = int(rng.integers(max(2, args.prompt_len // 2),
                             args.prompt_len + 1))
        engine.submit(Request(uid=uid, prompt=rng.integers(0, cfg.vocab, L),
                              max_new_tokens=args.max_new,
                              deadline_s=args.deadline or None))
    logger = None
    if args.metrics_jsonl:
        from repro_torch.training.metrics import MetricsLogger
        logger = MetricsLogger(args.metrics_jsonl,
                               run_name=f"serve-{cfg.name}")

    def _progress():
        snap = engine.metrics.snapshot()
        c, gz = snap["counters"], snap["gauges"]
        fields = dict(steps=c.get("steps_total", 0),
                      tokens=c.get("tokens_emitted", 0),
                      active=gz.get("active_slots", 0),
                      queued=gz.get("queue_depth", 0),
                      compiles=c.get("compiles_total", 0))
        if logger is not None:
            logger.log("serve", **fields)
        if args.log_every:
            dt = time.perf_counter() - t0
            print(f"[{dt:6.1f}s] steps={fields['steps']} "
                  f"tokens={fields['tokens']} active={fields['active']} "
                  f"queued={fields['queued']} "
                  f"compiles={fields['compiles']}")

    if args.log_every or logger is not None:
        # a drain loop of our own, for the periodic summaries
        next_log = t0 + (args.log_every or 1.0)
        while engine.has_work:
            engine.tick(args.sync_every)
            if time.perf_counter() >= next_log:
                _progress()
                next_log = time.perf_counter() + (args.log_every or 1.0)
        _progress()
    responses = engine.run()          # finalize (stops the profiler)
    wall = time.perf_counter() - t0
    stats = engine.latency_stats()
    if logger is not None:
        logger.log("final", wall_s=wall, **{
            k: v for k, v in stats.items()
            if isinstance(v, (int, float))})
        logger.close()
    if args.trace_out:
        engine.export_trace(args.trace_out)
        print(f"chrome trace written to {args.trace_out} "
              f"(open in https://ui.perfetto.dev)")
    if engine.profile_trace:
        print(f"profiler trace written to {engine.profile_trace}")
    kv_quant = engine.model.cfg.kv_quant
    print(f"arch={cfg.name} device={device} requests={args.requests} "
          f"batch={args.max_batch} weights={cfg.quant or cfg.param_dtype} "
          f"kv={'int8' if kv_quant else cfg.dtype} "
          f"weight_bytes={quantized_stats(params)['weight_bytes']}")
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
          f"chunked admissions={stats['chunked_admissions']} "
          f"fallback admissions={stats['fallback_admissions']}")
    if n_ok != len(responses) or stats["preemptions"] \
            or stats["faults_injected"]:
        print(f"resilience: ok={n_ok}/{len(responses)} "
              f"timeouts={stats['timeouts']} "
              f"cancelled={stats['cancellations']} "
              f"errors={stats['slot_errors']} "
              f"preemptions={stats['preemptions']} "
              f"faults_injected={stats['faults_injected']}")
    if args.paged:
        print(f"kv pages: total={stats['kv_pages_total']} "
              f"live={stats['kv_pages_live']} "
              f"released={stats['kv_pages_released']} "
              f"cow splits={stats['kv_cow_splits']} "
              f"preemptions={stats['preemptions']}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"arch": cfg.name, "device": str(device),
                       "wall_s": wall, **stats}, f, indent=2)
    return responses, stats


if __name__ == "__main__":
    main()
