"""End-to-end serving CLI of the PyTorch port: seeded requests through
one engine, or a fleet of engine replicas, on one device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --variant reduced --device cpu --requests 8 --max-new 12 \\
      [--paged --page-size 8] [--quant int8|int4] [--kv-cache-dtype int8] \\
      [--prefix-cache-tokens 256] [--draft int8@1|ngram --spec-gamma 4] \\
      [--faults nan_logits@12/1,page_alloc@30x2] [--deadline 2.0] \\
      [--trace-out trace.json] [--trace-dir prof/] \\
      [--metrics-jsonl run.jsonl] [--log-every 1.0] \\
      [--replicas 3 [--hedge] [--drain 1@0.5]]

``--variant reduced+edge`` (or ``edge`` at full width) serves the edge
profile: int4 weights and an int8 KV cache. ``--variant
reduced+continuous`` turns on chunked admission and the shared-prefix KV
cache, whose budget ``--prefix-cache-tokens`` also sets (attention-only
stacks: an SSM stack serves without one). ``--draft`` turns on speculative decoding (a self-draft
spec such as ``int8@1``, or ``ngram``, the prompt-lookup drafter that
also serves the SSM family; ``none`` turns off a config's draft, as in
the ``spec`` variant) and ``--spec-gamma`` sets the tokens proposed a
step; the run then prints a ``speculative:`` line. ``--arch`` takes every
architecture the port builds: the dense ids, the MoE family
(qwen2-moe-a2.7b, granite-moe-3b-a800m, mixtral-8x7b), the SSM family
(mamba2-780m), the hybrid jamba-1.5-large-398b and the frontend
families: the VLM pixtral-12b and the encoder-decoder
seamless-m4t-medium, whose every request carries (n_tokens, d_embed)
frames drawn from the seed (a VLM's prefix enters its slot as one
embedding chunk before the text; an encoder-decoder encodes them once
at admission). A stack with SSM sublayers keeps contiguous state only
(no ``--paged``, no prefix cache, no model draft: ``--draft ngram``
serves it); the frontend families serve from rings only (the pool is
token-only, as in JAX), and the encoder-decoder takes no model draft
(``--draft ngram`` serves it); quantization and the edge
profile apply to every stack (the MoE experts and router stay in full
precision, as in the JAX package). The device is CUDA unless
``--device cpu`` is given; without a CUDA device the CLI exits with an
error instead of running on the CPU. Weights are made from ``--seed``
and quantized after they are made, as ``cfg.quant`` says.

``--faults`` injects a deterministic fault schedule
(``serving/faults.py``; '' defers to ``REPRO_FAULTS``), ``--deadline``
gives every request a deadline, ``--trace-out`` writes the request
lifecycle as a Chrome trace, ``--trace-dir`` a ``torch.profiler`` trace
of the first steps, and ``--metrics-jsonl`` / ``--log-every`` write and
print registry summaries while serving.

``--replicas N`` (N > 1) serves the same seeded requests through a
fault-tolerant ``Fleet`` of N engines on the one device, sharing one
copy of the weights (``serving/fleet.py``): routed by prefix affinity,
health and load, failed over by replay, with ``--hedge`` (a second copy
of a slow-starting request, the first token wins) and ``--drain
rid@seconds[,...]`` (a rolling restart: drain each replica at that wall
time, rejoin it once drained). ``--faults`` may then also name the fleet
sites (``replica_crash``, ``replica_hang``, ``router_drop``), and
``--trace-out`` writes the merged trace (a lane a replica and a fleet
lane). Frontend-embedding architectures take the single-engine path.

``--mesh dp,mp`` (or ``auto``, or the ``sharded`` variant) serves on a
tensor- and data-parallel mesh, one process a rank under torchrun::

  PYTHONPATH=src python -m torch.distributed.run --standalone \
      --nproc-per-node 8 -m repro_torch.launch.serve --arch llama3.2-1b \
      --variant reduced --device cpu --mesh 2,4 --temperature 0

Each rank reads torchrun's environment and initialises the process
group itself (gloo under ``--device cpu``, NCCL on the card, one card a
rank), serves the same seeded requests, and rank 0 alone prints (with a
``mesh: data=... model=... (N devices)`` line) and writes ``--json``.
``--mesh none`` serves a sharded variant on one device.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import time

import numpy as np
import torch
import torch.distributed

from repro_torch.configs import ARCHS, EXTRA_ARCHS, get_arch
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.model import build
from repro_torch.quant import quantize_for_cfg, quantized_stats
from repro_torch.serving.engine import Engine
from repro_torch.serving.faults import Faults
from repro_torch.serving.request import Request
from repro_torch.serving.sampler import Sampler


def _engine_kwargs(args):
    """Engine knobs shared by the single-engine and fleet paths (the
    fleet owns ``recorder``/``faults``/``trace_dir`` itself)."""
    return dict(max_batch=args.max_batch, cache_len=args.cache_len,
                sampler=Sampler(temperature=args.temperature, top_k=32),
                seed=args.seed, sync_every=args.sync_every,
                kv_cache_dtype=args.kv_cache_dtype,
                prefill_chunk=None if args.prefill_chunk < 0
                else args.prefill_chunk,
                prefix_cache_tokens=None if args.prefix_cache_tokens < 0
                else args.prefix_cache_tokens,
                paged=args.paged, page_size=args.page_size,
                num_pages=args.num_pages or None)


def _parse_drains(spec):
    """'rid@seconds[,rid@seconds...]' -> [(seconds, rid)] sorted."""
    plan = []
    for part in filter(None, (p.strip() for p in spec.split(","))):
        rid, sep, at = part.partition("@")
        try:
            if not sep:
                raise ValueError(part)
            plan.append((float(at), int(rid)))
        except ValueError:
            raise SystemExit(f"--drain: bad entry {part!r}, want "
                             f"'rid@seconds' (e.g. '0@2.5')")
    return sorted(plan)


def _serve_fleet(args, cfg, model, params, device):
    """--replicas > 1: serve through the fault-tolerant Fleet. The
    single-engine loop's requests, plus the --drain rolling-restart
    schedule and the fleet's report."""
    from repro_torch.serving.fleet import DRAINED, Fleet

    if cfg.frontend is not None:
        raise SystemExit("--replicas > 1 serves token-only prompts; "
                         "frontend-embedding archs need the "
                         "single-engine path")
    fl = Fleet(model, params, replicas=args.replicas,
               engine_kwargs=_engine_kwargs(args),
               hedge=args.hedge, trace=bool(args.trace_out),
               faults=(Faults.parse(args.faults, seed=args.faults_seed)
                       if args.faults else None))
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for uid in range(args.requests):
        L = int(rng.integers(max(2, args.prompt_len // 2),
                             args.prompt_len + 1))
        fl.submit(Request(uid=uid,
                          prompt=rng.integers(0, cfg.vocab, L),
                          max_new_tokens=args.max_new,
                          deadline_s=args.deadline or None))
    logger = None
    if args.metrics_jsonl:
        from repro_torch.training.metrics import MetricsLogger
        logger = MetricsLogger(args.metrics_jsonl,
                               run_name=f"serve-fleet-{cfg.name}")
    drains = _parse_drains(args.drain)
    draining = set()
    next_log = t0 + (args.log_every or 1.0)
    while fl.has_work:
        fl.tick(args.sync_every)
        elapsed = time.perf_counter() - t0
        while drains and elapsed >= drains[0][0]:
            _, rid = drains.pop(0)
            try:
                fl.drain(rid)
                draining.add(rid)
            except ValueError as err:   # already dead or drained: skip
                print(f"--drain: {err}")
        for rid in sorted(draining):
            if fl.replicas[rid].state == DRAINED:
                fl.rejoin(rid)          # rolling restart: a fresh engine
                draining.discard(rid)
        if (args.log_every or logger is not None) \
                and time.perf_counter() >= next_log:
            snap = fl.metrics.snapshot()
            c, gz = snap["counters"], snap["gauges"]
            fields = dict(inflight=gz.get("fleet_inflight", 0),
                          queued=gz.get("fleet_queue_depth", 0),
                          dispatches=c.get("dispatches", 0),
                          failovers=c.get("failovers", 0),
                          hedges=c.get("hedges_issued", 0))
            if logger is not None:
                logger.log("fleet", **fields)
            if args.log_every:
                states = "".join(r.state[0] for r in fl.replicas)
                print(f"[{elapsed:6.1f}s] replicas={states} " +
                      " ".join(f"{k}={v}" for k, v in fields.items()))
            next_log = time.perf_counter() + (args.log_every or 1.0)
    responses = fl.responses
    wall = time.perf_counter() - t0
    stats = fl.latency_stats()
    if logger is not None:
        logger.log("final", wall_s=wall, **{
            k: v for k, v in stats.items()
            if isinstance(v, (int, float))})
        logger.close()
    if args.trace_out:
        fl.export_trace(args.trace_out)
        print(f"merged chrome trace written to {args.trace_out} "
              f"(one lane per replica + a fleet lane; open in "
              f"https://ui.perfetto.dev)")
    tokens = sum(len(r.tokens) for r in responses.values())
    n_ok = sum(1 for r in responses.values() if r.ok)
    print(f"arch={cfg.name} device={device} requests={args.requests} "
          f"replicas={args.replicas} batch={args.max_batch}"
          + (" hedge" if args.hedge else ""))
    print(f"finished={stats['n_finished']} ok={n_ok} tokens={tokens} "
          f"wall={wall:.2f}s ({tokens / wall:,.1f} tok/s)")
    g = lambda k: stats.get(k, float("nan"))  # noqa: E731
    print(f"fleet ttft ms: p50={g('fleet_ttft_ms_p50'):.1f} "
          f"p95={g('fleet_ttft_ms_p95'):.1f} "
          f"p99={g('fleet_ttft_ms_p99'):.1f}")
    print(f"routing: dispatches={stats.get('dispatches', 0)} "
          f"affinity_hits={stats.get('affinity_hits', 0)} "
          f"breaker_opens={stats.get('breaker_opens', 0)}")
    print(f"resilience: deaths={stats.get('replica_deaths', 0)} "
          f"failovers={stats.get('failovers', 0)} "
          f"migrated={stats.get('requests_migrated', 0)} "
          f"router_drops={stats.get('router_drops', 0)} "
          f"hedges won/wasted={stats.get('hedges_won', 0)}"
          f"/{stats.get('hedges_wasted', 0)} "
          f"drains={stats.get('drains', 0)} "
          f"rejoins={stats.get('rejoins', 0)} "
          f"timeouts={stats.get('fleet_timeouts', 0)}")
    for r in fl.replicas:
        ewma = f"{r.ewma_s * 1e3:.1f}ms" if r.ewma_s else "-"
        print(f"  replica {r.rid}: {r.state} ticks={r.ticks} "
              f"step_ewma={ewma}"
              + (f" ({r.death_reason})" if r.death_reason else ""))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"arch": cfg.name, "device": str(device),
                       "wall_s": wall,
                       **{k: v for k, v in stats.items()
                          if isinstance(v, (int, float, str))}},
                      f, indent=2)
    return responses, stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS) + sorted(EXTRA_ARCHS),
                    default="llama3.2-1b")
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
    ap.add_argument("--prefix-cache-tokens", type=int, default=-1,
                    help="shared-prefix KV reuse budget in tokens (LRU; "
                         "0 = off, -1 keeps cfg.prefix_cache_tokens; "
                         "attention-only stacks)")
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
    ap.add_argument("--draft", default="",
                    help="speculative-decoding draft: a self-draft spec "
                         "'<prec>[@<blocks>]' (fp|int8|int4, e.g. "
                         "'int8@1' = the first block, int8-quantized) or "
                         "'ngram' (the prompt-lookup drafter, every "
                         "family); 'none' turns off a config-set draft "
                         "(the spec variant); '' keeps cfg.draft")
    ap.add_argument("--spec-gamma", type=int, default=0,
                    help="draft tokens proposed a speculative step (0 "
                         "keeps cfg.spec_gamma; needs --draft or a "
                         "spec-variant config)")
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="",
                    help="serving mesh: 'dp,mp' (e.g. '2,4' = 2-way data "
                         "x 4-way model), 'auto' = every rank on the model "
                         "axis, 'none' forces one device even for a "
                         "sharded variant, '' keeps cfg.mesh (see the "
                         "'sharded' variant); one process a rank under "
                         "torchrun")
    ap.add_argument("--json", default="",
                    help="optional path to dump latency stats (and, on "
                         "one engine, each request's tokens) as JSON")
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
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through a fault-tolerant Fleet of this "
                         "many engine replicas on the device (health-"
                         "checked routing, failover by replay, drain/"
                         "rejoin; serving/fleet.py); 1 = one engine. "
                         "--faults may then also name the fleet sites "
                         "(replica_crash/replica_hang/router_drop)")
    ap.add_argument("--hedge", action="store_true",
                    help="with --replicas > 1: copy slow-starting "
                         "requests to a second replica after the fleet's "
                         "p99 TTFT; the first token wins, the loser is "
                         "cancelled")
    ap.add_argument("--drain", default="",
                    help="with --replicas > 1: rolling-restart schedule "
                         "'rid@seconds[,rid@seconds...]': drain each "
                         "replica at that wall time, rejoin it once "
                         "drained")
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"error: {err}")
    cfg = get_arch(args.arch, variant=args.variant)
    mesh_spec = args.mesh or cfg.mesh
    if mesh_spec not in ("", "none", "off"):
        if args.replicas > 1:
            raise SystemExit("--replicas > 1 serves on one device; a "
                             "mesh serves one engine across its ranks")
        device = _init_mesh_group(device)
        rank = torch.distributed.get_rank()
        try:
            with contextlib.redirect_stdout(io.StringIO()) if rank \
                    else contextlib.nullcontext():
                return _serve(args, cfg, device, json_out=not rank)
        finally:
            torch.distributed.destroy_process_group()
    return _serve(args, cfg, device)


def _init_mesh_group(device):
    """The process group of a mesh run, from torchrun's environment:
    gloo for the CPU, NCCL on the card (this rank's card). Returns the
    rank's device."""
    if "WORLD_SIZE" not in os.environ:
        raise SystemExit("--mesh serves one process a rank: start the CLI "
                         "with torchrun (python -m torch.distributed.run "
                         "--nproc-per-node N -m repro_torch.launch.serve "
                         "...)")
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    torch.distributed.init_process_group(
        "nccl" if device.type == "cuda" else "gloo")
    return device


def _serve(args, cfg, device, json_out=True):
    if args.quant:
        cfg = cfg.replace(quant="" if args.quant == "none" else args.quant)
    if args.draft == "none":
        cfg = cfg.replace(draft="", spec_gamma=0)   # speculation off
    elif args.draft:
        cfg = cfg.replace(draft=args.draft)
    if args.spec_gamma:
        cfg = cfg.replace(spec_gamma=args.spec_gamma)
    model = build(cfg, device)
    params = quantize_for_cfg(model.init(args.seed), cfg)
    if args.replicas > 1:
        return _serve_fleet(args, cfg, model, params, device)
    engine = Engine(model, params, **_engine_kwargs(args),
                    mesh=args.mesh or None,
                    recorder=bool(args.trace_out), trace_dir=args.trace_dir,
                    faults=(Faults.parse(args.faults, seed=args.faults_seed)
                            if args.faults else None))

    rng = np.random.default_rng(args.seed)
    fe = cfg.frontend
    t0 = time.perf_counter()
    for uid in range(args.requests):
        # the draws of the JAX CLI, in its order: the length, a frontend
        # model's frames (n_tokens, d_embed), then the prompt
        L = int(rng.integers(max(2, args.prompt_len // 2),
                             args.prompt_len + 1))
        emb = None
        if fe is not None:
            emb = rng.normal(0, 1, (fe.n_tokens, fe.d_embed)).astype(
                np.float32)
        engine.submit(Request(uid=uid, prompt=rng.integers(0, cfg.vocab, L),
                              max_new_tokens=args.max_new, embeddings=emb,
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
    if engine.mesh is not None:
        print(f"mesh: data={engine.mesh.axis_size('data')} "
              f"model={engine.mesh.axis_size('model')} "
              f"({engine.mesh.size} devices)")
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
    line = (f"ok={n_ok}/{len(responses)} chunk={stats['prefill_chunk']} "
            f"chunked admissions={stats['chunked_admissions']} "
            f"fallback admissions={stats['fallback_admissions']}")
    if "prefix_hits" in stats:
        line += (f" prefix hits={stats['prefix_hits']} "
                 f"reused tokens={stats['prefix_hit_tokens']}")
    print(line)
    if n_ok != len(responses) or stats["preemptions"] \
            or stats["faults_injected"]:
        print(f"resilience: ok={n_ok}/{len(responses)} "
              f"timeouts={stats['timeouts']} "
              f"cancelled={stats['cancellations']} "
              f"errors={stats['slot_errors']} "
              f"preemptions={stats['preemptions']} "
              f"faults_injected={stats['faults_injected']}")
    if engine.spec_gamma:
        print(f"speculative: gamma={stats['spec_gamma']} "
              f"accept={stats['spec_acceptance_rate']:.2f} "
              f"tokens/step={stats['spec_tokens_per_step']:.2f}")
    if args.paged:
        print(f"kv pages: total={stats['kv_pages_total']} "
              f"live={stats['kv_pages_live']} "
              f"released={stats['kv_pages_released']} "
              f"cow splits={stats['kv_cow_splits']} "
              f"preemptions={stats['preemptions']}")
    if args.json and json_out:
        with open(args.json, "w") as f:
            json.dump({"arch": cfg.name, "device": str(device),
                       "wall_s": wall, **stats,
                       "tokens": {str(u): list(r.tokens)
                                  for u, r in responses.items()}},
                      f, indent=2)
    return responses, stats


if __name__ == "__main__":
    main()
