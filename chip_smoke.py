"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's kernels from this checkout and holds each against its
plain PyTorch version on the card (the paged decode-attention kernel
also against the contiguous one on the gathered view, which it must
equal exactly; the int8 and int4 dequantize-matmuls at every projection
shape of the model, ragged M and N, K 34 (an odd int4 group), a ragged K
and a strided x, bf16 int8 and int4 (groups of 32 and 64) on the
tensor-core route, bitwise equal across two calls); checks a
2-layer full-width llama3.2-1b on the card against the same model on the
CPU in fp32, dense and quantized (the edge profile: int4 weights and
int8 KV; int8 weights with fp32 KV); serves the full 16-layer bf16
llama3.2-1b (weights from a seed) through
``repro_torch.serving.engine.Engine`` on contiguous KV rings, checking
that the kernels ran on that path as often as its step trace implies,
and profiles a second batch through the same engine (device busy share,
kernel time by kernel); serves the same requests on a one-rank NCCL
serving mesh (``serve_mesh``: ``Engine(mesh="auto")`` over
``torch.distributed``, its step graphs capturing the layers' collectives;
tokens bitwise equal to ``serve``'s, launch counters and collectives
equal to what the step trace and the layer plan imply, and a profiled
second batch with no capture and two syncs a poll, the NCCL kernels it
saw recorded); serves the same requests on a paged KV pool
(greedy tokens equal to the contiguous run's, the paged kernel counted,
the pool drained) and profiles a second batch there too; serves four
streams on a pool too small for their growth, which must preempt, resume
by replay and drain; drives the engine lifecycle on the graph-captured
steps (``lifecycle``: an empty fault schedule invisible, a chaos
schedule of NaN logits, forced page exhaustion and a host stall
contained to one stream, cancels of a queued, a mid-admission and an
active request, an expired and a mid-stream deadline, a priority
displacement, the request tracer and the ``trace_dir`` profiler window,
each with no capture after warm-up, launch counters equal to the step
trace and, under the profiler, two host stream syncs a poll); serves
shared prompt heads through the prefix cache on the same steps
(``prefix``: a 512-token header, whole and partial hits on rings and on
the pool, hot tokens equal to a cold engine's, the hit counts, the
pool's page aliases and no split, no capture, two syncs a poll and none
in a hit's copies, the rings' copy time, eviction under a small budget,
the ladder's prefix-reclaim rung under pool pressure, a forced
copy-on-write split, an int8 KV pool; the pools drain); and
serves the same 16 requests quantized: int8
weights on bf16 rings (``serve_int8``), the edge profile on int8 rings
(``serve_edge``) and on an int8 pool (``serve_edge_paged``, tokens equal
to ``serve_edge``'s), with a profiled second batch through the int8 and
the edge engines. Then the SSM family (mamba2-780m): both SSD kernels against
their plain versions in the ``kernels`` phase (the recurrence kernel on
the route its plan picks, also bitwise compositional over splits at 1,
the tile's edges and 37, an identity step at dt = 0 and ``ssd_step``'s T
= 1 launch, and timed over a T sweep at b 1 with its fixed and per-token
cost fitted; the dual form on the route ``chunk_plan`` picks, bf16 on
the tensor-core route, bitwise repeatable, timed by sub-step and over
its sub-chunks); a 2-layer full-width fp32 mamba2 on the
card against the CPU through ``prefill`` (the chunked kernel) and
through an extend (``model_ssm``) and through ``Engine``
(``serve_ssm_check``, tokens identical); the full 48-layer bf16 model
served with the same schedule (``serve_ssm``, launch counts equal to the
trace), a profiled second batch (``profile_ssm``) and a 1024-token
``Model.prefill`` at full depth (``prefill_ssm``: wall and device ms,
the dual form's share, 48 ``ssd`` launches a call). Then the Zoo
compose layer: the flash-attention kernel against its plain version in
the ``kernels`` phase (pixtral-12b's hd 160 and llama3.2-1b's hd 64 at
G 4, G 1 and G 8, hd 40, a window, non-causal, a ragged length, fp32);
the repository's card tests (``card_tests``: ``tests/test_torch_card.py``
run without ``tests/conftest.py``, which imports JAX, in a subprocess
that must pass with no test skipped, while this process runs the model
checks); the Zoo's model services at full
width cut to 2 layers, fp32, card against CPU
(``model_vlm``: the pixtral-12b classifier and ``model.lm``); and the
paper's deployment example at full width (``zoo``: the 40-layer bf16
pixtral-12b classifier ``>> label_decoder`` deployed local, remote and
split, every endpoint group a program captured as a CUDA graph in its
first call and replayed after: identical outputs, exactly 40 flash and
81 norm launches a forward, the replays' counts confirmed by the
profiler's count of the kernels one replay ran, no capture after the
first call, each
build's wall ms, the deployed calls' peak memory apart from the
weights' draw and their graph pools' bytes; ``model.lm`` on llama3.2-1b
through ``lm.jitted()``, confirmed the same way; a registry round
trip on the card); fig. 2's
turn for the cache-free forward (``forward_turns``: mamba2-780m's
``model.lm``, 48 layers, B 1, L 1024, on the SSD ``mma`` route; the
deployed pixtral-12b classifier; llama3.2-1b's ``model.lm``, B 2, L
1024: each on graphs and eagerly in turns, graphs, eager, eager,
graphs, with wall ms, device ms, busy share and host launch calls,
outputs of the two modes bitwise equal (the same kernels run), launch
counters a forward as expected and confirmed by the profiler over
each profiled call, no capture after the first call, and on mamba2
the timing of the dual form's three launches a layer in each mode);
and the bf16 classifier at full
width cut to 2 layers on the
card against the plain fp32 forward on the CPU (``zoo_plain``: class
ids equal, logits within 2e-2 of max|plain|). Speculative decoding:
``spec_exact``, after the model checks, holds a 2-layer fp32 model's
spec tokens (``int8@1`` and n-gram) equal to its plain tokens and to the
CPU's; last, ``spec`` serves the ``spec`` variant's ``int8@8``
self-draft at gamma 4 on rings, on a pool and eagerly (all three
bitwise equal), the n-gram drafter and the plain engine, each warmed
and steady (no capture, counters = the trace, two syncs a poll, every
divergence from the plain engine's bf16 tokens at a near tie), and
``spec_ssm`` mamba2-780m's n-gram verify and replay (exact against
plain in fp32 at full depth, measured in bf16). The serving fleet, after
``prefix``: three replicas of the paged engine (a 1024-token prefix
cache) over one copy of the bf16 weights serve 24 requests, every other
one behind a shared 256-token head (``fleet``: streams bitwise equal to
one engine's, affinity hits, no capture, counters equal to the
replicas' summed traces, two syncs a poll on a profiled batch, tok/s
beside one engine's at 8 and 24 slots); ``fleet_chaos`` kills replica 0
and loses the failover's first redispatch (nothing lost, replayed
streams equal or leaving one engine's at a near tie, survivors
drained); ``fleet_hang_hedge`` (the hang watchdog, then zero-delay
hedges on single-step ticks, bitwise); ``fleet_trace`` (the merged
trace); ``fleet_rejoin`` (drain and rejoin twice: memory flat, captures
before ``mark_steady`` only); and ``fleet_exact`` beside ``spec_exact``
(fp32, 2 layers: fleet = one engine = the CPU's fleet). The other families,
after the Zoo: ``model_families`` holds qwen2-moe-a2.7b,
granite-moe-3b-a800m, internlm2-20b, qwen2.5-14b, starcoder2-15b and
gemma2-9b-class at full width cut to 2 layers (and mixtral-8x7b at its
reduced width) card against CPU in fp32, through ``prefill`` (flash at
G 1, 3, 5, 6 and 12 and hd 256, MoE capacity dispatch) and an extend
(decode attention, dense routing) with 8 decodes each: logits within
2e-3, greedy tokens and the experts of every router call identical;
``model_hybrid`` does the same for jamba's reduced super-block at the
SSM's published p 128, n 128; ``serve_moe`` serves qwen2-moe-a2.7b at
full width and depth (24 layers, 60 experts top-4 and 4 shared, bf16)
with the serve phase's engine and requests on rings (profiled), eagerly
and on a pool (tokens bitwise equal); ``serve_hybrid`` serves jamba at
its published widths cut to one super-block of 8 of its 16 experts on
rings (profiled) and eagerly, the pool refused. The frontend
families: ``model_encdec`` (seamless-m4t-medium at full width, 2
encoder and 2 decoder layers) and ``model_vlm_cached`` (pixtral-12b at
full width, 2 layers) card against CPU in fp32 through ``prefill`` with
1024 frames and through the engine's admission path (the encoded
memory, or the 1024-row embedding chunk at hd 160) with 8 decodes;
``serve_encdec`` and ``serve_vlm`` at full depth, bf16, 16 requests with
frames on graphs (counters = the trace with each admission's program, a
steady profiled batch: no capture, two syncs a poll; eager tokens
bitwise equal; pixtral's pool refuses frames), with the admission
program's ms against its bound. The decode-attention cases cover both tensor-core routes of its
plan (R <= 16 rows and above, S split over blocks, a fully masked row
at T 1 and T 16); every timed attention case records its plan and the
rates it reached, and the ``build`` line every template's ptxas
registers and spills (a spilling tensor-core, ``ssd_extend``, dual-form
``mma`` or ``rmsnorm_kernel`` template fails the run); every profile line splits
the ``ssd_extend`` device time by template (route) and gates the norm's
launch counter at 2 n_layers + 1 a forward. The RMSNorm kernel's three
routes (add + norm, the norm alone, Mamba-2's gated norm) are held
against their plain versions at llama3.2-1b's, pixtral-12b's and
mamba2-780m's shapes, bitwise repeatable, each timed with its host
microseconds per call (enqueue only).
Every engine runs its steps as CUDA graphs (``Engine``'s default on
the card): each serve phase checks it, ``serve_eager`` and
``serve_ssm_eager`` serve the same requests on eager steps
(``graphs=False``) after the graphs run (tokens identical; decode ms,
ITL, TTFT and tok/s of both; the eager turn profiles no batch), and
every profile phase marks its engine steady and fails on a capture in
its window, on a host stream sync other than the poll's two reads,
and on a launch counter that differs
from the profiler's count of its kernel templates (a count may fall
short by no more than the records the profiler lost, which the spins
that open and close the window measure).
Training: ``kernels_bwd`` holds the four backward kernels, which
replace no TPU kernel (the JAX package differentiates its plain
attention, norms and SSD scan), against their plain backwards and
autograd of the plain forwards: the flash backward (D, dK/dV, dQ from
the forward's LSE; bf16 on its tensor-core ``mma`` route, fp32 on
``simt``) at llama3.2-1b's train shape (B 4, L 1024, Hq 32, Hkv 8, hd
64), hd 128 at G 1, hd 160, a window of 256, non-causal Lq 128 / Lk
1024, L 1000 at hd 40 (a ragged key tile, zero-padded dimensions), G 8
with a window of 96 and fp32; the RMSNorm backward (add and norm routes)
at d 2048, N 4096 in bf16 and fp32, N 4095 and d 5120; each record
names its route and plan (``plan_bwd``); the SSD dual form's backward at
mamba2-780m's train shape (b 4, l 1024, h 48, p 64, n 128, chunk 256),
jamba's heads (h 128, p 128), fp32, a carried state and groups; the
gated norm's backward at N 4096, d 3072 (z of a 6448-wide row), d
16384 and fp32; each timed beside its bound, its plain backward and a
library yardstick where one call computes it (SDPA or add +
``F.rms_norm``, forward + backward less forward). ``train_exact`` (with
the model checks) trains llama3.2-1b and mamba2-780m cut to 2 layers,
jamba's reduced super-block at the SSM's published head and state dims,
with MoE on its even sublayers (3 steps each), and qwen2-moe-a2.7b cut
to 1 layer (B 1 x L 64, 1 step), fp32, on the card and on the CPU from
the same weights and batches (losses, first gradients
within 1e-4 of each leaf's max or 4 times the leaf's own move under a
rounding-level perturbation, parameters). ``train`` trains the full
16-layer bf16 llama with remat, B 4 x L 1024, on the train step
captured as one CUDA graph (``make_train_step``'s default on the card):
3 steps eagerly and 3 on the graph from one state, the same bits
(``graphs_vs_eager``), then 20 replays (step ms, tokens/s, peak memory
and graph-pool bytes, launches a step by op, no capture after the first,
a profiled replay: one ``cudaGraphLaunch`` and no
``cudaStreamSynchronize`` a step), after one eager step with remat off
(the same bits) and one at microbatch 2 (the loss within the bf16
gate); ``train_ssm`` the same for mamba2-780m at full width and depth
(48 layers); ``train_moe``, last, trains qwen2-moe-a2.7b at full width
on 4 of its 24 layers for 10 replays, its loss and gradients computed
twice the same bits and its auxiliary loss positive.
Every phase prints one JSON line; any failure raises and the
script exits non-zero without the final line. The second-to-last lines are the
kernel summary (JSON) and the card's name and power limit as
``nvidia-smi`` reports them; the last line is ``{"ok": true, "device":
{...}}``. Exits non-zero without a CUDA device, and when the port's
package is not beside it.

    python3 chip_smoke.py --norm-host-us SRC

times another checkout's norm wrapper alone (``norm_host_cost``);

    python3 chip_smoke.py --ssd-compare SRC

times another checkout's dual form at the kernels phase's two bf16
shapes and its ``prefill_ssm`` (``ssd_compare``);

    python3 chip_smoke.py --bwd-compare SRC

times another checkout's backward kernels (flash attention, the RMSNorm
add / norm and gated routes, the SSD dual form) at the kernels_bwd
phase's cases, each held against its plain backward (``bwd_compare``);

    python3 chip_smoke.py --train

builds the kernels and runs the three train cells alone (``train``,
``train_ssm``, ``train_moe``), without the final line.
"""
from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, published
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core rate, published
              "float32": 67e12}    # outside the tensor cores, published
DECODE_ATTN_SRC = "src/repro_torch/csrc/decode_attention.cu"
DECODE_ATTN_TPU = "src/repro/kernels/decode_attention/kernel.py:157"
PAGED_ATTN_TPU = "src/repro/kernels/decode_attention/kernel.py:90"
RMSNORM_SRC = "src/repro_torch/csrc/rmsnorm.cu"
RMSNORM_TPU = "src/repro/kernels/rmsnorm/kernel.py:30"
QMM_SRC = "src/repro_torch/csrc/quant_matmul.cu"
QMM_TPU = {8: "src/repro/kernels/quant_matmul/kernel.py:45",
           4: "src/repro/kernels/quant_matmul/kernel.py:66"}
SSD_SRC = "src/repro_torch/csrc/ssd_scan.cu"
SSD_TPU = "src/repro/kernels/ssd_scan/kernel.py:156"
SSD_EXT_TPU = "src/repro/kernels/ssd_scan/kernel.py:109"
FLASH_SRC = "src/repro_torch/csrc/flash_attention.cu"
FLASH_TPU = ("src/repro/kernels/flash_attention/kernel.py:153, "
             "src/repro/kernels/flash_attention/kernel.py:191")
#: mamba2-780m's SSD dims (h, p, g, n) and the reduced variant's with 2
#: groups
SSD_FULL = (48, 64, 1, 128)
SSD_REDUCED_G2 = (16, 32, 2, 32)
#: jamba-1.5-large-398b's SSD dims: 128 heads of 128, d_state 128
SSD_JAMBA = (128, 128, 1, 128)
SSD_TOL_REL = 1e-4
#: the bf16 Zoo classifier on the card against the plain fp32 forward,
#: relative to max|plain logits| (``zoo_plain``)
ZOO_BF16_TOL_REL = 2e-2
#: the dual form's launches on its ``mma`` route, in order; the last two
#: are programmatic dependent launches
SSD_CHAIN = ("ssd_chunk_states_kernel", "ssd_state_pass_kernel",
             "ssd_chunk_out_kernel")
#: the recurrence kernel's T sweep at b 1 (fixed and per-token cost)
SSD_SWEEP_T = (1, 16, 64, 128, 256)
#: llama3.2-1b's projection shapes (K, N): wi/wg, wk/wv, wq/wo, mlp wo;
#: the first one's decode row heads the kernel summary
QMM_SHAPES = ((2048, 8192), (2048, 512), (2048, 2048), (8192, 2048))
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: the decode-attention kernel's cases (contiguous, paged and the cached
#: cross-attention): bf16 within 4e-3, twice the largest error any of
#: them has shown (1.95e-3, chunk and cross_chunk_seamless)
ATTN_TOL = {"float32": 1e-4, "bfloat16": 4e-3}
#: spin kernels that open a profile window (``_profiled``)
PROFILE_LEAD = 256
#: the kernel templates that a wrapper call launches exactly once, by
#: the counters of the wrappers that launch them (a split's combine or
#: finalize kernel and the dual form's first two launches are left out):
#: each profile phase holds the counters against the profiler's counts
PROFILE_TEMPLATES = (
    (("decode_attention", "paged_decode_attention"),
     ("decode_mma_kernel", "decode_f32_kernel")),
    (("quant_matmul_int8", "quant_matmul_int4"),
     ("qmm_mma_kernel", "qmm_kernel")),
    (("rmsnorm",), ("rmsnorm_kernel",)),
    (("ssd_extend",), ("ssd_extend_kernel",)),
    (("ssd",), ("ssd_chunk_out_kernel", "ssd_chunk_kernel")),
    (("flash_attention",), ("flash_mma_kernel", "flash_f32_kernel")),
    (("flash_attention_bwd",), ("flash_bwd_dq_mma_kernel",
                                "flash_bwd_dq_kernel")),
    (("rmsnorm_bwd",), ("rmsnorm_bwd_kernel",)),
    (("rmsnorm_gated_bwd",), ("rmsnorm_gated_bwd_kernel",)),
    (("ssd_bwd",), ("ssd_bwd_mma_kernel", "ssd_bwd_key_kernel")))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


#: the timing spin's cycles: at least ~0.1 ms, and at least twice the
#: host's enqueue of the call at 2 GHz, at most ~10 ms
SPIN_CYCLES = (200_000, 20_000_000)


def median_ms(torch, fn, flush, iters=25, warmup=3):
    """Median CUDA-event time of one call, L2 flushed before each. A spin
    on the card before the start event keeps the stream busy while the
    host enqueues the call, so the host's launch latency is not counted
    as device time: ~0.1 ms, or twice the host time of the last warm-up
    call where that is longer (a wrapper that checks and allocates for
    ~0.2 ms before its launches, as the SSD backward's does, would
    otherwise leave the card idle inside the timed window)."""
    host = 0.0
    for _ in range(warmup):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        host = time.perf_counter() - t
    torch.cuda.synchronize()
    spin = int(min(max(SPIN_CYCLES[0], 4e9 * host), SPIN_CYCLES[1]))
    evs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(spin)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs)


def bound_ms(nbytes, flops, dtype):
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops \
        else "operations"


def achieved(rec):
    """The rates a timed case reached: its bound's bytes and operations
    over the kernel's time (GB/s, TFLOP/s)."""
    s = rec["kernel_ms"] * 1e-3
    return {"achieved_GBps": rec["bytes"] / s / 1e9,
            "achieved_TFLOPs": rec["flops"] / s / 1e12}


def ptxas_table(logs):
    """{kernel<template arguments>: {registers, spill_stores,
    spill_loads}} from ``nvcc -Xptxas -v`` output, one entry per
    compiled template."""
    import re
    table, name = {}, None
    for log in logs:
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                name = m.group(1)
                k = re.search(r"_cu_[0-9a-f]{8}(\d+)(\w+)", name)
                if k:
                    n, rest = int(k.group(1)), k.group(2)
                    name, tail = rest[:n], rest[n:]
                    if tail.startswith("I") and "EEv" in tail:
                        raw = tail[1:tail.index("EEv")]
                        raw = re.sub(r"\d+__nv_bfloat16", "bf16,", raw)
                        raw = re.sub(r"L[ib](\d+)E", r"\1,", raw)
                        raw = re.sub(r"^f", "float,", raw)
                        name = f"{name}<{raw.rstrip(',')}>"
                table[name] = {}
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m and name:
                table[name].update(spill_stores=int(m.group(1)),
                                   spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", ln)
            if m and name:
                table[name]["registers"] = int(m.group(1))
    return table


# --------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------- #
#: the attention cases timed (bf16): the plain steps' decode and chunk,
#: the spec steps' verify window and the draft's two-token window
TIMED_ATTN = ("decode", "chunk", "verify_T5", "window_T2", "decode_hd256",
              "chunk_hd256", "decode_hd160", "chunk_hd160",
              "embed_chunk_hd160")
#: query heads, KV heads and head_dim of the attention cases: llama3.2-1b's
#: by default, gemma2-9b-class's for the hd 256 cases, pixtral-12b's for
#: the hd 160 cases (on a 2048-slot ring)
ATTN_DIMS = (32, 8, 64)
GEMMA2_DIMS = (16, 8, 256)
PIXTRAL_DIMS = (32, 8, 160)


def decode_attention_cases(torch, flush):
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda, plan)
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_reference

    dev = torch.device("cuda")
    # (name, B, T, S, window, special rows[, (Hq, Hkv, hd)]): the main
    # path's decode step
    # (mma_keys, S split 4 ways) and chunk (mma_rows), a window, S 1000
    # (the split of 256 slots does not divide it: the last is 232), a
    # fully masked row at T 1 (every split masked: the combine's NEG_INF
    # case) and at T 16, and R = T * G of 12, 16 (mma_keys) and 20
    # (mma_rows) around the route threshold (R <= 16); the spec steps'
    # target verify (T 5, R 20: mma_rows) and draft window (T 2, R 8)
    cases = [
        ("decode", 8, 1, 1024, 0, None),
        ("chunk", 1, 128, 1024, 0, None),
        ("decode_window256", 8, 1, 1024, 256, None),
        ("decode_ragged_S1000", 8, 1, 1000, 0, None),
        ("chunk_all_masked_row", 2, 16, 1024, 0, "masked"),
        ("decode_all_masked_row", 8, 1, 1024, 0, "masked"),
        ("rows12", 4, 3, 1024, 0, None),
        ("rows16", 4, 4, 1024, 0, None),
        ("rows20", 4, 5, 1024, 0, None),
        ("verify_T5", 8, 5, 1024, 0, None),
        ("window_T2", 8, 2, 1024, 0, None),
        # gemma2-9b-class: head_dim 256 at G 2, decode and chunk, and a
        # decode under a window the ring wraps past
        ("decode_hd256", 8, 1, 1024, 0, None, GEMMA2_DIMS),
        ("chunk_hd256", 1, 128, 1024, 0, None, GEMMA2_DIMS),
        ("decode_hd256_window512", 8, 1, 1024, 512, None, GEMMA2_DIMS),
        ("chunk_hd256_all_masked_row", 2, 16, 1024, 0, "masked",
         GEMMA2_DIMS),
        # pixtral-12b: head_dim 160 at G 4 on a 2048-slot ring: decode
        # (mma_keys, 2 head-dim slices of 2 warps), a chunk and the
        # embedding chunk's 1024 rows (mma_rows, 32-row blocks), and a
        # fully masked row
        ("decode_hd160", 8, 1, 2048, 0, None, PIXTRAL_DIMS),
        ("chunk_hd160", 1, 128, 2048, 0, None, PIXTRAL_DIMS),
        ("embed_chunk_hd160", 1, 1024, 2048, 0, None, PIXTRAL_DIMS),
        ("decode_hd160_all_masked_row", 8, 1, 2048, 0, "masked",
         PIXTRAL_DIMS),
    ]
    out, errs = [], []
    for name, B, T, S, window, special, *dims in cases:
        Hq, Hkv, hd = dims[0] if dims else ATTN_DIMS
        g = torch.Generator(device=dev).manual_seed(SEED)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            q = torch.randn((B, T, Hq, hd), generator=g, device=dev
                            ).to(dtype)
            k = torch.randn((B, S, Hkv, hd), generator=g, device=dev
                            ).to(dtype)
            v = torch.randn((B, S, Hkv, hd), generator=g, device=dev
                            ).to(dtype)
            # rows sit at depth S - T (decode: the full ring) and extend
            # by T; the slots past each row's depth hold position -1
            depth = S - T if T > 1 else S - 1
            base = torch.full((B,), depth, dtype=torch.int32, device=dev)
            q_pos = (base[:, None] + torch.arange(
                T, dtype=torch.int32, device=dev)[None]).contiguous()
            slots = torch.arange(S, dtype=torch.int32, device=dev)[None]
            pos = torch.where(slots < depth + T, slots,
                              torch.full_like(slots, -1)).repeat(B, 1)
            if special == "masked":
                pos[0] = -1          # a freshly reset slot: every slot empty
            got = decode_attention_cuda(q, k, v, pos, q_pos, window=window)
            want = decode_attention_reference(q, k, v, pos, q_pos,
                                              window=window)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = bool(torch.isfinite(got).all().item()) \
                and err <= ATTN_TOL[dname]
            pl = plan(B, T, Hq, Hkv, S, hd, dtype)
            rec = {"phase": "kernels", "kernel": "decode_attention",
                   "case": name, "dtype": dname, "B": B, "T": T, "S": S,
                   "Hq": Hq, "Hkv": Hkv, "hd": hd, "window": window,
                   "plan": pl._asdict(),
                   "max_abs_err": err, "tol": ATTN_TOL[dname], "ok": ok}
            if special == "masked":
                mean_v = v[0].float().mean(0).repeat_interleave(
                    Hq // Hkv, dim=0)
                merr = (got[0].float() - mean_v[None]).abs().max().item()
                rec["masked_row_vs_mean_v"] = merr
                ok = ok and merr <= ATTN_TOL[dname]
                rec["ok"] = ok
            if name in TIMED_ATTN and dtype == torch.bfloat16:
                # the operations of the (query, slot) pairs the masks keep
                elt = q.element_size()
                nbytes = elt * (2 * B * S * Hkv * hd + 2 * B * T * Hq * hd) \
                    + 4 * (B * S + B * T)
                mask = ((pos[:, None, :] >= 0)
                        & (pos[:, None, :] <= q_pos[:, :, None]))[:, None]
                flops = 4 * Hq * hd * int(mask.sum().item())
                bms, by = bound_ms(nbytes, flops, dname)
                qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), \
                    v.transpose(1, 2)
                rec.update(
                    kernel_ms=median_ms(torch, lambda: decode_attention_cuda(
                        q, k, v, pos, q_pos, window=window), flush),
                    plain_ms=median_ms(
                        torch, lambda: decode_attention_reference(
                            q, k, v, pos, q_pos, window=window), flush),
                    library_ms=median_ms(
                        torch, lambda: F.scaled_dot_product_attention(
                            qh, kh, vh, attn_mask=mask, enable_gqa=True),
                        flush),
                    bound_ms=bms, bound_us=bms * 1e3, bound_by=by,
                    bytes=nbytes, flops=flops)
                rec.update(achieved(rec))
            emit(rec)
            out.append(rec)
            errs.append(err)
            if not ok:
                raise AssertionError(f"decode_attention {name} {dname}: "
                                     f"kernel disagrees with the plain "
                                     f"version: {rec}")
    return out, max(errs)


def paged_decode_attention_cases(torch, flush):
    """The paged kernel against its plain version, and against the
    contiguous kernel on the gathered logical view (exactly equal: the
    same template, only the K/V row address differs). Pools of random
    junk; each table is a seeded permutation of the pool's pages, and the
    last blocks of most rows point at the trash page with pos = -1."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda, paged_decode_attention_cuda, plan)
    from repro_torch.kernels.decode_attention.ref import (
        paged_decode_attention_reference, paged_kv_gather)

    dev = torch.device("cuda")
    # (name, B, T, page size, window, special rows[, (Hq, Hkv, hd[,
    # S])]): S 1024 unless the dims give it
    cases = [
        ("decode", 8, 1, 16, 0, None),
        ("chunk", 1, 128, 16, 0, None),
        ("decode_window256", 8, 1, 16, 256, None),
        ("chunk_all_masked_row", 2, 16, 16, 0, "masked"),
        ("decode_ps8", 8, 1, 8, 0, None),
        ("chunk_ps32", 1, 128, 32, 0, None),
        ("decode_all_masked_row", 8, 1, 16, 0, "masked"),
        ("verify_T5", 8, 5, 16, 0, None),
        ("window_T2", 8, 2, 16, 0, None),
        ("decode_hd256", 8, 1, 16, 0, None, GEMMA2_DIMS),
        ("chunk_hd256", 1, 128, 16, 0, None, GEMMA2_DIMS),
        ("decode_hd160", 8, 1, 16, 0, None, PIXTRAL_DIMS + (2048,)),
        ("chunk_hd160", 1, 128, 16, 0, None, PIXTRAL_DIMS + (2048,)),
    ]
    out, errs = [], []
    for name, B, T, ps, window, special, *dims in cases:
        Hq, Hkv, hd, *rest = dims[0] if dims else ATTN_DIMS
        S = rest[0] if rest else 1024
        NB = S // ps
        P = B * NB + 8                   # 8 pages no row maps
        g = torch.Generator(device=dev).manual_seed(SEED)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            q = torch.randn((B, T, Hq, hd), generator=g, device=dev
                            ).to(dtype)
            kp = torch.randn((P + 1, ps, Hkv, hd), generator=g, device=dev
                             ).to(dtype)
            vp = torch.randn((P + 1, ps, Hkv, hd), generator=g, device=dev
                             ).to(dtype)
            bt = torch.randperm(P, generator=g, device=dev)[:B * NB] \
                .reshape(B, NB).to(torch.int32)
            # row b holds 2 * ((b + 1) % 4) blocks fewer than S: those
            # blocks are at the trash page and their slots at pos -1
            live = torch.tensor([S - 2 * ((b + 1) % 4) * ps
                                 for b in range(B)], device=dev)
            blk = torch.arange(NB, device=dev)[None]
            bt = torch.where(blk * ps < live[:, None], bt,
                             torch.full_like(bt, P))
            slots = torch.arange(S, device=dev)[None]
            pos = torch.where(slots < live[:, None], slots,
                              torch.full_like(slots, -1)).to(torch.int32)
            if special == "masked":
                pos[0] = -1          # a freshly reset slot: every slot empty
            q_pos = ((live - T)[:, None] + torch.arange(T, device=dev)[None]
                     ).to(torch.int32).contiguous()
            got = paged_decode_attention_cuda(q, kp, vp, bt, pos, q_pos,
                                              window=window)
            want = paged_decode_attention_reference(q, kp, vp, bt, pos,
                                                    q_pos, window=window)
            kg, vg = paged_kv_gather(kp, vp, bt)
            contig = decode_attention_cuda(q, kg, vg, pos, q_pos,
                                           window=window)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            cerr = (got.float() - contig.float()).abs().max().item()
            ok = bool(torch.isfinite(got).all().item()) \
                and err <= ATTN_TOL[dname] and cerr == 0.0
            rec = {"phase": "kernels", "kernel": "paged_decode_attention",
                   "case": name, "dtype": dname, "B": B, "T": T, "S": S,
                   "page_size": ps, "NB": NB, "pool_pages": P + 1,
                   "trash_entries": int((bt == P).sum().item()),
                   "Hq": Hq, "Hkv": Hkv, "hd": hd, "window": window,
                   "plan": plan(B, T, Hq, Hkv, S, hd, dtype)._asdict(),
                   "max_abs_err": err, "tol": ATTN_TOL[dname],
                   "vs_contiguous_kernel_max_abs_diff": cerr, "ok": ok}
            if special == "masked":
                mean_v = vg[0].float().mean(0).repeat_interleave(
                    Hq // Hkv, dim=0)
                merr = (got[0].float() - mean_v[None]).abs().max().item()
                rec["masked_row_vs_mean_v"] = merr
                ok = ok and merr <= ATTN_TOL[dname]
                rec["ok"] = ok
            if name in TIMED_ATTN and dtype == torch.bfloat16:
                # what this run's data needs: every page the tables map
                # (the trash page once), q and out, pos, q_pos and the
                # tables; the operations of the (query, slot) pairs the
                # masks keep
                elt = q.element_size()
                pages = torch.unique(bt).numel()
                nbytes = elt * (2 * pages * ps * Hkv * hd
                                + 2 * B * T * Hq * hd) \
                    + 4 * (B * S + B * T + B * NB)
                mask = ((pos[:, None, :] >= 0)
                        & (pos[:, None, :] <= q_pos[:, :, None]))
                flops = 4 * Hq * hd * int(mask.sum().item())
                bms, by = bound_ms(nbytes, flops, dname)
                qh = q.transpose(1, 2)
                m4 = mask[:, None]

                def gather_sdpa():
                    k2, v2 = paged_kv_gather(kp, vp, bt)
                    return F.scaled_dot_product_attention(
                        qh, k2.transpose(1, 2), v2.transpose(1, 2),
                        attn_mask=m4, enable_gqa=True)

                rec.update(
                    kernel_ms=median_ms(
                        torch, lambda: paged_decode_attention_cuda(
                            q, kp, vp, bt, pos, q_pos), flush),
                    plain_ms=median_ms(
                        torch, lambda: paged_decode_attention_reference(
                            q, kp, vp, bt, pos, q_pos), flush),
                    contiguous_kernel_ms=median_ms(
                        torch, lambda: decode_attention_cuda(
                            q, kg, vg, pos, q_pos), flush),
                    gather_plus_sdpa_ms=median_ms(torch, gather_sdpa, flush),
                    library_ms=None,
                    bound_ms=bms, bound_us=bms * 1e3, bound_by=by,
                    bytes=nbytes, flops=flops)
                rec.update(achieved(rec))
                rec["vs_contiguous_ms_ratio"] = \
                    rec["kernel_ms"] / rec["contiguous_kernel_ms"]
            emit(rec)
            out.append(rec)
            errs.append(err)
            if not ok:
                raise AssertionError(f"paged_decode_attention {name} "
                                     f"{dname}: kernel disagrees with the "
                                     f"plain version or the contiguous "
                                     f"kernel: {rec}")
    return out, max(errs)


def memory_attention_cases(torch, flush):
    """The encoder-decoder's cached cross-attention
    (``layers.memory_attention``: T query rows against an S-slot frozen
    memory, every slot valid) on the card, through the decode-attention
    kernel over the persistent all-valid position row, against its plain
    version (``gqa_attention(causal=False)``, what the CPU runs) at
    seamless-m4t-medium's shapes (H 16 = Hkv, hd 64, S 1024 frames):
    the decode step (B 8, T 1: ``mma_keys``) and a chunk (B 1, T 128:
    ``mma_rows``), fp32 and bf16; the bf16 cases timed beside SDPA (no
    mask) and their bound (K/V and q read once, out written once; 4 B T
    H S hd operations)."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.kernel import plan
    from repro_torch.models import layers as L

    dev = torch.device("cuda")
    H, hd, S = 16, 64, 1024
    out, errs = [], []
    for name, B, T in (("cross_decode_seamless", 8, 1),
                       ("cross_chunk_seamless", 1, 128)):
        g = torch.Generator(device=dev).manual_seed(SEED)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            q = torch.randn((B, T, H, hd), generator=g, device=dev).to(dtype)
            k = torch.randn((B, S, H, hd), generator=g, device=dev).to(dtype)
            v = torch.randn((B, S, H, hd), generator=g, device=dev).to(dtype)
            got = L.memory_attention(q, k, v)
            want = L.gqa_attention(q, k, v, causal=False)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = bool(torch.isfinite(got).all().item()) \
                and err <= ATTN_TOL[dname]
            rec = {"phase": "kernels", "kernel": "decode_attention",
                   "case": name, "route": "memory_attention", "dtype": dname,
                   "B": B, "T": T, "S": S, "Hq": H, "Hkv": H, "hd": hd,
                   "plan": plan(B, T, H, H, S, hd, dtype)._asdict(),
                   "max_abs_err": err, "tol": ATTN_TOL[dname], "ok": ok}
            if dtype == torch.bfloat16:
                elt = q.element_size()
                nbytes = elt * (2 * B * S * H * hd + 2 * B * T * H * hd) \
                    + 4 * (S + B * T)
                flops = 4 * B * T * H * S * hd
                bms, by = bound_ms(nbytes, flops, dname)
                qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), \
                    v.transpose(1, 2)
                rec.update(
                    kernel_ms=median_ms(
                        torch, lambda: L.memory_attention(q, k, v), flush),
                    plain_ms=median_ms(
                        torch, lambda: L.gqa_attention(q, k, v,
                                                       causal=False), flush),
                    library_ms=median_ms(
                        torch, lambda: F.scaled_dot_product_attention(
                            qh, kh, vh), flush),
                    bound_ms=bms, bound_us=bms * 1e3, bound_by=by,
                    bytes=nbytes, flops=flops)
                rec.update(achieved(rec))
            emit(rec)
            out.append(rec)
            errs.append(err)
            if not ok:
                raise AssertionError(f"memory attention {name} {dname}: the "
                                     f"kernel disagrees with the plain "
                                     f"version: {rec}")
    return out, max(errs)


def host_us(torch, fn, n=200):
    """Host microseconds per call of ``fn``, enqueue only: a spin on the
    card (~5 ms) keeps the stream busy, so no call waits on the device."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(n * 50_000)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


#: (case, N, d, route, scale in the other dtype than the rows):
#: llama3.2-1b's d 2048 at a decode batch (N 8), a chunk (N 128) and
#: ``model.lm``'s forward (B 2 x L 1024 = N 2048); pixtral-12b's d 5120
#: in the Zoo's classifier forward (N 2048); mamba2-780m's d 1536 (ln1,
#: ln_f) at N 8 and 128, and its gated norm at d_in 3072 (f32 y, z a
#: slice of the 6448-wide in-projection row); each route once with an
#: f32 scale on bf16 rows and a bf16 scale on f32 rows
NORM_CASES = (("N8_d2048", 8, 2048, "add", False),
              ("N128_d2048", 128, 2048, "add", False),
              ("N8_d2048_no_residual", 8, 2048, "norm", False),
              ("N2048_d2048", 2048, 2048, "add", False),
              ("N2048_d5120", 2048, 5120, "add", False),
              ("N8_d1536", 8, 1536, "add", False),
              ("N128_d1536", 128, 1536, "add", False),
              ("N8_d3072_gated", 8, 3072, "gated", False),
              ("N128_d3072_gated", 128, 3072, "gated", False),
              ("N8_d1536_other_scale", 8, 1536, "add", True),
              ("N8_d2048_no_residual_other_scale", 8, 2048, "norm", True),
              ("N8_d3072_gated_other_scale", 8, 3072, "gated", True),
              # the hybrid: jamba's residual stream (d 8192) and its
              # gated norm at d_inner 16384, the kernel's MAX_D
              ("N8_d8192", 8, 8192, "add", False),
              ("N8_d16384_gated", 8, 16384, "gated", False),
              ("N128_d16384_gated", 128, 16384, "gated", False))
MAMBA2_PROJ = 6448       # mamba2-780m's in-projection width (z's stride)
JAMBA_PROJ = 33152       # jamba-1.5-large's (2 * 16384 + 2 * 128 + 128)


def rmsnorm_cases(torch, flush):
    """The CUDA norm against its plain version on its three routes at the
    shapes its paths give it (``NORM_CASES``), fp32 and bf16: max abs
    error within TOL (the gated route in bf16: within 2e-2 of max(1,
    |plain|) element by element, since one rounding step of a bf16
    output past 4 is 2^-5 and the sum of squares taken in another order
    may move one), bitwise equal across two launches; each timed against
    its bound, its plain version and, where one call computes the
    function, add + ``F.rms_norm`` (the gated route has none), with the
    wrapper's host microseconds per call (enqueue only)."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm.kernel import (
        fused_rmsnorm_cuda, gated_rmsnorm_cuda, plan)
    from repro_torch.kernels.rmsnorm.ref import (
        fused_rmsnorm_reference, gated_rmsnorm_reference)

    dev = torch.device("cuda")
    eps = 1e-5
    out, errs = [], []
    for case, N, d, route, other_scale in NORM_CASES:
        g = torch.Generator(device=dev).manual_seed(SEED)
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            elt = dtype.itemsize
            sdt = dtype if not other_scale else (
                torch.float32 if dtype == torch.bfloat16 else torch.bfloat16)
            scale = (1 + 0.1 * torch.randn((d,), generator=g, device=dev)
                     ).to(sdt)
            if route == "gated":
                y = torch.randn((N, d), generator=g, device=dev)
                proj = MAMBA2_PROJ if d < MAMBA2_PROJ else JAMBA_PROJ
                z = torch.randn((N, proj), generator=g,
                                device=dev).to(dtype)[:, :d]

                def kernel():
                    return gated_rmsnorm_cuda(y, z, scale, eps)

                def plain():
                    return gated_rmsnorm_reference(y, z, scale, eps)
                library = None
                # read y (f32) and z, write the output; silu (4), the
                # product, the square and sum, two scalings
                nbytes = N * d * (4 + 2 * elt) + sdt.itemsize * d
                flops = 9 * N * d
            else:
                x = torch.randn((N, d), generator=g, device=dev).to(dtype)
                r = torch.randn((N, d), generator=g, device=dev).to(dtype) \
                    if route == "add" else None

                def kernel():
                    return fused_rmsnorm_cuda(x, r, scale, eps)

                def plain():
                    return fused_rmsnorm_reference(x, r, scale, eps)

                def library():
                    return F.rms_norm(x if r is None else torch.add(x, r),
                                      (d,), scale, eps)
                if other_scale:   # one call takes one dtype
                    library = None
                # read x (and the residual), write y (and t)
                rw = 4 if route == "add" else 2
                nbytes = elt * rw * N * d + sdt.itemsize * d
                flops = (5 if route == "add" else 4) * N * d
            got, want = kernel(), plain()
            if route != "gated":
                got, want = got[0], want[0]
                t_err = (kernel()[1].float() - plain()[1].float()).abs().max()
            repeat = torch.equal(kernel() if route == "gated"
                                 else kernel()[0], got)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            if route != "gated":
                err = max(err, t_err.item())
                gate = err
            else:
                gate = (diff / want.float().abs().clamp(min=1)).max().item() \
                    if dtype == torch.bfloat16 else err
            ok = bool(torch.isfinite(got).all().item()) \
                and gate <= TOL[dname] and repeat
            bms, by = bound_ms(nbytes, flops, "float32")
            rec = {"phase": "kernels", "kernel": "rmsnorm", "case": case,
                   "route": route, "dtype": dname,
                   "scale_dtype": str(sdt).split(".")[1], "N": N, "d": d,
                   "plan": plan(N, d, dtype, route)._asdict(),
                   "max_abs_err": err, "gate_err": gate, "tol": TOL[dname],
                   "bitwise_repeat": repeat, "ok": ok,
                   "kernel_ms": median_ms(torch, kernel, flush),
                   "plain_ms": median_ms(torch, plain, flush),
                   "library_ms": None if library is None
                   else median_ms(torch, library, flush),
                   "host_us": host_us(torch, kernel),
                   "bound_ms": bms, "bound_us": bms * 1e3, "bound_by": by,
                   "bytes": nbytes, "flops": flops}
            emit(rec)
            out.append(rec)
            errs.append(err)
            if not ok:
                raise AssertionError(f"rmsnorm {case} {dname}: kernel "
                                     f"disagrees with the plain version or "
                                     f"with itself: {rec}")
    return out, max(errs)


def _int4pack_call(torch, x, qt):
    """``torch._weight_int4pack_mm`` set up for a symmetric int4 QTensor:
    the nibbles as unsigned ``q + 8`` (even rows in the high nibble, the
    layout ``_convert_weight_to_int4pack`` takes), zero points 0, so its
    ``(u - 8) * scale + zero`` is ``q * scale``. Returns the call."""
    from repro_torch.quant import unpack_int4
    K = x.shape[1]
    ng = qt["scale"].shape[0]
    u = (unpack_int4(qt["q4"]).T + 8).contiguous()          # (N, K)
    packed = ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8)
    w = torch._convert_weight_to_int4pack(packed, 8)
    sz = torch.stack([qt["scale"], torch.zeros_like(qt["scale"])], -1) \
        .to(torch.bfloat16).contiguous()                      # (ng, N, 2)
    return lambda: torch._weight_int4pack_mm(x, w, K // ng, sz)


def _int8pack_call(torch, x, qt):
    """``torch._weight_int8pack_mm``: x (M, K), weight (N, K) int8, one
    scale per output channel in x's dtype."""
    w = qt["q"].T.contiguous()
    s = qt["scale"].to(x.dtype)
    return lambda: torch._weight_int8pack_mm(x, w, s)


def _simt_call(torch, x, q, sc, bits):
    """The product on the ``simt`` route (the CUDA-core kernel that bf16
    took before the ``mma`` route, unchanged and still built for fp32
    and the shapes ``mma`` does not take), launched through the
    library's own entry point with ``plan``'s split: a yardstick timed
    in the same run."""
    from repro_torch.kernels.quant_matmul import kernel as K_
    M, K = x.shape
    N = q.shape[1]
    _, splits, kper = K_.plan(M, N, K)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    ws = torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
    fn = K_._launcher()
    stream = torch.cuda.current_stream().cuda_stream
    gs = K // sc.shape[0] if bits == 4 else 0

    def call():
        err = fn(x.data_ptr(), x.stride(0), q.data_ptr(), sc.data_ptr(),
                 out.data_ptr(), ws.data_ptr(), M, N, K, gs, kper, splits,
                 int(bits == 4), 1, stream)
        if err:
            raise RuntimeError(f"simt int{bits} launch failed: {err}")
        return out
    return call


def quant_matmul_cases(torch, flush):
    """Both dequantize-matmuls against their plain versions at every
    projection shape of llama3.2-1b, M in {1, 8, 37, 128} (decode, a
    ragged chunk tail, a full chunk) and, int8, M 16 (the spec variant's
    int8 self-draft window: 8 rows of 2 tokens), fp32 and bf16, plus a
    ragged N
    (200), K 34 (int4: an odd group of 17; int8: no multiple of 8), a K
    that is no multiple of the mma route's 64-row tile (2080), a strided
    x (a view of wider rows) and, for int4, a group of 64. Each case
    records its ``mma_plan`` route, which must be the rule's: bf16 on
    ``mma`` where N % 4 == 0 and, int4, the group is a multiple of 16
    or, int8, K a multiple of 8 (every ``mma`` case is also called twice
    and must be bitwise equal); fp32 and the rest on ``simt``.
    Tolerance: max|kernel - plain| <= tol * max|plain| (the sums run in
    another order; bf16 rounds the output). bf16 times at M 8 and 128
    (int8 also 16) for all four shapes, beside the plain version, a bf16 matmul on the
    dequantized weight (what quantization buys), PyTorch's own
    weight-only call where the card's PyTorch runs it and the same
    product on the ``simt`` route (``simt_ms``)."""
    from repro_torch.kernels.quant_matmul import kernel as K_
    from repro_torch.kernels.quant_matmul import ref as R_
    from repro_torch.quant import dequantize_tensor, quantize_tensor

    dev = torch.device("cuda")
    out = {8: [], 4: []}
    errs = {8: [], 4: []}
    library_note = {}
    for bits in (8, 4):
        name = f"quant_matmul_int{bits}"
        kern = K_.quant_matmul_int8_cuda if bits == 8 \
            else K_.quant_matmul_int4_cuda
        plain = R_.quant_matmul_int8_reference if bits == 8 \
            else R_.quant_matmul_int4_reference
        lib = _int8pack_call if bits == 8 else _int4pack_call
        qkey = "q" if bits == 8 else "q4"
        # (K, N, M, group, strided x)
        cases = [(K, N, M, 32, False) for K, N in QMM_SHAPES
                 for M in (1, 8, 37, 128)]
        cases += [(2048, 200, 8, 32, False), (2048, 200, 37, 32, False),
                  (34, 48, 1, 32, False), (34, 48, 37, 32, False),
                  (2080, 512, 8, 32, True), (2080, 512, 37, 32, False),
                  (2048, 8192, 8, 32, True), (2048, 512, 128, 32, True)]
        if bits == 4:
            cases += [(2048, 2048, M, 64, False)
                      for M in (1, 8, 37, 128)]
        else:
            # the int8 self-draft's window (8 rows of 2 tokens) at each
            # projection shape
            cases += [(K, N, 16, 32, False) for K, N in QMM_SHAPES]
        g = torch.Generator(device=dev).manual_seed(SEED)
        weights = {}
        for K, N, M, gs, strided in cases:
            if (K, N, gs) not in weights:
                w = 0.02 * torch.randn((K, N), generator=g, device=dev)
                weights[K, N, gs] = quantize_tensor(w, bits=bits,
                                                    group_size=gs)
            qt = weights[K, N, gs]
            q, sc = qt[qkey], qt["scale"]
            group = K // sc.shape[0] if bits == 4 else None
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype).split(".")[1]
                x = torch.randn((M, K + 64 * strided), generator=g,
                                device=dev).to(dtype)[:, :K]
                got = kern(x, q, sc)
                want = plain(x, q, sc)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ref_max = want.float().abs().max().item()
                ok = bool(torch.isfinite(got).all().item()) \
                    and got.dtype == dtype and got.shape == (M, N) \
                    and err <= TOL[dname] * ref_max
                pl = K_.mma_plan(bits, M, N, K, group or 0, dtype)
                route, blocks, splits = pl.route, pl.blocks, pl.splits
                fits = group % 16 == 0 if bits == 4 else K % 8 == 0
                ok = ok and route == ("mma" if dtype == torch.bfloat16
                                      and N % 4 == 0 and fits else "simt")
                rec = {"phase": "kernels", "kernel": name,
                       "case": f"K{K}_N{N}_M{M}" + (f"_gs{group}" if bits
                                                     == 4 and group != 32
                                                     else "")
                       + ("_strided" if strided else ""),
                       "dtype": dname, "M": M, "K": K, "N": N,
                       "group": group, "route": route, "blocks": blocks,
                       "splits": splits, "max_abs_err": err,
                       "max_abs_plain": ref_max,
                       "rel_err": err / ref_max if ref_max else err,
                       "tol_rel": TOL[dname], "ok": ok}
                if route == "mma":
                    rec["bitwise_repeat"] = bool(torch.equal(
                        kern(x, q, sc), got))
                    rec["ok"] = ok = ok and rec["bitwise_repeat"]
                if (K, N) in QMM_SHAPES and group in (None, 32) \
                        and not strided and M in (8, 16, 128) \
                        and dtype == torch.bfloat16:
                    elt = x.element_size()
                    nbytes = M * K * elt + q.numel() + 4 * sc.numel() \
                        + M * N * elt
                    flops = 2 * M * K * N
                    bms, by = bound_ms(nbytes, flops, dname)
                    w_bf16 = dequantize_tensor(qt, torch.bfloat16)
                    rec.update(
                        kernel_ms=median_ms(torch, lambda: kern(x, q, sc),
                                            flush),
                        plain_ms=median_ms(torch, lambda: plain(x, q, sc),
                                           flush),
                        dense_bf16_ms=median_ms(
                            torch, lambda: torch.matmul(x, w_bf16), flush),
                        bound_ms=bms, bound_us=bms * 1e3, bound_by=by,
                        bytes=nbytes, flops=flops, library_ms=None)
                    rec.update(achieved(rec))
                    simt = _simt_call(torch, x, q, sc, bits)
                    serr = (simt().float() - want.float()).abs().max()
                    rec["simt_max_abs_err"] = serr.item()
                    rec["simt_ms"] = median_ms(torch, simt, flush)
                    try:
                        call = lib(torch, x, qt)
                        lerr = (call().float() - want.float()).abs().max() \
                            .item()
                        rec["library_max_abs_err"] = lerr
                        if lerr <= TOL[dname] * ref_max:
                            rec["library_ms"] = median_ms(torch, call, flush)
                        else:
                            library_note[bits] = (
                                f"the library call disagrees with the "
                                f"plain version: {lerr}")
                    except Exception as e:          # noqa: BLE001
                        library_note[bits] = \
                            f"{type(e).__name__}: {str(e)[:200]}"
                    if library_note.get(bits):
                        rec["library_note"] = library_note[bits]
                emit(rec)
                out[bits].append(rec)
                errs[bits].append(err)
                if not ok:
                    raise AssertionError(f"{name} {rec['case']} {dname}: "
                                         f"kernel disagrees with the plain "
                                         f"version: {rec}")
    return out, {b: max(e) for b, e in errs.items()}


def _ssd_inputs(torch, g, b, l, h, p, groups, n, dtype):
    """x, dt, A, B, C, D and a state (b, h, p, n) from the generator:
    x, B, C ~ N(0, 1) in ``dtype``, dt in [0.001, 0.101), A in (-2, -0.5],
    D ~ N(0, 1), the state ~ N(0, 1); all but x, B, C in f32."""
    dev = torch.device("cuda")
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)  # noqa
    return (rnd(b, l, h, p).to(dtype),
            0.001 + 0.1 * torch.rand((b, l, h), generator=g, device=dev),
            -0.5 - 1.5 * torch.rand((h,), generator=g, device=dev),
            rnd(b, l, groups, n).to(dtype), rnd(b, l, groups, n).to(dtype),
            rnd(h), rnd(b, h, p, n))


def _rel_err(pairs):
    """max |kernel - plain| over the pairs, over max |plain|."""
    err = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
    scale = max(b.float().abs().max().item() for _, b in pairs)
    return err / scale


def ssd_extend_cases(torch, flush):
    """The recurrence kernel against its plain version (a loop of plain
    steps) at mamba2's decode (B 8, T 1), chunk (B 1, T 128) and spec
    verify (B 8, T 5: the n-gram drafter's window) shapes and at the
    reduced dims with 2 groups and a ragged T 5, in the form
    the model calls it (new state in place, the incoming one to the
    checkpoint), each on the route and grid ``extend_plan`` gives it:
    max|kernel - plain| <= 1e-4 * max|plain| in f32. Exact gates:
    extending by t1 then the rest gives the bits of extending by T at t1
    = 1 (a T = 1 launch, the decode route, then the chunk route), the
    tile's edges (tile - 1, tile, tile + 1), 37 and T // 2; a row with dt
    = 0 keeps its state bit for bit; ``ssd_step`` on CUDA equals the T =
    1 launch; the checkpoint equals the incoming state. Then the T sweep
    at b 1 (``ssd_extend_sweep``)."""
    from repro_torch.kernels.ssd_scan.kernel import (EXT_TILE, extend_plan,
                                                     ssd_extend_cuda)
    from repro_torch.kernels.ssd_scan.ops import ssd_step
    from repro_torch.kernels.ssd_scan.ref import ssd_extend_reference

    cases = [("decode", 8, 1, SSD_FULL), ("chunk", 1, 128, SSD_FULL),
             ("reduced_g2_T5", 2, 5, SSD_REDUCED_G2),
             ("verify_T5", 8, 5, SSD_FULL),
             ("jamba_decode", 8, 1, SSD_JAMBA),
             ("jamba_T16", 8, 16, SSD_JAMBA)]
    out, errs = [], []
    for name, b, T, (h, p, groups, n) in cases:
        g = torch.Generator(device="cuda").manual_seed(SEED)
        x, dt, A, B, C, D, s0 = _ssd_inputs(torch, g, b, T, h, p, groups,
                                            n, torch.float32)
        state, ckpt = s0.clone(), torch.empty_like(s0)
        y, s = ssd_extend_cuda(state, x, dt, A, B, C, D, out=state,
                               ckpt=ckpt)
        y0, s1 = ssd_extend_reference(s0, x, dt, A, B, C, D)
        splits = sorted(t for t in {1, EXT_TILE - 1, EXT_TILE, EXT_TILE + 1,
                                    37, T // 2} if 0 < t < T)
        split_equal = True
        for t1 in splits:
            ya, sa = ssd_extend_cuda(s0, x[:, :t1], dt[:, :t1], A,
                                     B[:, :t1], C[:, :t1], D)
            yb, sb = ssd_extend_cuda(sa, x[:, t1:], dt[:, t1:], A,
                                     B[:, t1:], C[:, t1:], D)
            split_equal = split_equal and torch.equal(
                torch.cat([ya, yb], 1), y) and torch.equal(sb, s)
        dt0 = dt.clone()
        dt0[0] = 0.0
        _, sz = ssd_extend_cuda(s0, x, dt0, A, B, C, D)
        y_step, s_step = ssd_step(s0, x[:, 0], dt[:, 0], A, B[:, 0],
                                  C[:, 0], D)
        y_k1, s_k1 = ssd_extend_cuda(s0, x[:, :1], dt[:, :1], A, B[:, :1],
                                     C[:, :1], D)
        torch.cuda.synchronize()
        rel = _rel_err([(y, y0), (s, s1)])
        rec = {"phase": "kernels", "kernel": "ssd_extend", "case": name,
               "dtype": "float32", "B": b, "T": T, "h": h, "p": p,
               "g": groups, "n": n,
               "plan": extend_plan(b, T, h, p, groups, n)._asdict(),
               "max_rel_err": rel,
               "max_abs_err": max((y - y0).abs().max().item(),
                                  (s - s1).abs().max().item()),
               "tol_rel": SSD_TOL_REL,
               "split_at": splits, "split_bitwise_equal": split_equal,
               "dt0_row_unchanged": torch.equal(sz[0], s0[0]),
               "ssd_step_equals_T1_kernel": torch.equal(y_step, y_k1[:, 0])
               and torch.equal(s_step, s_k1),
               "ckpt_equals_incoming": torch.equal(ckpt, s0)}
        rec["ok"] = bool(torch.isfinite(y).all().item()) \
            and rel <= SSD_TOL_REL and split_equal \
            and rec["dt0_row_unchanged"] \
            and rec["ssd_step_equals_T1_kernel"] \
            and rec["ckpt_equals_incoming"]
        if name in ("decode", "chunk", "verify_T5", "jamba_decode",
                    "jamba_T16"):
            bms, by, nbytes, flops = _ssd_extend_bound(s0, x, dt, B, C)
            sbuf, cbuf = torch.empty_like(s0), torch.empty_like(s0)
            rec.update(
                kernel_ms=median_ms(torch, lambda: ssd_extend_cuda(
                    s0, x, dt, A, B, C, D, out=sbuf, ckpt=cbuf), flush),
                plain_ms=median_ms(torch, lambda: ssd_extend_reference(
                    s0, x, dt, A, B, C, D), flush),
                library_ms=None, bound_ms=bms, bound_us=bms * 1e3,
                bound_by=by, bytes=nbytes, flops=flops)
        emit(rec)
        out.append(rec)
        errs.append(rec["max_abs_err"])
        if not rec["ok"]:
            raise AssertionError(f"ssd_extend {name}: kernel disagrees "
                                 f"with the plain version or an exact gate "
                                 f"failed: {rec}")
    out.append(ssd_extend_sweep(torch, flush))
    return out, max(errs)


def _ssd_extend_bound(s0, x, dt, B, C):
    """(bound ms, "bytes" or "operations", bytes, operations) of one
    extend call: each input read once (state, x, dt, B, C, A, D), each
    output written once (y, x's shape; the new state; the checkpoint);
    per token and head 5 p n operations (decay, update, readout) + 3 p."""
    b, T, h, p = x.shape
    n = s0.shape[-1]
    nbytes = 4 * (3 * s0.numel() + 2 * x.numel() + dt.numel() + B.numel()
                  + C.numel() + 2 * h)
    flops = b * T * h * (5 * p * n + 3 * p)
    return bound_ms(nbytes, flops, "float32") + (nbytes, flops)


def ssd_extend_sweep(torch, flush):
    """The recurrence kernel's time at b 1 and mamba2's dims over T in
    ``SSD_SWEEP_T`` (its own inputs each), and the least-squares line ms
    = fixed + per_token * T through them: the fixed part is the launch,
    the state's load and store and the first tile's round trip, the
    per-token part the recurrence."""
    import numpy as np

    from repro_torch.kernels.ssd_scan.kernel import (extend_plan,
                                                     ssd_extend_cuda)
    h, p, groups, n = SSD_FULL
    ms, bounds = [], []
    for T in SSD_SWEEP_T:
        g = torch.Generator(device="cuda").manual_seed(SEED)
        x, dt, A, B, C, D, s0 = _ssd_inputs(torch, g, 1, T, h, p, groups,
                                            n, torch.float32)
        sbuf, cbuf = torch.empty_like(s0), torch.empty_like(s0)
        ms.append(median_ms(torch, lambda: ssd_extend_cuda(
            s0, x, dt, A, B, C, D, out=sbuf, ckpt=cbuf), flush))
        bounds.append(_ssd_extend_bound(s0, x, dt, B, C)[0])
    per_token, fixed = np.polyfit(np.array(SSD_SWEEP_T, dtype=float),
                                  np.array(ms), 1)
    rec = {"phase": "kernels", "kernel": "ssd_extend", "case": "sweep_b1",
           "h": h, "p": p, "g": groups, "n": n, "T": list(SSD_SWEEP_T),
           "sweep_ms": ms, "sweep_bound_ms": bounds,
           "plans": [extend_plan(1, T, h, p, groups, n)._asdict()
                     for T in SSD_SWEEP_T],
           "fixed_ms": float(fixed), "per_token_us": float(per_token) * 1e3}
    emit(rec)
    return rec


def _ssd_bound(x, B, C, dt, b, l, h, p, n, chunk, dtype):
    """(bound ms, "bytes" or "operations", bytes, operations) of one
    dual-form call at ``dtype``'s peak: bytes, x, B, C in their dtype,
    dt, A, D, y and the final state in f32; operations of the unmasked
    (i, j <= i) pairs only (scores 2n, weight 3, product with x 2p) and,
    per position, the carried state's readout and update 4 p n and D*x
    2p, counted at the caller's chunk."""
    Q = chunk
    per_chunk = Q * (Q + 1) // 2 * (2 * n + 2 * p + 3) \
        + Q * (4 * p * n + 2 * p)
    flops = b * h * (l // Q) * per_chunk
    nbytes = x.element_size() * (x.numel() + B.numel() + C.numel()) \
        + 4 * (dt.numel() + 2 * h + b * l * h * p + b * h * p * n)
    return bound_ms(nbytes, flops, dtype) + (nbytes, flops)


def ssd_cases(torch, flush):
    """The chunked kernel against its plain version at mamba2's full dims
    (b 1, l 1024 and b 2, l 512 at chunk 256), and at the reduced dims
    with 2 groups at chunk 32 (from zero and from a given state), with
    f32 and bf16 x, B, C, each on the route ``chunk_plan`` gives it:
    max|kernel - plain| <= 1e-4 * max|plain| over y and the final state
    (both compute in f32 from the same inputs; the bf16 route's split
    pairs keep 16 bits of each f32 operand), two calls bitwise equal. The
    bf16 full-dims cases are timed: the call, each sub-step of the mma
    route alone ((a) chunk states, (b) the state pass, (c) the outputs,
    CUDA events on one set of buffers), and at b 1, l 1024 the call at
    every sub-chunk the kernels hold; ``bound_ms`` at the route's peak
    (bf16 tensor cores), ``bound_ms_cuda_cores`` at f32's."""
    from repro_torch.kernels.ssd_scan import kernel as K
    from repro_torch.kernels.ssd_scan.ref import ssd_reference

    cases = [("b1_l1024", 1, 1024, SSD_FULL, 256, False),
             ("b2_l512", 2, 512, SSD_FULL, 256, False),
             ("reduced_g2_l64", 2, 64, SSD_REDUCED_G2, 32, False),
             ("reduced_g2_l64_init", 2, 64, SSD_REDUCED_G2, 32, True),
             ("jamba_b1_l1024", 1, 1024, SSD_JAMBA, 256, False)]
    out, errs = [], []
    for name, b, l, (h, p, groups, n), chunk, init in cases:
        g = torch.Generator(device="cuda").manual_seed(SEED)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            x, dt, A, B, C, D, s0 = _ssd_inputs(torch, g, b, l, h, p,
                                                groups, n, dtype)
            s0 = s0 if init else None
            pl = K.chunk_plan(b, l, h, p, n, chunk, dtype)
            y, s = K.ssd_cuda(x, dt, A, B, C, D, chunk=chunk,
                              initial_state=s0)
            y2, s2 = K.ssd_cuda(x, dt, A, B, C, D, chunk=chunk,
                                initial_state=s0)
            y0, s1 = ssd_reference(x, dt, A, B, C, D, chunk=chunk,
                                   initial_state=s0)
            torch.cuda.synchronize()
            rel = _rel_err([(y, y0), (s, s1)])
            rec = {"phase": "kernels", "kernel": "ssd", "case": name,
                   "dtype": dname, "b": b, "l": l, "h": h, "p": p,
                   "g": groups, "n": n, "chunk": chunk,
                   "initial_state": init, "route": pl.route,
                   "plan": pl._asdict(), "max_rel_err": rel,
                   "max_abs_err": max((y - y0).abs().max().item(),
                                      (s - s1).abs().max().item()),
                   "tol_rel": SSD_TOL_REL,
                   "bitwise_repeat": torch.equal(y, y2)
                   and torch.equal(s, s2)}
            rec["ok"] = bool(torch.isfinite(y).all().item()) \
                and rel <= SSD_TOL_REL and rec["bitwise_repeat"]
            if b * l == 1024 and dtype == torch.bfloat16:
                peak = "bfloat16" if pl.route == "mma" else "float32"
                bms, by, nbytes, flops = _ssd_bound(x, B, C, dt, b, l, h, p,
                                                    n, chunk, peak)
                bufs = K.chunk_buffers(pl, b, l, h, p, n, x.device)

                def sub_step(mask, sub=0):
                    return lambda: K._launch_chunk(
                        x, dt, A, B, C, D, chunk, None, sub=sub,
                        steps=mask, bufs=bufs)

                rec.update(
                    kernel_ms=median_ms(torch, lambda: K.ssd_cuda(
                        x, dt, A, B, C, D, chunk=chunk), flush),
                    plain_ms=median_ms(torch, lambda: ssd_reference(
                        x, dt, A, B, C, D, chunk=chunk), flush),
                    library_ms=None, bound_ms=bms, bound_us=bms * 1e3,
                    bound_by=by, bound_peak=peak,
                    bound_ms_cuda_cores=_ssd_bound(
                        x, B, C, dt, b, l, h, p, n, chunk, "float32")[0],
                    bytes=nbytes, flops=flops)
                if pl.route == "mma":
                    rec["substep_ms"] = {
                        k: median_ms(torch, sub_step(m), flush)
                        for k, m in (("a_states", 1), ("b_pass", 2),
                                     ("c_outputs", 4))}
                    if b == 1:
                        rec["sub_ms"] = {}
                        for q in (16, 32, 64, 128):
                            qp = K.chunk_plan(b, l, h, p, n, chunk, dtype,
                                              q)
                            bufs = K.chunk_buffers(qp, b, l, h, p, n,
                                                   x.device)
                            rec["sub_ms"][q] = median_ms(
                                torch, sub_step(K.STEPS_ALL, q), flush)
                rec.update(achieved(rec))
            emit(rec)
            out.append(rec)
            errs.append(rec["max_abs_err"])
            if not rec["ok"]:
                raise AssertionError(f"ssd {name} {dname}: kernel "
                                     f"disagrees with the plain version or "
                                     f"is not repeatable: {rec}")
    return out, max(errs)


def flash_attention_cases(torch, flush):
    """The flash kernel against its plain version (the port of
    ``ref.attention_reference``, GQA heads expanded) at the shapes of the
    Zoo's services: pixtral-12b's attention (hd 160, G 4) and
    llama3.2-1b's (hd 64, G 4) at B 2, L 1024 in bf16, a G = 1 case at
    hd 128, a window of 256 (whose first live tile is wholly masked for
    some rows: the finite NEG_INF case), ``causal=False``, a ragged L of
    1000, hd 40 (zero-padded k-steps on the 64 tile), G 8 and an fp32
    case. Every case is timed beside the plain version and SDPA (an
    explicit mask for the window, a yardstick only); the bound counts q,
    k, v and o once and 4 B Hq hd operations per live query-key pair.
    Each case records its plan (route, head-dim tile) and the rates it
    reached. Its backward is the ``kernels_bwd`` phase's
    (``flash_bwd_cases``)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda, plan)
    from repro_torch.kernels.flash_attention.ref import attention_reference

    dev = torch.device("cuda")
    # (name, B, L, Hq, Hkv, hd, dtype, causal, window[, Lk]): Lk = L
    # unless given
    cases = [
        ("pixtral12b", 2, 1024, 32, 8, 160, "bfloat16", True, 0),
        ("llama1b", 2, 1024, 32, 8, 64, "bfloat16", True, 0),
        ("g1_hd128", 2, 1024, 8, 8, 128, "bfloat16", True, 0),
        ("window256", 2, 1024, 32, 8, 64, "bfloat16", True, 256),
        ("non_causal", 2, 1024, 32, 8, 64, "bfloat16", False, 0),
        ("ragged_L1000", 2, 1000, 32, 8, 160, "bfloat16", True, 0),
        ("hd40", 2, 1024, 32, 8, 40, "bfloat16", True, 0),
        ("g8", 2, 1024, 32, 4, 64, "bfloat16", True, 0),
        ("fp32", 2, 1024, 32, 8, 64, "float32", True, 0),
        # starcoder2-15b's G 12 (bq 5 query positions a block) and
        # gemma2-9b-class's hd 256 under its 4096-token window
        ("g12_hd128", 2, 1024, 48, 4, 128, "bfloat16", True, 0),
        ("gemma2_hd256_window4096", 1, 6144, 16, 8, 256, "bfloat16", True,
         4096),
        # seamless-m4t-medium, non-causal at G 1: the encoder's
        # self-attention over 1024 frames and the cache-free
        # cross-attention of 128 text rows against them (Lq != Lk)
        ("seamless_encoder", 1, 1024, 16, 16, 64, "bfloat16", False, 0),
        ("seamless_cross_Lq128", 1, 128, 16, 16, 64, "bfloat16", False, 0,
         1024),
    ]
    out, errs = [], []
    for name, B, L, Hq, Hkv, hd, dname, causal, window, *lk in cases:
        Lk = lk[0] if lk else L
        g = torch.Generator(device=dev).manual_seed(SEED)
        dtype = getattr(torch, dname)
        q = torch.randn((B, L, Hq, hd), generator=g, device=dev).to(dtype)
        k = torch.randn((B, Lk, Hkv, hd), generator=g, device=dev).to(dtype)
        v = torch.randn((B, Lk, Hkv, hd), generator=g, device=dev).to(dtype)
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

        def plain():     # what ops.mha_attention runs for CPU tensors
            rep = Hq // Hkv
            return attention_reference(
                qh, kh.repeat_interleave(rep, dim=1),
                vh.repeat_interleave(rep, dim=1), causal=causal,
                window=window)

        got = flash_attention_cuda(q, k, v, causal=causal, window=window)
        want = plain().transpose(1, 2)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = bool(torch.isfinite(got).all().item()) and err <= TOL[dname]
        pos = torch.arange(L, device=dev)
        mask = torch.ones((L, Lk), dtype=torch.bool, device=dev)
        if causal:
            mask &= pos[None] <= pos[:, None]
        if window:
            mask &= pos[None] > pos[:, None] - window
        pairs = int(mask.sum().item())
        nbytes = q.element_size() * 2 * (q.numel() + k.numel())
        flops = 4 * B * Hq * hd * pairs
        bms, by = bound_ms(nbytes, flops, dname)
        if window:
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qh, kh, vh, attn_mask=mask, enable_gqa=True)
        else:
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qh, kh, vh, is_causal=causal, enable_gqa=True)
        rec = {"phase": "kernels", "kernel": "flash_attention",
               "case": name, "dtype": dname, "B": B, "L": L, "Lk": Lk,
               "Hq": Hq,
               "Hkv": Hkv, "hd": hd, "causal": causal, "window": window,
               "plan": plan(B, L, Hq, Hkv, hd, dtype)._asdict(),
               "live_pairs": pairs, "max_abs_err": err, "tol": TOL[dname],
               "ok": ok,
               "kernel_ms": median_ms(torch, lambda: flash_attention_cuda(
                   q, k, v, causal=causal, window=window), flush),
               "plain_ms": median_ms(torch, plain, flush),
               "library_ms": median_ms(torch, sdpa, flush),
               "bound_ms": bms, "bound_us": bms * 1e3, "bound_by": by,
               "bytes": nbytes, "flops": flops}
        rec.update(achieved(rec))
        emit(rec)
        out.append(rec)
        errs.append(err)
        if not ok:
            raise AssertionError(f"flash_attention {name}: kernel "
                                 f"disagrees with the plain version: {rec}")
    return out, max(errs)


def card_tests(during=None):
    """The repository's card tests (``tests/test_torch_card.py``), run
    as the README names them: without ``tests/conftest.py``, which
    imports JAX, absent here. Fails unless pytest exits 0 with at least
    one test passed and none skipped. The tests run in a process of
    their own while this one runs ``during`` (work that times nothing
    on the card); the process is killed if it outlives 600 s or
    ``during`` raises."""
    import re
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda",
           "-q", "-p", "no:cacheprovider", "tests/test_torch_card.py"]
    import tempfile
    t0 = time.perf_counter()
    # files, not pipes: nothing reads a pipe while ``during`` runs
    with tempfile.TemporaryFile("w+") as out, \
            tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen(cmd, cwd=root, stdout=out, stderr=err,
                                text=True, env=dict(
                                    os.environ,
                                    PYTHONPATH=str(root / "src")))
        try:
            if during is not None:
                during()
            proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        out.seek(0)
        err.seek(0)
        r = subprocess.CompletedProcess(cmd, proc.returncode, out.read(),
                                        err.read())
    tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    count = {k: int(n) for n, k in re.findall(
        r"(\d+) (passed|skipped|failed|errors?|deselected)", tail)}
    rec = {"phase": "card_tests", "command": " ".join(cmd[1:]),
           "returncode": r.returncode, "summary": tail, "counts": count,
           "seconds": time.perf_counter() - t0}
    rec["ok"] = r.returncode == 0 and count.get("passed", 0) >= 1 \
        and count.get("skipped", 0) == 0
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"card tests failed:\n{r.stdout[-6000:]}\n"
                             f"{r.stderr[-3000:]}")


# --------------------------------------------------------------------- #
# phase 4: 2-layer full-width model, card against CPU
# --------------------------------------------------------------------- #
def model_check(torch, variant="", quant="", phase="model",
                arch="llama3.2-1b"):
    """The 2-layer full-width fp32 model on the card against the same
    model on the CPU: a 128-token extend and 8 greedy decode steps, logits
    within 2e-3 and tokens identical. ``variant``/``quant`` as in the
    serve CLI (the weights, from one seed, quantized on the CPU and
    copied to the card); a ``reduced`` variant keeps its own depth."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build
    from repro_torch.quant import quantize_for_cfg

    cfg = get_arch(arch, variant=variant).replace(
        n_layers=2, dtype="float32", param_dtype="float32")
    if quant:
        cfg = cfg.replace(quant=quant)
    t0 = time.perf_counter()
    cpu = build(cfg, "cpu")
    gpu = build(cfg, "cuda")
    p_cpu = quantize_for_cfg(cpu.init(SEED), cfg)
    p_gpu = _tree_to(p_cpu, gpu.device)
    kernels.reset_launch_counts()
    tokens = np.random.default_rng(SEED).integers(0, cfg.vocab, 128)
    tol = 2e-3
    runs = {}
    for name, model, params in (("cpu", cpu, p_cpu), ("gpu", gpu, p_gpu)):
        cache = model.make_cache(1, 256)
        toks = torch.from_numpy(tokens).to(model.device)[None]
        logits, _ = model.extend_into_cache(params, toks, cache)
        seq, steps = [int(logits[0, -1].argmax())], [logits[0].cpu()]
        for _ in range(8):
            tok = torch.tensor([[seq[-1]]], device=model.device)
            logits, _ = model.decode_step(params, tok, cache)
            steps.append(logits[0].cpu())
            seq.append(int(logits[0, -1].argmax()))
        runs[name] = (seq, steps)
    err = max((a - b).abs().max().item()
              for a, b in zip(runs["cpu"][1], runs["gpu"][1]))
    rec = {"phase": phase, "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype, "extend_T": 128,
           "decode_steps": 8, "logits_max_abs_err": err, "tol": tol,
           "tokens_gpu": runs["gpu"][0], "tokens_cpu": runs["cpu"][0],
           "seconds": time.perf_counter() - t0}
    if quant or variant:
        rec.update(quant=cfg.quant, kv_quant=cfg.kv_quant,
                   launches_gpu=kernels.launch_counts())
    rec["ok"] = err <= tol and runs["gpu"][0] == runs["cpu"][0]
    if cfg.quant:                  # the card's run went through the kernel
        rec["ok"] = rec["ok"] and \
            rec["launches_gpu"][f"quant_matmul_{cfg.quant}"] > 0
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"card and CPU disagree: {rec}")


def _ssm_pair():
    """A 2-layer full-width mamba2-780m in fp32 on the CPU and on the card,
    the same seed-0 weights on both."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build

    cfg = get_arch("mamba2-780m").replace(n_layers=2, dtype="float32",
                                          param_dtype="float32")
    cpu, gpu = build(cfg, "cpu"), build(cfg, "cuda")
    p_cpu = cpu.init(SEED)
    return cfg, (("cpu", cpu, p_cpu), ("gpu", gpu, _tree_to(p_cpu, "cuda")))


def model_ssm(torch, pair):
    """The 2-layer full-width fp32 mamba2 on the card against the CPU: a
    128-token ``prefill`` (the chunked kernel, cache returned) then 8
    greedy decode steps, and a 128-token extend on a fresh cache (the
    recurrence kernel) then 8 decode steps. Logits within 2e-3, greedy
    tokens identical, both SSD kernels launched on the card. Returns the
    card run's launch counts."""
    import numpy as np

    from repro_torch import kernels

    cfg, runs_on = pair
    tokens = np.random.default_rng(SEED).integers(0, cfg.vocab, 128)
    tol = 2e-3
    t0 = time.perf_counter()
    runs = {}
    kernels.reset_launch_counts()
    for name, model, params in runs_on:
        toks = torch.from_numpy(tokens).to(model.device)[None]
        out = {}
        for path in ("prefill", "extend"):
            cache = model.make_cache(1, 256)
            if path == "prefill":
                logits, _ = model.prefill(params, {"tokens": toks}, cache)
            else:
                logits, _ = model.extend_into_cache(params, toks, cache)
            seq, steps = [int(logits[0, -1].argmax())], [logits[0].cpu()]
            for _ in range(8):
                tok = torch.tensor([[seq[-1]]], device=model.device)
                logits, _ = model.decode_step(params, tok, cache)
                steps.append(logits[0].cpu())
                seq.append(int(logits[0, -1].argmax()))
            out[path] = (seq, steps)
        runs[name] = out
    counts = kernels.launch_counts()
    rec = {"phase": "model_ssm", "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype, "prompt": 128,
           "decode_steps": 8, "tol": tol, "launches_gpu": counts,
           "seconds": time.perf_counter() - t0}
    ok = counts["ssd"] > 0 and counts["ssd_extend"] > 0
    for path in ("prefill", "extend"):
        err = max((a - b).abs().max().item() for a, b in
                  zip(runs["cpu"][path][1], runs["gpu"][path][1]))
        rec[f"{path}_logits_max_abs_err"] = err
        rec[f"{path}_tokens_gpu"] = runs["gpu"][path][0]
        rec[f"{path}_tokens_cpu"] = runs["cpu"][path][0]
        ok = ok and err <= tol \
            and runs["gpu"][path][0] == runs["cpu"][path][0]
    rec["ok"] = ok
    emit(rec)
    if not ok:
        raise AssertionError(f"card and CPU disagree: {rec}")
    return counts


def serve_ssm_check(torch, pair):
    """The 2-layer fp32 mamba2 through ``Engine`` on the card and on the
    CPU: 4 requests of 16-96 tokens, 8 new each, 2 slots, chunks of 32,
    so slots are reused and steps mix decode rows with a chunk. Greedy
    tokens identical."""
    import numpy as np

    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request
    from repro_torch.serving.sampler import Sampler

    cfg, runs_on = pair
    rng = np.random.default_rng(SEED + 3)
    prompts = [rng.integers(0, cfg.vocab, int(L))
               for L in rng.integers(16, 97, 4)]
    got = {}
    for name, model, params in runs_on:
        engine = Engine(model, params, max_batch=2, cache_len=128,
                        prefill_chunk=32, sampler=Sampler(), seed=SEED)
        for uid, prompt in enumerate(prompts):
            engine.submit(Request(uid=uid, prompt=prompt, max_new_tokens=8))
        got[name] = ({u: r.tokens for u, r in engine.run().items()},
                     engine.step_kinds)
    same = [u for u in got["cpu"][0] if got["cpu"][0][u] == got["gpu"][0][u]]
    rec = {"phase": "serve_ssm_check", "arch": cfg.name,
           "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "prompt_lens": [len(x) for x in prompts], "max_new_tokens": 8,
           "max_batch": 2, "prefill_chunk": 32,
           "mixed_steps": got["gpu"][1].count("mixed"),
           "plain_steps": got["gpu"][1].count("plain"),
           "requests_equal": len(same), "tokens_gpu": got["gpu"][0]}
    rec["ok"] = len(same) == len(prompts) == len(got["gpu"][0]) \
        and all(len(t) == 8 for t in got["gpu"][0].values())
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"serve_ssm_check failed: {rec}")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


# --------------------------------------------------------------------- #
# the Zoo: model services card against CPU, then the paper's deployment
# example at full width
# --------------------------------------------------------------------- #
def _launch_delta(before, after):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _ms_matching(rows, part):
    """Device ms and launches of the kernels whose name holds ``part``."""
    hit = [(ms, c) for ms, c, k in rows if part in k]
    return {"ms": sum(ms for ms, _ in hit), "calls": sum(c for _, c in hit)}


def _ms_by_template(rows, part):
    """``_ms_matching`` of the kernels whose name holds ``part``, and the
    same split by their template arguments (one entry per route where
    the routes are distinct templates)."""
    import re
    out, per = _ms_matching(rows, part), {}
    for ms, c, k in rows:
        if part in k:
            m = re.search(re.escape(part) + r"\w*<([^<>]*)>", k)
            t = per.setdefault(m.group(1) if m else k[:60],
                               {"ms": 0.0, "calls": 0})
            t["ms"] += ms
            t["calls"] += c
    return dict(out, templates=per)


def _ms_by_kernel(rows, inc, out=None):
    """``_ms_matching`` of the kernels whose name holds ``inc`` (and not
    ``out``), and the same for each kernel template apart (its name
    without ``void``, the namespace and the argument list)."""
    hit = [(ms, c, k) for ms, c, k in rows
           if inc in k and (out is None or out not in k)]
    per = {}
    for ms, c, k in hit:
        name = k.replace("void ", "").replace("(anonymous namespace)::", "")
        t = per.setdefault(name.split("(")[0], {"ms": 0.0, "calls": 0})
        t["ms"] += ms
        t["calls"] += c
    return {"ms": sum(ms for ms, _, _ in hit),
            "calls": sum(c for _, c, _ in hit), "templates": per}


def _profiled(torch, fn):
    """Run ``fn`` in a profile window and return the profiler and the
    wall ms of ``fn`` (synchronized). The window opens and closes with
    ``PROFILE_LEAD`` spin kernels each, which ``_device_rows`` counts
    apart: the profiler loses device records of a window once the
    process has run a while (none in its first window; 0–24 a window
    over a run, once 293), most at the window's end (the last step's
    kernels: a whole spec step or a forward while a few lead spins were
    lost), so the trailing spins take that loss in place of ``fn``'s
    kernels, and the spins it lost measure it."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_LEAD):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        for _ in range(PROFILE_LEAD):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    return prof, wall_ms


def _device_rows(prof):
    """(device ms, calls, kernel) of a profile window, largest first,
    without the window's lead and trailing spins, and how many of the
    spins the profiler lost."""
    from torch.autograd import DeviceType

    rows, spins = [], 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            if "spin_kernel" in e.key:
                spins += e.count
            else:
                rows.append((getattr(e, "device_time_total",
                                     getattr(e, "cuda_time_total", 0.0))
                             / 1e3, e.count, e.key))
    return sorted(rows, reverse=True), 2 * PROFILE_LEAD - spins


def _counted_vs_profiled(counted, rows):
    """For each ``PROFILE_TEMPLATES`` group: (the launches its counters
    ``counted``, the profiler's count of its kernel templates)."""
    return {"+".join(names): (sum(counted.get(n, 0) for n in names),
                              sum(c for _, c, k in rows
                                  if any(t in k for t in temps)))
            for names, temps in PROFILE_TEMPLATES}


def _counters_confirmed(seen, lost):
    """The profiler may lose a few records: a kernel count may fall
    short of its counter by no more than the spins the window lost
    (``lost``), and never exceed it."""
    return all(0 <= a - b <= lost for a, b in seen.values())


def _chain_timing(prof, chain):
    """The runs of the kernels ``chain`` (name substrings, in launch
    order) in a profile window: each kernel's device us, the gap from
    each one's end to the next one's start (below 0 where the next began
    before it ended, as a programmatic dependent launch may), and the
    span from the first one's start to the last one's end, as medians
    over the runs; and the spans' sum in ms."""
    from torch.autograd import DeviceType

    evs = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.device_type == DeviceType.CUDA)
    runs = []
    for i, ev in enumerate(evs):
        if chain[0] not in ev[2]:
            continue
        run, j = [ev], i + 1
        for part in chain[1:]:
            while j < len(evs) and part not in evs[j][2]:
                j += 1
            if j == len(evs):
                break
            run.append(evs[j])
            j += 1
        if len(run) == len(chain):
            runs.append(run)
    if not runs:
        return {"runs": 0}
    med = statistics.median
    return {"runs": len(runs),
            "kernel_us": {c: med(r[k][1] - r[k][0] for r in runs)
                          for k, c in enumerate(chain)},
            "gap_us": {f"{a}->{b}": med(r[k + 1][0] - r[k][1]
                                        for r in runs)
                       for k, (a, b) in enumerate(zip(chain, chain[1:]))},
            "min_gap_us": {f"{a}->{b}": min(r[k + 1][0] - r[k][1]
                                            for r in runs)
                           for k, (a, b) in enumerate(zip(chain,
                                                          chain[1:]))},
            "span_us": med(r[-1][1] - r[0][0] for r in runs),
            "spans_ms": sum(r[-1][1] - r[0][0] for r in runs) / 1e3}


#: CUDA runtime calls a profile line counts on the host (the window's
#: 2 x ``PROFILE_LEAD`` spins are ``cudaLaunchKernel`` calls too)
HOST_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC",
              "cudaMemcpyAsync", "cudaStreamSynchronize")


def _profile_call(torch, fn, parts=(), chain=None, templates=()):
    """One warm call of ``fn`` under the profiler: device kernel time by
    kernel and its share of the call's wall time, the flash kernel's
    time and launches, the host's CUDA runtime calls (``HOST_CALLS``),
    and ``parts``: {name: (substring, excluded substring)} summed the
    same way. The launch counters' change over the call is held against
    the profiler's count of the kernel templates (``PROFILE_TEMPLATES``):
    ``launch_counters_confirmed`` is false where they differ by more
    than the records the profiler lost, so a replay that added counts
    its graph did not launch, or launched kernels it did not count,
    shows. ``chain``: ``_chain_timing`` of those kernels. ``templates``:
    {name: (substring, excluded substring or None)}, each summed by kernel
    template (``_ms_by_kernel``)."""
    from torch.autograd import DeviceType

    from repro_torch import kernels

    before = kernels.launch_counts()
    prof, wall_ms = _profiled(torch, fn)
    counted = _launch_delta(before, kernels.launch_counts())
    rows, lost = _device_rows(prof)
    busy = sum(ms for ms, _, _ in rows)
    calls = {e.key: e.count for e in prof.key_averages()
             if e.device_type == DeviceType.CPU}
    seen = _counted_vs_profiled(counted, rows)
    return {"wall_ms_profiled": wall_ms, "device_kernel_ms": busy,
            "device_busy_share": busy / wall_ms if busy else None,
            "kernel_launches": sum(c for _, c, _ in rows),
            "host_calls": {k: calls.get(k, 0) for k in HOST_CALLS},
            "launches_counted": counted,
            "launches_counted_vs_profiled": seen,
            "launch_counters_confirmed": _counters_confirmed(seen, lost),
            **({"chain": _chain_timing(prof, chain)} if chain else {}),
            "profiler_lost_spins": lost,
            "flash_attention": _ms_matching(rows, "flash_"),
            **{name: _ms_matching([r for r in rows if out not in r[2]], inc)
               for name, (inc, out) in dict(parts).items()},
            **{name: _ms_by_kernel(rows, inc, out)
               for name, (inc, out) in dict(templates).items()},
            "top": [{"kernel": k[:90], "ms": ms, "calls": c}
                    for ms, c, k in rows[:8]]}


def model_vlm(torch):
    """The Zoo's model services at full width, depth cut to 2 layers,
    fp32, card against CPU (weights from seed 0 made on the CPU and
    copied to the card): the pixtral-12b classifier (d 5120, hd 160, G 4)
    built with ``n_tokens=256`` (the ``classifier_service`` argument: 256
    frontend tokens of 1024 dims, B 2), logits within 2e-3 and class ids
    identical through the label decoder; and ``model.lm`` on a 2-layer
    llama3.2-1b (B 2, L 256), logits within 2e-3. The card's runs launch
    one flash attention a layer and 2 * n_layers + 1 norms."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.core import zoo_builders as zb
    from repro_torch.models.transformer import init_transformer

    tol, t0 = 2e-3, time.perf_counter()
    rng = np.random.default_rng(SEED)
    fp32 = dict(n_layers=2, dtype="float32", param_dtype="float32")
    cfg = get_arch("pixtral-12b").replace(**fp32)
    clf = zb.classifier_service_for(cfg, 1000, arch="pixtral-12b",
                                    n_tokens=256)
    dec = zb.label_decoder(1000)
    p_cpu = clf.metadata["init_params"](SEED, "cpu")
    p_gpu = _tree_to(p_cpu, "cuda")
    emb = torch.from_numpy(rng.normal(0, 1, (2, 256, 1024)).astype(
        np.float32))
    runs = {}
    for name, p, x in (("cpu", p_cpu, emb), ("gpu", p_gpu, emb.cuda())):
        before = kernels.launch_counts()
        logits = clf.fn(p, {"embeddings": x})
        out = dec(logits)
        runs[name] = (logits.cpu(), out["class_id"].cpu(),
                      _launch_delta(before, kernels.launch_counts()))
    err = (runs["cpu"][0] - runs["gpu"][0]).abs().max().item()
    want = {"flash_attention": 2, "rmsnorm": 5}
    rec = {"phase": "model_vlm", "arch": cfg.name, "n_layers": 2,
           "d_model": cfg.d_model, "hd": cfg.hd, "dtype": cfg.dtype,
           "batch": 2, "n_tokens": 256, "n_classes": 1000,
           "logits_max_abs_err": err, "tol": tol,
           "class_ids_gpu": runs["gpu"][1].tolist(),
           "class_ids_cpu": runs["cpu"][1].tolist(),
           "launches_gpu": runs["gpu"][2], "launches_expected": want}
    ok = err <= tol and torch.equal(runs["cpu"][1], runs["gpu"][1]) \
        and runs["gpu"][2] == want and not runs["cpu"][2]
    del p_cpu, p_gpu
    gc.collect()

    lcfg = get_arch("llama3.2-1b").replace(**fp32)
    lm = zb.lm_service_for(lcfg, arch="llama3.2-1b")
    p_cpu = init_transformer(lcfg, SEED, "cpu")
    p_gpu = _tree_to(p_cpu, "cuda")
    toks = torch.from_numpy(rng.integers(0, lcfg.vocab, (2, 256)).astype(
        np.int32))
    before = kernels.launch_counts()
    lg = lm.fn(p_gpu, {"tokens": toks.cuda()})
    lm_launches = _launch_delta(before, kernels.launch_counts())
    lm_err = (lm.fn(p_cpu, {"tokens": toks}) - lg.cpu()).abs().max().item()
    lm_want = {"flash_attention": 2, "rmsnorm": 5}
    rec.update(lm_arch=lcfg.name, lm_seq=256, lm_logits_max_abs_err=lm_err,
               lm_launches_gpu=lm_launches, lm_launches_expected=lm_want,
               seconds=time.perf_counter() - t0)
    rec["ok"] = ok and lm_err <= tol and lm_launches == lm_want
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"model_vlm: card and CPU disagree: {rec}")


def _program_totals(programs):
    """Captures held and graph-pool bytes over ``programs``."""
    return {"captures": sum(p.cache_size() for p in programs),
            "pool_bytes": sum(p.pool_bytes for p in programs)}


def _deployed_programs(dep):
    return [fn for _, fn, _ in dep._compiled.values()]


def _confirmed(prof):
    """What ``_profile_call`` found of the launch counters."""
    return {k: prof[k] for k in (
        "launch_counters_confirmed", "launches_counted_vs_profiled",
        "profiler_lost_spins", "device_kernel_ms",
        "device_busy_share", "wall_ms_profiled")}


def zoo(torch):
    """The paper's deployment example at full width: the pixtral-12b
    classifier (40 layers, bf16, weights made on the card from seed 0)
    ``>> label_decoder(1000)`` on frontend embeddings (B 2, 1024 tokens of
    1024 dims, bf16, seed 0), deployed all local, all remote and split
    after the classifier; every endpoint group runs through its program
    (``Service.jitted()``), captured as a CUDA graph in the first call
    and replayed after. Class ids and confidences must be identical
    across the three, every forward (the replays through the launches
    their capture recorded) must launch exactly 40 flash attentions and
    81 norms and nothing else of ours, one more call of each deployment
    under the profiler must confirm those counts from the kernels it
    ran (``_profile_call``), and no deployment may capture after its
    first call. The peak device memory is read from a reset
    made after the weights, so it holds the deployed calls and their
    graph pools, not ``init_params``' f32 draw. Then ``model.lm`` on the
    full llama3.2-1b (B 2, L 1024: 16 flash launches a forward) through
    ``lm.jitted()``, its replays confirmed the same way, and a registry
    round trip on the card: the reduced
    classifier (25 GB of npz is not a smoke step) published from the
    card, pulled back through a transport onto the card with its hash
    checked, composed with the decoder, giving equal outputs. Returns
    the launch counts of the phase (without ``profile_stages``' own
    programs, which no profiled call confirms) and the deployed service,
    its stages and input, for ``forward_turns``."""
    import shutil

    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.core import zoo_builders as zb
    from repro_torch.core.deploy import DeploymentPlan, deploy
    from repro_torch.core.netmodel import NetworkModel
    from repro_torch.core.profile import profile_stages
    from repro_torch.core.registry import Registry
    from repro_torch.core.transport import RepoTransport, SyncedRegistry
    from repro_torch.models.transformer import init_transformer
    from repro_torch.training.checkpoints import tree_hash

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    clf = zb.classifier_service("pixtral-12b", n_classes=1000, variant="")
    clf = clf.with_params(clf.metadata["init_params"](SEED, "cuda"))
    dec = zb.label_decoder(1000)
    svc = clf >> dec
    x = {"embeddings": torch.from_numpy(rng.normal(
        0, 1, (2, 1024, 1024)).astype(np.float32)).to("cuda",
                                                      torch.bfloat16)}
    clf.check_input(x)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    want = {"flash_attention": 40, "rmsnorm": 81}
    plans = {"local": DeploymentPlan.all_local(svc),
             "remote": DeploymentPlan.all_remote(svc, NetworkModel(seed=1)),
             "split": DeploymentPlan.split(svc, 1, NetworkModel(seed=2))}
    outs, recs, bad, pools, confirmed = {}, {}, [], 0, {}
    for name, plan in plans.items():
        dep = deploy(svc, plan, stages=[clf, dec])
        walls, captures = [], []
        for i in range(4):               # the first call warms up
            before = kernels.launch_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            y, tel = dep.call(x)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
            delta = _launch_delta(before, kernels.launch_counts())
            if delta != want:
                bad.append((name, i, delta))
            captures.append(_program_totals(_deployed_programs(dep))[
                "captures"])
        # one more replay of every program under the profiler: its
        # kernel templates must confirm what the replays counted
        seen = _profile_call(torch, lambda: dep.call(x))
        confirmed[name] = _confirmed(seen)
        if seen["launches_counted"] != want \
                or not seen["launch_counters_confirmed"]:
            bad.append((name, "profiled", confirmed[name]))
        outs[name] = y
        totals = _program_totals(_deployed_programs(dep))
        pools += totals["pool_bytes"]
        recs[name] = {
            "wall_ms_median": statistics.median(walls[1:]),
            "wall_ms": walls[1:],
            "build_wall_ms": walls[0],
            "captures_after_each_call": captures,
            "graph_pool_bytes": totals["pool_bytes"],
            "stages": [{"stage": s.stage, "endpoint": s.endpoint,
                        "compute_ms": s.compute_s * 1e3,
                        "modelled_network_ms": s.transfer_s * 1e3,
                        "param_bytes": s.param_bytes,
                        "pool_bytes": s.pool_bytes}
                       for s in tel.stages]}
        if len(set(captures)) != 1:
            bad.append((name, "captured after the first call", captures))
        del dep
    torch.cuda.synchronize()
    deployed_peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    # profile_stages' programs are its own and no profiled call confirms
    # their replays: its launches stay out of the phase's counts
    before = kernels.launch_counts()
    prof = profile_stages([clf, dec], x, iters=3)
    stage_launches = _launch_delta(before, kernels.launch_counts())
    ref = outs["local"]
    same = {name: torch.equal(o["class_id"], ref["class_id"])
            and torch.equal(o["confidence"], ref["confidence"])
            for name, o in outs.items()}
    n_params = clf.n_params
    turns_case = (svc, [clf, dec], x)
    del clf, svc, dec
    gc.collect()
    torch.cuda.empty_cache()

    lcfg = get_arch("llama3.2-1b")
    lm = zb.lm_service("llama3.2-1b")
    lp = init_transformer(lcfg, SEED, "cuda")
    toks = torch.from_numpy(rng.integers(0, lcfg.vocab, (2, 1024)).astype(
        np.int32)).cuda()
    lm_prog = lm.jitted()
    lm_walls, lm_bad, lm_captures = [], [], []
    for i in range(4):                   # the first call warms up
        before = kernels.launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits = lm_prog(lp, {"tokens": toks})
        torch.cuda.synchronize()
        lm_walls.append((time.perf_counter() - t1) * 1e3)
        delta = _launch_delta(before, kernels.launch_counts())
        if delta != {"flash_attention": 16, "rmsnorm": 33}:
            lm_bad.append((i, delta))
        lm_captures.append(lm_prog.cache_size())
    lm_prof = _profile_call(torch, lambda: lm_prog(lp, {"tokens": toks}))
    lm_ok = tuple(logits.shape) == (2, 1024, lcfg.vocab) \
        and bool(torch.isfinite(logits).all().item()) \
        and len(set(lm_captures)) == 1 \
        and lm_prof["launches_counted"] == {"flash_attention": 16,
                                            "rmsnorm": 33} \
        and lm_prof["launch_counters_confirmed"]
    lm_pool = lm_prog.pool_bytes
    del lp, logits, lm_prog
    gc.collect()

    # the registry round trip on the card (reduced classifier)
    root = Path(__file__).resolve().parent / "build" / "zoo_smoke"
    shutil.rmtree(root, ignore_errors=True)
    small = zb.classifier_service("pixtral-12b", n_classes=10)
    small = small.with_params(small.metadata["init_params"](SEED, "cuda"))
    small_dec = zb.label_decoder(10)
    remote = Registry(root / "remote", device="cuda")
    man = remote.publish(small, builder="model.classifier",
                         config={"arch": "pixtral-12b", "n_classes": 10})
    remote.publish(small_dec, builder="adapter.label_decoder",
                   config={"n_classes": 10})
    remote.publish_composed(small >> small_dec, [small, small_dec])
    sreg = SyncedRegistry(root / "cache", [RepoTransport(root / "remote")],
                          device="cuda")
    pulled, _ = sreg.pull(f"{small.name}_then_{small_dec.name}")
    pulled_bytes = sum(f.stat().st_size for f in (root / "cache").rglob("*")
                       if f.is_file())
    xs = {"embeddings": torch.from_numpy(rng.normal(
        0, 1, (2, 16, 64)).astype(np.float32)).cuda()}
    a, b = (small >> small_dec)(xs), pulled(xs)
    hashes = (tree_hash(small.params), man["params_hash"],
              tree_hash(pulled.params["stage0"]))
    reg_ok = len(set(hashes)) == 1 \
        and pulled.params["stage0"]["head"]["w"].is_cuda \
        and torch.equal(a["class_id"], b["class_id"]) \
        and torch.equal(a["confidence"], b["confidence"])
    shutil.rmtree(root, ignore_errors=True)

    counts = kernels.launch_counts()
    counts = {k: v - stage_launches.get(k, 0) for k, v in counts.items()}
    rec = {"phase": "zoo", "service": "classify_pixtral-12b >> "
           "label_decoder", "n_layers": 40, "dtype": "bfloat16",
           "n_params": n_params, "batch": 2, "n_tokens": 1024,
           "d_embed": 1024, "n_classes": 1000,
           "class_ids": ref["class_id"].tolist(),
           "confidence": ref["confidence"].tolist(),
           "placements_identical": same, "placements": recs,
           "profile": [{"stage": p.stage, "compute_ms": p.compute_ms,
                        "first_call_excess_ms": p.compile_ms,
                        "output_bytes": p.output_bytes,
                        "n_params": p.n_params} for p in prof],
           "launches_per_forward_expected": want,
           "bad_launch_counts": bad,
           "replays_confirmed_by_profiler": confirmed,
           "lm_replay_confirmed_by_profiler": _confirmed(lm_prof),
           "profile_stages_launches_not_counted": stage_launches,
           "resident_gib": resident / 2**30,
           "deployed_peak_gib": deployed_peak / 2**30,
           "deployed_peak_over_resident_gib":
               (deployed_peak - resident) / 2**30,
           "graph_pools_gib": pools / 2**30,
           "lm_arch": lcfg.name, "lm_batch": 2, "lm_seq": 1024,
           "lm_wall_ms_median": statistics.median(lm_walls[1:]),
           "lm_wall_ms": lm_walls[1:], "lm_build_wall_ms": lm_walls[0],
           "lm_captures_after_each_call": lm_captures,
           "lm_graph_pool_bytes": lm_pool,
           "lm_bad_launch_counts": lm_bad,
           "registry": {"hashes_equal": len(set(hashes)) == 1,
                        "pulled_bytes": pulled_bytes, "ok": reg_ok},
           "launches": counts, "seconds": time.perf_counter() - t0}
    rec["ok"] = all(same.values()) and not bad and not lm_bad and lm_ok \
        and reg_ok and counts["flash_attention"] > 0 \
        and all(v == 0 for k, v in counts.items()
                if k not in ("flash_attention", "rmsnorm"))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"zoo phase failed: {rec}")
    return counts, turns_case


def _outputs_agree(torch, graphs, eager):
    """Graph outputs against eager ones, which ran the same kernels on
    the same inputs: class ids equal where there are any, and the float
    output bitwise equal (its error beside, for a failure's reading)."""
    if isinstance(eager, dict):
        ids = torch.equal(graphs["class_id"], eager["class_id"])
        graphs, eager = graphs["confidence"], eager["confidence"]
    else:
        ids = True
    err = (graphs.float() - eager.float()).abs().max().item()
    bitwise = torch.equal(graphs, eager)
    return {"class_ids_equal": ids, "bitwise": bitwise,
            "max_abs_err": err, "ok": ids and bitwise}


def forward_turns(torch, service, graphs_call, eager_call, programs, want,
                  parts=(), extra=None, chain=None):
    """Fig. 2's turn for a cache-free forward: ``graphs_call`` (the
    service's program: one graph replay a call after its first) and
    ``eager_call`` (``Service.__call__``: one launch at a time) in turns
    inside one call: graphs, eager, eager, graphs. Each turn: a warm-up
    call, 3 synchronized calls (wall ms, median), one call under the
    profiler (device ms, busy share, kernel launches, the host's
    ``cudaGraphLaunch`` and ``cudaLaunchKernel`` calls). Fails unless
    every call's launch counters equal ``want``, the profiler's count of
    the kernel templates confirms the counters over each profiled call
    (on graphs, where a replay adds the launches its capture recorded),
    the programs (``programs()``: their captures and pool bytes) capture
    nothing after the first graphs call, and each graphs turn's outputs
    equal the eager turns' bitwise, since both run the same kernels on
    the same inputs (``_outputs_agree``). The device's peak memory is
    read from a reset made at the phase's start (the weights are
    resident by then). ``parts`` and ``chain`` as in
    ``_profile_call``."""
    from repro_torch import kernels

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    turns, bad, outs, captures = [], [], {}, None
    for t, mode in enumerate(("graphs", "eager", "eager", "graphs")):
        call = graphs_call if mode == "graphs" else eager_call
        walls = []
        for i in range(4):               # the first call warms up
            before = kernels.launch_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            y = call()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
            delta = _launch_delta(before, kernels.launch_counts())
            if delta != want:
                bad.append((t, i, delta))
            if captures is None:
                captures = programs()["captures"]
        outs.setdefault(mode, []).append(y)
        del y
        prof = _profile_call(torch, call, parts, chain)
        if prof["launches_counted"] != want:
            bad.append((t, "profiled", prof["launches_counted"]))
        if not prof["launch_counters_confirmed"]:
            bad.append((t, "profiler", prof["launches_counted_vs_profiled"]))
        turns.append(dict(mode=mode, warmup_ms=walls[0],
                          wall_ms_median=statistics.median(walls[1:]),
                          wall_ms=walls[1:], **prof))
    agree = [_outputs_agree(torch, g, outs["eager"][0])
             for g in outs["graphs"]]
    totals = programs()
    rec = {"phase": "forward_turns", "service": service, **(extra or {}),
           "turns": turns, "graphs_vs_eager": agree,
           "launches_per_call_expected": want, "bad_launch_counts": bad,
           "captures_after_first_call": captures,
           "captures_at_end": totals["captures"],
           "graph_pool_bytes": totals["pool_bytes"],
           "resident_gib": resident / 2**30,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    for mode in ("graphs", "eager"):
        for k in ("wall_ms_median", "device_kernel_ms",
                  "device_busy_share"):
            rec[f"{mode}_{k}"] = statistics.median(
                r[k] for r in turns if r["mode"] == mode)
    rec["seconds"] = time.perf_counter() - t_phase
    rec["ok"] = not bad and all(a["ok"] for a in agree) \
        and captures == totals["captures"] and captures > 0
    del outs
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"forward_turns failed for {service}: {rec}")
    return rec


def forward_turns_zoo(torch, case):
    """``forward_turns`` of the ``zoo`` phase's service deployed all
    local (its own deployment, freed after with its graph pool)."""
    from repro_torch.core.deploy import DeploymentPlan, deploy

    svc, stages, x = case
    dep = deploy(svc, DeploymentPlan.all_local(svc), stages=stages)
    forward_turns(
        torch, "classify_pixtral-12b >> label_decoder (deployed local)",
        lambda: dep.call(x)[0], lambda: svc(x),
        lambda: _program_totals(_deployed_programs(dep)),
        {"flash_attention": 40, "rmsnorm": 81},
        extra={"n_layers": 40, "dtype": "bfloat16", "batch": 2,
               "n_tokens": 1024})
    del dep
    gc.collect()
    torch.cuda.empty_cache()


def forward_turns_lm(torch, cfg, arch, params, batch, want, parts=()):
    """``forward_turns`` of ``model.lm`` on ``cfg`` with the caller's
    weights: ``batch`` rows of 1024 tokens from seed 0, through
    ``lm.jitted()`` (freed after with its graph pool) and eagerly. On an
    SSM the profiled calls time the dual form's three launches a layer
    (``SSD_CHAIN``), to show whether the programmatic dependent launches
    overlap inside a graph as they do eagerly."""
    import numpy as np

    from repro_torch.core import zoo_builders as zb

    extra = {"n_layers": cfg.n_layers, "dtype": cfg.dtype, "batch": batch,
             "seq": 1024, "logits_bytes": batch * 1024 * cfg.vocab * 4}
    if cfg.ssm is not None:
        from repro_torch.kernels.ssd_scan.kernel import chunk_plan

        s = cfg.ssm
        extra["ssd_route"] = chunk_plan(
            batch, 1024, s.expand * cfg.d_model // s.head_dim, s.head_dim,
            s.d_state, s.chunk, getattr(torch, cfg.dtype)).route
        if extra["ssd_route"] != "mma":
            raise AssertionError(f"{arch}: the dual form would run "
                                 f"{extra['ssd_route']}, not mma")
    lm = zb.lm_service_for(cfg, arch=arch)
    toks = {"tokens": torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (batch, 1024)).astype(np.int32)).cuda()}
    prog = lm.jitted()
    rec = forward_turns(
        torch, f"model.lm {arch}", lambda: prog(params, toks),
        lambda: lm(toks, params=params),
        lambda: _program_totals([prog]), want, parts, extra,
        chain=SSD_CHAIN if cfg.ssm is not None else None)
    del prog
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def zoo_plain(torch):
    """The bf16 Zoo at full width against a plain forward: the pixtral-12b
    classifier (d 5120, Hq 32, Hkv 8, hd 160) cut to 2 layers, B 1, 256
    frontend tokens of 1024 dims, weights from seed 0 made on the CPU in
    bf16: once on the card in bf16 (flash and norm kernels) and once on
    the CPU through the port's plain route in fp32, on the same weights
    and embeddings (the bf16 values widened). Class ids equal; logits
    within ``ZOO_BF16_TOL_REL`` of max|plain| (the card rounds every
    activation to bf16, unit roundoff 2^-8, and p to bf16 before the PV
    product; the plain fp32 route rounds neither: 2e-2, the kernels' bf16
    gate, taken relative to the logits' scale). The top-2 margin of the
    plain logits is printed beside the error."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.core import zoo_builders as zb

    t0 = time.perf_counter()
    cfg = get_arch("pixtral-12b").replace(n_layers=2)
    c32 = cfg.replace(dtype="float32", param_dtype="float32")
    clf = zb.classifier_service_for(cfg, 1000, arch="pixtral-12b",
                                    n_tokens=256)
    plain = zb.classifier_service_for(c32, 1000, arch="pixtral-12b",
                                      n_tokens=256)
    p_bf16 = clf.metadata["init_params"](SEED, "cpu")
    emb = torch.from_numpy(np.random.default_rng(SEED).normal(
        0, 1, (1, 256, 1024)).astype(np.float32)).bfloat16()
    p_gpu = _tree_to(p_bf16, "cuda")
    before = kernels.launch_counts()
    lg = clf.fn(p_gpu, {"embeddings": emb.cuda()}).float().cpu()
    launches = _launch_delta(before, kernels.launch_counts())
    del p_gpu
    gc.collect()
    torch.cuda.empty_cache()
    p_f32 = _tree_to(p_bf16, torch.float32)
    del p_bf16
    before = kernels.launch_counts()
    lp = plain.fn(p_f32, {"embeddings": emb.float()})
    cpu_launches = _launch_delta(before, kernels.launch_counts())
    err = (lg - lp).abs().max().item()
    scale = lp.abs().max().item()
    top2 = lp[0].topk(2).values
    want = {"flash_attention": 2, "rmsnorm": 5}
    rec = {"phase": "zoo_plain", "arch": cfg.name, "n_layers": 2,
           "d_model": cfg.d_model, "n_heads": cfg.n_heads,
           "n_kv_heads": cfg.n_kv_heads, "hd": cfg.hd, "batch": 1,
           "n_tokens": 256, "n_classes": 1000, "card_dtype": cfg.dtype,
           "plain_dtype": "float32", "logits_max_abs_err": err,
           "logits_max_abs_plain": scale, "rel_err": err / scale,
           "tol_rel": ZOO_BF16_TOL_REL,
           "top2_margin_plain": (top2[0] - top2[1]).item(),
           "class_id_gpu": int(lg[0].argmax()),
           "class_id_cpu": int(lp[0].argmax()),
           "launches_gpu": launches, "launches_expected": want,
           "seconds": time.perf_counter() - t0}
    rec["ok"] = err <= ZOO_BF16_TOL_REL * scale \
        and rec["class_id_gpu"] == rec["class_id_cpu"] \
        and launches == want and not cpu_launches \
        and bool(torch.isfinite(lg).all().item())
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"zoo_plain: the card's bf16 classifier and "
                             f"the plain fp32 forward disagree: {rec}")


def prefill_ssm(torch, model, params, phase="prefill_ssm"):
    """The cache-free forward at full depth: mamba2-780m (48 layers, bf16,
    the caller's seed-0 weights), B 1, a 1024-token prompt through
    ``Model.prefill`` into a fresh cache. Wall ms per synchronized call
    (median of 3 after a warm-up; the caches made beforehand), the
    launch counts of those 3 calls (``ssd`` 48 a call: one a layer),
    device ms by kernel and the dual form's share under the profiler
    (one more call). Fails on non-finite logits of the wrong shape or
    another ``ssd`` count."""
    import numpy as np

    from repro_torch import kernels

    t_phase = time.perf_counter()
    cfg = model.cfg
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, 1024)).to(model.device)[None]
    caches = [model.make_cache(1, 1024) for _ in range(5)]

    def call(cache):
        return model.prefill(params, {"tokens": toks}, cache)[0]

    logits = call(caches[0])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    walls = []
    for cache in caches[1:4]:
        t0 = time.perf_counter()
        call(cache)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    prof = _profile_call(torch, lambda: call(caches[4]),
                         parts={"ssd": ("ssd_", "ssd_extend")})
    ssd = prof.pop("ssd")
    busy = prof["device_kernel_ms"]
    ssd["share_of_device"] = ssd["ms"] / busy if busy else None
    rec = {"phase": phase, "arch": cfg.name, "n_layers": cfg.n_layers,
           "dtype": cfg.dtype, "batch": 1, "prompt": 1024,
           "wall_ms_median": statistics.median(walls), "wall_ms": walls,
           "launches_3_calls": counts, "ssd_per_call": counts.get("ssd", 0)
           / 3, "ssd_device": ssd, **prof,
           "logits_shape": list(logits.shape),
           "seconds": time.perf_counter() - t_phase}
    rec["ok"] = bool(torch.isfinite(logits).all().item()) \
        and logits.shape[-1] == cfg.vocab and logits.shape[0] == 1 \
        and counts.get("ssd", 0) == 3 * cfg.n_layers \
        and prof["launch_counters_confirmed"]
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"{phase} failed: {rec}")
    return rec


# --------------------------------------------------------------------- #
# phases 5, 7 and 8: serve the full model through the engine, on
# contiguous rings, on a paged pool, and on a pool under pressure
# --------------------------------------------------------------------- #
def served_model():
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build

    cfg = get_arch("llama3.2-1b")
    model = build(cfg)
    return model, model.init(SEED)


_KV_KEYS = ("k", "v", "kp", "vp", "k_scale", "v_scale", "kp_scale",
            "vp_scale")


def _kv_bytes(engine):
    """K/V storage of the cache, int8 scales included."""
    return sum(t.nbytes for sub in engine.cache.values()
               for key, t in sub.items() if key in _KV_KEYS)


def _state_bytes(engine):
    """SSM state of the cache: conv tails and states, checkpoints
    included."""
    return sum(t.nbytes for sub in engine.cache.values()
               for key, t in sub.items()
               if key in ("conv", "ssm", "conv_ckpt", "ssm_ckpt"))


def _sublayers(cfg):
    """(attention, SSM, FFN-carrying, MoE) sublayers of ``cfg``'s stack."""
    from repro_torch.models.transformer import block_spec, n_blocks

    spec, nb = block_spec(cfg), n_blocks(cfg)
    return tuple(nb * sum(f(m, ffn) for m, ffn in spec) for f in (
        lambda m, ffn: m == "attn", lambda m, ffn: m == "ssm",
        lambda m, ffn: ffn is not None, lambda m, ffn: ffn == "moe"))


def _norms_per_forward(cfg):
    """Fused-norm launches of one forward: ``ln1`` a sublayer, ``ln2``
    a sublayer with an FFN, the gated norm an SSM mixer, and ``ln_f``:
    2 n_layers + 1 for a dense, MoE or pure SSM stack, 23 a Jamba
    super-block and ``ln_f``."""
    n_attn, n_ssm, n_ffn, _ = _sublayers(cfg)
    return n_attn + n_ssm + n_ffn + n_ssm + 1


def _forward_launches(cfg, forwards, paged, quant):
    """Kernel launches of ``forwards`` cached forwards of ``cfg``'s stack:
    one attention launch an attention sublayer (none on an int8 cache,
    which plain attention reads, as in the JAX model), one recurrence
    launch an SSM sublayer (a decode is its T = 1 launch), the norms of
    ``_norms_per_forward``, and through the dequantize-matmul of
    ``quant`` the projections: 4 an attention sublayer (q, k, v, o), 2
    an SSM mixer (in, out), 3 an MLP, 3 a MoE FFN's shared expert (the
    routed experts and the router stay unquantized, as in JAX), and an
    untied LM head (a tied one is the bf16 embedding table): 7 a dense
    layer, 4 a MoE layer (7 with a shared expert)."""
    n_attn, n_ssm, n_ffn, n_moe = _sublayers(cfg)
    attn = 0 if cfg.kv_quant else n_attn * forwards
    shared = 3 * n_moe if cfg.moe is not None and cfg.moe.n_shared else 0
    proj = (4 * n_attn + 2 * n_ssm + 3 * (n_ffn - n_moe) + shared
            + (0 if cfg.tie_embeddings else 1)) * forwards
    return {"decode_attention": 0 if paged else attn,
            "paged_decode_attention": attn if paged else 0,
            "quant_matmul_int8": proj if quant == "int8" else 0,
            "quant_matmul_int4": proj if quant == "int4" else 0,
            "rmsnorm": _norms_per_forward(cfg) * forwards,
            "ssd": 0,
            "ssd_extend": n_ssm * forwards,
            "flash_attention": 0, "flash_attention_bwd": 0,
            "rmsnorm_bwd": 0, "rmsnorm_gated_bwd": 0, "ssd_bwd": 0}


def _expected_launches(cfg, engine, paged, kinds=None):
    """Kernel launches the step trace implies (``kinds``: the kinds of
    the steps to count, default every step of the engine). Target
    forwards: one a plain step, two a mixed step (the decode rows, then
    the chunk), one an admit chunk, and a spec step's verify (two on an
    SSM stack, which replays the accepted prefix). A model draft adds
    one draft forward an admit chunk (its lagging chunk) and gamma a
    spec step (the window, then gamma - 1 decodes), on its own
    contiguous cache, with its projections through the dequantize-matmul
    of its precision (``cfg.draft``, as ``quant.self_draft`` parses
    it)."""
    from repro_torch.quant.self_draft import parse_draft_spec

    kinds = engine.step_kinds if kinds is None else kinds
    n_spec, n_admit = kinds.count("spec"), kinds.count("admit")
    replay = 2 if cfg.ssm is not None else 1
    forwards = kinds.count("plain") + 2 * kinds.count("mixed") + n_admit \
        + replay * n_spec
    want = _forward_launches(cfg, forwards, paged, cfg.quant)
    draft = getattr(engine, "_draft_model", None)
    if draft is not None:
        prec = parse_draft_spec(cfg.draft)[0]
        d = _forward_launches(
            draft.cfg, n_admit + engine.spec_gamma * n_spec, False,
            prec if prec in ("int8", "int4") else cfg.quant)
        want = {k: want[k] + d[k] for k in want}
    return want


def serve(torch, model, params, *, paged=False, base=None, phase=None,
          bf16=None, graphs=None, mesh=None):
    """16 requests (prompts of 64-512 tokens from the seed in the model's
    vocab, 32 new each) through the engine; every kernel count set to 0
    just before and read just after, and equal to what the step trace
    implies. Paged (``base``: the contiguous phase's record and
    tokens): the same requests on a pool of 288 pages of 16, which
    holds all 8 streams at once, so the schedule and the greedy tokens
    are the contiguous run's; the pool drains. ``bf16``: the bf16 serve
    phase's tokens, whose share a quantized run reproduces is printed
    (information, not a gate: quantization changes tokens). ``graphs``:
    the engine's argument (None: its steps run as CUDA graphs, which the
    phase checks; False: eager). ``mesh``: the engine's (a serving mesh
    spec); its collectives, set to 0 with the counters, must equal what
    the layer plan implies for the step trace."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.quant import quantized_stats
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request
    from repro_torch.serving.sampler import Sampler

    cfg = model.cfg
    kw = dict(paged=True, page_size=16, num_pages=288) if paged else {}
    engine = Engine(model, params, max_batch=8, cache_len=1024,
                    prefill_chunk=128, sampler=Sampler(), seed=SEED,
                    graphs=graphs, mesh=mesh, **kw)
    rng = np.random.default_rng(SEED)
    lens = rng.integers(64, 513, 16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    mesh_mod.reset_collective_counts()
    t0 = time.perf_counter()
    for uid, L in enumerate(lens):
        engine.submit(Request(uid=uid, prompt=rng.integers(0, cfg.vocab, L),
                              max_new_tokens=32))
    responses = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    collectives = mesh_mod.collective_counts()
    stats = engine.latency_stats()
    want = _expected_launches(cfg, engine, paged)
    toks = sum(len(r.tokens) for r in responses.values())
    bad = [uid for uid, r in responses.items()
           if r.finish_reason != "length" or len(r.tokens) != 32
           or not all(0 <= t < cfg.vocab for t in r.tokens)]
    phase = phase or ("serve_paged" if paged else "serve")
    rec = {"phase": phase, "arch": cfg.name,
           "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "requests": len(responses),
           "prompt_lens": [int(x) for x in lens], "max_new_tokens": 32,
           "max_batch": 8, "cache_len": 1024, "prefill_chunk": 128, **kw,
           "plain_steps": engine.step_kinds.count("plain"),
           "mixed_steps": engine.step_kinds.count("mixed"),
           "launches": counts, "launches_expected": want,
           "tokens": toks, "wall_s": wall, "tok_per_s": toks / wall,
           "ttft_ms_p50": stats.get("ttft_ms_p50"),
           "ttft_ms_p99": stats.get("ttft_ms_p99"),
           "itl_ms_p50": stats.get("itl_ms_p50"),
           "itl_ms_p99": stats.get("itl_ms_p99"),
           "decode_ms_p50": stats.get("decode_ms_p50"),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "quant": cfg.quant, "kv_quant": cfg.kv_quant,
           "weight_bytes": quantized_stats(params)["weight_bytes"],
           "table_bytes": params["embed"]["table"].nbytes,
           "table_bytes": params["embed"]["table"].nbytes,
           "kv_bytes": _kv_bytes(engine),
           "state_bytes": _state_bytes(engine), "bad_requests": bad,
           "graphs": engine.graphs,
           "programs": engine.program_cache_sizes(),
           "program_builds_ms": [e["elapsed_ms"] for e in
                                 engine.metrics.get_series("compiles").values]}
    rec["ok"] = not bad and counts == want \
        and engine.graphs == (graphs is not False)
    if mesh is not None:
        rec.update(mesh=dict(engine.mesh.sizes), collectives=collectives,
                   collectives_expected=_mesh_collectives(
                       cfg, engine.mesh.sizes, engine.step_kinds, 8))
        rec["ok"] = rec["ok"] and collectives == rec["collectives_expected"]
    # a snapshot: the profile phase serves more requests on this engine
    tokens = {uid: list(r.tokens) for uid, r in responses.items()}
    if bf16 is not None:
        same = sum(a == b for uid in tokens
                   for a, b in zip(tokens[uid], bf16[uid]))
        rec["token_share_equal_bf16"] = same / sum(map(len, bf16.values()))
    if paged:
        ref_rec, ref_tokens = base
        same = [uid for uid in tokens if tokens[uid] == ref_tokens.get(uid)]
        rec.update(
            tokens_equal_contiguous=len(same),
            kv_bytes_contiguous=ref_rec["kv_bytes"],
            pool_over_ring=rec["kv_bytes"] / ref_rec["kv_bytes"],
            **{k: stats[k] for k in ("kv_pages_total", "kv_pages_live",
                                     "kv_pages_released", "preemptions")})
        engine._paged.check_invariants()
        rec["ok"] = rec["ok"] and len(same) == len(ref_tokens) \
            and len(tokens) == len(ref_tokens) \
            and stats["kv_pages_live"] == 0 and stats["preemptions"] == 0
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"{rec['phase']} phase failed: {rec}")
    return counts, engine, rec, tokens


def _mesh_collectives(cfg, sizes, kinds, max_batch):
    """The collectives the layer plan implies for the steps ``kinds`` on a
    mesh of ``sizes`` (a dense stack with a tied LM head): a forward
    reduces the vocab-sharded embedding when the vocab divides the model
    axis, and each layer its attention output and its MLP (the row-
    parallel ``wo``s) where their inputs divide it; it gathers the
    projections to whole heads where the KV heads do not divide it, and
    the logits' vocab blocks; every step gathers its record over the
    data axis when the batch divides it. Forwards: one a plain step,
    two a mixed step."""
    mp, dp = sizes["model"], sizes["data"]
    hd = cfg.head_dim or cfg.d_model // cfg.n_heads
    forwards = kinds.count("plain") + 2 * kinds.count("mixed")
    reduces = int(cfg.vocab % mp == 0) + cfg.n_layers * (
        int(cfg.n_heads * hd % mp == 0) + int(cfg.d_ff % mp == 0))
    gathers = int(cfg.vocab % mp == 0)
    if cfg.n_kv_heads % mp:
        gathers += cfg.n_layers * sum(
            int(n * hd % mp == 0)
            for n in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    out = {"all_reduce": reduces * forwards,
           "all_gather": gathers * forwards
           + len(kinds) * int(max_batch % dp == 0)}
    return {k: v for k, v in out.items() if v}


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def serve_mesh(torch, model, params, base):
    """The serve phase's engine and requests on a serving mesh: a
    one-rank NCCL process group (``tcp://localhost``), ``Engine(mesh=
    "auto")`` on contiguous rings, its step graphs captured with the
    layers' collectives inside (the communicators warmed first on the
    capture stream). Gates: greedy tokens bitwise equal to ``serve``'s
    (``base``: its record and tokens; one rank changes no sum), launch
    counters equal to the step trace, collectives equal to the layer
    plan (``_mesh_collectives``), and on a profiled second batch
    (``profile_mesh``) no capture, two syncs a poll and the plan's
    collectives again (the NCCL kernels and device-to-device copies the
    profiler saw are recorded beside them). Reports tok/s and decode
    ms/step beside ``serve``'s. Destroys the group at the end."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod

    t_phase = time.perf_counter()
    rec0, tokens0 = base
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        _, engine, rec, tokens = serve(torch, model, params,
                                       phase="serve_mesh_run", mesh="auto")
        mesh_mod.reset_collective_counts()
        prof = profile(torch, engine, "profile_mesh")
        seen = mesh_mod.collective_counts()
        want = _mesh_collectives(model.cfg, engine.mesh.sizes,
                                 engine.step_kinds[-prof["steps"]:], 8)
        out = {"phase": "serve_mesh", "mesh": dict(engine.mesh.sizes),
               "backend": dist.get_backend(),
               "tokens_equal_serve": tokens == tokens0,
               "launches_equal_trace": rec["launches"]
               == rec["launches_expected"],
               "collectives": rec["collectives"],
               "collectives_expected": rec["collectives_expected"],
               "profiled_collectives": seen,
               "profiled_collectives_expected": want,
               "profiled_nccl_kernels": prof["nccl_kernels"],
               "profiled_memcpy_dtod": prof["memcpy_dtod"],
               "profiled_syncs": prof["host_calls"]["cudaStreamSynchronize"],
               "profiled_polls": prof["polls"],
               "steady_compiles": prof["steady_compiles"],
               "device_busy_share": prof["device_busy_share"],
               "tok_per_s": rec["tok_per_s"],
               "serve_tok_per_s": rec0["tok_per_s"],
               "decode_ms_p50": rec["decode_ms_p50"],
               "serve_decode_ms_p50": rec0["decode_ms_p50"],
               "programs": engine.program_cache_sizes(),
               "nvidia_smi": _smi()}
        del engine
        gc.collect()
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t_phase
    out["ok"] = out["tokens_equal_serve"] and out["launches_equal_trace"] \
        and seen == want and rec["ok"]
    emit(out)
    if not out["ok"]:
        raise AssertionError(f"serve_mesh phase failed: {out}")
    return out


def serve_mesh_only(torch):
    """``python3 chip_smoke.py --serve-mesh``: the kernels built, the serve
    phase and ``serve_mesh`` alone."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0})
    model, params = served_model()
    _, engine, rec, tokens = serve(torch, model, params)
    del engine
    gc.collect()
    serve_mesh(torch, model, params, (rec, tokens))
    print(_smi(), flush=True)
    return 0


def pool_pressure(torch, model, params):
    """Four streams of 256 prompt tokens and 64 new on a pool of 72 pages
    of 16: all four admit (17 pages each), then their growth to 20 pages
    each outruns the pool, so provisioning preempts and requeues streams
    that resume by replay. Passes when it preempted, every request
    finished "length", the launch counts equal the trace's and the pool
    drained with its invariants intact. How many streams equal an
    unpreempted contiguous run is printed, not gated: the replay's
    chunked extends change the bf16 GEMM shapes."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request
    from repro_torch.serving.sampler import Sampler

    cfg = model.cfg
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, cfg.vocab, 256) for _ in range(4)]
    kw = dict(max_batch=4, cache_len=1024, prefill_chunk=128,
              sampler=Sampler(), seed=SEED)

    def run(**paged_kw):
        engine = Engine(model, params, **kw, **paged_kw)
        reqs = [Request(uid=u, prompt=p, max_new_tokens=64)
                for u, p in enumerate(prompts)]
        for r in reqs:
            engine.submit(r)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        responses = engine.run()
        torch.cuda.synchronize()
        return engine, reqs, responses, time.perf_counter() - t0

    engine, reqs, responses, wall = run(paged=True, page_size=16,
                                        num_pages=72)
    counts = kernels.launch_counts()
    want = _expected_launches(cfg, engine, True)
    stats = engine.latency_stats()
    engine._paged.check_invariants()
    _, _, base, _ = run()
    same = sum(responses[u].tokens == base[u].tokens for u in base)
    bad = [u for u, r in responses.items()
           if r.finish_reason != "length" or len(r.tokens) != 64]
    rec = {"phase": "pool_pressure", "requests": 4, "prompt_len": 256,
           "max_new_tokens": 64, "max_batch": 4, "cache_len": 1024,
           "page_size": 16, "num_pages": 72,
           "preemptions": stats["preemptions"],
           "preemptions_per_request": [r.preemptions for r in reqs],
           "plain_steps": engine.step_kinds.count("plain"),
           "mixed_steps": engine.step_kinds.count("mixed"),
           "launches": counts, "launches_expected": want,
           "kv_pages_live": stats["kv_pages_live"],
           "kv_pages_released": stats["kv_pages_released"],
           "streams_equal_unpreempted_contiguous": int(same),
           "wall_s": wall, "bad_requests": bad}
    rec["ok"] = stats["preemptions"] >= 1 and not bad \
        and counts == want and stats["kv_pages_live"] == 0 \
        and len(responses) == 4
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"pool-pressure phase failed: {rec}")
    return rec


# --------------------------------------------------------------------- #
# the engine lifecycle on the graph-captured steps: faults, cancel,
# deadlines, priorities and request tracing
# --------------------------------------------------------------------- #
#: the lifecycle phase's engine: llama3.2-1b at full width on graphs,
#: paged (pages of 16), as the serve phase's batch and chunk
LIFECYCLE_ENGINE = dict(max_batch=8, cache_len=1024, prefill_chunk=128,
                        paged=True, page_size=16)
#: the lifecycle workload: 12 prompts of 64-384 tokens from the seed, 64
#: new tokens each (8 slots, so 4 wait), and a 512-token prompt (four
#: chunks) that a cancel catches mid-admission
LIFECYCLE_REQUESTS, LIFECYCLE_NEW = 12, 64
#: the serve phase's decode ms/step p50 on graphs before the poison lane
#: (PERF.md §5); and the lane's reckoned cost a step, µs (8 x 128256 f32
#: logits read and written at 3.35 TB/s)
SERVE_DECODE_MS_P50_BEFORE_LANE = (5.7, 5.8)
POISON_US_RECKONED = 2.5


def _lifecycle_prompts(vocab):
    import numpy as np

    rng = np.random.default_rng(SEED + 3)
    lens = rng.integers(64, 385, LIFECYCLE_REQUESTS)
    prompts = [rng.integers(0, vocab, int(L)) for L in lens]
    return prompts, rng.integers(0, vocab, 512)


def _lifecycle_engine(model, params, **extra):
    """A lifecycle engine warmed until every slot admitted once
    (``_warm``), then marked steady."""
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.sampler import Sampler

    engine = Engine(model, params, sampler=Sampler(), seed=SEED,
                    **LIFECYCLE_ENGINE, **extra)
    _warm(engine, "lifecycle")
    engine.mark_steady()
    return engine


def _warm(engine, phase):
    """Admit into every slot once (one one-chunk admission of a 16-token
    prompt a slot, then plain steps): each slot's mixed program and the
    plain step built and, on graphs, captured."""
    import numpy as np

    from repro_torch.serving.request import Request

    rng = np.random.default_rng(SEED + 4)
    for uid in range(engine.max_batch):
        engine.submit(Request(uid=1000 + uid,
                              prompt=rng.integers(0, engine.model.cfg.vocab,
                                                  16),
                              max_new_tokens=16))
    engine.tick(engine.max_batch + 8)   # every build falls in this burst
    engine.run()
    progs = engine.program_cache_sizes()
    if progs != {"step": 1, "mixed": engine.max_batch}:
        raise AssertionError(f"{phase} warm-up built {progs}")


def _submit(engine, uids, prompts, **kw):
    from repro_torch.serving.request import Request

    for uid, p in zip(uids, prompts):
        engine.submit(Request(uid=uid, prompt=p,
                              max_new_tokens=LIFECYCLE_NEW, **kw))


def _fill_slots(engine):
    """Tick one step at a time until every slot holds a stream."""
    while engine._admit is not None or None in engine.slots:
        engine.tick(1)


def _steady(engine, progs):
    """Nothing built since warm-up: program counts as they were and no
    capture after ``mark_steady``."""
    return engine.program_cache_sizes() == progs \
        and engine.metrics.counters["steady_compiles"].value == 0


def _drive(torch, engine, fn):
    """Run ``fn`` with every launch counter set to 0 just before; returns
    (counts, the counts the steps it ran imply, wall s)."""
    from repro_torch import kernels

    n0 = len(engine.step_kinds)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = _expected_launches(engine.model.cfg, engine, engine.paged,
                              engine.step_kinds[n0:])
    return counts, want, wall


def _tokens(engine, uids):
    return {u: list(engine.responses[u].tokens) for u in uids}


def _gate(rec):
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"{rec['phase']} failed: {rec}")


def lifecycle(torch, model, params, serve_rec):
    """The engine lifecycle on the card's graph-captured steps, at full
    width (llama3.2-1b, 16 layers, bf16; ``LIFECYCLE_ENGINE``). Every
    engine is warmed until each slot admitted once and marked steady, so
    a capture in any part fails it. One line a part:

    * ``lifecycle_invisible``: an enabled, empty fault schedule against
      ``faults=False``: tokens and program counts equal;
    * ``lifecycle_chaos``: NaN logits on slot 3 mid-run, ``page_alloc``
      forced twice, a 2 ms ``slow_step``: one stream ends "error", every
      stream never preempted equals the clean run, preempted ones end
      "length" with all their tokens (equality printed), the pool
      drains, >= 3 faults counted by the engine and the schedule;
    * ``lifecycle_cancel``: a queued, a mid-admission and an active
      request cancelled; the active one keeps a prefix of its clean
      stream and the next queued request takes its slot and streams
      clean;
    * ``lifecycle_deadline``: an expired request times out with no
      token; a deadline blown by a 1 s ``slow_step`` keeps a prefix;
    * ``lifecycle_priority``: a priority-1 request displaces a
      priority-0 stream from a full table; the victim waits behind it
      and ends "length";
    * ``lifecycle_tracer``: ``recorder=True``: a valid Chrome trace, one
      complete span a request with its tokens and reason, tokens equal
      to untraced runs; tok/s traced and untraced in turns;
    * ``lifecycle_profile_window``: ``trace_dir=`` writes a trace naming
      the decode-attention and RMSNorm kernels;
    * ``lifecycle_syncs``: under the profiler, a poison, a cancel and a
      preemption: ``cudaStreamSynchronize`` = 2 x polls; poisoning and
      clearing the lane alone: no sync;
    * ``lifecycle``: the launch counters of every part against its step
      trace, the poison lane's device time and the serve phase's decode
      ms/step p50 with it.

    Launch counters equal the step trace in every part."""
    import shutil

    from torch.autograd import DeviceType

    from repro_torch import kernels
    from repro_torch.serving import tracing
    from repro_torch.serving.faults import Faults

    t_phase = time.perf_counter()
    cfg = model.cfg
    prompts, long_prompt = _lifecycle_prompts(cfg.vocab)
    W = list(range(LIFECYCLE_REQUESTS))
    launches = {}

    # --- the clean run and an empty, enabled schedule ------------------
    clean_e = _lifecycle_engine(model, params, faults=False)
    progs = clean_e.program_cache_sizes()
    launches["clean"] = _drive(torch, clean_e, lambda: (
        _submit(clean_e, W, prompts), clean_e.run()))
    clean = _tokens(clean_e, W)
    empty_e = _lifecycle_engine(model, params, faults=Faults(seed=0))
    launches["empty"] = _drive(torch, empty_e, lambda: (
        _submit(empty_e, W, prompts), empty_e.run()))
    rec = {"phase": "lifecycle_invisible", "requests": len(W),
           "max_new_tokens": LIFECYCLE_NEW, **LIFECYCLE_ENGINE,
           "programs": progs,
           "programs_empty_schedule": empty_e.program_cache_sizes(),
           "tokens_equal": _tokens(empty_e, W) == clean,
           "lengths": [len(t) for t in clean.values()]}
    rec["ok"] = rec["tokens_equal"] and _steady(clean_e, progs) \
        and _steady(empty_e, progs) \
        and all(n == LIFECYCLE_NEW for n in rec["lengths"])
    del empty_e
    _gate(rec)

    # --- chaos ----------------------------------------------------------
    sched = Faults(seed=0)
    chaos_e = _lifecycle_engine(model, params, faults=sched)
    w0 = chaos_e._steps
    (sched.on("slow_step", step=w0 + 16, delay_s=0.002)
          .on("nan_logits", step=w0 + 24, slot=3)
          .on("page_alloc", step=w0 + 40, times=2))
    uids = [100 + u for u in W]
    launches["chaos"] = _drive(torch, chaos_e, lambda: (
        _submit(chaos_e, uids, prompts), chaos_e.run()))
    resp = {u - 100: chaos_e.responses[u] for u in uids}
    pre = {u - 100: chaos_e.requests[u].preemptions for u in uids}
    errors = [u for u, r in resp.items() if r.finish_reason == "error"]
    unpreempted = [u for u in W if not pre[u] and u not in errors]
    preempted = [u for u in W if pre[u]]
    st = chaos_e.latency_stats()
    chaos_e._paged.check_invariants()
    rec = {"phase": "lifecycle_chaos",
           "schedule": [{k: getattr(s, k) for k in
                         ("site", "step", "slot", "times", "delay_s",
                          "fired")} for s in sched.specs],
           "warm_up_steps": w0, "errors": errors,
           "error_prefix_of_clean": all(
               resp[u].tokens == clean[u][:len(resp[u].tokens)]
               for u in errors),
           "preempted": preempted,
           "preempted_reasons": [resp[u].finish_reason for u in preempted],
           "preempted_equal_unpreempted_run": [
               resp[u].tokens == clean[u] for u in preempted],
           "unpreempted_equal_clean": sum(
               resp[u].tokens == clean[u] for u in unpreempted),
           "unpreempted": len(unpreempted),
           "faults_injected": st["faults_injected"],
           "snapshot_faults_fired_total": chaos_e.metrics.snapshot()[
               "collected"]["faults_fired_total"],
           "preemptions": st["preemptions"],
           "kv_pages_live": st["kv_pages_live"]}
    rec["ok"] = len(errors) == 1 and rec["error_prefix_of_clean"] \
        and rec["unpreempted_equal_clean"] == len(unpreempted) \
        and preempted and all(
            resp[u].finish_reason == "length"
            and len(resp[u].tokens) == LIFECYCLE_NEW for u in preempted) \
        and st["kv_pages_live"] == 0 and st["faults_injected"] >= 3 \
        and rec["snapshot_faults_fired_total"] >= 3 \
        and _steady(chaos_e, progs)
    _gate(rec)

    # --- cancel: queued, mid-admission, active --------------------------
    c = clean_e
    states = {}

    def cancel_run():
        _submit(c, [200 + u for u in range(8)], prompts[:8])
        _submit(c, [208], [long_prompt])
        _submit(c, [209, 210], prompts[8:10])
        states["queued"] = c.cancel(210)
        _fill_slots(c)
        c.tick()
        states["slot"] = next(b for b, r in enumerate(c.slots)
                              if r is not None and r.uid == 202)
        states["active"] = c.cancel(202)
        c.tick(1)
        adm = c._admit
        states["admitting"] = (adm.req.uid, adm.slot, adm.base, adm.length)
        states["mid_admission"] = c.cancel(208)
        while any(r.uid == 209 for r in c.queue) or c._admit is not None:
            c.tick(1)
        states["next_in_slot"] = c.slots[states["slot"]].uid
        c.run()

    launches["cancel"] = _drive(torch, c, cancel_run)
    resp = {u: c.responses[u] for u in range(200, 211)}
    got202 = resp[202].tokens
    rec = {"phase": "lifecycle_cancel", **states,
           "reasons": {u: r.finish_reason for u, r in resp.items()},
           "active_tokens": len(got202),
           "active_prefix_of_clean": got202 == clean[2][:len(got202)],
           "next_equal_clean": resp[209].tokens == clean[8],
           "others_equal_clean": sum(resp[200 + u].tokens == clean[u]
                                     for u in (0, 1, 3, 4, 5, 6, 7)),
           "cancellations": c.latency_stats()["cancellations"]}
    adm_uid, _, base, length = states["admitting"]
    rec["ok"] = all(states[k] is True for k in
                    ("queued", "active", "mid_admission")) \
        and [resp[u].finish_reason for u in (210, 208, 202)] \
        == ["cancelled"] * 3 \
        and not resp[210].tokens and not resp[208].tokens \
        and adm_uid == 208 and 0 < base < length \
        and 0 < len(got202) < LIFECYCLE_NEW \
        and rec["active_prefix_of_clean"] \
        and states["next_in_slot"] == 209 and rec["next_equal_clean"] \
        and resp[209].finish_reason == "length" \
        and rec["others_equal_clean"] == 7 and _steady(c, progs)
    _gate(rec)

    # --- deadlines --------------------------------------------------------
    d = chaos_e

    def deadline_run():
        sched.on("slow_step", step=d._steps + 12, delay_s=1.0)
        _submit(d, [300], prompts[10:11], deadline_s=1e-6)
        _submit(d, [301], prompts[11:12], deadline_s=0.5)
        time.sleep(0.01)
        d.run()

    launches["deadline"] = _drive(torch, d, deadline_run)
    r0, r1 = d.responses[300], d.responses[301]
    rec = {"phase": "lifecycle_deadline",
           "expired": {"reason": r0.finish_reason, "tokens": len(r0.tokens)},
           "midstream": {"reason": r1.finish_reason,
                         "tokens": len(r1.tokens),
                         "prefix_of_clean":
                             r1.tokens == clean[11][:len(r1.tokens)]},
           "timeouts": d.latency_stats()["timeouts"]}
    rec["ok"] = r0.finish_reason == "timeout" and not r0.tokens \
        and r1.finish_reason == "timeout" \
        and 0 < len(r1.tokens) < LIFECYCLE_NEW \
        and rec["midstream"]["prefix_of_clean"] and _steady(d, progs) \
        and d._paged.live_pages == 0
    _gate(rec)

    # --- priorities ---------------------------------------------------------
    p = clean_e
    order = {}

    def priority_run():
        _submit(p, [400 + u for u in range(8)], prompts[:8])
        _fill_slots(p)
        p.tick()
        _submit(p, [408], prompts[8:9], priority=1)
        p.tick(1)
        order["queue"] = [r.uid for r in p.queue]
        order["displacer"] = (p._admit.req.uid if p._admit is not None
                              else next((r.uid for r in p.slots
                                         if r is not None and r.uid == 408),
                                        None))
        p.run()

    launches["priority"] = _drive(torch, p, priority_run)
    victims = [u for u in range(400, 408) if p.requests[u].preemptions]
    rec = {"phase": "lifecycle_priority", **order, "victims": victims,
           "victim_reasons": [p.responses[u].finish_reason for u in victims],
           "victim_tokens": [len(p.responses[u].tokens) for u in victims],
           "victims_equal_unpreempted_run": [
               p.responses[u].tokens == clean[u - 400] for u in victims],
           "displacer_equal_clean": p.responses[408].tokens == clean[8],
           "others_equal_clean": sum(
               p.responses[u].tokens == clean[u - 400]
               for u in range(400, 408) if u not in victims)}
    rec["ok"] = len(victims) == 1 and order["queue"] == victims \
        and order["displacer"] == 408 \
        and rec["victim_reasons"] == ["length"] \
        and rec["victim_tokens"] == [LIFECYCLE_NEW] \
        and p.responses[408].finish_reason == "length" \
        and rec["displacer_equal_clean"] and rec["others_equal_clean"] == 7 \
        and _steady(p, progs)
    _gate(rec)

    # --- the tracer, traced against untraced in turns --------------------
    traced_e = _lifecycle_engine(model, params, faults=False, recorder=True)
    turns = []
    for i, e in enumerate((clean_e, traced_e, traced_e, clean_e)):
        uids = [500 + 100 * i + u for u in W]
        counts, want, wall = _drive(torch, e, lambda: (
            _submit(e, uids, prompts), e.run()))
        launches[f"tracer_turn{i + 1}"] = (counts, want, wall)
        toks = _tokens(e, uids)
        turns.append({"traced": e is traced_e, "wall_s": wall,
                      "tok_per_s": sum(map(len, toks.values())) / wall,
                      "tokens_equal_clean": [toks[u] for u in uids]
                      == [clean[u] for u in W]})
    trace = traced_e.export_trace()
    spans = tracing.complete_spans(trace)
    traced_uids = [u for u in traced_e.responses]
    rec = {"phase": "lifecycle_tracer", "turns": turns,
           "traced_tok_per_s": statistics.median(
               t["tok_per_s"] for t in turns if t["traced"]),
           "untraced_tok_per_s": statistics.median(
               t["tok_per_s"] for t in turns if not t["traced"]),
           "events": len(trace["traceEvents"]), "spans": len(spans),
           "requests": len(traced_uids),
           "validate": tracing.validate_chrome_trace(trace)}
    rec["spans_match"] = len(spans) == len(traced_uids) and all(
        spans[f"req {u}"]["args"]["generated"]
        == len(traced_e.responses[u].tokens)
        and spans[f"req {u}"]["args"]["finish"]
        == traced_e.responses[u].finish_reason for u in traced_uids)
    rec["ok"] = rec["validate"] == [] and rec["spans_match"] \
        and all(t["tokens_equal_clean"] for t in turns) \
        and _steady(traced_e, progs) and _steady(clean_e, progs)
    del traced_e
    _gate(rec)

    # --- the profiler window (trace_dir=) ---------------------------------
    tdir = Path(__file__).resolve().parent / "build" / "lifecycle_trace"
    shutil.rmtree(tdir, ignore_errors=True)
    window_e = _lifecycle_engine(model, params, faults=False,
                                 trace_dir=str(tdir))
    launches["profile_window"] = _drive(torch, window_e, lambda: (
        _submit(window_e, W[:8], prompts[:8]), window_e.run()))
    path = window_e.profile_trace
    names = set()
    if path and os.path.exists(path):
        with open(path) as f:
            names = {ev.get("name", "") for ev in json.load(f)["traceEvents"]}
    rec = {"phase": "lifecycle_profile_window",
           "trace_file": path and os.path.relpath(path, tdir.parent.parent),
           "bytes": os.path.getsize(path) if names else 0,
           "decode_kernels": sorted({n[:60] for n in names
                                     if "decode_" in n and "kernel" in n}),
           "rmsnorm_kernels": sorted({n[:60] for n in names
                                      if "rmsnorm_kernel" in n}),
           "tokens_equal_clean": _tokens(window_e, W[:8])
           == {u: clean[u] for u in W[:8]}}
    rec["ok"] = bool(names) and bool(rec["decode_kernels"]) \
        and bool(rec["rmsnorm_kernels"]) and rec["tokens_equal_clean"] \
        and _steady(window_e, progs)
    del window_e
    shutil.rmtree(tdir, ignore_errors=True)
    _gate(rec)

    # --- host syncs under the profiler: poison, cancel, preemption -------
    e = chaos_e
    polls = e.metrics.counters["trace_polls"]
    marks = {}

    def sync_run():
        _submit(e, [700 + u for u in range(8)], prompts[:8])
        _fill_slots(e)
        e.tick()
        _submit(e, [708], prompts[8:9], priority=1)
        e.tick()                         # 708 displaces a stream
        sched.on("nan_logits", step=e._steps + 4, slot=5)
        e.tick()
        marks["cancel"] = e.cancel(702)
        e.run()

    p0, pre0 = polls.value, e.latency_stats()["preemptions"]
    n0 = len(e.step_kinds)
    kernels.reset_launch_counts()
    prof, wall_ms = _profiled(torch, sync_run)
    counts = kernels.launch_counts()
    launches["syncs"] = (counts, _expected_launches(
        cfg, e, True, e.step_kinds[n0:]), wall_ms / 1e3)
    calls = {ev.key: ev.count for ev in prof.key_averages()
             if ev.device_type == DeviceType.CPU}
    reasons = {u: e.responses[u].finish_reason for u in range(700, 709)}
    rec = {"phase": "lifecycle_syncs", "polls": polls.value - p0,
           "cudaStreamSynchronize": calls.get("cudaStreamSynchronize", 0),
           "preemptions": e.latency_stats()["preemptions"] - pre0,
           "cancelled": marks["cancel"], "reasons": reasons,
           "host_calls": {k: calls.get(k, 0) for k in HOST_CALLS}}
    prof, _ = _profiled(torch, lambda: (e._set_poison(3),
                                        e._clear_poison()))
    calls = {ev.key: ev.count for ev in prof.key_averages()
             if ev.device_type == DeviceType.CPU}
    rec["poison_alone"] = {k: calls.get(k, 0) for k in HOST_CALLS}
    rec["ok"] = rec["polls"] > 0 \
        and rec["cudaStreamSynchronize"] == 2 * rec["polls"] \
        and rec["preemptions"] >= 1 and marks["cancel"] \
        and list(reasons.values()).count("error") == 1 \
        and reasons[702] == "cancelled" and reasons[708] == "length" \
        and rec["poison_alone"]["cudaStreamSynchronize"] == 0 \
        and rec["poison_alone"]["cudaMemcpyAsync"] == 0 \
        and _steady(e, progs) and not bool(e._poison.any())
    _gate(rec)
    e._paged.check_invariants()
    live = e._paged.live_pages
    del chaos_e, e, d

    # --- the poison lane's cost and the counters of every part -----------
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    logits = torch.randn(8, cfg.vocab, device="cuda")
    lane = torch.zeros(8, device="cuda")
    lane_ms = median_ms(torch, lambda: logits + lane[:, None], flush)
    del flush
    rec = {"phase": "lifecycle",
           "launches": {k: {"counted": {n: v for n, v in c.items() if v},
                            "expected": {n: v for n, v in w.items() if v},
                            "equal": c == w, "wall_s": t}
                        for k, (c, w, t) in launches.items()},
           "poison_lane_ms": lane_ms,
           "poison_lane_bound_ms": bound_ms(2 * logits.nbytes + lane.nbytes,
                                            0, "float32")[0],
           "poison_lane_reckoned_us": POISON_US_RECKONED,
           "serve_decode_ms_p50": serve_rec["decode_ms_p50"],
           "serve_decode_ms_p50_before_lane":
               SERVE_DECODE_MS_P50_BEFORE_LANE,
           "chaos_engine_pages_live_after": live,
           "seconds": time.perf_counter() - t_phase}
    rec["ok"] = all(v["equal"] for v in rec["launches"].values()) \
        and live == 0
    del clean_e, c, p
    gc.collect()
    _gate(rec)
    return rec


# --------------------------------------------------------------------- #
# the prefix cache on the graph-captured steps
# --------------------------------------------------------------------- #
#: the prefix phase's engines: the lifecycle phase's shape (llama3.2-1b
#: at full width on graphs, 8 slots, chunks of 128), on rings or on a
#: pool of pages of 16; the hot engines' budget in tokens
PREFIX_ENGINE = dict(max_batch=8, cache_len=1024, prefill_chunk=128)
PREFIX_PAGED = dict(paged=True, page_size=16)
PREFIX_BUDGET = 8192
#: the shared header and the partial hits' share of it (both multiples
#: of the chunk: a hit resumes on a chunk boundary, so the hot run's
#: chunks have the cold run's shapes), and the requests behind each
PREFIX_HEADER, PREFIX_PARTIAL, PREFIX_FULL_N, PREFIX_PARTIAL_N = \
    512, 256, 12, 4
#: the eviction part's budget, and the pressure part's pool (pages)
PREFIX_EVICT_BUDGET, PREFIX_PRESSURE_PAGES = 1024, 216
#: host calls that must not appear in a hit's copies: a stream sync and
#: a synchronous copy (``_profiled``'s own device syncs bracket the call)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaMemcpy")


def _prefix_prompts(vocab):
    """From the seed: 12 prompts of the 512-token header and a tail of
    32-256 tokens of their own, then 4 of its first 256 tokens, 256 of
    their own and a tail (partial hits at 256); 4 other 512-token headers
    with tails (the eviction and pressure parts); 4 prompts of 600 tokens
    sharing nothing (the pressure part)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 5)
    header = rng.integers(0, vocab, PREFIX_HEADER)

    def tail():
        return rng.integers(0, vocab, int(rng.integers(32, 257)))

    shared = [np.concatenate([header, tail()])
              for _ in range(PREFIX_FULL_N)]
    shared += [np.concatenate([header[:PREFIX_PARTIAL],
                               rng.integers(0, vocab, 256), tail()])
               for _ in range(PREFIX_PARTIAL_N)]
    others = [np.concatenate([rng.integers(0, vocab, PREFIX_HEADER), tail()])
              for _ in range(4)]
    plain = [rng.integers(0, vocab, 600) for _ in range(4)]
    return shared, others, plain


def _prefix_engine(model, params, pct, paged, **extra):
    """An engine of the prefix phase, warmed until every slot admitted
    once (``_warm``; the 16-token prompts publish nothing), then
    ``reset_stats()``: the watchdog armed, the stats counting from
    here."""
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.sampler import Sampler

    engine = Engine(model, params, sampler=Sampler(), seed=SEED,
                    faults=False, prefix_cache_tokens=pct,
                    **PREFIX_ENGINE, **(PREFIX_PAGED if paged else {}),
                    **extra)
    _warm(engine, "prefix")
    engine.reset_stats()
    return engine


def _host_calls(prof):
    from torch.autograd import DeviceType

    calls = {e.key: e.count for e in prof.key_averages()
             if e.device_type == DeviceType.CPU}
    return {k: calls.get(k, 0) for k in HOST_CALLS + SYNC_CALLS[1:]}


def _no_sync(calls):
    return all(calls[k] == 0 for k in SYNC_CALLS)


def _serve_run(torch, engine, uids, prompts, launches, key):
    """Serve ``prompts`` to the end with the counters set to 0 just
    before; returns the run's record (steps by kind, wall, TTFT, ITL and
    decode ms/step p50 of the engine's stats since its reset)."""
    n0 = len(engine.step_kinds)
    launches[key] = _drive(torch, engine, lambda: (
        _submit(engine, uids, prompts), engine.run()))
    kinds = engine.step_kinds[n0:]
    st = engine.latency_stats()
    return {"mixed_steps": kinds.count("mixed"),
            "plain_steps": kinds.count("plain"),
            "wall_s": launches[key][2],
            "tok_per_s": sum(len(engine.responses[u].tokens)
                             for u in uids) / launches[key][2],
            **{k: st.get(k) for k in ("ttft_ms_p50", "itl_ms_p50",
                                      "decode_ms_p50")}}


def _prefix_layout(torch, model, params, shared, paged, launches, flush):
    """The main part on one layout: a cold and a hot engine serve the 16
    shared-header requests; the hot engine serves them again under the
    profiler (all 16 hit); then a hit's host calls alone and, on the
    pool, a forced copy-on-write split; the entries dropped, the pool
    drains. Returns (record, the cold engine, its tokens)."""
    from repro_torch import kernels

    lay = "paged" if paged else "ring"
    cfg = model.cfg
    uids = list(range(len(shared)))
    cold = _prefix_engine(model, params, 0, paged)
    progs = cold.program_cache_sizes()
    cold_run = _serve_run(torch, cold, uids, shared, launches, f"{lay}_cold")
    want = _tokens(cold, uids)
    hot = _prefix_engine(model, params, PREFIX_BUDGET, paged)
    hot_run = _serve_run(torch, hot, uids, shared, launches, f"{lay}_hot")
    st = hot.latency_stats()
    rec = {"phase": f"prefix_{lay}", **PREFIX_ENGINE,
           **(PREFIX_PAGED if paged else {}), "requests": len(shared),
           "header": PREFIX_HEADER, "partial": PREFIX_PARTIAL,
           "max_new_tokens": LIFECYCLE_NEW, "budget": PREFIX_BUDGET,
           "prompt_lens": [len(p) for p in shared],
           "cold": cold_run, "hot": hot_run,
           "tokens_equal_cold": _tokens(hot, uids) == want,
           **{k: st[k] for k in ("prefix_hits", "prefix_hit_tokens",
                                 "prefix_entries", "prefix_tokens",
                                 "prefix_misses")}}
    hits_want = (PREFIX_FULL_N - 1, PREFIX_PARTIAL_N)
    ok = rec["tokens_equal_cold"] \
        and st["prefix_hits"] == sum(hits_want) \
        and st["prefix_hit_tokens"] == hits_want[0] * PREFIX_HEADER \
        + hits_want[1] * PREFIX_PARTIAL
    if paged:
        rec.update({k: st[k] for k in ("kv_alias_pages", "kv_cow_splits")})
        ok = ok and st["kv_alias_pages"] == (
            hits_want[0] * PREFIX_HEADER + hits_want[1] * PREFIX_PARTIAL) \
            // PREFIX_PAGED["page_size"] and st["kv_cow_splits"] == 0

    # the same requests again under the profiler: every one hits
    polls = hot.metrics.counters["trace_polls"]
    p0, n0, h0 = polls.value, len(hot.step_kinds), st["prefix_hits"]
    uids2 = [100 + u for u in uids]
    kernels.reset_launch_counts()
    prof, wall_ms = _profiled(torch, lambda: (
        _submit(hot, uids2, shared), hot.run()))
    launches[f"{lay}_hot_profiled"] = (
        kernels.launch_counts(),
        _expected_launches(cfg, hot, paged, hot.step_kinds[n0:]),
        wall_ms / 1e3)
    calls = _host_calls(prof)
    rec["profiled"] = {
        "polls": polls.value - p0, "host_calls": calls,
        "hits": hot.latency_stats()["prefix_hits"] - h0,
        "tokens_equal_cold": [_tokens(hot, uids2)[100 + u] for u in uids]
        == [want[u] for u in uids]}
    ok = ok and rec["profiled"]["tokens_equal_cold"] \
        and rec["profiled"]["hits"] == len(uids) \
        and rec["profiled"]["polls"] > 0 \
        and calls["cudaStreamSynchronize"] == 2 * rec["profiled"]["polls"]

    # a hit's host calls alone, on an idle slot
    kv, _, Q = hot.prefix_cache.lookup(shared[0])
    b = 0
    if paged:
        pk = hot._paged
        ps = PREFIX_PAGED["page_size"]
        pinned = []

        def alias():
            pk.release_slot(b)
            pk.alias_prefix(b, kv[:Q // ps])
            hot._reset_slot(b, Q)
            hot._push_block_tables()

        alias_calls = _host_calls(_profiled(torch, alias)[0])
        publish_calls = _host_calls(_profiled(
            torch, lambda: pinned.append(pk.snapshot_prefix(b, Q)))[0])
        pk.release_pages(pinned[0])
        # part 0: a forced copy-on-write split on the aliased pages
        split0 = pk.cow_splits
        before = {k: sub[k][:, kv[:2]].clone()
                  for sub in hot.cache.values() for k in sub
                  if k in ("kp", "vp")}
        split_calls = _host_calls(_profiled(
            torch, lambda: hot._provision(b, 0, 2 * ps))[0])
        new = [int(p) for p in pk.block_tables[b, :2]]
        rec["hit_host_calls"] = {"alias_and_stamp": alias_calls,
                                 "publish": publish_calls}
        rec["forced_split"] = {
            "splits": pk.cow_splits - split0, "host_calls": split_calls,
            "pages_equal": all(torch.equal(
                next(iter(hot.cache.values()))[k][:, new], v)
                for k, v in before.items()) and not set(new) & set(kv)}
        pk.release_slot(b)
        hot._push_block_tables()
        pk.check_invariants(hot.prefix_cache.entries())
        ok = ok and _no_sync(alias_calls) and _no_sync(publish_calls) \
            and _no_sync(split_calls) and rec["forced_split"]["splits"] == 2 \
            and rec["forced_split"]["pages_equal"]
    else:
        nbytes = 2 * sum(t[:, :, :Q].nbytes for part in kv.values()
                         for t in part.values())
        mat = _profiled(torch, lambda: hot._materialize(b, kv, Q))[0]
        ext = _profiled(torch, lambda: hot._extract(b, Q))[0]
        rec["hit_host_calls"] = {"materialize": _host_calls(mat),
                                 "extract": _host_calls(ext)}
        rec["hit_copies"] = {
            "tokens": Q, "bytes_moved": nbytes,
            "materialize_ms": median_ms(
                torch, lambda: hot._materialize(b, kv, Q), flush),
            "extract_ms": median_ms(torch, lambda: hot._extract(b, Q),
                                    flush),
            "bound_ms": bound_ms(nbytes, 0, cfg.dtype)[0]}
        for name, prof in (("materialize", mat), ("extract", ext)):
            rows = _device_rows(prof)[0]
            rec["hit_copies"][f"{name}_device_ms"] = sum(r[0] for r in rows)
            rec["hit_copies"][f"{name}_kernels"] = sum(r[1] for r in rows)
        ok = ok and all(_no_sync(c) for c in rec["hit_host_calls"].values())
    rec["programs"] = hot.program_cache_sizes()
    ok = ok and _steady(hot, progs) and _steady(cold, progs)
    if paged:
        while hot.prefix_cache.drop_lru():
            pass
        pk.check_invariants()
        rec["pages_live_after_drop"] = pk.live_pages
        rec["cold_pages_live"] = cold._paged.live_pages
        ok = ok and pk.live_pages == 0 and cold._paged.live_pages == 0
    rec["ok"] = ok
    del hot
    gc.collect()
    _gate(rec)
    return rec, cold, want


def prefix(torch, model, params):
    """The prefix cache on the card's graph-captured steps, at full width
    (llama3.2-1b, 16 layers, bf16; ``PREFIX_ENGINE``), greedy. Every
    engine is warmed until each slot admitted once, so a capture in any
    part fails it. One line a part:

    * ``prefix_ring`` / ``prefix_paged``: 12 requests behind one 512-token
      header and 4 behind its first 256 tokens, 64 new each, on a cold
      engine (no prefix cache) and a hot one (8192 tokens): tokens equal,
      15 hits of 6656 tokens, on the pool 416 alias pages and no split;
      mixed steps, TTFT, ITL and decode ms/step p50 of both; the hot
      engine serves them again under the profiler (16 hits,
      ``cudaStreamSynchronize`` = 2 x polls); a hit's host calls alone
      (rings: materialize and extract, timed, with the kernels they
      launch; pool: the alias and stamp, the publication's pin) make no
      host sync and no synchronous copy; on the pool a forced
      copy-on-write split copies its 2 pages bitwise with no sync, and
      the pool drains once the entries go;
    * ``prefix_evict``: a 1024-token budget and 4 distinct headers twice
      (paged): >= 2 evictions, <= 1024 tokens stored, tokens equal cold;
    * ``prefix_pressure``: a pool of 216 pages: 3 headers' streams leave
      their entries pinned, then 4 unrelated 600-token streams admit and
      grow only because the ladder evicts entries: no preemption, >= 1
      eviction, tokens equal cold;
    * ``prefix_int8``: 4 of the header's requests on an int8 KV pool:
      hot = cold, 3 hits, the entry's scale pages written, the pool
      drains (the rings' int8 copies are held by the card tests);
    * ``prefix``: the launch counters of every run against its step
      trace, and the phase's seconds."""
    t_phase = time.perf_counter()
    cfg = model.cfg
    shared, others, plain = _prefix_prompts(cfg.vocab)
    launches = {}
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    ring_rec, cold, _ = _prefix_layout(torch, model, params, shared, False,
                                       launches, flush)
    del cold, flush
    gc.collect()
    paged_rec, cold, _ = _prefix_layout(torch, model, params, shared, True,
                                        launches, None)
    progs = cold.program_cache_sizes()

    # --- eviction under the token budget (paged) ------------------------
    evict_prompts = others + others
    ev_uids = [200 + u for u in range(len(evict_prompts))]
    _serve_run(torch, cold, ev_uids, evict_prompts, launches, "evict_cold")
    e = _prefix_engine(model, params, PREFIX_EVICT_BUDGET, True)
    ev_run = _serve_run(torch, e, ev_uids, evict_prompts, launches,
                        "evict_hot")
    st = e.latency_stats()
    rec = {"phase": "prefix_evict", "budget": PREFIX_EVICT_BUDGET,
           "requests": len(evict_prompts), "run": ev_run,
           **{k: st[k] for k in ("prefix_evictions", "prefix_tokens",
                                 "prefix_entries", "prefix_hits",
                                 "kv_pages_released")},
           "tokens_equal_cold": _tokens(e, ev_uids) == _tokens(cold,
                                                               ev_uids)}
    while e.prefix_cache.drop_lru():
        pass
    rec["pages_live_after_drop"] = e._paged.live_pages
    rec["ok"] = rec["tokens_equal_cold"] and st["prefix_evictions"] >= 2 \
        and st["prefix_tokens"] <= PREFIX_EVICT_BUDGET \
        and e._paged.live_pages == 0 and _steady(e, progs)
    del e
    gc.collect()
    _gate(rec)

    # --- pool pressure: the ladder's prefix-reclaim rung -----------------
    a_uids = [300 + u for u in range(3)]
    b_uids = [310 + u for u in range(4)]
    for uids, prompts in ((a_uids, others[:3]), (b_uids, plain)):
        _serve_run(torch, cold, uids, prompts, launches, f"pressure_cold{uids[0]}")
    e = _prefix_engine(model, params, PREFIX_BUDGET, True,
                       num_pages=PREFIX_PRESSURE_PAGES)
    a_run = _serve_run(torch, e, a_uids, others[:3], launches,
                       "pressure_hot_a")
    pinned = e._paged.live_pages
    b_run = _serve_run(torch, e, b_uids, plain, launches, "pressure_hot_b")
    st = e.latency_stats()
    rec = {"phase": "prefix_pressure", "num_pages": PREFIX_PRESSURE_PAGES,
           "first": a_run, "then": b_run,
           "pages_pinned_by_entries_between": pinned,
           **{k: st[k] for k in ("preemptions", "prefix_evictions",
                                 "prefix_entries", "kv_pages_live")},
           "tokens_equal_cold": _tokens(e, a_uids + b_uids)
           == _tokens(cold, a_uids + b_uids)}
    while e.prefix_cache.drop_lru():
        pass
    rec["pages_live_after_drop"] = e._paged.live_pages
    rec["ok"] = rec["tokens_equal_cold"] and st["preemptions"] == 0 \
        and st["prefix_evictions"] >= 1 and e._paged.live_pages == 0 \
        and _steady(e, progs) and _steady(cold, progs) \
        and cold._paged.live_pages == 0
    del e, cold
    gc.collect()
    _gate(rec)

    # --- an int8 KV pool -------------------------------------------------
    uids = list(range(4))
    runs = {}
    for name, pct in (("cold", 0), ("hot", PREFIX_BUDGET)):
        e = _prefix_engine(model, params, pct, True, kv_cache_dtype="int8")
        _serve_run(torch, e, uids, shared[:4], launches, f"int8_{name}")
        runs[name] = _tokens(e, uids)
        runs[f"{name}_steady"] = _steady(e, progs)
    st = e.latency_stats()
    kv, _, Q = e.prefix_cache.lookup(shared[0])
    sub = next(iter(e.cache.values()))
    rec = {"phase": "prefix_int8", "requests": len(uids),
           "tokens_equal_cold": runs["hot"] == runs["cold"],
           "prefix_hits": st["prefix_hits"],
           "kv_alias_pages": st["kv_alias_pages"],
           "scale_pages_set": bool((sub["kp_scale"][:, kv[:Q // 16]] != 0)
                                   .all()),
           "pool_dtypes": {k: str(sub[k].dtype) for k in
                           ("kp", "kp_scale")}}
    while e.prefix_cache.drop_lru():
        pass
    rec["pages_live_after_drop"] = e._paged.live_pages
    rec["ok"] = rec["tokens_equal_cold"] and rec["prefix_hits"] == 3 \
        and rec["scale_pages_set"] and e._paged.live_pages == 0 \
        and runs["cold_steady"] and runs["hot_steady"]
    del e
    gc.collect()
    _gate(rec)

    rec = {"phase": "prefix",
           "launches": {k: {"counted": {n: v for n, v in c.items() if v},
                            "expected": {n: v for n, v in w.items() if v},
                            "equal": c == w, "wall_s": t}
                        for k, (c, w, t) in launches.items()},
           "mixed_steps_cold_hot": {
               r["phase"]: (r["cold"]["mixed_steps"], r["hot"]["mixed_steps"])
               for r in (ring_rec, paged_rec)},
           "seconds": time.perf_counter() - t_phase}
    rec["ok"] = all(v["equal"] for v in rec["launches"].values())
    gc.collect()
    torch.cuda.empty_cache()
    _gate(rec)
    return rec


# --------------------------------------------------------------------- #
# the serving fleet: engine replicas on one card
# --------------------------------------------------------------------- #
#: every replica's engine, and the one engine the fleet is held against:
#: the serve phase's slots, ring and chunks, a pool of pages of 16 and a
#: 1024-token prefix cache
FLEET_ENGINE = dict(max_batch=8, cache_len=1024, prefill_chunk=128,
                    paged=True, page_size=16, prefix_cache_tokens=1024)
#: replicas; requests (prompts of 64-512 tokens, every other one behind
#: a shared head of ``FLEET_HEAD`` tokens), new tokens each
FLEET_REPLICAS, FLEET_REQUESTS, FLEET_NEW, FLEET_HEAD = 3, 24, 32, 256
#: ``benchmarks/check_fleet.py``'s chaos schedule: replica 0 killed at
#: fleet tick 2, and the first dispatch from tick 2 on (a failover's
#: redispatch) lost in flight
FLEET_KILL_RID, FLEET_KILL_TICK = 0, 2
#: how far ``memory_allocated()`` may move between two rejoins
FLEET_REJOIN_MIB = 16


def _fleet_prompts(vocab):
    import numpy as np

    rng = np.random.default_rng(SEED + 8)
    head = rng.integers(0, vocab, FLEET_HEAD)
    out = []
    for i in range(FLEET_REQUESTS):
        if i % 2:
            tail = rng.integers(0, vocab, int(rng.integers(32, 257)))
            out.append(np.concatenate([head, tail]))
        else:
            out.append(rng.integers(0, vocab, int(rng.integers(64, 513))))
    return out


def _chaos_faults():
    from repro_torch.serving.faults import Faults

    return (Faults(seed=SEED)
            .on("replica_crash", step=FLEET_KILL_TICK, slot=FLEET_KILL_RID)
            .on("router_drop", step=FLEET_KILL_TICK))


def _fleet_kwargs(**extra):
    from repro_torch.serving.sampler import Sampler

    return dict(FLEET_ENGINE, sampler=Sampler(), seed=SEED, **extra)


def _new_fleet(model, params, *, warm, engine_kwargs=None, **kw):
    """A fleet of ``FLEET_REPLICAS`` engines over the one ``params``
    tree; ``warm``: each replica admits into every slot once (``_warm``),
    then the fleet is marked steady."""
    from repro_torch.serving.fleet import Fleet

    kw.setdefault("faults", False)
    fl = Fleet(model, params, replicas=FLEET_REPLICAS,
               engine_kwargs=engine_kwargs or _fleet_kwargs(), **kw)
    if warm:
        for r in fl.replicas:
            _warm(r.engine, f"fleet replica {r.rid}")
        fl.mark_steady()
    return fl


def _fleet_submit(target, prompts, uids, uid0=0, new=FLEET_NEW):
    """Submit ``prompts[uid - uid0]`` for each of ``uids``."""
    from repro_torch.serving.request import Request

    for uid in uids:
        target.submit(Request(uid=uid, prompt=prompts[uid - uid0],
                              max_new_tokens=new))


def _fleet_drive(fl, steps=None, limit=20000):
    """Tick ``fl`` until it has no work: each tick's wall s and the
    tokens each request had delivered after it."""
    ticks = []
    for _ in range(limit):
        if not fl.has_work:
            return ticks
        t0 = time.perf_counter()
        fl.tick(steps)
        ticks.append((time.perf_counter() - t0,
                      {u: len(r.tokens) for u, r in fl.responses.items()}))
    raise AssertionError(f"the fleet still had work after {limit} ticks")


def _fleet_expected(cfg, fl, n0):
    """The launches the replicas' step traces since ``n0`` (steps a
    replica) imply, summed over the replicas."""
    out = {}
    for r in fl.replicas:
        e = _expected_launches(cfg, r.engine, True,
                               r.engine.step_kinds[n0[r.rid]:])
        out = {k: out.get(k, 0) + v for k, v in e.items()}
    return out


def _graph_pool_bytes(torch, engines):
    """Device bytes of the segments of each engine's graph pool."""
    segs = torch.cuda.memory_snapshot()
    return {k: sum(seg["total_size"] for seg in segs
                   if tuple(seg.get("segment_pool_id", ()))
                   == tuple(e._graph_pool or ()))
            for k, e in engines.items()}


def _replayed(fl):
    """Requests resubmitted with delivered tokens (a replay)."""
    return sorted(u for u, e in fl._entries.items()
                  if any(a.base > 0 for a in e.assigns))


def _fleet_streams(torch, model, params, fl, prompts, want):
    """Each stream against the one engine's tokens ``want``: a stream
    never replayed must be bitwise equal; a replayed one (its chunked
    extends have other bf16 GEMM shapes) equal, or first leaving the
    engine's stream at a near tie (``_near_ties``: the top-2 margin
    within ``SPEC_MARGIN_TOL`` of max|logit|)."""
    got = {u: list(r.tokens) for u, r in fl.responses.items()}
    replayed = _replayed(fl)
    ties = _near_ties(torch, model, params, prompts,
                      {u: want[u] for u in replayed},
                      {u: got[u] for u in replayed})
    rec = {"replayed": replayed,
           "replayed_equal": sum(got[u] == want[u] for u in replayed),
           "fresh_unequal": [u for u in got
                             if u not in replayed and got[u] != want[u]],
           "divergences": ties,
           "beyond_tie": [u for u, t in ties.items()
                          if t.get("margin_over_max") is None
                          or t["margin_over_max"] > SPEC_MARGIN_TOL]}
    rec["ok"] = not rec["fresh_unequal"] and not rec["beyond_tie"]
    return rec


def _drained(fl):
    """Survivors hold no work and, their prefix caches cleared, no live
    page; their allocator invariants hold."""
    out = {}
    for r in fl.replicas:
        if not r.alive:
            continue
        eng = r.engine
        while eng.prefix_cache.drop_lru():
            pass
        eng._paged.check_invariants()
        out[r.rid] = {"has_work": eng.has_work,
                      "kv_pages_live": eng._paged.live_pages}
    return out, all(not v["has_work"] and v["kv_pages_live"] == 0
                    for v in out.values())


def _one_engine(torch, model, params, prompts, max_batch):
    """The one engine: warmed, stats reset (steady), then the fleet's
    requests; its tokens and run record."""
    from repro_torch.serving.engine import Engine

    engine = Engine(model, params, faults=False,
                    **_fleet_kwargs(max_batch=max_batch))
    _warm(engine, f"fleet single engine ({max_batch} slots)")
    engine.reset_stats()
    uids = range(FLEET_REQUESTS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _fleet_submit(engine, prompts, uids)
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = engine.latency_stats()
    tokens = {u: list(engine.responses[u].tokens) for u in uids}
    n_tok = sum(map(len, tokens.values()))
    rec = {"max_batch": max_batch, "wall_s": wall, "tok_per_s": n_tok / wall,
           "steady_compiles": engine.metrics.counters[
               "steady_compiles"].value,
           **{k: st.get(k) for k in ("ttft_ms_p50", "ttft_ms_p99",
                                     "decode_ms_p50", "prefix_hits")}}
    del engine
    gc.collect()
    return tokens, rec


def fleet(torch, model, params):
    """The fleet, clean, at full width on the card's graphs (llama3.2-1b,
    16 layers, bf16): ``FLEET_REPLICAS`` replicas of ``FLEET_ENGINE``
    over one params tree, each warmed (every slot admitted once) and the
    fleet marked steady, serve ``FLEET_REQUESTS`` requests. Gates: every
    stream bitwise equal to one engine's on the same requests (same
    arguments, this call), at least one affinity hit, one dispatch a
    request, no death, no capture after warm-up on any replica, the
    launch counters equal to the replicas' summed step traces; a
    profiled second batch: no capture, the launch counters confirmed by
    the profiler's count of their kernel templates, and
    ``cudaStreamSynchronize`` = 2 x the polls summed over replicas.
    Printed: weight bytes (once), each replica's KV and graph-pool
    bytes, fleet tok/s, fleet TTFT p50 / p99, ms a fleet tick, degraded
    transitions, and the one engine's tok/s at 8 slots and at 24 (one
    card ticks the replicas one after another: no gain is claimed).
    Returns the fleet, the prompts and the one engine's tokens."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.quant import quantized_stats

    t_phase = time.perf_counter()
    parts = {}
    cfg = model.cfg
    prompts = _fleet_prompts(cfg.vocab)
    want, one8 = _one_engine(torch, model, params, prompts, 8)
    tokens24, one24 = _one_engine(torch, model, params, prompts,
                                  FLEET_REPLICAS * 8)
    one24["tokens_equal_8_slots"] = sum(tokens24[u] == want[u]
                                        for u in want)
    torch.cuda.synchronize()
    parts["one_engines"] = time.perf_counter() - t_phase
    mem0 = torch.cuda.memory_allocated()
    fl = _new_fleet(model, params, warm=True)
    torch.cuda.synchronize()
    mem_warm = torch.cuda.memory_allocated()
    parts["fleet_build_and_warm"] = time.perf_counter() - t_phase \
        - sum(parts.values())
    n0 = {r.rid: len(r.engine.step_kinds) for r in fl.replicas}
    builds0 = {r.rid: r.engine.metrics.counters["compiles_total"].value
               for r in fl.replicas}
    kernels.reset_launch_counts()
    _fleet_submit(fl, prompts, range(FLEET_REQUESTS))
    ticks = _fleet_drive(fl)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    wall = sum(w for w, _ in ticks)
    want_counts = _fleet_expected(cfg, fl, n0)
    st = fl.latency_stats()
    got = {u: list(r.tokens) for u, r in fl.responses.items()}
    n_tok = sum(map(len, got.values()))
    walls_ms = sorted(w * 1e3 for w, _ in ticks)
    rec = {"phase": "fleet", "arch": cfg.name, "n_layers": cfg.n_layers,
           "dtype": cfg.dtype, "replicas": FLEET_REPLICAS,
           "engine": {k: v for k, v in FLEET_ENGINE.items()},
           "requests": FLEET_REQUESTS, "max_new_tokens": FLEET_NEW,
           "prompt_lens": [len(p) for p in prompts],
           "streams_equal_one_engine": sum(got[u] == want[u] for u in want),
           "dispatches": st["dispatches"], "replica_deaths":
           st["replica_deaths"], "affinity_hits": fl.router.affinity_hits,
           "steady_compiles": fl.steady_compiles(),
           "builds_in_run": {r.rid: r.engine.metrics.counters[
               "compiles_total"].value - builds0[r.rid]
               for r in fl.replicas},
           "launches": counts, "launches_expected": want_counts,
           "fleet_ticks": len(ticks), "wall_s": wall,
           "tok_per_s": n_tok / wall,
           "fleet_ttft_ms_p50": st.get("fleet_ttft_ms_p50"),
           "fleet_ttft_ms_p99": st.get("fleet_ttft_ms_p99"),
           "tick_ms_mean": wall * 1e3 / len(ticks),
           "tick_ms_p50": walls_ms[len(walls_ms) // 2],
           "tick_ms_max": walls_ms[-1],
           "degraded_transitions": {
               r.rid: sum(ev["name"] == "degraded" and ev["args"]["rid"]
                          == r.rid for ev in fl._events)
               for r in fl.replicas},
           "replica_states": {r.rid: r.state for r in fl.replicas},
           "replica_ticks": {r.rid: r.ticks for r in fl.replicas},
           "replica_prefix_hits": {
               r.rid: st[f"replica_{r.rid}"].get("prefix_hits")
               for r in fl.replicas},
           "one_engine_8_slots": one8, "one_engine_24_slots": one24,
           "weight_bytes": quantized_stats(params)["weight_bytes"],
           "table_bytes": params["embed"]["table"].nbytes,
           "replica_kv_bytes": {r.rid: _kv_bytes(r.engine)
                                for r in fl.replicas},
           "replica_graph_pool_bytes": _graph_pool_bytes(
               torch, {r.rid: r.engine for r in fl.replicas}),
           "fleet_memory_allocated_bytes": mem_warm - mem0}
    rec["ok"] = rec["streams_equal_one_engine"] == FLEET_REQUESTS \
        and len(got) == FLEET_REQUESTS \
        and rec["affinity_hits"] >= 1 \
        and rec["dispatches"] == FLEET_REQUESTS \
        and rec["replica_deaths"] == 0 \
        and not any(rec["steady_compiles"].values()) \
        and counts == want_counts

    parts["run"] = time.perf_counter() - t_phase - sum(parts.values())

    # a profiled second batch on the steady fleet
    rng = np.random.default_rng(SEED + 1)
    batch = [rng.integers(0, cfg.vocab, 256) for _ in range(6)]
    counters = {r.rid: r.engine.metrics.counters for r in fl.replicas}
    polls0 = {k: c["trace_polls"].value for k, c in counters.items()}
    n0 = {r.rid: len(r.engine.step_kinds) for r in fl.replicas}
    _fleet_submit(fl, batch, range(100, 106), uid0=100, new=16)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    prof, wall_ms = _profiled(torch, fl.run)
    counts = kernels.launch_counts()
    rows, lost = _device_rows(prof)
    polls = sum(c["trace_polls"].value - polls0[k]
                for k, c in counters.items())
    syncs = _host_calls(prof).get("cudaStreamSynchronize", 0)
    seen = _counted_vs_profiled(counts, rows)
    want_counts = _fleet_expected(cfg, fl, n0)
    busy = sum(ms for ms, _, _ in rows)
    prof_rec = {"polls": polls, "cudaStreamSynchronize": syncs,
                "steady_compiles": fl.steady_compiles(),
                "wall_ms_profiled": wall_ms, "device_kernel_ms": busy,
                "device_busy_share": busy / wall_ms if wall_ms else None,
                "launches_counted_vs_profiled": seen,
                "launches_equal_trace": counts == want_counts,
                "profiler_lost_spins": lost,
                "finished_length": sum(fl.responses[u].finish_reason
                                       == "length"
                                       for u in range(100, 106)),
                "top": [{"kernel": k[:90], "ms": ms, "calls": c}
                        for ms, c, k in rows[:8]]}
    prof_rec["ok"] = polls > 0 and syncs == 2 * polls \
        and not any(prof_rec["steady_compiles"].values()) \
        and counts == want_counts and _counters_confirmed(seen, lost) \
        and prof_rec["finished_length"] == 6
    rec["profiled_batch"] = prof_rec
    rec["ok"] = rec["ok"] and prof_rec["ok"]
    parts["profiled_batch"] = time.perf_counter() - t_phase \
        - sum(parts.values())
    rec["seconds"] = time.perf_counter() - t_phase
    rec["seconds_parts"] = parts
    _gate(rec)
    return fl, prompts, want, rec["launches"]


def fleet_chaos(torch, model, params, prompts, want):
    """``benchmarks/check_fleet.py``'s scenario at full width on the
    card: a warmed, steady fleet serves the requests while replica 0 is
    killed at fleet tick 2 and the failover's first redispatch is lost in
    flight. Gates: no request lost (every one finishes "length"), replica
    0 dead of "crash" with at least one request migrated, the drop
    detected once, every stream never replayed bitwise equal to the one
    engine's and every replayed one equal or leaving it at a near tie;
    on the survivors no capture and, their prefix caches cleared, no
    live page. Printed: the failover's cost, the ticks and ms from the
    kill to each migrated stream's next token."""
    t_phase = time.perf_counter()
    fl = _new_fleet(model, params, warm=True, faults=_chaos_faults())
    _fleet_submit(fl, prompts, range(FLEET_REQUESTS))
    ticks = _fleet_drive(fl)
    st = fl.latency_stats()
    migrated = sorted(u for u, e in fl._entries.items()
                      if e.req.preemptions)
    base = ticks[FLEET_KILL_TICK - 2][1]    # delivered when the kill came
    cost = {}
    for u in migrated:
        for t in range(FLEET_KILL_TICK - 1, len(ticks)):
            if ticks[t][1][u] > base[u]:
                cost[u] = {"ticks": t - FLEET_KILL_TICK + 2,
                           "ms": 1e3 * sum(w for w, _ in
                                           ticks[FLEET_KILL_TICK - 1:t + 1]),
                           "delivered_at_kill": base[u]}
                break
    streams = _fleet_streams(torch, model, params, fl, prompts, want)
    drained, empty = _drained(fl)
    dead = fl.replicas[FLEET_KILL_RID]
    rec = {"phase": "fleet_chaos", "schedule": [
        ("replica_crash", FLEET_KILL_TICK, FLEET_KILL_RID),
        ("router_drop", FLEET_KILL_TICK)],
        "finished": sum(r.finished for r in fl.responses.values()),
        "finished_length": sum(r.finish_reason == "length"
                               for r in fl.responses.values()),
        "replica_states": {r.rid: (r.state, r.death_reason)
                           for r in fl.replicas},
        **{k: st[k] for k in ("replica_deaths", "failovers",
                              "requests_migrated", "router_drops",
                              "redispatches", "dispatches")},
        "migrated": migrated, "failover_cost": cost,
        "streams": streams, "steady_compiles": fl.steady_compiles(),
        "survivors": drained, "fleet_ticks": len(ticks),
        "wall_s": sum(w for w, _ in ticks)}
    rec["ok"] = rec["finished_length"] == FLEET_REQUESTS \
        and len(fl.responses) == FLEET_REQUESTS \
        and dead.state == "dead" and dead.death_reason == "crash" \
        and st["requests_migrated"] >= 1 and st["router_drops"] == 1 \
        and len(cost) == len(migrated) and streams["ok"] and empty \
        and not any(n for rid, n in rec["steady_compiles"].items()
                    if rid != FLEET_KILL_RID)
    rec["seconds"] = time.perf_counter() - t_phase
    del fl
    gc.collect()
    _gate(rec)


def fleet_hang_hedge(torch, model, params, prompts, want):
    """The watchdog and hedging at full width on the card: replica 1
    hangs at fleet tick 2 (``hang_ticks`` 3) and is killed as "hang",
    its streams migrated (every request finishes "length"; streams
    gated as ``fleet_chaos`` gates them); then a fleet with
    ``hedge=True, hedge_delay_s=0`` on single-step ticks serves the
    first 8 requests: every hedge won or wasted, at least one issued,
    every token delivered once and each stream bitwise equal to the one
    engine's (a hedge starts from scratch)."""
    t_phase = time.perf_counter()
    fl = _new_fleet(model, params, warm=False, hang_ticks=3,
                    faults="replica_hang@2/1")
    _fleet_submit(fl, prompts, range(FLEET_REQUESTS))
    ticks = _fleet_drive(fl)
    st = fl.latency_stats()
    hung = fl.replicas[1]
    hang = {"replica_states": {r.rid: (r.state, r.death_reason)
                               for r in fl.replicas},
            "requests_migrated": st["requests_migrated"],
            "finished_length": sum(r.finish_reason == "length"
                                   for r in fl.responses.values()),
            "streams": _fleet_streams(torch, model, params, fl, prompts,
                                      want),
            "fleet_ticks": len(ticks)}
    hang["ok"] = hung.state == "dead" and hung.death_reason == "hang" \
        and st["requests_migrated"] >= 1 \
        and hang["finished_length"] == FLEET_REQUESTS \
        and hang["streams"]["ok"]
    del fl
    gc.collect()
    n = 8
    fl = _new_fleet(model, params, warm=False, hedge=True,
                    hedge_delay_s=0.0)
    _fleet_submit(fl, prompts, range(n))
    ticks = _fleet_drive(fl, steps=1)
    st = fl.latency_stats()
    got = {u: list(r.tokens) for u, r in fl.responses.items()}
    hedge = {k: st[k] for k in ("hedges_issued", "hedges_won",
                                "hedges_wasted", "dispatches")}
    hedge.update({"requests": n, "fleet_ticks": len(ticks),
                  "streams_equal_one_engine": sum(got[u] == want[u]
                                                  for u in range(n)),
                  "finished_length": sum(r.finish_reason == "length"
                                         for r in fl.responses.values())})
    hedge["ok"] = hedge["hedges_issued"] >= 1 \
        and hedge["hedges_won"] + hedge["hedges_wasted"] \
        == hedge["hedges_issued"] \
        and hedge["streams_equal_one_engine"] == n \
        and hedge["finished_length"] == n and len(got) == n
    del fl
    gc.collect()
    _gate({"phase": "fleet_hang_hedge", "hang": hang, "hedge": hedge,
           "seconds": time.perf_counter() - t_phase,
           "ok": hang["ok"] and hedge["ok"]})


def fleet_rejoin(torch, model, params, fl, prompts, want):
    """A rolling restart on the clean phase's fleet: replica 1 drained
    mid-run (every stream finishes "length" and equals the one
    engine's; the replica reaches ``drained``), rejoined (a fresh
    engine, warmed, then marked steady), a batch served, then drained
    and rejoined again. Gates: ``memory_allocated()`` after the second
    rejoin's warm-up within ``FLEET_REJOIN_MIB`` MiB of its value after
    the first; the rejoined engines capture in their warm-up and never
    after ``mark_steady`` (a batch after each rejoin); every batch's
    streams equal the one engine's."""
    t_phase = time.perf_counter()
    uids = range(FLEET_REQUESTS)
    batches, mem, builds = [], [], []

    def batch(uid0, drain_at=None):
        _fleet_submit(fl, prompts, [uid0 + u for u in uids], uid0=uid0)
        outstanding = None
        if drain_at is not None:
            for _ in range(drain_at):
                fl.tick()
            outstanding = fl._outstanding(1)
            fl.drain(1)
        _fleet_drive(fl)
        got = {u - uid0: list(fl.responses[u].tokens)
               for u in range(uid0, uid0 + FLEET_REQUESTS)}
        batches.append({
            "uid0": uid0, "outstanding_on_1_at_drain": outstanding,
            "equal_one_engine": sum(got[u] == want[u] for u in uids),
            "finished_length": sum(fl.responses[uid0 + u].finish_reason
                                   == "length" for u in uids),
            "steady_compiles": fl.steady_compiles()})

    def rejoin():
        old_kv = _kv_bytes(fl.replicas[1].engine)
        fl.rejoin(1)
        eng = fl.replicas[1].engine
        _warm(eng, "fleet_rejoin")
        warm_builds = eng.metrics.counters["compiles_total"].value
        eng.mark_steady()
        gc.collect()
        torch.cuda.synchronize()
        mem.append(torch.cuda.memory_allocated())
        builds.append({"warm_up": warm_builds, "replaced_kv_bytes": old_kv,
                       "reserved_bytes": torch.cuda.memory_reserved()})

    batch(200, drain_at=2)
    drained = fl.replicas[1].state
    rejoin()
    batch(300)
    fl.drain(1)
    fl.tick()
    drained2 = fl.replicas[1].state
    rejoin()
    batch(400)
    rec = {"phase": "fleet_rejoin", "batches": batches,
           "states_after_drain": [drained, drained2],
           "rejoins": fl.latency_stats()["rejoins"],
           "memory_allocated_after_rejoins": mem,
           "memory_moved_mib": (mem[1] - mem[0]) / 2**20,
           "rejoined_builds": builds}
    rec["ok"] = drained == "drained" and drained2 == "drained" \
        and batches[0]["outstanding_on_1_at_drain"] \
        and all(b["equal_one_engine"] == FLEET_REQUESTS
                and b["finished_length"] == FLEET_REQUESTS
                and not any(b["steady_compiles"].values())
                for b in batches) \
        and abs(mem[1] - mem[0]) <= FLEET_REJOIN_MIB * 2**20 \
        and all(b["warm_up"] > 0 for b in builds)
    rec["seconds"] = time.perf_counter() - t_phase
    _gate(rec)


def fleet_trace(torch, model, params, prompts):
    """``trace=True`` through a crash (replica 0 at fleet tick 2): the
    merged Chrome trace validates, has the fleet's lane (99) and one a
    replica (100, 101, 102), and the fleet lane holds ``replica_dead``
    and ``failover``; every request finishes "length"."""
    from repro_torch.serving.tracing import validate_chrome_trace

    t_phase = time.perf_counter()
    n = 6
    fl = _new_fleet(model, params, warm=False, trace=True,
                    faults=f"replica_crash@{FLEET_KILL_TICK}/"
                           f"{FLEET_KILL_RID}")
    _fleet_submit(fl, prompts, range(n))
    _fleet_drive(fl)
    trace = fl.export_trace()
    ev = trace["traceEvents"]
    lanes = sorted({e["pid"] for e in ev if e.get("ph") == "M"
                    and e["name"] == "process_name"})
    fleet_lane = [e["name"] for e in ev
                  if e.get("pid") == 99 and e.get("ph") == "i"]
    rec = {"phase": "fleet_trace", "events": len(ev), "lanes": lanes,
           "problems": validate_chrome_trace(trace)[:5],
           "fleet_lane": sorted(set(fleet_lane)),
           "finished_length": sum(r.finish_reason == "length"
                                  for r in fl.responses.values())}
    rec["ok"] = not rec["problems"] and lanes == [99, 100, 101, 102] \
        and "replica_dead" in fleet_lane and "failover" in fleet_lane \
        and rec["finished_length"] == n
    rec["seconds"] = time.perf_counter() - t_phase
    del fl
    gc.collect()
    _gate(rec)


def fleet_phases(torch, model, params):
    """The fleet phases in order; the clean phase's fleet serves the
    rolling restart last. Returns the clean run's launch counts."""
    t0 = time.perf_counter()
    fl, prompts, want, counts = fleet(torch, model, params)
    fleet_chaos(torch, model, params, prompts, want)
    fleet_hang_hedge(torch, model, params, prompts, want)
    fleet_trace(torch, model, params, prompts)
    fleet_rejoin(torch, model, params, fl, prompts, want)
    del fl
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "fleet_timing", "seconds": time.perf_counter() - t0})
    return counts


def fleet_exact(torch):
    """The chaos schedule's exact identity, in fp32: a 2-layer
    full-width llama3.2-1b on 3 replicas of 2 slots (chunks of 32, a
    pool of pages of 16, a prefix cache) serves 6 requests of 16-96
    tokens (16 new) while replica 0 is killed at fleet tick 2 and the
    first redispatch is lost. Every stream, the replayed ones included,
    must equal one engine's tokens on the card and the same fleet's
    tokens on the CPU; at least one stream is replayed."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models.model import build
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.fleet import Fleet
    from repro_torch.serving.sampler import Sampler

    t0 = time.perf_counter()
    cfg = get_arch("llama3.2-1b").replace(n_layers=2, dtype="float32",
                                          param_dtype="float32")
    cpu, gpu = build(cfg, "cpu"), build(cfg, "cuda")
    p_cpu = cpu.init(SEED)
    p_gpu = _tree_to(p_cpu, "cuda")
    rng = np.random.default_rng(SEED + 9)
    prompts = [rng.integers(0, cfg.vocab, int(L))
               for L in rng.integers(16, 97, 6)]
    ek = dict(max_batch=2, cache_len=128, prefill_chunk=32, paged=True,
              page_size=16, prefix_cache_tokens=256, seed=SEED)
    uids = range(len(prompts))

    one = Engine(gpu, p_gpu, sampler=Sampler(), faults=False, **ek)
    _fleet_submit(one, prompts, uids, new=16)
    want = {u: list(r.tokens) for u, r in one.run().items()}
    del one
    out = {}
    for name, model, params in (("gpu", gpu, p_gpu), ("cpu", cpu, p_cpu)):
        fl = Fleet(model, params, replicas=3, degrade_factor=1e9,
                   faults=_chaos_faults(),
                   engine_kwargs=dict(ek, sampler=Sampler()))
        _fleet_submit(fl, prompts, uids, new=16)
        fl.run()
        st = fl.latency_stats()
        out[name] = {"tokens": {u: list(r.tokens)
                                for u, r in fl.responses.items()},
                     "replayed": _replayed(fl),
                     **{k: st[k] for k in ("requests_migrated",
                                           "router_drops",
                                           "replica_deaths")}}
        del fl
    gc.collect()
    rec = {"phase": "fleet_exact", "arch": cfg.name, "n_layers": 2,
           "dtype": "float32", "prompt_lens": [len(p) for p in prompts],
           "max_new_tokens": 16,
           "gpu_equals_one_engine": out["gpu"]["tokens"] == want,
           "gpu_equals_cpu": out["gpu"]["tokens"] == out["cpu"]["tokens"],
           **{f"{name}_{k}": v for name, o in out.items()
              for k, v in o.items() if k != "tokens"}}
    rec["ok"] = rec["gpu_equals_one_engine"] and rec["gpu_equals_cpu"] \
        and len(rec["gpu_replayed"]) >= 1 \
        and rec["gpu_requests_migrated"] >= 1 \
        and rec["gpu_router_drops"] == 1
    rec["seconds"] = time.perf_counter() - t0
    _gate(rec)


# --------------------------------------------------------------------- #
# speculative decoding on the graph-captured steps
# --------------------------------------------------------------------- #
#: the spec phases' engine: the serve phase's (8 slots, 1024-token rings,
#: chunks of 128) at gamma 4
SPEC_ENGINE = dict(max_batch=8, cache_len=1024, prefill_chunk=128,
                   spec_gamma=4)
#: a bf16 stream that leaves the plain engine's may do so only at a near
#: tie: the plain stream's top-2 margin there within this share of
#: max|logit| (the bf16 gate's tolerance)
SPEC_MARGIN_TOL = TOL["bfloat16"]


def _serve_prompts(vocab):
    """The serve phase's 16 prompts (64-512 tokens from the seed)."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    lens = rng.integers(64, 513, 16)
    return [rng.integers(0, vocab, int(L)) for L in lens]


def _spec_warm(engine, phase, want):
    """Admit into every slot once (8 one-chunk admissions of 16-token
    prompts, 16 new each): every program built and, on graphs, captured;
    then ``reset_stats()``, which marks the engine steady and starts its
    stats (the spec counters included) from the run that follows."""
    import numpy as np

    from repro_torch.serving.request import Request

    rng = np.random.default_rng(SEED + 4)
    for uid in range(8):
        engine.submit(Request(uid=1000 + uid,
                              prompt=rng.integers(0, engine.model.cfg.vocab,
                                                  16),
                              max_new_tokens=16))
    engine.run()
    progs = engine.program_cache_sizes()
    if progs != want:
        raise AssertionError(f"{phase} warm-up built {progs}, not {want}")
    engine.reset_stats()
    return progs


def _kind_ms(engine, n0, kind):
    """Median wall ms of the engine's steps of ``kind`` since step
    ``n0`` (the burst averages ``latency_stats`` reads)."""
    kinds = engine.step_kinds[n0:]
    times = engine.step_times[n0:]
    vals = [t * 1e3 for k, t in zip(kinds, times) if k == kind]
    return statistics.median(vals) if vals else None


def _spec_serve(torch, engine, prompts):
    """Serve ``prompts`` (32 new tokens each) on a warmed engine with the
    counters set to 0 just before: (tokens by uid, launch counts, the
    counts the trace implies, the run's record)."""
    from repro_torch.serving.request import Request

    uids = list(range(len(prompts)))
    n0 = len(engine.step_kinds)
    polls0 = engine.metrics.counters["trace_polls"].value

    def run():
        for uid, p in zip(uids, prompts):
            engine.submit(Request(uid=uid, prompt=p, max_new_tokens=32))
        engine.run()

    counts, want, wall = _drive(torch, engine, run)
    kinds = engine.step_kinds[n0:]
    tokens = {u: list(engine.responses[u].tokens) for u in uids}
    st = engine.latency_stats()
    n_tok = sum(map(len, tokens.values()))
    rec = {"steps": len(kinds), "spec_steps": kinds.count("spec"),
           "admit_steps": kinds.count("admit"),
           "plain_steps": kinds.count("plain"),
           "mixed_steps": kinds.count("mixed"),
           "tokens": n_tok, "wall_s": wall, "tok_per_s": n_tok / wall,
           "polls": engine.metrics.counters["trace_polls"].value - polls0,
           "decode_ms_p50": _kind_ms(engine, n0, "spec" if engine.spec_gamma
                                     else "plain"),
           "launches": counts, "launches_expected": want,
           "finished_length": sum(
               engine.responses[u].finish_reason == "length" for u in uids),
           **{k: st.get(k) for k in ("spec_tokens_per_step",
                                     "spec_acceptance_rate", "ttft_ms_p50",
                                     "itl_ms_p50")}}
    return tokens, counts, want, rec


def _spec_syncs(torch, engine, phase):
    """A second batch (8 prompts of 256 tokens, 16 new) on the steady
    engine under the profiler, gated as every profile phase: host stream
    syncs against polls (2 a poll), no capture, the launch counters
    equal to the trace and to the profiler's kernel counts (within the
    spins the window lost)."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.serving.request import Request

    rng = np.random.default_rng(SEED + 1)
    vocab = engine.model.cfg.vocab
    for uid in range(100, 108):
        engine.submit(Request(uid=uid, prompt=rng.integers(0, vocab, 256),
                              max_new_tokens=16))
    counters = engine.metrics.counters
    polls0, n0 = counters["trace_polls"].value, len(engine.step_kinds)
    progs = engine.program_cache_sizes()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    prof, wall_ms = _profiled(torch, engine.run)
    counts = kernels.launch_counts()
    rows, lost = _device_rows(prof)
    polls = counters["trace_polls"].value - polls0
    syncs = _host_calls(prof).get("cudaStreamSynchronize", 0)
    seen = _counted_vs_profiled(counts, rows)
    want = _expected_launches(engine.model.cfg, engine, engine.paged,
                              engine.step_kinds[n0:])
    busy = sum(ms for ms, _, _ in rows)
    rec = {"polls": polls, "cudaStreamSynchronize": syncs,
           "steady_compiles": counters["steady_compiles"].value,
           "programs": engine.program_cache_sizes(),
           "wall_ms_profiled": wall_ms, "device_kernel_ms": busy,
           "device_busy_share": busy / wall_ms if wall_ms else None,
           "launches_counted_vs_profiled": seen,
           "profiler_lost_spins": lost,
           "top": [{"kernel": k[:90], "ms": ms, "calls": c}
                   for ms, c, k in rows[:8]]}
    rec["ok"] = polls > 0 and syncs == 2 * polls \
        and rec["steady_compiles"] == 0 and rec["programs"] == progs \
        and counts == want and _counters_confirmed(seen, lost)
    if not rec["ok"]:
        raise AssertionError(f"{phase} profiled batch failed: {rec}")
    return rec


def _near_ties(torch, model, params, prompts, plain, spec):
    """For each stream whose spec tokens leave the plain engine's: the
    first position where they differ, and the plain stream's top-2
    margin there over max|logit|, from one cache-free bf16 forward over
    the prompt and the plain tokens before it (the ``margin_over_max``
    the gate reads); beside it, from the same forward and from one in
    fp32 on the same weights (``fp32_*``), the top token and how far the
    plain and the spec token lie below it, over max|logit|."""
    from repro_torch.models import transformer as T

    cfg32 = model.cfg.replace(dtype="float32", param_dtype="float32")
    params32 = None
    out = {}
    for uid, want in plain.items():
        got = spec[uid]
        if got == want:
            continue
        i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
        if i >= len(want) or i >= len(got):
            out[uid] = {"position": i, "margin_over_max": None}
            continue
        toks = torch.tensor([list(prompts[uid]) + want[:i]],
                            device=model.device)
        rec = {"position": i, "plain_token": want[i], "spec_token": got[i]}
        if params32 is None:
            params32 = _tree_map(params, lambda t: t.float()
                                 if t.is_floating_point() else t)
        for tag, cfg, ps in (("", model.cfg, params),
                             ("fp32_", cfg32, params32)):
            with torch.no_grad():
                logits, _ = T.forward_train(ps, cfg, toks)
            last = logits[0, -1].float()
            top2 = torch.topk(last, 2)
            scale = last.abs().max()
            rec.update({
                tag + "top_token": int(top2.indices[0]),
                tag + "max_abs_logit": scale.item(),
                tag + "plain_gap_over_max":
                    ((top2.values[0] - last[want[i]]) / scale).item(),
                tag + "spec_gap_over_max":
                    ((top2.values[0] - last[got[i]]) / scale).item()})
            if not tag:
                rec["margin"] = (top2.values[0] - top2.values[1]).item()
                rec["margin_over_max"] = rec["margin"] / scale.item()
        out[uid] = rec
    del params32
    return out


def _tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    return fn(tree)


# --------------------------------------------------------------------- #
# the MoE, hybrid and other dense families
# --------------------------------------------------------------------- #
#: held card against CPU at full width cut to 2 layers, fp32: the MoE
#: family (G 1 and 3) and the dense ids (G 6, 5, 12; head_dim 256 under
#: a window), each with the query-head groups its flash and decode
#: attention launches take; mixtral-8x7b (93 GB of bf16 weights, more
#: than one card) at its reduced width
FAMILY_ARCHS = (("qwen2-moe-a2.7b", ""), ("granite-moe-3b-a800m", ""),
                ("internlm2-20b", ""), ("qwen2.5-14b", ""),
                ("starcoder2-15b", ""), ("gemma2-9b-class", ""),
                ("mixtral-8x7b", "reduced"))
#: jamba-1.5-large-398b on one card: one super-block (8 sublayers) of 8
#: of its 16 experts, top-2 kept (51.6 GB of bf16 weights; 90.3 GB with
#: all 16)
JAMBA_EXPERTS = 8
FAMILY_TOL = 2e-3


class _ExpertLog:
    """While active, records the experts every MoE router call picks
    (``moe._gates``' top-k ids, each row sorted, read back after the
    run)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.mod, self.real, self.ids = moe, moe._gates, []

        def gates(p, xf, m):
            out = self.real(p, xf, m)
            self.ids.append(out[2])
            return out

        moe._gates = gates
        return self

    def __exit__(self, *exc):
        self.mod._gates = self.real

    def host(self):
        import numpy as np
        return [np.sort(i.reshape(-1, i.shape[-1]).cpu().numpy(), -1)
                for i in self.ids]


def _card_pair(cfg):
    """``cfg``'s model on the CPU and on the card with one set of
    weights: made on the card from the seed, copied to the host."""
    from repro_torch.models.model import build

    gpu, cpu = build(cfg, "cuda"), build(cfg, "cpu")
    p_gpu = gpu.init(SEED)
    return (("cpu", cpu, _tree_to(p_gpu, "cpu")), ("gpu", gpu, p_gpu))


def _card_vs_cpu(torch, cfg, runs_on, phase, extra=None):
    """The cache-free path (a 128-token ``prefill``: flash attention, MoE
    capacity dispatch, the SSD dual form) and the cached path (a
    128-token extend: decode attention, dense routing, the recurrence),
    each followed by 8 greedy decodes, on the CPU and on the card. Gates:
    logits within ``FAMILY_TOL``, greedy tokens identical, the same
    experts picked for every token of every router call, and the card
    run's launches of the path's kernels (counted from 0 just before)."""
    import numpy as np

    from repro_torch import kernels

    tokens = np.random.default_rng(SEED).integers(0, cfg.vocab, 128)
    t0 = time.perf_counter()
    runs = {}
    for name, model, params in runs_on:
        if name == "gpu":
            kernels.reset_launch_counts()
        out = {}
        for path in ("prefill", "extend"):
            with _ExpertLog() as log:
                cache = model.make_cache(1, 256)
                toks = torch.from_numpy(tokens).to(model.device)[None]
                if path == "prefill":
                    logits, _ = model.prefill(params, {"tokens": toks},
                                              cache)
                else:
                    logits, _ = model.extend_into_cache(params, toks, cache)
                seq, steps = [int(logits[0, -1].argmax())], \
                    [logits[0].cpu()]
                for _ in range(8):
                    tok = torch.tensor([[seq[-1]]], device=model.device)
                    logits, _ = model.decode_step(params, tok, cache)
                    steps.append(logits[0].cpu())
                    seq.append(int(logits[0, -1].argmax()))
            out[path] = (seq, steps, log.host())
        if name == "gpu":
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
        runs[name] = out
    rec = {"phase": phase, "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "n_heads": cfg.n_heads,
           "n_kv_heads": cfg.n_kv_heads, "G": cfg.n_heads // cfg.n_kv_heads
           if cfg.n_kv_heads else 0, "head_dim": cfg.hd,
           "window": cfg.sliding_window, "dtype": cfg.dtype,
           "prompt": 128, "decode_steps": 8, "tol": FAMILY_TOL,
           "launches_gpu": counts, **(extra or {})}
    if cfg.moe is not None:
        rec.update(n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
                   n_shared=cfg.moe.n_shared)
    ok = all(counts[k] > 0 for k in (
        ["decode_attention", "flash_attention"] * bool(cfg.n_heads)
        + ["ssd", "ssd_extend"] * (cfg.ssm is not None)))
    for path in ("prefill", "extend"):
        (ts_c, lg_c, ex_c), (ts_g, lg_g, ex_g) = runs["cpu"][path], \
            runs["gpu"][path]
        err = max((a - b).abs().max().item() for a, b in zip(lg_c, lg_g))
        experts = len(ex_c) == len(ex_g) and all(
            np.array_equal(a, b) for a, b in zip(ex_c, ex_g))
        rec[f"{path}_logits_max_abs_err"] = err
        rec[f"{path}_tokens_gpu"] = ts_g
        rec[f"{path}_tokens_equal"] = ts_g == ts_c
        rec[f"{path}_router_calls"] = len(ex_g)
        rec[f"{path}_experts_equal"] = experts
        ok = ok and err <= FAMILY_TOL and ts_g == ts_c and experts
    rec["seconds"] = time.perf_counter() - t0
    rec["ok"] = ok
    emit(rec)
    if not ok:
        raise AssertionError(f"{phase}: card and CPU disagree: {rec}")
    return counts


def model_families(torch):
    """``FAMILY_ARCHS`` card against CPU (``_card_vs_cpu``), one line an
    architecture. Returns the card runs' launch counts by architecture."""
    from repro_torch.configs import get_arch

    out = {}
    for arch, variant in FAMILY_ARCHS:
        cfg = get_arch(arch, variant=variant).replace(
            n_layers=2, dtype="float32", param_dtype="float32")
        pair = _card_pair(cfg)
        out[cfg.name] = _card_vs_cpu(torch, cfg, pair, "model_families")
        del pair
        gc.collect()
        torch.cuda.empty_cache()
    return out


def model_hybrid(torch):
    """jamba-1.5-large-398b's reduced super-block (attention, seven SSM
    mixers, MoE on the even sublayers) widened to d_model 512 with the
    SSM's published head_dim 128 and d_state 128 (8 heads), so the SSD
    kernels run at p 128 inside a whole model: card against CPU in fp32
    (``_card_vs_cpu``). Returns the card run's launch counts."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = get_arch("jamba-1.5-large-398b", variant="reduced")
    cfg = cfg.replace(d_model=512, head_dim=512 // cfg.n_heads,
                      ssm=dataclasses.replace(cfg.ssm, head_dim=128,
                                              d_state=128))
    pair = _card_pair(cfg)
    counts = _card_vs_cpu(torch, cfg, pair, "model_hybrid", extra={
        "ssm_head_dim": cfg.ssm.head_dim, "ssm_d_state": cfg.ssm.d_state,
        "ssm_heads": cfg.ssm.n_heads(cfg.d_model)})
    del pair
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _nbytes(tree):
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.nbytes


def _family_serve(torch, cfg, phase, paged):
    """``cfg`` at full width, bf16, weights from the seed, through the
    serve phase's engine and requests (``serve``: 8 slots, cache 1024,
    chunks of 128, 16 requests, 32 new tokens each, launch counters =
    the step trace) on graphs; a profiled second batch (``profile``: no
    capture after ``mark_steady``, 2 host syncs a poll, counters = the
    profiler's kernel counts); the same requests on eager steps (tokens
    bitwise equal to the graphs run's) and, where ``paged``, on a pool of
    pages of 16 (tokens bitwise equal to the rings', the pool drained),
    else the pool refused with ``ValueError``. One summary line: the
    weights' and KV's bytes, the init time, tok/s, TTFT and decode ms
    p50 of each run and the least time a forward can take, every weight
    byte read once (dense routing reads every expert). Returns the
    graphs run's launch counts by phase, and the pool run's."""
    from repro_torch.models.model import build
    from repro_torch.serving.engine import Engine

    t0 = time.perf_counter()
    model = build(cfg)
    params = model.init(SEED)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    counts, engine, rec, tokens = serve(torch, model, params, phase=phase)
    prof = profile(torch, engine, phase.replace("serve", "profile"))
    del engine
    gc.collect()
    runs = {"graphs": rec}
    _, engine, erec, etokens = serve(torch, model, params, graphs=False,
                                     phase=f"{phase}_eager")
    runs["eager"] = erec
    del engine
    gc.collect()
    out_counts = {phase: counts}
    if paged:
        pcounts, engine, prec, _ = serve(torch, model, params, paged=True,
                                         base=(rec, tokens),
                                         phase=f"{phase}_paged")
        runs["paged"] = prec
        out_counts[f"{phase}_paged"] = pcounts
        del engine
        pool = "served"
    else:
        try:
            Engine(model, params, max_batch=8, cache_len=1024, paged=True)
        except ValueError as err:
            pool = f"ValueError: {err}"
        else:
            pool = "accepted"
    table = params["embed"]["table"].nbytes
    weights = _nbytes(params)
    experts = sum(sub["moe"][k].nbytes for sub in params["blocks"].values()
                  if "moe" in sub for k in ("wi", "wg", "wo"))
    out = {"phase": f"{phase}_summary", "arch": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "n_experts": cfg.moe.n_experts,
           "top_k": cfg.moe.top_k, "weight_bytes": weights,
           "expert_bytes": experts, "embed_table_bytes": table,
           "kv_bytes": rec["kv_bytes"], "state_bytes": rec["state_bytes"],
           "init_s": t_init,
           "forward_bound_ms": (weights - table) / HBM_BYTES_PER_S * 1e3,
           "graphs_equal_eager": etokens == tokens,
           "pool": pool, "profile_busy_share": prof["device_busy_share"],
           "profile_decode_attention": prof["decode_attention"],
           **{f"{k}_{m}": r[k] for m, r in runs.items() for k in (
               "tok_per_s", "ttft_ms_p50", "decode_ms_p50", "peak_mem_gib")}}
    out["ok"] = out["graphs_equal_eager"] and (
        pool == "served" if paged else pool.startswith("ValueError"))
    emit(out)
    if not out["ok"]:
        raise AssertionError(f"{phase}: {out}")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return out_counts


def serve_moe(torch):
    """qwen2-moe-a2.7b at full width and depth (24 layers, 60 experts
    top-4 and 4 shared, bf16: 28.6 GB of weights) through
    ``_family_serve`` on rings, eagerly and on the pool."""
    from repro_torch.configs import get_arch

    return _family_serve(torch, get_arch("qwen2-moe-a2.7b"), "serve_moe",
                         paged=True)


def serve_hybrid(torch):
    """jamba-1.5-large-398b at its published widths (d_model 8192, 64
    heads over 8 KV heads, d_expert 24576, SSM head_dim 128, d_state 128),
    one super-block of 8 sublayers and 8 of its 16 experts (top-2 kept):
    ``JAMBA_EXPERTS``, 51.6 GB of bf16 weights, through
    ``_family_serve`` on rings and eagerly; the pool raises, as in JAX."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = get_arch("jamba-1.5-large-398b")
    cfg = cfg.replace(n_layers=cfg.attn_every, moe=dataclasses.replace(
        cfg.moe, n_experts=JAMBA_EXPERTS))
    emit({"phase": "serve_hybrid_cut", "arch": cfg.name,
          "n_layers": "72 -> 8 (one super-block)",
          "n_experts": f"16 -> {JAMBA_EXPERTS} (top-2 kept)",
          "why": "90.3 GB of bf16 weights for one super-block with all "
                 "16 experts; 80 GB on the card"})
    return _family_serve(torch, cfg, "serve_hybrid", paged=False)


# --------------------------------------------------------------------- #
# the frontend families: seamless-m4t-medium's encoder-decoder and
# pixtral-12b's embedding prefix
# --------------------------------------------------------------------- #
#: the serve phases of the frontend families: (text tokens low, high),
#: the cache length (the VLM's holds its 1024-token prefix too)
FRONTEND_SERVE = {"seamless-m4t-medium": ((32, 128), 256),
                  "pixtral-12b": ((64, 256), 1536)}


def _frames(rng, cfg, n):
    """``n`` frontend inputs (n_tokens, d_embed) f32, drawn from ``rng``."""
    fe = cfg.frontend
    return [rng.normal(0, 1, (fe.n_tokens, fe.d_embed)).astype("float32")
            for _ in range(n)]


def _frontend_card_vs_cpu(torch, cfg, phase):
    """``cfg`` cut to 2 layers (an encoder-decoder: 2 encoder and 2
    decoder layers), fp32, on the CPU and on the card with one set of
    weights (made on the card from the seed), on one input of 1024
    frames (or patches) and 128 text tokens from the seed. Two paths,
    each followed by 8 greedy decodes: ``prefill`` with the frames (the
    encoder and the cache-free cross-attention: flash, non-causal; a
    VLM's prefix before the text) and the engine's admission (an
    encoder-decoder: ``encode_memory`` copied into the cache, then a
    128-token extend; a VLM: the 1024-row embedding chunk through
    ``extend_into_cache``, then the 128-token extend: decode attention,
    at hd 160). Gates: logits within ``FAMILY_TOL``, greedy tokens
    identical, the card's flash and decode-attention launches (counted
    from 0 just before) nonzero. Returns the card run's launch counts."""
    import numpy as np

    from repro_torch import kernels

    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, cfg.vocab, 128)
    frames = _frames(rng, cfg, 1)[0]
    encdec = cfg.family == "encdec"
    cache_len = 256 if encdec else 2048
    t0 = time.perf_counter()
    runs = {}
    for name, model, params in _card_pair(cfg):
        if name == "gpu":
            kernels.reset_launch_counts()
        dev = model.device
        toks = torch.from_numpy(tokens).to(dev)[None]
        emb = torch.from_numpy(frames).to(dev)[None]
        out = {}
        for path in ("prefill", "admission"):
            cache = model.make_cache(1, cache_len)
            if path == "prefill":
                logits, _ = model.prefill(params, {"tokens": toks,
                                                   "embeddings": emb}, cache)
            else:
                if encdec:
                    xk, xv = model.encode_memory(params, emb)
                    cache["xk"].copy_(xk)
                    cache["xv"].copy_(xv)
                else:
                    model.extend_into_cache(params, None, cache,
                                            embeddings=emb, last_only=True)
                logits, _ = model.extend_into_cache(params, toks, cache)
            seq, steps = [int(logits[0, -1].argmax())], [logits[0].cpu()]
            for _ in range(8):
                tok = torch.tensor([[seq[-1]]], device=dev)
                logits, _ = model.decode_step(params, tok, cache)
                steps.append(logits[0].cpu())
                seq.append(int(logits[0, -1].argmax()))
            out[path] = (seq, steps)
        if name == "gpu":
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
        runs[name] = out
        del model, params
        gc.collect()
    torch.cuda.empty_cache()
    rec = {"phase": phase, "arch": cfg.name, "family": cfg.family,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
           "head_dim": cfg.hd, "vocab": cfg.vocab, "dtype": cfg.dtype,
           "frontend_tokens": cfg.frontend.n_tokens,
           "d_embed": cfg.frontend.d_embed, "prompt": 128,
           "decode_steps": 8, "tol": FAMILY_TOL, "launches_gpu": counts}
    if encdec:
        rec["encoder_layers"] = cfg.encoder.n_layers
    ok = counts["decode_attention"] > 0 and counts["flash_attention"] > 0
    for path in ("prefill", "admission"):
        (ts_c, lg_c), (ts_g, lg_g) = runs["cpu"][path], runs["gpu"][path]
        err = max((a - b).abs().max().item() for a, b in zip(lg_c, lg_g))
        rec[f"{path}_logits_max_abs_err"] = err
        rec[f"{path}_tokens_gpu"] = ts_g
        rec[f"{path}_tokens_equal"] = ts_g == ts_c
        ok = ok and err <= FAMILY_TOL and ts_g == ts_c
    rec["seconds"] = time.perf_counter() - t0
    rec["ok"] = ok
    emit(rec)
    if not ok:
        raise AssertionError(f"{phase}: card and CPU disagree: {rec}")
    return counts


def model_encdec(torch):
    """seamless-m4t-medium at full width (d_model 1024, 16 heads, vocab
    256206, 1024 frames of 1024 dims) cut to 2 encoder and 2 decoder
    layers, fp32, card against CPU (``_frontend_card_vs_cpu``)."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = get_arch("seamless-m4t-medium")
    cfg = cfg.replace(n_layers=2, dtype="float32", param_dtype="float32",
                      encoder=dataclasses.replace(cfg.encoder, n_layers=2))
    return _frontend_card_vs_cpu(torch, cfg, "model_encdec")


def model_vlm_cached(torch):
    """pixtral-12b at full width (d_model 5120, head_dim 160, G 4, the
    1024-token embedding prefix) cut to 2 layers, fp32, through its
    cached path, card against CPU (``_frontend_card_vs_cpu``)."""
    from repro_torch.configs import get_arch

    cfg = get_arch("pixtral-12b").replace(n_layers=2, dtype="float32",
                                          param_dtype="float32")
    return _frontend_card_vs_cpu(torch, cfg, "model_vlm_cached")


def _frontend_launches(cfg, forwards, admissions):
    """Kernel launches of ``forwards`` cached decoder forwards and
    ``admissions`` frontend admissions: a VLM's decoder takes one decode
    attention and 2 norms a layer and ``ln_f``, and its embedding chunk
    is one more such forward; an encoder-decoder's decoder layer takes
    two decode attentions (self and cross) and 3 norms (``ln1``,
    ``ln_x``, ``ln2``), and an encode one flash a layer and ``2
    n_enc + 1`` norms."""
    nl = cfg.n_layers
    out = {"decode_attention": 0, "paged_decode_attention": 0,
           "quant_matmul_int8": 0, "quant_matmul_int4": 0, "rmsnorm": 0,
           "ssd": 0, "ssd_extend": 0, "flash_attention": 0,
           "flash_attention_bwd": 0, "rmsnorm_bwd": 0,
           "rmsnorm_gated_bwd": 0, "ssd_bwd": 0}
    if cfg.family == "encdec":
        ne = cfg.encoder.n_layers
        out["decode_attention"] = 2 * nl * forwards
        out["rmsnorm"] = (3 * nl + 1) * forwards + (2 * ne + 1) * admissions
        out["flash_attention"] = ne * admissions
    else:
        out["decode_attention"] = nl * (forwards + admissions)
        out["rmsnorm"] = (2 * nl + 1) * (forwards + admissions)
    return out


def _frontend_engine_run(torch, model, params, reqs, graphs, uid0=0,
                         engine=None):
    """``reqs`` ((prompt, frames) pairs, 32 new tokens each) through a
    fresh engine (8 slots, chunks of 128; ``graphs`` as ``Engine``
    takes it) or through ``engine``; the launch counters set to 0 just
    before and read just after. Returns (engine, record, tokens)."""
    from repro_torch import kernels
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request
    from repro_torch.serving.sampler import Sampler

    cfg = model.cfg
    if engine is None:
        engine = Engine(model, params, max_batch=8,
                        cache_len=FRONTEND_SERVE[cfg.name][1],
                        prefill_chunk=128, sampler=Sampler(), seed=SEED,
                        graphs=graphs)
    n0 = len(engine.step_kinds)
    adm0 = engine.metrics.counters["chunked_admissions"].value
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for i, (prompt, emb) in enumerate(reqs):
        engine.submit(Request(uid=uid0 + i, prompt=prompt, embeddings=emb,
                              max_new_tokens=32))
    responses = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    kinds = engine.step_kinds[n0:]
    forwards = kinds.count("plain") + 2 * kinds.count("mixed")
    admissions = engine.metrics.counters["chunked_admissions"].value - adm0
    stats = engine.latency_stats()
    mine = {u: r for u, r in responses.items()
            if uid0 <= u < uid0 + len(reqs)}
    toks = sum(len(r.tokens) for r in mine.values())
    rec = {"graphs": engine.graphs, "requests": len(mine),
           "plain_steps": kinds.count("plain"),
           "mixed_steps": kinds.count("mixed"), "admissions": admissions,
           "launches": counts,
           "launches_expected": _frontend_launches(cfg, forwards,
                                                   admissions),
           "tokens": toks, "wall_s": wall, "tok_per_s": toks / wall,
           "ttft_ms_p50": stats.get("ttft_ms_p50"),
           "itl_ms_p50": stats.get("itl_ms_p50"),
           "decode_ms_p50": stats.get("decode_ms_p50"),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "programs": engine.program_cache_sizes(),
           "bad_requests": [u for u, r in mine.items()
                            if r.finish_reason != "length"
                            or len(r.tokens) != 32]}
    return engine, rec, {u: list(r.tokens) for u, r in mine.items()}


def _frontend_serve(torch, arch, phase):
    """``arch`` at full width and depth, bf16, weights from the seed,
    through ``Engine`` on graphs: 16 requests (1024 frames or patches of
    1024 dims each and ``FRONTEND_SERVE``'s text lengths, 32 new tokens)
    at 8 slots, chunks of 128. Gates: every request finishes with 32
    tokens, the launch counters equal the step trace's count with each
    admission's frontend work (``_frontend_launches``); a second batch of
    8 requests after ``mark_steady`` under the profiler: no capture, 2
    host stream syncs a poll, the counters equal the trace and the
    profiler's kernel counts (within the records it lost); the same 16
    requests on eager steps give bitwise the graphs run's tokens. The
    VLM's pool refuses an embeddings request, as JAX's does. Prints
    decode ms p50, TTFT p50, tok/s and peak memory of both runs, the
    encode's (or the embedding chunk's) device ms at B 1, and a decode
    forward's bound: every decoder weight byte and the slots' memory
    (an encoder-decoder's cross K/V at 8 slots) read once. Returns the
    graphs run's launch counts by phase."""
    import numpy as np
    from torch.autograd import DeviceType

    from repro_torch.configs import get_arch
    from repro_torch.models.model import build
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request

    t_phase = time.perf_counter()
    cfg = get_arch(arch)
    model = build(cfg)
    params = model.init(SEED)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t_phase
    (lo, hi), cache_len = FRONTEND_SERVE[arch]
    rng = np.random.default_rng(SEED)
    lens = rng.integers(lo, hi + 1, 16)
    frames = _frames(rng, cfg, 16)
    reqs = [(rng.integers(0, cfg.vocab, L), f) for L, f in zip(lens, frames)]
    engine, rec, tokens = _frontend_engine_run(torch, model, params, reqs,
                                               None)
    line = dict(rec, phase=phase, arch=cfg.name, cache_len=cache_len,
                prompt_lens=[int(x) for x in lens])
    line["ok"] = rec["graphs"] and not rec["bad_requests"] \
        and rec["launches"] == rec["launches_expected"]
    emit(line)
    if not line["ok"]:
        raise AssertionError(f"{phase}: {line}")

    # a second batch on the warm engine, steady, under the profiler
    rng2 = np.random.default_rng(SEED + 1)
    lens2 = rng2.integers(lo, hi + 1, 8)
    frames2 = _frames(rng2, cfg, 8)
    reqs2 = [(rng2.integers(0, cfg.vocab, L), f)
             for L, f in zip(lens2, frames2)]
    engine.mark_steady()
    programs = engine.program_cache_sizes()
    counters = engine.metrics.counters
    polls0 = counters["trace_polls"].value
    box = {}
    prof, wall_ms = _profiled(torch, lambda: box.update(rec=(
        _frontend_engine_run(torch, model, params, reqs2, None, uid0=100,
                             engine=engine)[1])))
    prec = box["rec"]
    rows, lost = _device_rows(prof)
    calls = {evt.key: evt.count for evt in prof.key_averages()
             if evt.device_type == DeviceType.CPU}
    polls = counters["trace_polls"].value - polls0
    seen = _counted_vs_profiled(prec["launches"], rows)
    busy = sum(ms for ms, _, _ in rows)
    prof_line = {
        "phase": phase.replace("serve", "profile"), "requests": 8,
        "wall_ms_profiled": wall_ms, "device_kernel_ms": busy,
        "device_busy_share": busy / wall_ms if busy else None,
        "plain_steps": prec["plain_steps"], "mixed_steps": prec["mixed_steps"],
        "admissions": prec["admissions"], "launches": prec["launches"],
        "launches_expected": prec["launches_expected"],
        "decode_attention": _ms_matching(rows, "decode_"),
        "flash_attention": _ms_matching(rows, "flash_"),
        "top": [{"kernel": k[:90], "ms": ms, "calls": c}
                for ms, c, k in rows[:12]],
        "steady_compiles": counters["steady_compiles"].value,
        "programs": programs, "polls": polls,
        "host_calls": {k: calls.get(k, 0) for k in (
            "cudaGraphLaunch", "cudaLaunchKernel", "cudaStreamSynchronize",
            "cudaMemcpyAsync", "cudaHostAlloc")},
        "launches_counted_vs_profiled": seen, "profiler_lost_spins": lost}
    prof_line["ok"] = (
        not prec["bad_requests"]
        and prec["launches"] == prec["launches_expected"]
        and counters["steady_compiles"].value == 0
        and engine.program_cache_sizes() == programs
        and polls > 0 and calls.get("cudaStreamSynchronize", 0) == 2 * polls
        and _counters_confirmed(seen, lost))
    emit(prof_line)
    if not prof_line["ok"]:
        raise AssertionError(f"{phase}: the profiled batch failed its "
                             f"gates: {prof_line}")
    cache_bytes = sum(t.nbytes for t in _leaves(engine.cache))
    # what a decode forward's attention reads: every slot's K/V, the
    # whole ring (the kernel masks by position, it skips no tile), and an
    # encoder-decoder's memory
    kv_read = sum(t.nbytes for k, t in _items(engine.cache)
                  if k in ("k", "v", "xk", "xv"))
    # the admission program's time at B 1 (CUDA events around a replay,
    # median of 5; slot 0's rows take the writes), and its body run
    # eagerly (the same kernels, launched from the host)
    key = ("encode",) if model.is_encdec else ("embed_chunk", 0)
    frontend_programs = sorted(k[0] for k in engine._programs
                               if k[0] in ("encode", "embed_chunk"))
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    frontend_ms = median_ms(torch, engine._programs[key], flush, iters=5,
                            warmup=1)
    frontend_eager_ms = median_ms(torch, engine._programs[key].body, flush,
                                  iters=5, warmup=1)
    del flush
    del engine
    gc.collect()

    # the same 16 requests on eager steps: bitwise the graphs run's
    _, erec, etokens = _frontend_engine_run(torch, model, params, reqs,
                                            False)
    gc.collect()

    if model.is_encdec:
        pool = "n/a (no paged cache)"
    else:
        try:
            Engine(model, params, max_batch=1, cache_len=cache_len,
                   paged=True, page_size=16,
                   num_pages=cache_len // 16).submit(
                Request(uid=0, prompt=reqs[0][0], embeddings=frames[0],
                        max_new_tokens=2))
        except ValueError as err:
            pool = f"ValueError: {err}"
        else:
            pool = "accepted"
    # a decode forward reads every decoder weight byte once: all but the
    # encoder, the frontend projection and the embedding table (one row)
    dec = ("dec_layers" if model.is_encdec else "blocks", "lm_head",
           "ln_f")
    weights = _nbytes(params)
    read = sum(_nbytes(params[k]) for k in dec)
    f_bytes, f_flops = _frontend_work(cfg, params, cache_len)
    f_bound, f_by = bound_ms(f_bytes, f_flops, cfg.dtype)
    out = {"phase": f"{phase}_summary", "arch": cfg.name,
           "family": cfg.family, "n_layers": cfg.n_layers,
           "encoder_layers": cfg.encoder.n_layers if cfg.encoder else 0,
           "d_model": cfg.d_model, "head_dim": cfg.hd, "dtype": cfg.dtype,
           "frontend_tokens": cfg.frontend.n_tokens,
           "weight_bytes": weights, "init_s": t_init,
           "cache_bytes": cache_bytes,
           "decode_forward_weight_bytes": read,
           "decode_forward_kv_bytes": kv_read,
           "decode_forward_bound_ms_weights": read / HBM_BYTES_PER_S * 1e3,
           "decode_forward_bound_ms": (read + kv_read) / HBM_BYTES_PER_S
           * 1e3,
           "frontend_programs": frontend_programs,
           ("encode_ms" if model.is_encdec else "embed_chunk_ms"):
               frontend_ms,
           "frontend_eager_ms": frontend_eager_ms,
           "frontend_bound_ms": f_bound, "frontend_bound_by": f_by,
           "frontend_bytes": f_bytes, "frontend_flops": f_flops,
           "graphs_equal_eager": etokens == tokens, "pool": pool,
           "profile_busy_share": prof_line["device_busy_share"],
           "seconds": time.perf_counter() - t_phase,
           **{f"{k}_{m}": r[k] for m, r in (("graphs", rec), ("eager", erec))
              for k in ("tok_per_s", "ttft_ms_p50", "decode_ms_p50",
                        "peak_mem_gib")}}
    out["ok"] = out["graphs_equal_eager"] and not erec["bad_requests"] and (
        model.is_encdec or pool.startswith("ValueError"))
    emit(out)
    if not out["ok"]:
        raise AssertionError(f"{phase}: {out}")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return {phase: rec["launches"]}


def _leaves(tree):
    for _, t in _items(tree):
        yield t


def _frontend_work(cfg, params, cache_len):
    """(bytes, operations) of one admission's frontend work at B 1: an
    encode (the frontend projection, every encoder layer, every decoder
    layer's cross K/V: their weights read once, the frames read and the
    slot's memory rows written; 2 operations a weight a frame, and 4 L^2
    d a layer for the bidirectional attention) or an embedding chunk
    (every decoder block's weights read once and the slot's K/V rows
    written; 2 operations a weight a position, and 4 Hq hd a causal
    (query, key) pair a layer)."""
    fe = cfg.frontend
    L, d = fe.n_tokens, cfg.d_model
    elt = 2 if cfg.dtype == "bfloat16" else 4

    def count(tree):
        return sum(t.numel() for t in _leaves(tree))

    if cfg.family == "encdec":
        dec = params["dec_layers"]["cross_attn"]
        w = count(params["frontend_proj"]) + count(params["enc_layers"]) \
            + count(dec["wk"]) + count(dec["wv"])
        out = 2 * cfg.n_layers * L * cfg.n_kv_heads * cfg.hd * elt
        nbytes = w * elt + 4 * L * fe.d_embed + out
        flops = 2 * L * w + cfg.encoder.n_layers * 4 * L * L * d
    else:
        w = count(params["frontend_proj"]) + count(params["blocks"])
        out = 2 * cfg.n_layers * L * cfg.n_kv_heads * cfg.hd * elt
        nbytes = w * elt + 4 * L * fe.d_embed + out
        pairs = L * (L + 1) // 2
        flops = 2 * L * w + cfg.n_layers * 4 * pairs * cfg.n_heads * cfg.hd
    return nbytes, flops


def _items(tree, key=None):
    """(leaf key, leaf) of every leaf of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, k)
    else:
        yield key, tree


def serve_encdec(torch):
    """seamless-m4t-medium at full width and depth (12 + 12 layers, bf16)
    through ``_frontend_serve``: 1024 frames a request, encoded once at
    admission."""
    return _frontend_serve(torch, "seamless-m4t-medium", "serve_encdec")


def serve_vlm(torch):
    """pixtral-12b at full width and depth (40 layers, head_dim 160,
    bf16) through ``_frontend_serve`` on the rings: a 1024-token
    embedding prefix a request, one embedding chunk before the text."""
    return _frontend_serve(torch, "pixtral-12b", "serve_vlm")


def spec_exact(torch):
    """The exact identity gates, in fp32: a 2-layer full-width
    llama3.2-1b (the ``spec`` variant's ``int8@1`` self-draft, and the
    n-gram drafter) serves 4 requests of 16-96 tokens (16 new, 2 slots,
    chunks of 32) on the card's graphs; its greedy spec tokens must
    equal the card's plain tokens and the CPU's spec tokens."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models.model import build
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request
    from repro_torch.serving.sampler import Sampler

    t0 = time.perf_counter()
    # the spec variant's rule at 2 layers: an int8 draft of 1 block
    cfg = get_arch("llama3.2-1b").replace(
        name="llama3.2-1b-spec", n_layers=2, dtype="float32",
        param_dtype="float32", draft="int8@1", spec_gamma=4)
    cpu, gpu = build(cfg, "cpu"), build(cfg, "cuda")
    p_cpu = cpu.init(SEED)
    p_gpu = _tree_to(p_cpu, "cuda")
    rng = np.random.default_rng(SEED + 6)
    prompts = [rng.integers(0, cfg.vocab, int(L))
               for L in rng.integers(16, 97, 4)]

    def run(model, params, **kw):
        engine = Engine(model, params, max_batch=2, cache_len=128,
                        prefill_chunk=32, sampler=Sampler(), seed=SEED, **kw)
        for uid, p in enumerate(prompts):
            engine.submit(Request(uid=uid, prompt=p, max_new_tokens=16))
        return {u: list(r.tokens) for u, r in engine.run().items()}, engine

    rec = {"phase": "spec_exact", "arch": cfg.name, "n_layers": 2,
           "dtype": "float32", "prompt_lens": [len(p) for p in prompts],
           "max_new_tokens": 16, "draft": {}}
    plain_cfg = cfg.replace(draft="", spec_gamma=0)
    plain_gpu, _ = run(build(plain_cfg, "cuda"), p_gpu)
    ok = True
    for draft in (cfg.draft, "ngram"):
        spec_gpu, eng = run(gpu, p_gpu, draft=draft)
        spec_cpu, _ = run(cpu, p_cpu, draft=draft)
        st = eng.latency_stats()
        r = {"gpu_equals_plain": spec_gpu == plain_gpu,
             "gpu_equals_cpu": spec_gpu == spec_cpu,
             "graphs": eng.graphs,
             "spec_tokens_per_step": st["spec_tokens_per_step"],
             "spec_acceptance_rate": st["spec_acceptance_rate"]}
        rec["draft"][draft] = r
        ok = ok and r["gpu_equals_plain"] and r["gpu_equals_cpu"] \
            and eng.graphs
    rec["seconds"] = time.perf_counter() - t0
    rec["ok"] = ok
    _gate(rec)


def spec(torch, model, params, plain_tokens):
    """Speculative decoding at full width on the card's graphs
    (llama3.2-1b, 16 layers, bf16; ``SPEC_ENGINE``): the ``spec``
    variant (an ``int8@8`` self-draft at gamma 4) on rings
    (``spec_rings``), on a pool of pages of 16 (``spec_paged``: tokens
    equal to the rings' bitwise, the pool drained) and on eager steps
    (``spec_eager``: the first 4 of the requests, each request's tokens
    equal to the rings' bitwise), the n-gram drafter on rings
    (``spec_ngram``), and the plain engine warmed the same way
    (``spec_plain``), each serving the serve phase's 16 requests (32
    new) but ``spec_eager``. Every engine is warmed until each slot
    admitted once and marked steady: no capture after, launch counters = the
    step trace; the spec engines on graphs then profile a second batch
    (``cudaStreamSynchronize`` = 2 x polls). Identity at bf16 is
    measured: the streams equal to the plain engine's, and each that
    differs must do so at a near tie (``_near_ties``: the plain stream's
    top-2 margin within ``SPEC_MARGIN_TOL`` of max|logit|). Reported,
    one run each (no gain is claimed): decode ms a spec step, tokens a
    spec step, acceptance rate, tok/s against the plain engine."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.sampler import Sampler

    t_phase = time.perf_counter()
    prompts = _serve_prompts(model.cfg.vocab)
    spec_model = build(get_arch("llama3.2-1b", variant="spec"))
    runs, lines = {}, {}
    cases = (("spec_plain", model, {}, None),
             ("spec_rings", spec_model, {}, None),
             ("spec_paged", spec_model, dict(paged=True, page_size=16,
                                             num_pages=288), None),
             ("spec_eager", spec_model, {}, False),
             ("spec_ngram", model, dict(draft="ngram"), None))
    for name, m, extra, graphs in cases:
        kw = dict(SPEC_ENGINE, **extra)
        if name == "spec_plain":
            kw.pop("spec_gamma")
        engine = Engine(m, params, sampler=Sampler(), seed=SEED,
                        graphs=graphs, **kw)
        progs = _spec_warm(engine, name, {"step": 1, "admit_chunk": 8}
                           if engine.spec_gamma
                           else {"step": 1, "mixed": 8})
        # an eager spec step takes ~25x a replay's wall: 4 requests
        tokens, counts, want, rec = _spec_serve(
            torch, engine, prompts[:4] if name == "spec_eager" else prompts)
        rec.update(phase=name, arch=m.cfg.name, draft=m.cfg.draft
                   or kw.get("draft", ""), graphs=engine.graphs,
                   programs=progs,
                   steady_compiles=engine.metrics.counters[
                       "steady_compiles"].value,
                   streams_equal_plain=sum(
                       tokens[u] == plain_tokens[u] for u in tokens))
        ok = counts == want and rec["steady_compiles"] == 0 \
            and engine.program_cache_sizes() == progs \
            and rec["finished_length"] == len(tokens) \
            and engine.graphs == (graphs is not False)
        if name == "spec_paged":
            rec["tokens_equal_rings"] = tokens == runs["spec_rings"]
            rec["kv_pages_live"] = engine.latency_stats()["kv_pages_live"]
            engine._paged.check_invariants()
            ok = ok and rec["tokens_equal_rings"] \
                and rec["kv_pages_live"] == 0
        if name == "spec_eager":
            rec["tokens_equal_graphs"] = all(
                tokens[u] == runs["spec_rings"][u] for u in tokens)
            ok = ok and rec["tokens_equal_graphs"]
        if name in ("spec_rings", "spec_ngram"):
            ties = _near_ties(torch, m, params, prompts, plain_tokens,
                              tokens)
            rec["divergences"] = ties
            ok = ok and all(t["margin_over_max"] is not None
                            and t["margin_over_max"] <= SPEC_MARGIN_TOL
                            for t in ties.values())
        if engine.spec_gamma and engine.graphs:
            rec["profiled"] = _spec_syncs(torch, engine, name)
            if name == "spec_paged":
                rec["kv_pages_live_after_profile"] = \
                    engine.latency_stats()["kv_pages_live"]
                ok = ok and rec["kv_pages_live_after_profile"] == 0
        rec["ok"] = ok
        runs[name], lines[name] = tokens, rec
        del engine
        gc.collect()
        _gate(rec)
    base = lines["spec_plain"]
    summary = {"phase": "spec", "seconds": time.perf_counter() - t_phase,
               "plain_tok_per_s": base["tok_per_s"],
               "plain_decode_ms_p50": base["decode_ms_p50"]}
    for name in ("spec_rings", "spec_paged", "spec_ngram"):
        r = lines[name]
        summary[name] = {k: r[k] for k in (
            "decode_ms_p50", "spec_tokens_per_step", "spec_acceptance_rate",
            "tok_per_s", "streams_equal_plain")}
        summary[name]["tok_per_s_over_plain"] = \
            r["tok_per_s"] / base["tok_per_s"]
    summary["ok"] = True
    _gate(summary)
    del spec_model
    gc.collect()
    return lines


def spec_ssm(torch, model, params, plain_tokens):
    """The n-gram drafter on mamba2-780m (48 layers, bf16, gamma 4,
    ``SPEC_ENGINE``) on graphs: every spec step verifies and then
    replays the accepted prefix (restoring the pre-verify checkpoint),
    so it runs two full target forwards. Warmed, then the serve phase's
    16 requests (launch counters = the trace: 96 ``ssd_extend`` launches
    a spec step), a profiled second batch (2 syncs a poll, no capture),
    the plain engine warmed the same way in the same call (not
    profiled: ``profile_ssm`` gates its syncs), and identity
    at bf16 measured as in ``spec`` but not gated on the margin: there
    the bf16 cache-free forward's own top token leaves the plain
    engine's by up to a tenth of max|logit|, so a 2e-2 margin separates
    nothing; each divergence records where the plain and the spec token
    lie in the fp32 forward of the same weights. The exact gate comes
    first, at full depth (``spec_ssm_fp32``): the same weights in fp32,
    plain and n-gram on graphs, every stream's tokens equal."""
    from repro_torch.models.model import build
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.sampler import Sampler

    t_phase = time.perf_counter()
    prompts = _serve_prompts(model.cfg.vocab)
    base = dict(SPEC_ENGINE)
    base.pop("spec_gamma")
    m32 = build(model.cfg.replace(dtype="float32", param_dtype="float32"))
    p32 = _tree_map(params, lambda t: t.float())
    rec32 = {"phase": "spec_ssm_fp32", "arch": model.cfg.name,
             "n_layers": model.cfg.n_layers, "dtype": "float32"}
    toks32 = {}
    for name, kw in (("plain", {}), ("ngram", dict(draft="ngram",
                                                   spec_gamma=4))):
        engine = Engine(m32, p32, sampler=Sampler(), seed=SEED, **base,
                        **kw)
        _spec_warm(engine, "spec_ssm_fp32", {"step": 1, "admit_chunk": 8}
                   if kw else {"step": 1, "mixed": 8})
        toks32[name], counts, want, rec = _spec_serve(torch, engine,
                                                      prompts)
        rec32[name] = {k: rec[k] for k in (
            "steps", "spec_steps", "decode_ms_p50", "tok_per_s",
            "spec_tokens_per_step", "spec_acceptance_rate")}
        rec32[name]["counters_equal_trace"] = counts == want
        del engine
        gc.collect()
    rec32["streams_equal_plain"] = sum(
        toks32["ngram"][u] == toks32["plain"][u] for u in toks32["plain"])
    rec32["ok"] = toks32["ngram"] == toks32["plain"] \
        and rec32["plain"]["counters_equal_trace"] \
        and rec32["ngram"]["counters_equal_trace"]
    del m32, p32
    gc.collect()
    torch.cuda.empty_cache()
    _gate(rec32)
    lines = {}
    for name, kw in (("spec_ssm_plain", {}),
                     ("spec_ssm", dict(draft="ngram", spec_gamma=4))):
        engine = Engine(model, params, sampler=Sampler(), seed=SEED,
                        **base, **kw)
        progs = _spec_warm(engine, name, {"step": 1, "admit_chunk": 8}
                           if kw else {"step": 1, "mixed": 8})
        tokens, counts, want, rec = _spec_serve(torch, engine, prompts)
        rec.update(phase=name, arch=model.cfg.name, graphs=engine.graphs,
                   programs=progs,
                   steady_compiles=engine.metrics.counters[
                       "steady_compiles"].value,
                   streams_equal_plain=sum(
                       tokens[u] == plain_tokens[u] for u in tokens))
        ok = counts == want and rec["steady_compiles"] == 0 \
            and rec["finished_length"] == 16 and engine.graphs
        if kw:
            # measured, not gated: at 48 bf16 layers the cache-free bf16
            # forward's own top token leaves the plain engine's by up to
            # a tenth of max|logit| (its fp32 twin shows which is right);
            # the exact gate is spec_ssm_fp32's
            rec["divergences"] = _near_ties(torch, model, params, prompts,
                                            plain_tokens, tokens)
            rec["ssd_extend_per_spec_step"] = 2 * model.cfg.n_layers
        if kw:
            rec["profiled"] = _spec_syncs(torch, engine, name)
        rec["ok"] = ok
        lines[name] = rec
        del engine
        gc.collect()
        _gate(rec)
    p, s = lines["spec_ssm_plain"], lines["spec_ssm"]
    _gate({"phase": "spec_ssm_summary",
           "seconds": time.perf_counter() - t_phase,
           "plain_decode_ms_p50": p["decode_ms_p50"],
           "spec_decode_ms_p50": s["decode_ms_p50"],
           "spec_step_over_plain_step": s["decode_ms_p50"]
           / p["decode_ms_p50"],
           "spec_tokens_per_step": s["spec_tokens_per_step"],
           "spec_acceptance_rate": s["spec_acceptance_rate"],
           "plain_tok_per_s": p["tok_per_s"], "spec_tok_per_s": s["tok_per_s"],
           "tok_per_s_over_plain": s["tok_per_s"] / p["tok_per_s"],
           "streams_equal_plain": s["streams_equal_plain"], "ok": True})
    return lines


def serve_eager(torch, model, params, graphs_turn, phase):
    """The serve phase's requests through the engine's eager steps
    (``graphs=False``) beside its CUDA graphs: the serve phase's own run
    on graphs (``graphs_turn``: its record and tokens), then a fresh
    engine on eager steps that serves them (its own serve line,
    ``{phase}_turn2``). The eager turn profiles no batch: the profiler's
    bookkeeping of some 50,000 eager launches took a minute of host
    time. This phase's line sets the two turns side by side (decode ms
    p50, ITL and TTFT p50, tok/s; the graphs turn's serve wall includes
    its captures) and passes when the eager turn's greedy tokens equal
    the graphs run's."""
    rec0, tokens0 = graphs_turn
    _, engine, rec, tokens = serve(torch, model, params, graphs=False,
                                   phase=f"{phase}_turn2")
    del engine
    gc.collect()
    turns, same = [("graphs", rec0), ("eager", rec)], [tokens == tokens0]
    keys = ("decode_ms_p50", "itl_ms_p50", "ttft_ms_p50", "tok_per_s")
    out = {"phase": phase, "arch": model.cfg.name,
           "turns": [dict({k: r[k] for k in keys + ("wall_s",)}, mode=mode)
                     for mode, r in turns],
           "tokens_equal_first_graphs_run": same}
    for mode in ("graphs", "eager"):
        for k in keys:
            out[f"{mode}_{k}"] = statistics.median(
                r[k] for m, r in turns if m == mode)
    out["ok"] = all(same)
    emit(out)
    if not out["ok"]:
        raise AssertionError(f"{phase} phase failed: {out}")
    return out


def serve_quantized(torch, model, cpu_params, bf16_tokens):
    """The serve phase's requests on the seed-0 bf16 weights quantized:
    int8 weights on bf16 rings (``serve_int8``), then the edge profile,
    int4 weights (group 32) on int8 rings (``serve_edge``) and on an int8
    pool (``serve_edge_paged``: tokens equal to ``serve_edge``'s, the pool
    drained), and a profiled second batch through the int8 engine
    (``profile_int8``) and the edge engine (``profile_edge``).
    ``cpu_params``: the bf16 tree on the host. Each configuration copies
    it to the card, quantizes it there and frees the bf16 projections
    before it serves, so the card holds only what a quantized deployment
    holds and ``peak_mem_gib`` reads that. Returns the int8 and the edge
    phase's launch counts."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build
    from repro_torch.quant import quantize_for_cfg

    out = []
    for cfg in (model.cfg.replace(quant="int8"),
                get_arch("llama3.2-1b", variant="edge")):
        qmodel = build(cfg)
        dense = _tree_to(cpu_params, "cuda")
        qparams = quantize_for_cfg(dense, cfg)
        del dense
        phase = "serve_edge" if cfg.kv_quant else "serve_int8"
        counts, engine, rec, tokens = serve(torch, qmodel, qparams,
                                            phase=phase, bf16=bf16_tokens)
        out.append(counts)
        profile(torch, engine,
                "profile_edge" if cfg.kv_quant else "profile_int8")
        del engine
        if cfg.kv_quant:
            serve(torch, qmodel, qparams, paged=True, base=(rec, tokens),
                  phase="serve_edge_paged", bf16=bf16_tokens)
    return out


# --------------------------------------------------------------------- #
# phase 6: where the device time goes (torch.profiler)
# --------------------------------------------------------------------- #
def profile(torch, engine, phase="profile"):
    """A second batch through the warm engine under the profiler: device
    kernel time by kernel, and its share of the wall time (the rest is
    the device idling while the host launches work); ``seconds`` is what
    the phase adds to a run, the profiler's own bookkeeping included.
    The ``rmsnorm`` counter, set to 0 just before, must read
    ``_norms_per_forward`` launches a forward just after (2 n_layers + 1:
    97 on mamba2-780m, the gated norm counting there too, 33 on
    llama3.2-1b, 49 on qwen2-moe-a2.7b; 24 on a Jamba super-block). The engine's steps
    run as CUDA graphs (or eagerly, in ``serve_eager``'s eager turns):
    the phase marks it steady first and fails on any capture in the
    window (``steady_compiles``), on a host stream sync
    other than the poll's two reads (``cudaStreamSynchronize`` = 2 x
    polls), and where a launch counter differs from the profiler's count
    of the kernel templates its wrapper launches once a call
    (``PROFILE_TEMPLATES``) by more than the records the profiler lost
    (the window's spins it lost; never above the counter); it
    prints the program counts and each
    program's build wall time (warm-up and capture). Returns its
    line."""
    t_phase = time.perf_counter()
    import numpy as np
    from torch.autograd import DeviceType

    from repro_torch import kernels
    from repro_torch.serving.request import Request

    vocab = engine.model.cfg.vocab
    rng = np.random.default_rng(SEED + 1)
    for uid in range(100, 108):
        engine.submit(Request(uid=uid, prompt=rng.integers(0, vocab, 256),
                              max_new_tokens=16))
    n0 = len(engine.step_kinds)
    engine.mark_steady()
    programs = engine.program_cache_sizes()
    counters = engine.metrics.counters
    polls0 = counters["trace_polls"].value
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    prof, wall_ms = _profiled(torch, engine.run)
    counts = kernels.launch_counts()
    rows, lost = _device_rows(prof)
    # the host side: self time by op and CUDA runtime call, and the
    # calls that block the host on the device or on a page-locked
    # allocation
    host = sorted(((evt.self_cpu_time_total / 1e3, evt.count, evt.key)
                   for evt in prof.key_averages()
                   if evt.device_type == DeviceType.CPU), reverse=True)
    blocking = {k: c for _, c, k in host
                if "Synchronize" in k or k in ("cudaHostAlloc", "cudaMemcpy",
                                               "cudaFreeHost")}
    busy = sum(ms for ms, _, _ in rows)
    calls = {k: c for _, c, k in host}
    polls = counters["trace_polls"].value - polls0
    seen = _counted_vs_profiled(counts, rows)
    kinds = engine.step_kinds[n0:]
    launches = sum(c for _, c, _ in rows)
    forwards = kinds.count("plain") + 2 * kinds.count("mixed")
    norms = _norms_per_forward(engine.model.cfg) * forwards
    rec = {"phase": phase, "requests": 8, "prompt_len": 256,
           "max_new_tokens": 16, "steps": len(kinds),
           "plain_steps": kinds.count("plain"),
           "mixed_steps": kinds.count("mixed"),
           "launches_per_forward": launches / forwards if forwards else None,
           "wall_ms_profiled": wall_ms, "device_kernel_ms": busy,
           "device_busy_share": busy / wall_ms if busy else None,
           "kernel_launches": launches,
           "decode_attention": _ms_matching(rows, "decode_"),
           "quant_matmul": _ms_matching(rows, "qmm_"),
           "ssd_extend": _ms_by_template(rows, "ssd_extend"),
           "top": [{"kernel": k[:90], "ms": ms, "calls": c}
                   for ms, c, k in rows[:12]],
           "host_top": [{"op": k[:60], "self_ms": ms, "calls": c}
                        for ms, c, k in host[:15]],
           "host_blocking_calls": blocking, "launch_counts": counts,
           "rmsnorm_per_forward": counts["rmsnorm"] / forwards,
           "rmsnorm_device": _ms_matching(rows, "rmsnorm"),
           "graphs": engine.graphs, "programs": programs,
           "program_builds": engine.metrics.get_series("compiles").values,
           "steady_compiles": counters["steady_compiles"].value,
           "polls": polls,
           "host_calls": {k: calls.get(k, 0) for k in (
               "cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC",
               "cudaStreamSynchronize", "cudaMemcpyAsync")},
           "launches_counted_vs_profiled": seen,
           "nccl_kernels": {k[:90]: c for _, c, k in rows
                            if "nccl" in k.lower()},
           "memcpy_dtod": sum(c for _, c, k in rows if "DtoD" in k),
           "profiler_lost_spins": lost,
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    if counts["rmsnorm"] != norms:
        raise AssertionError(f"{phase}: {counts['rmsnorm']} rmsnorm "
                             f"launches, the trace implies {norms}")
    if counters["steady_compiles"].value \
            or engine.program_cache_sizes() != programs:
        raise AssertionError(f"{phase}: a program was built in the "
                             f"steady window")
    if calls.get("cudaStreamSynchronize", 0) != 2 * polls or not polls:
        raise AssertionError(
            f"{phase}: {calls.get('cudaStreamSynchronize', 0)} host stream "
            f"syncs over {polls} polls; only the poll's two reads may sync")
    if not _counters_confirmed(seen, lost):
        raise AssertionError(f"{phase}: launch counters differ from the "
                             f"profiler's kernel counts by more than the "
                             f"{lost} records it lost: {seen}")
    return rec


def norm_host_cost(torch, src):
    """``python3 chip_smoke.py --norm-host-us SRC``: the host microseconds
    per call (enqueue only) and device ms of the ``rmsnorm`` wrapper that
    the ``repro_torch`` under SRC registers, called as ``wrapper(x,
    residual, scale, eps)``, bf16, at ``NORM_CASES``' add shapes; one
    JSON line a shape, then the card's name and power limit. Run on two
    checkouts in one chip call (a parent unpacked with ``git archive``
    and this one), it compares their wrappers on one card."""
    sys.path.insert(0, str(src))
    from repro_torch import kernels

    wrapper = kernels._WRAPPERS["rmsnorm"]
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for case, N, d, route, other_scale in NORM_CASES:
        if route != "add" or other_scale:
            continue
        x, r = (torch.randn((N, d), generator=g, device="cuda").bfloat16()
                for _ in range(2))
        scale = torch.ones((d,), device="cuda", dtype=torch.bfloat16)

        def call():
            return wrapper(x, r, scale, 1e-5)

        emit({"phase": "norm_host_cost", "src": str(src),
              "wrapper": f"{wrapper.__module__}.{wrapper.__name__}",
              "case": case, "N": N, "d": d, "dtype": "bfloat16",
              "host_us": host_us(torch, call),
              "host_us_again": host_us(torch, call),
              "kernel_ms": median_ms(torch, call, flush)})
    print(_smi(), flush=True)
    return 0


def _launch_ms(torch, fn, calls=5):
    """Device ms a call of each kernel template that ``fn`` launches, from
    the profiler over ``calls`` calls (L2 warm)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
        if t and "Memset" not in e.key:
            name = e.key.replace("(anonymous namespace)::", "")
            out[name.replace("void ", "").split("(")[0]] = t / 1e3 / calls
    return out


def bwd_compare(torch, src):
    """``python3 chip_smoke.py --bwd-compare SRC``: the backward kernels
    of the ``repro_torch`` under SRC at the kernels_bwd phase's inputs:
    flash attention (``FLASH_BWD_CASES``), the RMSNorm add / norm
    (``NORM_BWD_CASES``) and gated routes (``GATED_BWD_CASES``) and the
    SSD dual form (``SSD_BWD_CASES``; a case's sub-chunk override only
    where SRC's kernel module has ``_bwd_at_sub``): kernel ms, the device ms of each
    kernel template, the largest error relative to max|plain| of the
    plain backward, a bitwise repeat; one JSON line a case, after a line
    of the backward templates' ptxas registers and spills, then the
    card's name and power limit. Run on two checkouts in one chip call (a
    parent unpacked with ``git archive`` and this one), it compares their
    kernels on one card. Exits 1 where a case fails its gate."""
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda, flash_attention_lse_cuda)
    from repro_torch.kernels.flash_attention.ref import \
        attention_backward_reference
    from repro_torch.kernels.rmsnorm.kernel import (fused_rmsnorm_bwd_cuda,
                                                    gated_rmsnorm_bwd_cuda)
    from repro_torch.kernels.rmsnorm.ref import (
        fused_rmsnorm_backward_reference, gated_rmsnorm_backward_reference)
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan.ref import ssd_backward_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    emit({"phase": "bwd_compare_build", "src": str(src),
          "ptxas": {k: v for k, v in
                    ptxas_table(_build.BUILD_LOG.values()).items()
                    if any(t in k for t in ("flash_bwd_", "rmsnorm_bwd_kernel",
                                            "rmsnorm_gated_bwd", "ssd_bwd_"))}})
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    tr = lambda t: t.transpose(1, 2)  # noqa: E731
    ok = True

    def report(kernel, case, dname, fn, want):
        nonlocal ok
        got, again = fn(), fn()
        torch.cuda.synchronize()
        err = max(_rel_to_max(a, w) for a, w in zip(got, want))
        rep = all(torch.equal(a, b) for a, b in zip(got, again))
        fin = all(bool(torch.isfinite(a).all().item()) for a in got)
        passed = err <= TOL[dname] and rep and fin
        ok = ok and passed
        emit({"phase": "bwd_compare", "src": str(src), "kernel": kernel,
              "case": case, "dtype": dname, "rel_err": err,
              "bitwise_repeat": rep, "finite": fin, "ok": passed,
              "kernel_ms": median_ms(torch, fn, flush, iters=10),
              "launch_ms": _launch_ms(torch, fn)})

    for case in FLASH_BWD_CASES:
        name, dname, causal, window = case[0], case[6], case[7], case[8]
        q, k, v, do, _ = _flash_bwd_inputs(torch, case)
        o, lse = flash_attention_lse_cuda(q, k, v, causal=causal,
                                          window=window)
        want = [tr(w) for w in attention_backward_reference(
            tr(q), tr(k), tr(v), tr(do), causal=causal, window=window)]
        report("flash_attention_bwd", name, dname,
               lambda: flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                causal=causal,
                                                window=window), want)
        del q, k, v, do, o, lse, want
    for name, N, d, route, dname in NORM_BWD_CASES:
        x, r, s, dy, dt = _norm_bwd_inputs(torch, N, d, route, dname)
        report("rmsnorm_bwd", name, dname,
               lambda: fused_rmsnorm_bwd_cuda(x, r, s, dy, dt, 1e-5),
               fused_rmsnorm_backward_reference(x, r, s, dy, dt, 1e-5))
    for name, N, d, stride, dname in GATED_BWD_CASES:
        y, z, s, dout = _gated_bwd_inputs(torch, N, d, stride, dname)
        report("rmsnorm_gated_bwd", name, dname,
               lambda: gated_rmsnorm_bwd_cuda(y, z, s, dout),
               gated_rmsnorm_backward_reference(y, z, s, dout))
        del y, z, s, dout
    at_sub = getattr(ssd_kernel, "_bwd_at_sub", None)
    for case in SSD_BWD_CASES:
        name, chunk, dname, sub = case[0], case[7], case[8], _case_sub(case)
        x, dt, A, B, C, D, s0, dy, dfinal = _ssd_bwd_inputs(torch, case)
        want = [t for t in ssd_backward_reference(
            x, dt, A, B, C, D, dy, dfinal, chunk=chunk, initial_state=s0)
                if t is not None]

        def run():
            if sub and at_sub:
                return at_sub(x, dt, A, B, C, D, dy, dfinal, chunk, s0, sub)
            return ssd_kernel.ssd_bwd_cuda(x, dt, A, B, C, D, dy, dfinal,
                                           chunk=chunk, initial_state=s0)
        report("ssd_bwd", name, dname,
               lambda: [t for t in run() if t is not None], want)
        del x, dt, A, B, C, D, s0, dy, dfinal, want
        gc.collect()
        torch.cuda.empty_cache()
    print(_smi(), flush=True)
    return 0 if ok else 1


def ssd_compare(torch, src):
    """``python3 chip_smoke.py --ssd-compare SRC``: the dual form of the
    ``repro_torch`` under SRC, bf16 at the kernels phase's two timed
    shapes (b 1, l 1024 and b 2, l 512, chunk 256, its inputs), then
    ``prefill_ssm`` on that package; one JSON line each, then the card's
    name and power limit. Run on two checkouts in one chip call (a parent
    unpacked with ``git archive`` and this one), it compares their
    kernels and prefills on one card."""
    sys.path.insert(0, str(src))
    from repro_torch.configs import get_arch
    from repro_torch.kernels.ssd_scan.kernel import ssd_cuda
    from repro_torch.models.model import build

    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    h, p, groups, n = SSD_FULL
    for name, b, l in (("b1_l1024", 1, 1024), ("b2_l512", 2, 512)):
        g = torch.Generator(device="cuda").manual_seed(SEED)
        _ssd_inputs(torch, g, b, l, h, p, groups, n, torch.float32)
        x, dt, A, B, C, D, _ = _ssd_inputs(torch, g, b, l, h, p, groups, n,
                                           torch.bfloat16)
        emit({"phase": "ssd_compare", "src": str(src), "case": name,
              "dtype": "bfloat16", "chunk": 256,
              "kernel_ms": median_ms(torch, lambda: ssd_cuda(
                  x, dt, A, B, C, D, chunk=256), flush)})
    del flush
    model = build(get_arch("mamba2-780m"))
    prefill_ssm(torch, model, model.init(SEED), phase="prefill_ssm_compare")
    print(_smi(), flush=True)
    return 0


# --------------------------------------------------------------------- #
# training: the backward kernels, llama3.2-1b's train step at full width
# --------------------------------------------------------------------- #
FLASH_BWD_SRC = "src/repro_torch/csrc/flash_attention_bwd.cu"
#: (name, B, Lq, Hq, Hkv, hd, dtype, causal, window[, Lk]): llama's train
#: shape first (the kernel line's head case)
FLASH_BWD_CASES = (
    ("llama1b_train", 4, 1024, 32, 8, 64, "bfloat16", True, 0),
    ("g1_hd128", 2, 1024, 8, 8, 128, "bfloat16", True, 0),
    ("pixtral12b_hd160", 2, 1024, 32, 8, 160, "bfloat16", True, 0),
    ("window256", 2, 1024, 32, 8, 64, "bfloat16", True, 256),
    ("non_causal_Lq128_Lk1024", 1, 128, 16, 16, 64, "bfloat16", False, 0,
     1024),
    ("L1000_hd40", 2, 1000, 32, 8, 40, "bfloat16", True, 0),
    ("G8_window96", 2, 1024, 64, 8, 64, "bfloat16", True, 96),
    ("fp32_hd64", 2, 1024, 32, 8, 64, "float32", True, 0))
#: (name, N, d, route, dtype): llama's train rows first
NORM_BWD_CASES = (
    ("N4096_d2048_add", 4096, 2048, "add", "bfloat16"),
    ("N4096_d2048_norm", 4096, 2048, "norm", "bfloat16"),
    ("N4096_d2048_add_fp32", 4096, 2048, "add", "float32"),
    ("N4096_d2048_norm_fp32", 4096, 2048, "norm", "float32"),
    ("N4095_d2048_add", 4095, 2048, "add", "bfloat16"),
    ("N2048_d5120_add", 2048, 5120, "add", "bfloat16"))


def _rel_to_max(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


def _fwd_bwd_minus_fwd(torch, flush, fwd, leaves, grads):
    """ms of a library call's forward and backward less its forward
    alone (a yardstick of the backward)."""
    def both():
        torch.autograd.grad(fwd(), leaves, grads)
    with torch.no_grad():
        t_fwd = median_ms(torch, fwd, flush)
    return median_ms(torch, both, flush) - t_fwd


def _flash_bwd_inputs(torch, case):
    """q, k, v, dO of a ``FLASH_BWD_CASES`` entry on the card, from the
    seed, and the case's Lk."""
    name, B, L, Hq, Hkv, hd, dname, causal, window, *lk = case
    Lk = lk[0] if lk else L
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    dtype = getattr(torch, dname)
    q = torch.randn((B, L, Hq, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Lk, Hkv, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Lk, Hkv, hd), generator=g, device=dev).to(dtype)
    do = torch.randn((B, L, Hq, hd), generator=g, device=dev).to(dtype)
    return q, k, v, do, Lk


def _norm_bwd_inputs(torch, N, d, route, dname):
    """x, the residual, the scale, dy and dt of a ``NORM_BWD_CASES``
    entry on the card, from the seed (no residual or dt on the norm
    route)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    dtype = getattr(torch, dname)
    x = torch.randn((N, d), generator=g, device=dev).to(dtype)
    r = torch.randn((N, d), generator=g, device=dev).to(dtype) \
        if route == "add" else None
    s = (1 + 0.1 * torch.randn((d,), generator=g, device=dev)).to(dtype)
    dy = torch.randn((N, d), generator=g, device=dev).to(dtype)
    dt = torch.randn((N, d), generator=g, device=dev).to(dtype) \
        if route == "add" else None
    return x, r, s, dy, dt


def flash_bwd_cases(torch, flush):
    """The flash backward kernels (``flash_attention_bwd_cuda``: D, dK/dV,
    dQ) against the plain backward (``ref.attention_backward_reference``)
    and against autograd of the plain forward on the card, at
    ``FLASH_BWD_CASES``: max|err| within TOL of max|plain|, bitwise
    repeatable. Each case timed beside the plain backward and SDPA's
    forward + backward less its forward (a yardstick); the bound counts
    q, k, v, o, dO, the LSE, dq, dk and dv once and 10 hd operations a
    live pair and query head."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda, flash_attention_lse_cuda, plan_bwd)
    from repro_torch.kernels.flash_attention.ref import (
        _mask, attention_backward_reference, attention_reference)

    dev = torch.device("cuda")
    out, errs = [], []
    for case in FLASH_BWD_CASES:
        name, B, L, Hq, Hkv, hd, dname, causal, window = case[:9]
        q, k, v, do, Lk = _flash_bwd_inputs(torch, case)
        G = Hq // Hkv
        dtype = q.dtype
        o, lse = flash_attention_lse_cuda(q, k, v, causal=causal,
                                          window=window)
        tr = lambda t: t.transpose(1, 2)  # noqa: E731

        def kernel():
            return flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                            causal=causal, window=window)

        def plain():
            return attention_backward_reference(
                tr(q), tr(k), tr(v), tr(do), causal=causal, window=window)

        got, again = kernel(), kernel()
        want = [tr(w) for w in plain()]
        auto = [t.float().requires_grad_() for t in (q, k, v)]
        attention_reference(tr(auto[0]),
                            tr(auto[1]).repeat_interleave(G, 1),
                            tr(auto[2]).repeat_interleave(G, 1),
                            causal=causal, window=window).backward(
            tr(do.float()))
        torch.cuda.synchronize()
        err = max(_rel_to_max(a, w) for a, w in zip(got, want))
        err_auto = max(_rel_to_max(a, w.grad) for a, w in zip(got, auto))
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        ok = all(bool(torch.isfinite(a).all().item()) for a in got) \
            and max(err, err_auto) <= TOL[dname] and repeat
        del auto
        pairs = int(_mask(L, Lk, causal, window, dev).sum().item())
        es = q.element_size()
        nbytes = es * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
        flops = 10 * B * Hq * hd * pairs
        bms, by = bound_ms(nbytes, flops, dname)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        mask = _mask(L, Lk, causal, window, dev) if window else None

        def sdpa():
            return F.scaled_dot_product_attention(
                tr(leaves[0]), tr(leaves[1]), tr(leaves[2]), attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True)
        rec = {"phase": "kernels_bwd", "kernel": "flash_attention_bwd",
               "case": name, "dtype": dname, "B": B, "L": L, "Lk": Lk,
               "Hq": Hq, "Hkv": Hkv, "hd": hd, "causal": causal,
               "window": window,
               "plan": plan_bwd(B, L, Lk, Hq, Hkv, hd, dtype)._asdict(),
               "live_pairs": pairs, "max_abs_err": err,
               "rel_err_vs_autograd": err_auto, "tol_rel": TOL[dname],
               "bitwise_repeat": repeat, "ok": ok,
               "kernel_ms": median_ms(torch, kernel, flush),
               "plain_ms": median_ms(torch, plain, flush, iters=5),
               "library_ms": _fwd_bwd_minus_fwd(torch, flush, sdpa, leaves,
                                                tr(do)),
               "bound_ms": bms, "bound_by": by, "bytes": nbytes,
               "flops": flops}
        rec.update(achieved(rec))
        emit(rec)
        out.append(rec)
        errs.append(err)
        if not ok:
            raise AssertionError(f"flash_attention_bwd {name}: kernel "
                                 f"disagrees with the plain backward: {rec}")
    return out, max(errs)


def norm_bwd_cases(torch, flush):
    """The RMSNorm backward kernel (``fused_rmsnorm_bwd_cuda``: rows, then
    the dscale reduction) against ``ref.fused_rmsnorm_backward_reference``
    and autograd of the plain forward, at ``NORM_BWD_CASES`` (the scale in
    the rows' dtype, as the train step's parameters; dt given on the add
    route): max|err| within TOL of max|plain| for dx and dscale, bitwise
    repeatable; timed beside the plain backward and add + ``F.rms_norm``'s
    forward + backward less its forward (a yardstick); the bound counts
    x, the residual, dy, dt, the scale, dx and dscale once (bytes)."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm.kernel import (fused_rmsnorm_bwd_cuda,
                                                    plan_bwd)
    from repro_torch.kernels.rmsnorm.ref import (
        fused_rmsnorm_backward_reference, fused_rmsnorm_reference)

    eps = 1e-5
    out, errs = [], []
    for name, N, d, route, dname in NORM_BWD_CASES:
        x, r, s, dy, dt = _norm_bwd_inputs(torch, N, d, route, dname)
        dtype = x.dtype

        def kernel():
            return fused_rmsnorm_bwd_cuda(x, r, s, dy, dt, eps)

        def plain():
            return fused_rmsnorm_backward_reference(x, r, s, dy, dt, eps)

        got, again, want = kernel(), kernel(), plain()
        leaves = [t.float().requires_grad_() for t in (x, s)]
        y, t = fused_rmsnorm_reference(leaves[0], None if r is None
                                       else r.float(), leaves[1], eps)
        torch.autograd.backward([y] + ([t] if dt is not None else []),
                                [dy.float()] + ([dt.float()]
                                                if dt is not None else []))
        torch.cuda.synchronize()
        err = max(_rel_to_max(got[0], want[0]), _rel_to_max(got[1], want[1]))
        err_auto = max(_rel_to_max(got[0], leaves[0].grad),
                       _rel_to_max(got[1], leaves[1].grad))
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        ok = bool(torch.isfinite(got[0]).all().item()) \
            and max(err, err_auto) <= TOL[dname] and repeat
        es = x.element_size()
        rows = 5 if route == "add" else 3      # x, r, dy, dt in; dx out
        nbytes = es * (rows * N * d + 2 * d)
        bms, by = bound_ms(nbytes, 12 * N * d, "float32")
        lib = [t.clone().requires_grad_() for t in
               ((x, r, s) if route == "add" else (x, s))]

        def library():
            if route == "add":
                t_ = torch.add(lib[0], lib[1])
                return F.rms_norm(t_, (d,), lib[2], eps), t_
            return (F.rms_norm(lib[0], (d,), lib[1], eps),)
        rec = {"phase": "kernels_bwd", "kernel": "rmsnorm_bwd", "case": name,
               "route": route, "dtype": dname, "N": N, "d": d,
               "plan": plan_bwd(N, d, dtype, route)._asdict(),
               "max_abs_err": err, "rel_err_vs_autograd": err_auto,
               "tol_rel": TOL[dname], "bitwise_repeat": repeat, "ok": ok,
               "kernel_ms": median_ms(torch, kernel, flush),
               "plain_ms": median_ms(torch, plain, flush),
               "library_ms": _fwd_bwd_minus_fwd(
                   torch, flush, library, lib,
                   (dy, dt) if route == "add" else (dy,)),
               "bound_ms": bms, "bound_by": by, "bytes": nbytes}
        emit(rec)
        out.append(rec)
        errs.append(err)
        if not ok:
            raise AssertionError(f"rmsnorm_bwd {name}: kernel disagrees "
                                 f"with the plain backward: {rec}")
    return out, max(errs)


SSD_BWD_SRC = "src/repro_torch/csrc/ssd_scan_bwd.cu"
#: (name, b, l, h, p, g, n, chunk, dtype, initial state, final-state
#: gradient[, sub-chunk]): mamba2-780m's train shape first (the kernel
#: line's head case), jamba's heads, fp32 (the simt route), a carried
#: state, groups, a bf16 chunk that is no multiple of 16 (simt), jamba's
#: heads with a carried state and a final-state gradient, and the mma
#: route at a sub-chunk given by the caller
SSD_BWD_CASES = (
    ("mamba2_train", 4, 1024, 48, 64, 1, 128, 256, "bfloat16", False,
     False),
    ("jamba_heads", 1, 1024, 128, 128, 1, 128, 256, "bfloat16", False,
     False),
    ("fp32", 2, 512, 48, 64, 1, 128, 256, "float32", False, False),
    ("state", 2, 512, 16, 64, 1, 128, 128, "bfloat16", True, True),
    ("groups", 2, 512, 16, 32, 4, 64, 64, "bfloat16", False, True),
    ("bf16_chunk40_simt", 2, 320, 16, 64, 1, 128, 40, "bfloat16", False,
     True),
    ("jamba_state", 1, 512, 128, 128, 1, 128, 256, "bfloat16", True, True),
    ("sub64", 2, 512, 16, 64, 1, 128, 256, "bfloat16", True, True, 64))
#: (name, N, d, z's row stride, dtype): mamba2's train rows first (z of a
#: 6448-wide in-projection row), jamba's d_inner (a 33152-wide row), fp32,
#: an N that is no multiple of the rows a block (two rows of d 1536 a
#: block), fp32 at jamba's d_inner
GATED_BWD_CASES = (
    ("N4096_d3072", 4096, 3072, 6448, "bfloat16"),
    ("N1024_d16384", 1024, 16384, JAMBA_PROJ, "bfloat16"),
    ("N4096_d3072_fp32", 4096, 3072, 6448, "float32"),
    ("N4095_d1536", 4095, 1536, 3328, "bfloat16"),
    ("N1024_d16384_fp32", 1024, 16384, JAMBA_PROJ, "float32"))


def _case_sub(case):
    """A ``SSD_BWD_CASES`` entry's sub-chunk override (0: the plan's)."""
    return case[11] if len(case) > 11 else 0


def _ssd_bwd_inputs(torch, case):
    """x, dt, A, B, C, D, s0, dy and dfinal of a ``SSD_BWD_CASES`` entry on
    the card, from the seed, as the mixer makes them (x, B, C strided
    slices of one conv-output row, dt a softplus, A over -1..-16)."""
    import torch.nn.functional as F

    name, b, l, h, p, groups, n, chunk, dname, init, dfin = case[:11]
    dev = torch.device("cuda")
    dtype = getattr(torch, dname)
    g = torch.Generator(device=dev).manual_seed(SEED)
    xbc = torch.randn((b, l, h * p + 2 * groups * n), generator=g,
                      device=dev).to(dtype)
    x = xbc[..., :h * p].unflatten(-1, (h, p))
    B = xbc[..., h * p:h * p + groups * n].unflatten(-1, (groups, n))
    C = xbc[..., h * p + groups * n:].unflatten(-1, (groups, n))
    dt = F.softplus(torch.randn((b, l, h), generator=g, device=dev) - 3.0)
    A = -torch.linspace(1.0, 16.0, h, device=dev)
    D = torch.randn((h,), generator=g, device=dev)
    s0 = torch.randn((b, h, p, n), generator=g, device=dev) \
        if init else None
    dy = torch.randn((b, l, h, p), generator=g, device=dev)
    dfinal = torch.randn((b, h, p, n), generator=g, device=dev) \
        if dfin else None
    return x, dt, A, B, C, D, s0, dy, dfinal


def _gated_bwd_inputs(torch, N, d, stride, dname):
    """y (f32), z (a strided slice of a ``stride``-wide row), the scale
    and dout of a ``GATED_BWD_CASES`` entry on the card, from the seed."""
    dev = torch.device("cuda")
    dtype = getattr(torch, dname)
    g = torch.Generator(device=dev).manual_seed(SEED)
    y = torch.randn((N, d), generator=g, device=dev)
    z = torch.randn((N, stride), generator=g, device=dev).to(dtype)[:, :d]
    s = (1 + 0.1 * torch.randn((d,), generator=g, device=dev)).to(dtype)
    dout = torch.randn((N, d), generator=g, device=dev).to(dtype)
    return y, z, s, dout


def _ssd_bwd_flops(b, l, h, p, n, chunk):
    """The operations of the dual form's backward that the inputs need:
    per unmasked (i, j <= i) pair of a chunk, C_i.B_j and dy_i.x^_j
    recomputed (2n, 2p), the products into dx^, dB and dC (2p, 2n, 2n)
    and its weights (6); per token, the six p x n state products (the
    chunk's own state, dy_i C_i^T, S_in C_i, S_in^T dy_i, G B_j, G^T
    x^_j: 12 p n) and its small terms (6 p)."""
    Q = chunk
    per_chunk = Q * (Q + 1) // 2 * (6 * n + 4 * p + 6) \
        + Q * (12 * p * n + 6 * p)
    return b * h * (l // Q) * per_chunk


def ssd_bwd_cases(torch, flush):
    """The SSD backward kernels (``ssd_bwd_cuda`` on the route
    ``bwd_plan`` picks: bf16 ``mma``, five launches in sub-chunks; f32
    and odd chunks ``simt``, seven; no atomics) against
    ``ref.ssd_backward_reference`` and autograd of the plain forward (f32)
    at ``SSD_BWD_CASES`` (``_ssd_bwd_inputs``): every gradient within TOL
    of max|plain|, bitwise repeatable. Each timed beside its bound and
    the plain backward (no single library call computes it); the bound
    counts x, B, C, dt, A, D, dy and the states read once, dx, ddt, dB,
    dC, dA, dD and the initial state's gradient written once, and
    ``_ssd_bwd_flops`` at the inputs' peak (bf16 tensor cores; f32's for
    fp32, and ``bound_ms_cuda_cores`` at f32's for every case). The
    gradient does not depend on the chunking, so ``bound_ms`` counts the
    fewest operations over the chunkings the backward can run (the
    caller's chunk and each of ``BWD_SUBS`` that divides it);
    ``bound_ms_sub`` counts those at the sub-chunk the route ran and
    ``bound_ms_chunk`` at the caller's chunk. The head case also gives
    each kernel template's device ms (``launch_ms``) and its time at each
    sub-chunk of ``BWD_SUBS`` that fits (``by_sub``)."""
    from repro_torch.kernels.ssd_scan import kernel as K
    from repro_torch.kernels.ssd_scan.ref import (ssd_backward_reference,
                                                  ssd_reference)

    out, errs = [], []
    for case in SSD_BWD_CASES:
        name, b, l, h, p, groups, n, chunk, dname, init, dfin = case[:11]
        sub = _case_sub(case)
        x, dt, A, B, C, D, s0, dy, dfinal = _ssd_bwd_inputs(torch, case)
        pl = K.bwd_plan(b, l, h, p, n, chunk, x.dtype, sub)

        def kernel(sub=sub):
            return K._bwd_at_sub(x, dt, A, B, C, D, dy, dfinal, chunk, s0,
                                 sub)

        def plain():
            return ssd_backward_reference(x, dt, A, B, C, D, dy, dfinal,
                                          chunk=chunk, initial_state=s0)

        got, again, want = kernel(), kernel(), plain()
        got, again, want = ([t for t in r if t is not None]
                            for r in (got, again, want))
        leaves = [t.float().requires_grad_() for t in
                  (x, dt, A, B, C, D) + ((s0,) if init else ())]
        y, fin = ssd_reference(*leaves[:6], chunk=chunk,
                               initial_state=leaves[6] if init else None)
        auto = torch.autograd.grad([y] + ([fin] if dfin else []), leaves,
                                   [dy] + ([dfinal] if dfin else []))
        torch.cuda.synchronize()
        err = max(_rel_to_max(a, w) for a, w in zip(got, want))
        err_auto = max(_rel_to_max(a, w) for a, w in zip(got, auto))
        repeat = all(torch.equal(a, c) for a, c in zip(got, again))
        ok = all(bool(torch.isfinite(a).all().item()) for a in got) \
            and max(err, err_auto) <= TOL[dname] and repeat
        del leaves, y, fin, auto, want, again
        es = x.element_size()
        states = b * h * p * n * (2 * init + dfin)
        nbytes = 2 * es * (x.numel() + B.numel() + C.numel()) \
            + 4 * (2 * dt.numel() + 4 * h + dy.numel() + states)
        flops = min(_ssd_bwd_flops(b, l, h, p, n, q)
                    for q in (chunk,) + K.BWD_SUBS if chunk % q == 0)
        bms, by = bound_ms(nbytes, flops, dname)
        rec = {"phase": "kernels_bwd", "kernel": "ssd_bwd", "case": name,
               "dtype": dname, "b": b, "l": l, "h": h, "p": p, "g": groups,
               "n": n, "chunk": chunk, "initial_state": init,
               "final_state_grad": dfin, "route": pl.route, "sub": pl.sub,
               "plan": pl._asdict(), "max_abs_err": err,
               "rel_err_vs_autograd": err_auto, "tol_rel": TOL[dname],
               "bitwise_repeat": repeat, "ok": ok,
               "kernel_ms": median_ms(torch, kernel, flush, iters=10),
               "plain_ms": median_ms(torch, plain, flush, iters=3,
                                     warmup=1),
               "library_ms": None, "bound_ms": bms, "bound_by": by,
               "bound_ms_cuda_cores": bound_ms(nbytes, flops,
                                               "float32")[0],
               "bound_ms_sub": bound_ms(nbytes, _ssd_bwd_flops(
                   b, l, h, p, n, pl.sub), dname)[0],
               "bound_ms_chunk": bound_ms(nbytes, _ssd_bwd_flops(
                   b, l, h, p, n, chunk), dname)[0],
               "bytes": nbytes, "flops": flops}
        rec.update(achieved(rec))
        if not out:             # the head case: by template, by sub-chunk
            rec["launch_ms"] = _launch_ms(torch, kernel)
            if pl.route == "mma":
                rec["by_sub"] = {
                    q: median_ms(torch, lambda q=q: kernel(q), flush,
                                 iters=10)
                    for q in K.BWD_SUBS if chunk % q == 0 and
                    K.bwd_main_smem(q, p, n) <= K.SMEM_LIMIT and q >= 64}
        emit(rec)
        out.append(rec)
        errs.append(err)
        del got
        gc.collect()
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"ssd_bwd {name}: kernel disagrees with "
                                 f"the plain backward: {rec}")
    return out, max(errs)


def gated_bwd_cases(torch, flush):
    """The gated norm's backward kernel (``gated_rmsnorm_bwd_cuda``: rows,
    then the dscale reduction) against
    ``ref.gated_rmsnorm_backward_reference`` and autograd of the plain
    forward (f32) at ``GATED_BWD_CASES`` (y f32, the SSD output; z read
    in place from its strided row; the scale in z's dtype, as the train
    step's parameters): dy, dz and dscale within TOL of max|plain|,
    bitwise repeatable; timed beside its bound (y, z, dout, the scale
    read once, dy, dz, dscale written once: bytes) and the plain backward
    (no single library call computes it)."""
    from repro_torch.kernels.rmsnorm.kernel import (gated_rmsnorm_bwd_cuda,
                                                    plan_bwd)
    from repro_torch.kernels.rmsnorm.ref import (
        gated_rmsnorm_backward_reference, gated_rmsnorm_reference)

    out, errs = [], []
    for name, N, d, stride, dname in GATED_BWD_CASES:
        y, z, s, dout = _gated_bwd_inputs(torch, N, d, stride, dname)
        pl = plan_bwd(N, d, z.dtype, "gated")

        def kernel():
            return gated_rmsnorm_bwd_cuda(y, z, s, dout)

        def plain():
            return gated_rmsnorm_backward_reference(y, z, s, dout)

        got, again, want = kernel(), kernel(), plain()
        leaves = [t.float().requires_grad_() for t in (y, z, s)]
        auto = torch.autograd.grad(gated_rmsnorm_reference(*leaves), leaves,
                                   dout.float())
        torch.cuda.synchronize()
        err = max(_rel_to_max(a, w) for a, w in zip(got, want))
        err_auto = max(_rel_to_max(a, w) for a, w in zip(got, auto))
        repeat = all(torch.equal(a, c) for a, c in zip(got, again))
        ok = all(bool(torch.isfinite(a).all().item()) for a in got) \
            and max(err, err_auto) <= TOL[dname] and repeat
        es = z.element_size()
        nbytes = N * d * (2 * 4 + 3 * es) + 2 * d * es
        bms, by = bound_ms(nbytes, 20 * N * d, "float32")
        rec = {"phase": "kernels_bwd", "kernel": "rmsnorm_gated_bwd",
               "case": name, "dtype": dname, "N": N, "d": d,
               "z_row_stride": stride,
               "route": "wide" if pl.nv == 8 else "registers",
               "plan": pl._asdict(), "max_abs_err": err,
               "rel_err_vs_autograd": err_auto, "tol_rel": TOL[dname],
               "bitwise_repeat": repeat, "ok": ok,
               "kernel_ms": median_ms(torch, kernel, flush),
               "plain_ms": median_ms(torch, plain, flush, iters=10),
               "library_ms": None, "bound_ms": bms, "bound_by": by,
               "bytes": nbytes}
        if not out:             # the head case: by template
            rec["launch_ms"] = _launch_ms(torch, kernel)
        emit(rec)
        out.append(rec)
        errs.append(err)
        if not ok:
            raise AssertionError(f"rmsnorm_gated_bwd {name}: kernel "
                                 f"disagrees with the plain backward: "
                                 f"{rec}")
    return out, max(errs)


def _grads(torch, model, params, batch):
    """(loss, gradient leaves) of one train loss, as the train step
    takes them."""
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.training.train_loop import _unflatten_like, batch_to

    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, _ = model.train_loss(
        _unflatten_like(params, leaves),
        batch_to(batch, leaves[0].device))
    return loss.detach(), torch.autograd.grad(loss, leaves)


TRAIN_STEPS = 20
TRAIN_B, TRAIN_L = 4, 1024
#: steps of the MoE cell, and its depth: 4 of qwen2-moe-a2.7b's 24 layers
#: (2.90 B parameters, 34.9 GB with AdamW's f32 moments)
TRAIN_MOE_STEPS = 10
TRAIN_MOE_BLOCKS = 4


#: steps each way of a train cell's ``graphs_vs_eager`` check
GRAPH_CHECK_STEPS = 3
#: the same bits from both ways, and these from the profiled replay
GRAPH_METRICS = ("loss", "lm_loss", "aux_loss", "grad_norm", "lr")


def _train_cell(torch, phase, cfg, steps, want, checks, templates=()):
    """``cfg`` (bf16, remat on) trains on the card: B 4 x L 1024 from
    ``batches_for(cfg, 4, 1024, seed=0)``, AdamW with
    ``cosine_schedule(3e-4, 100, 10_000)`` (JAX's ``build_step``).

    First the eager functional step (``graphs=False``) from the initial
    state: one step with remat on and the ``checks``: ``remat_off`` (one
    step with remat off: loss, gradient norm and parameters the same
    bits), ``microbatch2`` (one step at microbatch 2: the loss within the
    bf16 gate), ``repeat`` (before the step, the loss and its gradients
    twice: the same bits, so no sum of the forward or the backward runs
    in an order that changes from run to run). The eager side goes on to
    ``GRAPH_CHECK_STEPS`` steps; its metrics and parameters are copied to
    the host and its states freed (two train states never share the
    card beyond the functional update's own two: qwen2-moe's is 34.9 GB).
    Then ``graphs_vs_eager``: the captured step (``make_train_step``'s
    default on the card) from a host copy of the initial state, copied
    into its buffers: the warm-up, the capture and a replay, the same
    bits as the eager side's steps (every metric and parameter), the
    warm-up's and the capture's wall ms, peak memory and the graph pool's
    bytes. Then ``steps`` replays with the counters set to 0 just before
    (the kernels line's launches): step ms p50 and max (host clock
    around each step, synchronized), tokens/s, launches a step by op
    (``want``: the first replay's, and ``steps`` times that over the
    run), no capture after the first, losses, auxiliary losses and
    gradient norms finite; and one more replay profiled (busy share,
    device time by kernel, the counters confirmed by the profiler,
    ``cudaGraphLaunch`` and ``cudaStreamSynchronize`` a step: 1 and 0;
    ``templates`` as ``_profile_call`` takes them). Returns the run's
    launch counts."""
    from repro_torch import kernels
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.data.pipeline import batches_for
    from repro_torch.models.model import build
    from repro_torch.training.optimizer import AdamW, cosine_schedule
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)

    allocated_before = torch.cuda.memory_allocated()
    assert cfg.remat and cfg.dtype == "bfloat16"
    data = batches_for(cfg, TRAIN_B, TRAIN_L, seed=0)
    t0 = time.perf_counter()
    batches = [next(data) for _ in range(GRAPH_CHECK_STEPS + steps + 1)]
    data_s = time.perf_counter() - t0
    model = build(cfg)
    opt = AdamW(lr=cosine_schedule(3e-4, 100, 10_000))
    state0 = init_train_state(model, opt, SEED)
    # the captured side's start: the initial parameters on the host, and
    # the optimizer's initial state (zero moments, step 0)
    host_params = _tree_to(state0["params"], "cpu")
    host0 = {"params": host_params, "opt": opt.init(host_params),
             "step": torch.zeros((), dtype=torch.int32)}
    eager = make_train_step(model, opt, graphs=False)
    rec, gates = {}, {}
    if "repeat" in checks:
        l1, g1 = _grads(torch, model, state0["params"], batches[0])
        l2, g2 = _grads(torch, model, state0["params"], batches[0])
        diff = [i for i, (a, b) in enumerate(zip(g1, g2))
                if not torch.equal(a, b)]
        same = {"loss": torch.equal(l1, l2), "grads": not diff}
        rec.update(repeat_same_bits=same, repeat_leaves_differing=diff)
        gates["repeat"] = all(same.values())
        del g1, g2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, m_on = eager(state0, batches[0])
    torch.cuda.synchronize()
    rec["peak_memory_gib_eager_step"] = \
        torch.cuda.max_memory_allocated() / 2**30

    def same_bits(other_state, other_m):
        same = {k: torch.equal(m_on[k], other_m[k])
                for k in ("loss", "grad_norm", "aux_loss")}
        diff = [i for i, (a, b) in enumerate(zip(
            tree_leaves(state["params"]),
            tree_leaves(other_state["params"]))) if not torch.equal(a, b)]
        same["params"] = not diff
        return same, diff

    if "remat_off" in checks:
        off = build(cfg.replace(remat=False))
        s_off, m_off = make_train_step(off, opt, graphs=False)(state0,
                                                               batches[0])
        torch.cuda.synchronize()
        rec["peak_memory_gib_with_remat_off_step"] = \
            torch.cuda.max_memory_allocated() / 2**30
        same, diff = same_bits(s_off, m_off)
        rec.update(remat_off_same_bits=same, remat_off_leaves_differing=diff)
        gates["remat_off"] = all(same.values())
        del s_off
    if "microbatch2" in checks:
        _, m_micro = make_train_step(model, opt, microbatch=2,
                                     graphs=False)(state0, batches[0])
        err = abs(float(m_micro["loss"]) - float(m_on["loss"])) \
            / float(m_on["loss"])
        rec.update(microbatch2_loss_rel_err=err,
                   microbatch2_tol_rel=TOL["bfloat16"])
        gates["microbatch2"] = err <= TOL["bfloat16"]
    del state0
    eager_ms = [m_on]
    for batch in batches[1:GRAPH_CHECK_STEPS]:
        state, m = eager(state, batch)
        eager_ms.append(m)
    eager_ms = [{k: m[k].cpu() for k in GRAPH_METRICS} for m in eager_ms]
    eager_params = [p.cpu() for p in tree_leaves(state["params"])]
    del state, eager
    gc.collect()
    torch.cuda.empty_cache()

    # the captured step from the same initial state
    step = make_train_step(model, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, graph_ms, graph_walls = host0, [], []
    for batch in batches[:GRAPH_CHECK_STEPS]:
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        graph_walls.append((time.perf_counter() - t) * 1e3)
        graph_ms.append({k: m[k].cpu() for k in GRAPH_METRICS})
    del host0, host_params
    peak = torch.cuda.max_memory_allocated()
    same = {k: all(torch.equal(a[k], b[k])
                   for a, b in zip(eager_ms, graph_ms))
            for k in GRAPH_METRICS}
    diff = [i for i, (a, b) in enumerate(zip(
        eager_params, tree_leaves(state["params"]))) if not torch.equal(
            a, b.cpu())]
    same["params"] = not diff
    del eager_params
    rec.update(graphs_vs_eager_steps=GRAPH_CHECK_STEPS,
               graphs_vs_eager_same_bits=same,
               graphs_vs_eager_leaves_differing=diff,
               graph_warmup_call_ms=graph_walls[0],
               graph_capture_call_ms=graph_walls[1],
               graph_replay_call_ms=graph_walls[2:],
               graph_pool_gib=step.pool_bytes / 2**30,
               captures_after_check=step.cache_size())
    gates["graphs_vs_eager"] = all(same.values())

    kernels.reset_launch_counts()
    first = kernels.launch_counts()
    walls, ms, per_step = [], [m_on], None
    for i in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batches[GRAPH_CHECK_STEPS + i])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
        ms.append(m)
        if i == 0:
            per_step = _launch_delta(first, kernels.launch_counts())
    counts = kernels.launch_counts()
    holder = {}

    def one():
        holder["out"] = step(state, batches[-1])
    prof_rec = _profile_call(torch, one, templates=templates)
    ms.append(holder["out"][1])
    losses = [float(m["loss"]) for m in ms]
    aux = [float(m["aux_loss"]) for m in ms]
    norms = [float(m["grad_norm"]) for m in ms[:-1]]
    p50 = statistics.median(walls)
    calls = prof_rec["host_calls"]
    rec = {"phase": phase, "arch": cfg.name, "n_layers": cfg.n_layers,
           "dtype": cfg.dtype, "remat": cfg.remat, "B": TRAIN_B,
           "L": TRAIN_L, "steps": steps, "data_s": data_s,
           "graphs": True, "allocated_before_gib": allocated_before / 2**30,
           "step_ms": walls, "step_ms_p50": p50, "step_ms_max": max(walls),
           "step_ms_first": walls[0], "tokens_per_s": TRAIN_B * TRAIN_L
           / p50 * 1e3, "peak_memory_gib": peak / 2**30,
           "reserved_gib": torch.cuda.memory_reserved() / 2**30,
           "launches_a_step": per_step, "launches_want": want,
           "launches": counts, "captures": step.cache_size(),
           "graph_launches_a_step": calls.get("cudaGraphLaunch"),
           "stream_syncs_a_step": calls.get("cudaStreamSynchronize"),
           "losses": losses, "aux_losses": aux, "grad_norms": norms, **rec,
           "gates": gates, "profiled_step": prof_rec}
    rec["ok"] = (all(math.isfinite(x) for x in losses + aux + norms)
                 and all(per_step.get(k, 0) == n for k, n in want.items())
                 and all(gates.values())
                 and all(counts[k] == n * steps for k, n in want.items())
                 and step.cache_size() == 1
                 and calls.get("cudaGraphLaunch") == 1
                 and calls.get("cudaStreamSynchronize") == 0
                 and prof_rec["launch_counters_confirmed"])
    if cfg.moe is not None:
        rec["ok"] = rec["ok"] and all(a > 0 for a in aux)
    emit(rec)
    if not rec["ok"]:
        brief = {k: v for k, v in rec.items() if k != "profiled_step"}
        raise AssertionError(f"{phase}: a gate failed: {brief}")
    return counts


def train_phase(torch):
    """llama3.2-1b at full width (16 layers, bf16) trains on the card
    (``_train_cell``): ``resolve_config(..., "train_4k")`` (remat on),
    with the remat-off and microbatch-2 checks; launches a step: flash
    forward 32 with remat, backward 16; RMSNorm 33 + 32 recomputed,
    backward 33."""
    from repro_torch.launch.steps import resolve_config

    cfg = resolve_config("llama3.2-1b", "train_4k")
    nl = cfg.n_layers
    want = {"flash_attention": 2 * nl, "flash_attention_bwd": nl,
            "rmsnorm": 2 * nl + 1 + 2 * nl, "rmsnorm_bwd": 2 * nl + 1}
    return _train_cell(torch, "train", cfg, TRAIN_STEPS, want,
                       ("remat_off", "microbatch2"))


def train_ssm(torch):
    """mamba2-780m at full width and depth (48 layers, d 1536, bf16)
    trains on the card (``_train_cell``): ``resolve_config(...,
    "train_4k")`` (remat on), cut from B 256 x L 4096 to B 4 x L 1024 as
    llama's cell is, with the remat-off and microbatch-2 checks; launches
    a step: the SSD dual form 48 + 48 recomputed, its backward 48; the
    norms 97 + 96 recomputed (``ln1`` and the gated norm a layer,
    ``ln_f``), the add / norm backward 49 and the gated backward 48. The
    profiled step names the SSD forward's and backward's device ms by
    kernel template, and the gated backward's."""
    from repro_torch.launch.steps import resolve_config

    cfg = resolve_config("mamba2-780m", "train_4k")
    nl = cfg.n_layers
    want = {"ssd": 2 * nl, "ssd_bwd": nl, "rmsnorm": 2 * nl + 1 + 2 * nl,
            "rmsnorm_bwd": nl + 1, "rmsnorm_gated_bwd": nl,
            "ssd_extend": 0, "flash_attention": 0}
    return _train_cell(torch, "train_ssm", cfg, TRAIN_STEPS, want,
                       ("remat_off", "microbatch2"),
                       templates={"ssd_forward": ("ssd_", "ssd_bwd"),
                                  "ssd_backward": ("ssd_bwd", None),
                                  "gated_backward": ("rmsnorm_gated_bwd",
                                                     None)})


def train_moe(torch):
    """qwen2-moe-a2.7b at full width (d 2048, 60 experts top-4 and the
    shared expert, 16 heads: flash at G 1) on 4 of its 24 layers
    (``with_depth``), bf16, remat on, trains ``TRAIN_MOE_STEPS`` steps
    on the card (``_train_cell``), with the ``repeat`` check (the
    token dispatch combines by gather, no atomics: the same bits run
    after run); the auxiliary loss finite and positive; launches a step:
    flash 4 + 4 recomputed, backward 4; RMSNorm 9 + 8, backward 9."""
    from repro_torch.launch.steps import resolve_config, with_depth

    cfg = with_depth(resolve_config("qwen2-moe-a2.7b", "train_4k"),
                     {"blocks": TRAIN_MOE_BLOCKS})
    nl = cfg.n_layers
    want = {"flash_attention": 2 * nl, "flash_attention_bwd": nl,
            "rmsnorm": 2 * nl + 1 + 2 * nl, "rmsnorm_bwd": 2 * nl + 1,
            "ssd": 0, "ssd_bwd": 0}
    return _train_cell(torch, "train_moe", cfg, TRAIN_MOE_STEPS, want,
                       ("repeat",))


TRAIN_EXACT_LAYERS = 2


def _exact_configs():
    """The ``train_exact`` models, fp32, with their B, L and steps:
    llama3.2-1b and
    mamba2-780m at full width cut to 2 layers (B 2 x L 128, L 256: a
    whole chunk), jamba-1.5-large-398b's
    reduced super-block (attention, seven SSM mixers, MoE on the even
    sublayers) widened as ``model_hybrid`` widens it (d_model 512, the
    SSM's published head_dim 128 and d_state 128; B 2 x L 128), 3 steps
    each; qwen2-moe-a2.7b at full width cut to 1 layer, B 1 x L 64, 1
    step (its shared expert and its head_dim-128 fp32 flash backward; its
    1.2 B f32 parameters, most of them the 151,936-row embedding and
    head, make each CPU step the slowest of the phase)."""
    import dataclasses

    from repro_torch.configs import get_arch

    f32 = dict(dtype="float32", param_dtype="float32")
    jamba = get_arch("jamba-1.5-large-398b", variant="reduced")
    jamba = jamba.replace(d_model=512, head_dim=512 // jamba.n_heads,
                          ssm=dataclasses.replace(jamba.ssm, head_dim=128,
                                                  d_state=128))
    return ((get_arch("llama3.2-1b").replace(n_layers=TRAIN_EXACT_LAYERS,
                                             **f32), 2, 128, 3),
            (get_arch("mamba2-780m").replace(n_layers=TRAIN_EXACT_LAYERS,
                                             **f32), 2, 256, 3),
            (jamba, 2, 128, 3),
            (get_arch("qwen2-moe-a2.7b").replace(n_layers=1, **f32), 1,
             64, 1))


#: the relative size of the perturbation ``train_exact`` measures each
#: leaf's conditioning with: one f32 rounding
ROUNDING_PERTURBATION = 2.0 ** -23
#: a leaf's gradient gate in rounding-level moves of its own gradient:
#: mamba2's A_log moved 1.06e-4 of its max on the CPU under that
#: perturbation and 1.78e-4 between the card and the CPU
GRAD_SENSITIVITY_FACTOR = 4


def _perturbed_grads(torch, model, params, batch):
    """The gradient leaves of one train loss with every projection's
    output (``layers.linear``) scaled by 1 + 2^-23 N(0, 1) from a fixed
    seed: the forward moved by about one f32 rounding, as another
    summation order of a GEMM (the card's against the CPU's) moves it."""
    from repro_torch.models import layers, ssm

    real = layers.linear
    gen = torch.Generator().manual_seed(SEED)

    def noisy(p, x):
        y = real(p, x)
        return y * (1 + ROUNDING_PERTURBATION * torch.randn(
            y.shape, generator=gen, dtype=y.dtype))
    layers.linear = ssm.linear = noisy
    try:
        return _grads(torch, model, params, batch)[1]
    finally:
        layers.linear = ssm.linear = real


def train_exact(torch):
    """Each of ``_exact_configs`` trains its steps on the card and on the
    CPU from the same weights and batches, fp32 (TF32 off): losses within
    1e-5 relative, the first step's gradients within 1e-4 of each leaf's
    max|CPU|, the parameters after the last step within rtol 1e-4, atol
    5e-5
    (Adam's m / sqrt(v) turns the last bits of a near-zero gradient into
    up to lr in the update). A leaf whose gradient is a small residual of
    large per-token terms (an SSM's A_log and dt_bias) moves by more than
    that under any rounding-level change of the forward: each leaf's
    ``cpu_sensitivity`` is how far the CPU's own gradient moves when
    every projection's output is perturbed by one f32 rounding
    (``_perturbed_grads``), and a leaf is held to 1e-4 or
    ``GRAD_SENSITIVITY_FACTOR`` times its sensitivity, whichever is
    larger (``grad_widened`` lists the leaves held wider, with their
    errors); measured on the stacks with an SSM, every leaf of the others
    held to 1e-4. One line a model; raises after the
    last if any failed."""
    from repro_torch.core.pytree import tree_flatten_with_path, tree_leaves
    from repro_torch.data.pipeline import batches_for
    from repro_torch.models.model import build
    from repro_torch.training.optimizer import AdamW, cosine_schedule
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)

    failed = []
    for cfg, B, L, steps in _exact_configs():
        t0 = time.perf_counter()
        opt = AdamW(lr=cosine_schedule(3e-4, 100, 10_000))
        card, cpu = build(cfg), build(cfg, device="cpu")
        state = init_train_state(card, opt, SEED)
        cpu_state = _tree_to(state, "cpu")
        names = ["/".join(map(str, path)) for path, _ in
                 tree_flatten_with_path(cpu_state["params"])]
        data = batches_for(cfg, B, L, seed=0)
        batches = [next(data) for _ in range(steps)]
        _, g_card = _grads(torch, card, state["params"], batches[0])
        _, g_cpu = _grads(torch, cpu, cpu_state["params"], batches[0])
        errs = [_rel_to_max(a.cpu(), b) for a, b in zip(g_card, g_cpu)]
        sens = [0.0] * len(errs)
        if cfg.ssm is not None:
            g_pert = _perturbed_grads(torch, cpu, cpu_state["params"],
                                      batches[0])
            sens = [_rel_to_max(a, b) for a, b in zip(g_pert, g_cpu)]
            del g_pert
        tols = [max(1e-4, GRAD_SENSITIVITY_FACTOR * x) for x in sens]
        widened = {n: {"err": e, "cpu_sensitivity": x, "tol": t}
                   for n, e, x, t in zip(names, errs, sens, tols)
                   if t > 1e-4}
        grad_ok = all(e <= t for e, t in zip(errs, tols))
        del g_card, g_cpu
        step_card, step_cpu = make_train_step(card, opt), \
            make_train_step(cpu, opt)
        loss_err = 0.0
        for b in batches:
            state, mc = step_card(state, b)
            cpu_state, mh = step_cpu(cpu_state, b)
            loss_err = max(loss_err,
                           abs(float(mc["loss"]) - float(mh["loss"]))
                           / float(mh["loss"]))
        pairs = list(zip(tree_leaves(state["params"]),
                         tree_leaves(cpu_state["params"])))
        param_ok = all(torch.allclose(a.cpu(), b, rtol=1e-4, atol=5e-5)
                       for a, b in pairs)
        param_err = max((a.cpu() - b).abs().max().item() for a, b in pairs)
        rec = {"phase": "train_exact", "arch": cfg.name, "n_layers":
               cfg.n_layers, "d_model": cfg.d_model, "dtype": cfg.dtype,
               "B": B, "L": L, "steps": steps, "loss_rel_err": loss_err,
               "grad_rel_err": max(errs),
               "grad_rel_err_held_to_1e-4": max(
                   (e for e, t in zip(errs, tols) if t == 1e-4),
                   default=0.0),
               "grad_tol": 1e-4, "grad_widened": widened,
               "param_max_abs_err": param_err, "param_rtol": 1e-4,
               "param_atol": 5e-5, "aux_loss_card": float(mc["aux_loss"]),
               "seconds": time.perf_counter() - t0}
        rec["ok"] = loss_err <= 1e-5 and grad_ok and param_ok
        emit(rec)
        if not rec["ok"]:
            failed.append(rec)
        del card, cpu, state, cpu_state, pairs
        gc.collect()
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"train_exact: card and CPU disagree: "
                             f"{failed}")


def train_cells(torch) -> int:
    """``--train``: the kernels built, then the three train cells, each
    on an empty card, and their seconds."""
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    marks = [("start", time.perf_counter())]
    _build.build_all()
    marks.append(("build", time.perf_counter()))
    for name, cell in (("train", train_phase), ("train_ssm", train_ssm),
                       ("train_moe", train_moe)):
        cell(torch)
        gc.collect()
        torch.cuda.empty_cache()
        marks.append((name, time.perf_counter()))
    emit({"phase": "timing", "seconds": {
        name: t - prev for (name, t), (_, prev) in zip(marks[1:], marks)}})
    print(_smi(), flush=True)
    return 0


def _smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--norm-host-us"] and len(sys.argv) == 3:
        return norm_host_cost(torch, Path(sys.argv[2]).resolve())
    if sys.argv[1:2] == ["--ssd-compare"] and len(sys.argv) == 3:
        return ssd_compare(torch, Path(sys.argv[2]).resolve())
    if sys.argv[1:2] == ["--bwd-compare"] and len(sys.argv) == 3:
        return bwd_compare(torch, Path(sys.argv[2]).resolve())
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    if sys.argv[1:] == ["--train"]:
        return train_cells(torch)
    if sys.argv[1:] == ["--serve-mesh"]:
        return serve_mesh_only(torch)
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.models.model import build
    from repro_torch.models.transformer import init_transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _smi()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi})

    t0 = time.perf_counter()
    marks = [("start", t0)]
    _build.build_all()
    t_nvcc = time.perf_counter() - t0
    ptxas = ptxas_table(_build.BUILD_LOG.values())
    gated = ("_mma_kernel", "ssd_extend", "rmsnorm_kernel",
             "ssd_chunk_states", "ssd_state_pass", "ssd_chunk_out",
             "flash_bwd_", "rmsnorm_bwd_kernel", "rmsnorm_gated_bwd",
             "ssd_bwd_")
    spills = {k: v for k, v in ptxas.items() if any(s in k for s in gated)
              and (v.get("spill_stores") or v.get("spill_loads"))}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_s": t_nvcc, "ptxas": ptxas,
          "tensor_core_templates": sum("_mma_kernel" in k for k in ptxas),
          "ssd_extend_templates": {k: v for k, v in ptxas.items()
                                   if "ssd_extend" in k},
          "rmsnorm_templates": {k: v for k, v in ptxas.items()
                                if "rmsnorm_kernel" in k},
          "ssd_mma_templates": {k: v for k, v in ptxas.items()
                                if any(s in k for s in gated[3:6])},
          "backward_templates": {k: v for k, v in ptxas.items()
                                 if any(s in k for s in gated[6:])},
          "gated_spills": spills})
    if spills or not all(any(s in k for k in ptxas) for s in gated):
        raise AssertionError(f"tensor-core, ssd_extend, ssd mma, rmsnorm "
                             f"or backward templates missing or spilling: "
                             f"{spills}")

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    attn, attn_err = decode_attention_cases(torch, flush)
    mem, mem_err = memory_attention_cases(torch, flush)
    attn, attn_err = attn + mem, max(attn_err, mem_err)
    paged, paged_err = paged_decode_attention_cases(torch, flush)
    norm, norm_err = rmsnorm_cases(torch, flush)
    qmm, qmm_err = quant_matmul_cases(torch, flush)
    ext, ext_err = ssd_extend_cases(torch, flush)
    ssd, ssd_err = ssd_cases(torch, flush)
    flash, flash_err = flash_attention_cases(torch, flush)
    marks.append(("build_and_kernels", time.perf_counter()))
    flash_bwd, flash_bwd_err = flash_bwd_cases(torch, flush)
    norm_bwd, norm_bwd_err = norm_bwd_cases(torch, flush)
    ssd_bwd, ssd_bwd_err = ssd_bwd_cases(torch, flush)
    gated_bwd, gated_bwd_err = gated_bwd_cases(torch, flush)
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    marks.append(("kernels_bwd", time.perf_counter()))

    def model_checks():
        model_check(torch)
        model_check(torch, variant="edge", phase="model_quant")
        model_check(torch, quant="int8", phase="model_quant")
        # quantized SSM stacks: the edge profile and int8 weights on mamba2
        model_check(torch, variant="reduced+edge", phase="model_quant",
                    arch="mamba2-780m")
        model_check(torch, variant="reduced", quant="int8",
                    phase="model_quant", arch="mamba2-780m")
        spec_exact(torch)
        fleet_exact(torch)
        train_exact(torch)

    # the card tests in their own process while the model checks, which
    # time nothing on the card, run in this one
    card_tests(during=model_checks)
    marks.append(("card_tests_and_model_checks", time.perf_counter()))
    model, params = served_model()
    counts, engine, rec, tokens = serve(torch, model, params)
    profile(torch, engine)
    del engine
    gc.collect()
    serve_mesh(torch, model, params, (rec, tokens))
    serve_eager(torch, model, params, (rec, tokens), "serve_eager")
    paged_counts, engine, _, _ = serve(torch, model, params, paged=True,
                                       base=(rec, tokens))
    profile(torch, engine, "profile_paged")
    del engine
    # the two layouts again in reverse order (contiguous, paged, paged,
    # contiguous): the host-bound step varies from call to call, so the
    # layouts are compared only inside one call, in turns
    serve(torch, model, params, paged=True, base=(rec, tokens),
          phase="serve_paged_turn2")
    serve(torch, model, params, phase="serve_turn2")
    pool_pressure(torch, model, params)
    lifecycle(torch, model, params, rec)
    prefix_rec = prefix(torch, model, params)
    fleet_counts = fleet_phases(torch, model, params)
    # the bf16 tree leaves the card, so the quantized phases' peak memory
    # counts only their own weights
    params = _tree_to(params, "cpu")
    gc.collect()
    int8_counts, edge_counts = serve_quantized(torch, model, params, tokens)
    del model, params
    gc.collect()
    marks.append(("llama_serve", time.perf_counter()))
    # the SSM family: mamba2-780m, 2 layers card against CPU, then the
    # full 48-layer bf16 model through the engine
    pair = _ssm_pair()
    ssd_counts = model_ssm(torch, pair)
    serve_ssm_check(torch, pair)
    del pair
    ssm_model = build(get_arch("mamba2-780m"))
    ssm_params = ssm_model.init(SEED)
    ext_counts, engine, ssm_rec, ssm_tokens = serve(
        torch, ssm_model, ssm_params, phase="serve_ssm")
    profile(torch, engine, "profile_ssm")
    del engine
    serve_eager(torch, ssm_model, ssm_params, (ssm_rec, ssm_tokens),
                "serve_ssm_eager")
    prefill_ssm(torch, ssm_model, ssm_params)
    # fig. 2's turn for the cache-free forward: the same dual form
    # through model.lm, on graphs and eagerly
    forward_turns_lm(torch, ssm_model.cfg, "mamba2-780m", ssm_params, 1,
                     {"ssd": 48, "rmsnorm": 97},
                     parts={"ssd": ("ssd_", "ssd_extend")})
    del ssm_model, ssm_params
    gc.collect()
    torch.cuda.empty_cache()
    marks.append(("ssm", time.perf_counter()))
    # the Zoo: model services card against CPU, then the paper's
    # deployment example at full width on graphs, fig. 2's turn for it
    # and for llama3.2-1b's model.lm, then the bf16 classifier at full
    # width against the plain forward
    model_vlm(torch)
    zoo_counts, zoo_case = zoo(torch)
    forward_turns_zoo(torch, zoo_case)
    del zoo_case
    gc.collect()
    torch.cuda.empty_cache()
    lcfg = get_arch("llama3.2-1b")
    forward_turns_lm(torch, lcfg, "llama3.2-1b",
                     init_transformer(lcfg, SEED, "cuda"), 2,
                     {"flash_attention": 16, "rmsnorm": 33})
    gc.collect()
    torch.cuda.empty_cache()
    zoo_plain(torch)
    marks.append(("zoo", time.perf_counter()))
    # the MoE, hybrid and other dense families: card against CPU, then
    # qwen2-moe at full width and depth and jamba's super-block served
    family_counts = model_families(torch)
    family_counts["jamba-reduced-p128"] = model_hybrid(torch)
    family_counts.update(serve_moe(torch))
    family_counts.update(serve_hybrid(torch))
    marks.append(("families", time.perf_counter()))
    # the frontend families: card against CPU at full width, then
    # seamless-m4t-medium and pixtral-12b at full depth on graphs
    frontend_counts = {"seamless-m4t-medium-2x2": model_encdec(torch),
                       "pixtral-12b-2-cached": model_vlm_cached(torch)}
    frontend_counts.update(serve_encdec(torch))
    frontend_counts.update(serve_vlm(torch))
    marks.append(("frontends", time.perf_counter()))
    # speculative decoding last: its profile windows come after every
    # earlier phase's, whose gates count the records a window loses
    # (more in the later windows of a process)
    model, params = served_model()
    spec_lines = spec(torch, model, params, tokens)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    ssm_model = build(get_arch("mamba2-780m"))
    spec_lines.update(spec_ssm(torch, ssm_model, ssm_model.init(SEED),
                               ssm_tokens))
    del ssm_model
    gc.collect()
    marks.append(("spec", time.perf_counter()))
    # training last: llama3.2-1b at full width, its backward kernels on
    # the step's path
    torch.cuda.empty_cache()
    train_counts = train_phase(torch)
    gc.collect()
    torch.cuda.empty_cache()
    marks.append(("train", time.perf_counter()))
    # the SSM and MoE stacks: mamba2-780m at full width and depth, then
    # qwen2-moe-a2.7b at full width on 4 layers
    ssm_train_counts = train_ssm(torch)
    gc.collect()
    torch.cuda.empty_cache()
    moe_train_counts = train_moe(torch)
    gc.collect()
    torch.cuda.empty_cache()
    marks.append(("train_ssm_moe", time.perf_counter()))
    emit({"phase": "timing", "seconds": {
        name: t - prev for (name, t), (_, prev) in zip(marks[1:], marks)},
        "total_s": marks[-1][1] - marks[0][1]})

    def entry(name, route, src, tpu, err, rows, launches, extra=()):
        head = rows[0]
        keys = ("case", "kernel_ms", "plain_ms", "library_ms",
                "bound_ms") + tuple(extra)
        return {"name": name, "route": route, "source": src,
                "replaces": tpu, "launches": launches[name],
                "max_abs_err": err, "ms": head["kernel_ms"],
                "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"],
                "library_ms": head["library_ms"],
                "cases": [{k: r[k] for k in keys} for r in rows]}

    def timed(rows):
        return [r for r in rows if "kernel_ms" in r]

    def spec_launches(name):
        """The kernel's launches in the spec phases' served runs."""
        return {ph: rec["launches"][name] for ph, rec in spec_lines.items()
                if rec["launches"][name]}

    kernel_lines = [
        entry("decode_attention", "cuda", DECODE_ATTN_SRC, DECODE_ATTN_TPU,
              attn_err, timed(attn), counts, extra=("plan",)),
        entry("rmsnorm", "cuda", RMSNORM_SRC, RMSNORM_TPU, norm_err,
              timed(norm), counts,
              extra=("dtype", "scale_dtype", "route", "bound_by", "host_us",
                     "plan")),
        entry("paged_decode_attention", "cuda", DECODE_ATTN_SRC,
              PAGED_ATTN_TPU, paged_err, timed(paged), paged_counts,
              extra=("contiguous_kernel_ms", "gather_plus_sdpa_ms",
                     "plan")),
        entry("quant_matmul_int8", "cuda", QMM_SRC, QMM_TPU[8], qmm_err[8],
              timed(qmm[8]), int8_counts,
              extra=("dense_bf16_ms", "simt_ms", "route", "blocks",
                     "splits", "bound_by", "rel_err")),
        entry("quant_matmul_int4", "cuda", QMM_SRC, QMM_TPU[4], qmm_err[4],
              timed(qmm[4]), edge_counts,
              extra=("dense_bf16_ms", "simt_ms", "route", "blocks",
                     "splits", "bound_by", "rel_err")),
        dict(entry("ssd_extend", "cuda", SSD_SRC, SSD_EXT_TPU, ext_err,
                   timed(ext), ext_counts, extra=("bound_by", "plan")),
             sweep={k: ext[-1][k] for k in ("T", "sweep_ms", "fixed_ms",
                                            "per_token_us")}),
        entry("ssd", "cuda", SSD_SRC, SSD_TPU, ssd_err, timed(ssd),
              ssd_counts, extra=("bound_by", "route", "plan", "substep_ms",
                                 "bound_ms_cuda_cores")),
        entry("flash_attention", "cuda", FLASH_SRC, FLASH_TPU, flash_err,
              flash, zoo_counts, extra=("bound_by", "plan"))]
    for line in kernel_lines:
        line["spec_launches"] = spec_launches(line["name"])
        line["family_launches"] = {
            k: c[line["name"]] for k, c in family_counts.items()
            if c[line["name"]]}
        line["frontend_launches"] = {
            k: c[line["name"]] for k, c in frontend_counts.items()
            if c[line["name"]]}
        line["fleet_launches"] = fleet_counts[line["name"]]
        line["train_launches"] = train_counts[line["name"]]
    # the backward kernels (no TPU counterpart): launches of the train
    # phase's 20 steps (the flash and add / norm backward, llama), of
    # train_ssm's 20 (the SSD and gated-norm backward, mamba2)
    kernel_lines += [
        entry("flash_attention_bwd", "cuda", FLASH_BWD_SRC, None,
              flash_bwd_err, flash_bwd, train_counts,
              extra=("dtype", "bound_by", "plan", "rel_err_vs_autograd")),
        entry("rmsnorm_bwd", "cuda", RMSNORM_SRC, None, norm_bwd_err,
              norm_bwd, train_counts,
              extra=("dtype", "route", "bound_by", "rel_err_vs_autograd")),
        dict(entry("ssd_bwd", "cuda", SSD_BWD_SRC, None, ssd_bwd_err,
                   ssd_bwd, ssm_train_counts,
                   extra=("dtype", "bound_by", "bound_ms_cuda_cores",
                          "rel_err_vs_autograd", "route", "sub", "plan",
                          "bound_ms_sub", "bound_ms_chunk")),
             plan=ssd_bwd[0]["plan"], route=ssd_bwd[0]["route"],
             bound_ms_sub=ssd_bwd[0]["bound_ms_sub"],
             bound_ms_chunk=ssd_bwd[0]["bound_ms_chunk"],
             launch_ms=ssd_bwd[0]["launch_ms"],
             by_sub=ssd_bwd[0].get("by_sub")),
        dict(entry("rmsnorm_gated_bwd", "cuda", RMSNORM_SRC, None,
                   gated_bwd_err, gated_bwd, ssm_train_counts,
                   extra=("dtype", "bound_by", "rel_err_vs_autograd",
                          "route", "plan")),
             plan=gated_bwd[0]["plan"], route=gated_bwd[0]["route"],
             launch_ms=gated_bwd[0]["launch_ms"])]
    for line in kernel_lines:
        line["train_ssm_launches"] = ssm_train_counts[line["name"]]
        line["train_moe_launches"] = moe_train_counts[line["name"]]
    emit({"kernels": kernel_lines})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
