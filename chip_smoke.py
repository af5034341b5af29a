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
kernel time by kernel); serves the same requests on a paged KV pool
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
trace and, under the profiler, two host stream syncs a poll); and
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
that must pass with no test skipped); the Zoo's model services at full
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
ids equal, logits within 2e-2 of max|plain|). The decode-attention cases cover both tensor-core routes of its
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
(``graphs=False``) in turns with graphs (tokens identical; decode ms,
ITL, TTFT and tok/s of both), and every profile phase marks its engine
steady and fails on a capture in its window, on a host stream sync
other than the poll's two reads, and on a launch counter that differs
from the profiler's count of its kernel templates (a count may fall
short by no more than the records the profiler lost, which the
window's lead spins measure).
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
shapes and its ``prefill_ssm`` (``ssd_compare``).
"""
from __future__ import annotations

import gc
import json
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
    (("flash_attention",), ("flash_mma_kernel", "flash_f32_kernel")))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def median_ms(torch, fn, flush, iters=25, warmup=3):
    """Median CUDA-event time of one call, L2 flushed before each. A spin
    of ~0.1 ms on the card before the start event keeps the stream busy
    while the host enqueues the call, so the host's launch latency is
    not counted as device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(200_000)
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
def decode_attention_cases(torch, flush):
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda, plan)
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_reference

    dev = torch.device("cuda")
    Hq, Hkv, hd = 32, 8, 64
    # (name, B, T, S, window, special rows): the main path's decode step
    # (mma_keys, S split 4 ways) and chunk (mma_rows), a window, S 1000
    # (the split of 256 slots does not divide it: the last is 232), a
    # fully masked row at T 1 (every split masked: the combine's NEG_INF
    # case) and at T 16, and R = T * G of 12, 16 (mma_keys) and 20
    # (mma_rows) around the route threshold (R <= 16)
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
    ]
    out, errs = [], []
    for name, B, T, S, window, special in cases:
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
            ok = bool(torch.isfinite(got).all().item()) and err <= TOL[dname]
            pl = plan(B, T, Hq, Hkv, S, hd, dtype)
            rec = {"phase": "kernels", "kernel": "decode_attention",
                   "case": name, "dtype": dname, "B": B, "T": T, "S": S,
                   "Hq": Hq, "Hkv": Hkv, "hd": hd, "window": window,
                   "plan": pl._asdict(),
                   "max_abs_err": err, "tol": TOL[dname], "ok": ok}
            if special == "masked":
                mean_v = v[0].float().mean(0).repeat_interleave(
                    Hq // Hkv, dim=0)
                merr = (got[0].float() - mean_v[None]).abs().max().item()
                rec["masked_row_vs_mean_v"] = merr
                ok = ok and merr <= TOL[dname]
                rec["ok"] = ok
            if name in ("decode", "chunk") and dtype == torch.bfloat16:
                elt = q.element_size()
                nbytes = elt * (2 * B * S * Hkv * hd + 2 * B * T * Hq * hd) \
                    + 4 * (B * S + B * T)
                flops = 4 * B * T * Hq * S * hd
                bms, by = bound_ms(nbytes, flops, dname)
                mask = ((pos[:, None, :] >= 0)
                        & (pos[:, None, :] <= q_pos[:, :, None]))[:, None]
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
    Hq, Hkv, hd, S = 32, 8, 64, 1024
    # (name, B, T, page size, window, special rows)
    cases = [
        ("decode", 8, 1, 16, 0, None),
        ("chunk", 1, 128, 16, 0, None),
        ("decode_window256", 8, 1, 16, 256, None),
        ("chunk_all_masked_row", 2, 16, 16, 0, "masked"),
        ("decode_ps8", 8, 1, 8, 0, None),
        ("chunk_ps32", 1, 128, 32, 0, None),
        ("decode_all_masked_row", 8, 1, 16, 0, "masked"),
    ]
    out, errs = [], []
    for name, B, T, ps, window, special in cases:
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
                and err <= TOL[dname] and cerr == 0.0
            rec = {"phase": "kernels", "kernel": "paged_decode_attention",
                   "case": name, "dtype": dname, "B": B, "T": T, "S": S,
                   "page_size": ps, "NB": NB, "pool_pages": P + 1,
                   "trash_entries": int((bt == P).sum().item()),
                   "Hq": Hq, "Hkv": Hkv, "hd": hd, "window": window,
                   "plan": plan(B, T, Hq, Hkv, S, hd, dtype)._asdict(),
                   "max_abs_err": err, "tol": TOL[dname],
                   "vs_contiguous_kernel_max_abs_diff": cerr, "ok": ok}
            if special == "masked":
                mean_v = vg[0].float().mean(0).repeat_interleave(
                    Hq // Hkv, dim=0)
                merr = (got[0].float() - mean_v[None]).abs().max().item()
                rec["masked_row_vs_mean_v"] = merr
                ok = ok and merr <= TOL[dname]
                rec["ok"] = ok
            if name in ("decode", "chunk") and dtype == torch.bfloat16:
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
              ("N8_d3072_gated_other_scale", 8, 3072, "gated", True))
MAMBA2_PROJ = 6448       # mamba2-780m's in-projection width (z's stride)


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
                z = torch.randn((N, MAMBA2_PROJ), generator=g,
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
    ragged chunk tail, a full chunk), fp32 and bf16, plus a ragged N
    (200), K 34 (int4: an odd group of 17; int8: no multiple of 8), a K
    that is no multiple of the mma route's 64-row tile (2080), a strided
    x (a view of wider rows) and, for int4, a group of 64. Each case
    records its ``mma_plan`` route, which must be the rule's: bf16 on
    ``mma`` where N % 4 == 0 and, int4, the group is a multiple of 16
    or, int8, K a multiple of 8 (every ``mma`` case is also called twice
    and must be bitwise equal); fp32 and the rest on ``simt``.
    Tolerance: max|kernel - plain| <= tol * max|plain| (the sums run in
    another order; bf16 rounds the output). bf16 times at M 8 and 128 for
    all four shapes, beside the plain version, a bf16 matmul on the
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
                        and not strided and M in (8, 128) \
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
    steps) at mamba2's decode (B 8, T 1) and chunk (B 1, T 128) shapes
    and at the reduced dims with 2 groups and a ragged T 5, in the form
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
             ("reduced_g2_T5", 2, 5, SSD_REDUCED_G2)]
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
        if name in ("decode", "chunk"):
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
             ("reduced_g2_l64_init", 2, 64, SSD_REDUCED_G2, 32, True)]
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
    reached. The backward raises."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda, plan)
    from repro_torch.kernels.flash_attention.ref import attention_reference

    dev = torch.device("cuda")
    # (name, B, L, Hq, Hkv, hd, dtype, causal, window)
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
    ]
    out, errs = [], []
    for name, B, L, Hq, Hkv, hd, dname, causal, window in cases:
        g = torch.Generator(device=dev).manual_seed(SEED)
        dtype = getattr(torch, dname)
        q = torch.randn((B, L, Hq, hd), generator=g, device=dev).to(dtype)
        k = torch.randn((B, L, Hkv, hd), generator=g, device=dev).to(dtype)
        v = torch.randn((B, L, Hkv, hd), generator=g, device=dev).to(dtype)
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
        mask = torch.ones((L, L), dtype=torch.bool, device=dev)
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
               "case": name, "dtype": dname, "B": B, "L": L, "Hq": Hq,
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
    # the launch sits in an autograd Function whose backward raises
    qg = q.detach().requires_grad_()
    try:
        flash_attention_cuda(qg, k, v).float().sum().backward()
    except NotImplementedError:
        pass
    else:
        raise AssertionError("flash_attention: backward did not raise")
    return out, max(errs)


def card_tests():
    """The repository's card tests (``tests/test_torch_card.py``), run
    as the README names them: without ``tests/conftest.py``, which
    imports JAX, absent here. Fails unless pytest exits 0 with at least
    one test passed and none skipped."""
    import re
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda",
           "-q", "-p", "no:cacheprovider", "tests/test_torch_card.py"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=str(root / "src")),
                       timeout=600)
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
def model_check(torch, variant="", quant="", phase="model"):
    """The 2-layer full-width fp32 model on the card against the same
    model on the CPU: a 128-token extend and 8 greedy decode steps, logits
    within 2e-3 and tokens identical. ``variant``/``quant`` as in the
    serve CLI (the weights, from one seed, quantized on the CPU and
    copied to the card)."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build
    from repro_torch.quant import quantize_for_cfg

    cfg = get_arch("llama3.2-1b", variant=variant).replace(
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


def _profiled(torch, fn):
    """Run ``fn`` in a profile window and return the profiler and the
    wall ms of ``fn`` (synchronized). The window opens with
    ``PROFILE_LEAD`` spin kernels, which ``_device_rows`` counts apart:
    the profiler loses a few device records of a window once the process
    has run a while (none in its first window; 0–24 a window over a
    run, once 293), and the spins it lost measure that."""
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
    return prof, wall_ms


def _device_rows(prof):
    """(device ms, calls, kernel) of a profile window, largest first,
    without the window's lead spins, and how many of the spins the
    profiler lost."""
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
    return sorted(rows, reverse=True), PROFILE_LEAD - spins


def _counted_vs_profiled(counted, rows):
    """For each ``PROFILE_TEMPLATES`` group: (the launches its counters
    ``counted``, the profiler's count of its kernel templates)."""
    return {"+".join(names): (sum(counted.get(n, 0) for n in names),
                              sum(c for _, c, k in rows
                                  if any(t in k for t in temps)))
            for names, temps in PROFILE_TEMPLATES}


def _counters_confirmed(seen, lost):
    """The profiler may lose a few records: a kernel count may fall
    short of its counter by no more than the lead spins the window lost
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
#: ``PROFILE_LEAD`` spins are ``cudaLaunchKernel`` calls too)
HOST_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC",
              "cudaMemcpyAsync", "cudaStreamSynchronize")


def _profile_call(torch, fn, parts=(), chain=None):
    """One warm call of ``fn`` under the profiler: device kernel time by
    kernel and its share of the call's wall time, the flash kernel's
    time and launches, the host's CUDA runtime calls (``HOST_CALLS``),
    and ``parts``: {name: (substring, excluded substring)} summed the
    same way. The launch counters' change over the call is held against
    the profiler's count of the kernel templates (``PROFILE_TEMPLATES``):
    ``launch_counters_confirmed`` is false where they differ by more
    than the records the profiler lost, so a replay that added counts
    its graph did not launch, or launched kernels it did not count,
    shows. ``chain``: ``_chain_timing`` of those kernels."""
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
            "profiler_lost_lead_spins": lost,
            "flash_attention": _ms_matching(rows, "flash_"),
            **{name: _ms_matching([r for r in rows if out not in r[2]], inc)
               for name, (inc, out) in dict(parts).items()},
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
        "profiler_lost_lead_spins", "device_kernel_ms",
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


def _expected_launches(cfg, engine, paged, kinds=None):
    """Kernel launches the step trace implies (``kinds``: the kinds of
    the steps to count, default every step of the engine): per forward, one
    attention launch a layer (none on an int8 cache, which plain
    attention reads, as in the JAX model), 2 * n_layers + 1 norms, and 7
    projections a layer through the dequantize-matmul of ``cfg.quant``
    (the tied LM head is the bf16 embedding table); an SSM stack instead
    makes one recurrence launch a layer (a plain step's decode is its
    T = 1 launch) and no attention, and its norms are ``ln1`` and the
    gated norm of each layer and ``ln_f``."""
    kinds = engine.step_kinds if kinds is None else kinds
    n_plain = kinds.count("plain")
    n_mixed = kinds.count("mixed")
    forwards = n_plain + 2 * n_mixed       # a mixed step runs two forwards
    ssm = cfg.ssm is not None
    attn = 0 if (cfg.kv_quant or ssm) else cfg.n_layers * forwards
    proj = 7 * cfg.n_layers * forwards
    return {"decode_attention": 0 if paged else attn,
            "paged_decode_attention": attn if paged else 0,
            "quant_matmul_int8": proj if cfg.quant == "int8" else 0,
            "quant_matmul_int4": proj if cfg.quant == "int4" else 0,
            "rmsnorm": (2 * cfg.n_layers + 1) * forwards,
            "ssd": 0,
            "ssd_extend": cfg.n_layers * forwards if ssm else 0,
            "flash_attention": 0}


def serve(torch, model, params, *, paged=False, base=None, phase=None,
          bf16=None, graphs=None):
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
    phase checks; False: eager)."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.quant import quantized_stats
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request
    from repro_torch.serving.sampler import Sampler

    cfg = model.cfg
    kw = dict(paged=True, page_size=16, num_pages=288) if paged else {}
    engine = Engine(model, params, max_batch=8, cache_len=1024,
                    prefill_chunk=128, sampler=Sampler(), seed=SEED,
                    graphs=graphs, **kw)
    rng = np.random.default_rng(SEED)
    lens = rng.integers(64, 513, 16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for uid, L in enumerate(lens):
        engine.submit(Request(uid=uid, prompt=rng.integers(0, cfg.vocab, L),
                              max_new_tokens=32))
    responses = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
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
           "kv_bytes": _kv_bytes(engine),
           "state_bytes": _state_bytes(engine), "bad_requests": bad,
           "graphs": engine.graphs,
           "programs": engine.program_cache_sizes(),
           "program_builds_ms": [e["elapsed_ms"] for e in
                                 engine.metrics.get_series("compiles").values]}
    rec["ok"] = not bad and counts == want \
        and engine.graphs == (graphs is not False)
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
    """A lifecycle engine warmed until every slot admitted once (each
    slot's mixed program and the plain step captured: 8 one-chunk
    admissions, then plain steps), then marked steady."""
    import numpy as np

    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request
    from repro_torch.serving.sampler import Sampler

    engine = Engine(model, params, sampler=Sampler(), seed=SEED,
                    **LIFECYCLE_ENGINE, **extra)
    rng = np.random.default_rng(SEED + 4)
    for uid in range(8):
        engine.submit(Request(uid=1000 + uid,
                              prompt=rng.integers(0, model.cfg.vocab, 16),
                              max_new_tokens=16))
    engine.tick(16)              # every build falls in this first burst
    engine.run()
    progs = engine.program_cache_sizes()
    if progs != {"step": 1, "mixed": 8}:
        raise AssertionError(f"lifecycle warm-up built {progs}")
    engine.mark_steady()
    return engine


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
    want = _expected_launches(engine.model.cfg, engine, True,
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


def serve_eager(torch, model, params, graphs_turn, phase):
    """The serve phase's requests through the engine's eager steps
    (``graphs=False``) and its CUDA graphs, in turns: the serve phase's
    own run on graphs and its profiled second batch (``graphs_turn``:
    the serve record, its tokens and the profile record), then eager,
    eager, graphs, each a fresh engine that serves (its own serve line)
    and profiles a second batch (its own profile line, gated as every
    profile phase). This phase's line sets the four turns side by side
    (decode ms p50, ITL and TTFT p50, tok/s; the profiled batch's wall,
    device time and busy share; a graphs turn's serve wall includes its
    captures) and passes when every turn's greedy tokens equal the first
    graphs run's."""
    rec0, tokens0, prof0 = graphs_turn
    turns, same = [("graphs", rec0, prof0)], []
    for i, graphs in enumerate((False, False, None)):
        _, engine, rec, tokens = serve(torch, model, params, graphs=graphs,
                                       phase=f"{phase}_turn{i + 2}")
        prof = profile(torch, engine, f"{phase}_profile{i + 2}")
        del engine
        gc.collect()
        turns.append(("eager" if graphs is False else "graphs", rec, prof))
        same.append(tokens == tokens0)
    keys = ("decode_ms_p50", "itl_ms_p50", "ttft_ms_p50", "tok_per_s")
    pkeys = ("wall_ms_profiled", "device_kernel_ms", "device_busy_share")
    out = {"phase": phase, "arch": model.cfg.name,
           "turns": [dict({k: r[k] for k in keys + ("wall_s",)},
                          **{k: p[k] for k in pkeys}, mode=mode)
                     for mode, r, p in turns],
           "tokens_equal_first_graphs_run": same}
    for mode in ("graphs", "eager"):
        for k in keys + pkeys:
            vals = [{**r, **p}[k] for m, r, p in turns if m == mode]
            out[f"{mode}_{k}"] = statistics.median(vals)
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
    The ``rmsnorm`` counter, set to 0 just before, must read 2 n_layers
    + 1 launches a forward just after (97 on mamba2-780m, 33 on
    llama3.2-1b: the gated norm counts there too). The engine's steps
    run as CUDA graphs (or eagerly, in ``serve_eager``'s eager turns):
    the phase marks it steady first and fails on any capture in the
    window (``steady_compiles``), on a host stream sync
    other than the poll's two reads (``cudaStreamSynchronize`` = 2 x
    polls), and where a launch counter differs from the profiler's count
    of the kernel templates its wrapper launches once a call
    (``PROFILE_TEMPLATES``) by more than the records the profiler lost
    (the window's lead spins it lost; never above the counter); it
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
    norms = (2 * engine.model.cfg.n_layers + 1) * forwards
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
           "profiler_lost_lead_spins": lost,
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
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


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
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--norm-host-us"] and len(sys.argv) == 3:
        return norm_host_cost(torch, Path(sys.argv[2]).resolve())
    if sys.argv[1:2] == ["--ssd-compare"] and len(sys.argv) == 3:
        return ssd_compare(torch, Path(sys.argv[2]).resolve())
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.models.model import build
    from repro_torch.models.transformer import init_transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi})

    t0 = time.perf_counter()
    _build.build_all()
    t_nvcc = time.perf_counter() - t0
    ptxas = ptxas_table(_build.BUILD_LOG.values())
    gated = ("_mma_kernel", "ssd_extend", "rmsnorm_kernel",
             "ssd_chunk_states", "ssd_state_pass", "ssd_chunk_out")
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
                                if any(s in k for s in gated[3:])},
          "gated_spills": spills})
    if spills or not all(any(s in k for k in ptxas) for s in gated):
        raise AssertionError(f"tensor-core, ssd_extend, ssd mma or rmsnorm "
                             f"templates missing or spilling: {spills}")

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    attn, attn_err = decode_attention_cases(torch, flush)
    paged, paged_err = paged_decode_attention_cases(torch, flush)
    norm, norm_err = rmsnorm_cases(torch, flush)
    qmm, qmm_err = quant_matmul_cases(torch, flush)
    ext, ext_err = ssd_extend_cases(torch, flush)
    ssd, ssd_err = ssd_cases(torch, flush)
    flash, flash_err = flash_attention_cases(torch, flush)
    del flush
    card_tests()
    model_check(torch)
    model_check(torch, variant="edge", phase="model_quant")
    model_check(torch, quant="int8", phase="model_quant")
    model, params = served_model()
    counts, engine, rec, tokens = serve(torch, model, params)
    prof = profile(torch, engine)
    del engine
    serve_eager(torch, model, params, (rec, tokens, prof), "serve_eager")
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
    # the bf16 tree leaves the card, so the quantized phases' peak memory
    # counts only their own weights
    params = _tree_to(params, "cpu")
    gc.collect()
    int8_counts, edge_counts = serve_quantized(torch, model, params, tokens)
    del model, params
    gc.collect()
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
    prof = profile(torch, engine, "profile_ssm")
    del engine
    serve_eager(torch, ssm_model, ssm_params, (ssm_rec, ssm_tokens, prof),
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

    emit({"kernels": [
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
              flash, zoo_counts, extra=("bound_by", "plan"))]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
