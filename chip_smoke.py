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
by replay and drain; and serves the same 16 requests quantized: int8
weights on bf16 rings (``serve_int8``), the edge profile on int8 rings
(``serve_edge``) and on an int8 pool (``serve_edge_paged``, tokens equal
to ``serve_edge``'s), with a profiled second batch through the int8 and
the edge engines. Then the SSM family (mamba2-780m): both SSD kernels against
their plain versions in the ``kernels`` phase (the recurrence kernel
also bitwise compositional over a split, an identity step at dt = 0 and
``ssd_step``'s T = 1 launch); a 2-layer full-width fp32 mamba2 on the
card against the CPU through ``prefill`` (the chunked kernel) and
through an extend (``model_ssm``) and through ``Engine``
(``serve_ssm_check``, tokens identical); the full 48-layer bf16 model
served with the same schedule (``serve_ssm``, launch counts equal to the
trace) and a profiled second batch (``profile_ssm``). Then the Zoo
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
split, identical outputs, exactly 40 flash and 81 norm launches a
forward; ``model.lm`` on llama3.2-1b; a registry round trip on the
card). The decode-attention cases cover both tensor-core routes of its
plan (R <= 16 rows and above, S split over blocks, a fully masked row
at T 1 and T 16); every timed attention case records its plan and the
rates it reached, and the ``build`` line every template's ptxas
registers and spills (a spilling tensor-core template fails the run).
Every phase prints one JSON line; any failure raises and the
script exits non-zero without the final line. The second-to-last lines are the
kernel summary (JSON) and the card's name and power limit as
``nvidia-smi`` reports them; the last line is ``{"ok": true, "device":
{...}}``. Exits non-zero without a CUDA device, and when the port's
package is not beside it.
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
RMSNORM_SRC = "src/repro_torch/kernels/rmsnorm/kernel.py"
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
#: llama3.2-1b's projection shapes (K, N): wi/wg, wk/wv, wq/wo, mlp wo;
#: the first one's decode row heads the kernel summary
QMM_SHAPES = ((2048, 8192), (2048, 512), (2048, 2048), (8192, 2048))
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


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


def rmsnorm_cases(torch, flush):
    """The Triton norm against its plain version at the shapes its paths
    give it: llama3.2-1b's d 2048 at a decode batch (N 8), a chunk
    (N 128) and ``model.lm``'s forward (B 2 x L 1024 = N 2048), and
    pixtral-12b's d 5120 in the Zoo's classifier forward (N 2048; a
    non-power-of-two d, so a BLOCK 8192 launch with a masked tail); fp32
    and bf16, timed against its bound wherever it adds a residual."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm.kernel import fused_rmsnorm_triton
    from repro_torch.kernels.rmsnorm.ref import fused_rmsnorm_reference

    dev = torch.device("cuda")
    eps = 1e-5
    out, errs = [], []
    for N, d, with_res in ((8, 2048, True), (128, 2048, True),
                           (8, 2048, False), (2048, 2048, True),
                           (2048, 5120, True)):
        g = torch.Generator(device=dev).manual_seed(SEED)
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            x = torch.randn((N, d), generator=g, device=dev).to(dtype)
            r = torch.randn((N, d), generator=g, device=dev).to(dtype) \
                if with_res else None
            scale = (1 + 0.1 * torch.randn((d,), generator=g, device=dev)
                     ).to(dtype)
            y, t = fused_rmsnorm_triton(x, r, scale, eps)
            y0, t0 = fused_rmsnorm_reference(x, r, scale, eps)
            torch.cuda.synchronize()
            err = max((y.float() - y0.float()).abs().max().item(),
                      (t.float() - t0.float()).abs().max().item())
            ok = bool(torch.isfinite(y).all().item()) and err <= TOL[dname]
            rec = {"phase": "kernels", "kernel": "rmsnorm",
                   "case": f"N{N}_d{d}" + ("" if with_res
                                           else "_no_residual"),
                   "dtype": dname, "N": N, "d": d, "max_abs_err": err,
                   "tol": TOL[dname], "ok": ok}
            if with_res:
                elt = x.element_size()
                nbytes = elt * (4 * N * d + d)
                flops = 5 * N * d
                bms, by = bound_ms(nbytes, flops, "float32")
                rec.update(
                    kernel_ms=median_ms(torch, lambda: fused_rmsnorm_triton(
                        x, r, scale, eps), flush),
                    plain_ms=median_ms(torch, lambda: fused_rmsnorm_reference(
                        x, r, scale, eps), flush),
                    library_ms=median_ms(torch, lambda: F.rms_norm(
                        torch.add(x, r), (d,), scale, eps), flush),
                    bound_ms=bms, bound_us=bms * 1e3, bound_by=by,
                    bytes=nbytes, flops=flops)
            emit(rec)
            out.append(rec)
            errs.append(err)
            if not ok:
                raise AssertionError(f"rmsnorm {rec['case']} {dname}: "
                                     f"kernel disagrees with the plain "
                                     f"version: {rec}")
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
    checkpoint): max|kernel - plain| <= 1e-4 * max|plain| in f32. Exact
    gates: extending by T // 2 then the rest (37 + 91 at T 128) gives
    the bits of extending by T; a row with dt = 0 keeps its state bit for
    bit; ``ssd_step`` on CUDA equals the T = 1 launch; the checkpoint
    equals the incoming state."""
    from repro_torch.kernels.ssd_scan.kernel import ssd_extend_cuda
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
        t1 = 37 if T == 128 else T // 2
        split_equal = True
        if t1:
            ya, sa = ssd_extend_cuda(s0, x[:, :t1], dt[:, :t1], A,
                                     B[:, :t1], C[:, :t1], D)
            yb, sb = ssd_extend_cuda(sa, x[:, t1:], dt[:, t1:], A,
                                     B[:, t1:], C[:, t1:], D)
            split_equal = torch.equal(torch.cat([ya, yb], 1), y) \
                and torch.equal(sb, s)
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
               "g": groups, "n": n, "max_rel_err": rel,
               "max_abs_err": max((y - y0).abs().max().item(),
                                  (s - s1).abs().max().item()),
               "tol_rel": SSD_TOL_REL,
               "split_at": t1, "split_bitwise_equal": split_equal,
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
            # each input read once (state, x, dt, B, C, A, D), each output
            # written once (y, the new state, the checkpoint); per token
            # and head 5 p n operations (decay, update, readout) + 3 p
            nbytes = 4 * (3 * s0.numel() + x.numel() + dt.numel()
                          + B.numel() + C.numel() + 2 * h + y.numel())
            flops = b * T * h * (5 * p * n + 3 * p)
            bms, by = bound_ms(nbytes, flops, "float32")
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
    return out, max(errs)


def ssd_cases(torch, flush):
    """The chunked kernel against its plain version at mamba2's full dims
    (b 1, l 1024 and b 2, l 512 at chunk 256), and at the reduced dims
    with 2 groups at chunk 32 (from zero and from a given state), with
    f32 and bf16 x, B, C: max|kernel - plain| <= 1e-4 * max|plain| over
    y and the final state (both compute in f32 from the same inputs)."""
    from repro_torch.kernels.ssd_scan.kernel import ssd_cuda
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
            y, s = ssd_cuda(x, dt, A, B, C, D, chunk=chunk,
                            initial_state=s0)
            y0, s1 = ssd_reference(x, dt, A, B, C, D, chunk=chunk,
                                   initial_state=s0)
            torch.cuda.synchronize()
            rel = _rel_err([(y, y0), (s, s1)])
            rec = {"phase": "kernels", "kernel": "ssd", "case": name,
                   "dtype": dname, "b": b, "l": l, "h": h, "p": p,
                   "g": groups, "n": n, "chunk": chunk,
                   "initial_state": init, "max_rel_err": rel,
                   "max_abs_err": max((y - y0).abs().max().item(),
                                      (s - s1).abs().max().item()),
                   "tol_rel": SSD_TOL_REL}
            rec["ok"] = bool(torch.isfinite(y).all().item()) \
                and rel <= SSD_TOL_REL
            if b * l == 1024 and dtype == torch.bfloat16:
                # bytes: x, B, C in their dtype, dt, A, D, y and the final
                # state in f32; operations of the unmasked (i, j <= i)
                # pairs only: scores 2n, weight 3, product with x 2p; per
                # position the carried state's readout and update 4 p n
                # and D*x 2p (the masked half of each diagonal tile,
                # which the kernel computes and zeroes, is not counted)
                Q = chunk
                per_chunk = Q * (Q + 1) // 2 * (2 * n + 2 * p + 3) \
                    + Q * (4 * p * n + 2 * p)
                flops = b * h * (l // Q) * per_chunk
                nbytes = x.element_size() * (x.numel() + B.numel()
                                             + C.numel()) \
                    + 4 * (dt.numel() + 2 * h + y.numel() + b * h * p * n)
                bms, by = bound_ms(nbytes, flops, "float32")
                rec.update(
                    kernel_ms=median_ms(torch, lambda: ssd_cuda(
                        x, dt, A, B, C, D, chunk=chunk), flush),
                    plain_ms=median_ms(torch, lambda: ssd_reference(
                        x, dt, A, B, C, D, chunk=chunk), flush),
                    library_ms=None, bound_ms=bms, bound_us=bms * 1e3,
                    bound_by=by, bytes=nbytes, flops=flops)
            emit(rec)
            out.append(rec)
            errs.append(rec["max_abs_err"])
            if not rec["ok"]:
                raise AssertionError(f"ssd {name} {dname}: kernel "
                                     f"disagrees with the plain version: "
                                     f"{rec}")
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


def _profile_call(torch, fn):
    """One warm call of ``fn`` under the profiler: device kernel time by
    kernel and its share of the call's wall time, and the flash
    kernel's time and launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((getattr(e, "device_time_total",
                            getattr(e, "cuda_time_total", 0.0)) / 1e3,
                    e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(ms for ms, _, _ in rows)
    return {"wall_ms_profiled": wall_ms, "device_kernel_ms": busy,
            "device_busy_share": busy / wall_ms if busy else None,
            "kernel_launches": sum(c for _, c, _ in rows),
            "flash_attention": _ms_matching(rows, "flash_"),
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


def zoo(torch):
    """The paper's deployment example at full width: the pixtral-12b
    classifier (40 layers, bf16, weights made on the card from seed 0)
    ``>> label_decoder(1000)`` on frontend embeddings (B 2, 1024 tokens of
    1024 dims, bf16, seed 0), deployed all local, all remote and split
    after the classifier. Class ids and confidences must be identical
    across the three, and every forward must launch exactly 40 flash
    attentions and 81 norms and nothing else of ours. Then ``model.lm``
    on the full llama3.2-1b (B 2, L 1024: 16 flash launches a forward),
    and a registry round trip on the card: the reduced classifier (25 GB
    of npz is not a smoke step) published from the card, pulled back
    through a transport onto the card with its hash checked, composed
    with the decoder, giving equal outputs. Returns the launch counts of
    the phase."""
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
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    clf = zb.classifier_service("pixtral-12b", n_classes=1000, variant="")
    clf = clf.with_params(clf.metadata["init_params"](SEED, "cuda"))
    dec = zb.label_decoder(1000)
    svc = clf >> dec
    x = {"embeddings": torch.from_numpy(rng.normal(
        0, 1, (2, 1024, 1024)).astype(np.float32)).to("cuda",
                                                      torch.bfloat16)}
    clf.check_input(x)
    want = {"flash_attention": 40, "rmsnorm": 81}
    plans = {"local": DeploymentPlan.all_local(svc),
             "remote": DeploymentPlan.all_remote(svc, NetworkModel(seed=1)),
             "split": DeploymentPlan.split(svc, 1, NetworkModel(seed=2))}
    outs, recs, bad = {}, {}, []
    for name, plan in plans.items():
        dep = deploy(svc, plan, stages=[clf, dec])
        walls = []
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
        outs[name] = y
        recs[name] = {
            "wall_ms_median": statistics.median(walls[1:]),
            "wall_ms_first": walls[0],
            "stages": [{"stage": s.stage, "endpoint": s.endpoint,
                        "compute_ms": s.compute_s * 1e3,
                        "modelled_network_ms": s.transfer_s * 1e3}
                       for s in tel.stages]}
    prof = profile_stages([clf, dec], x, iters=3)
    device_profile = _profile_call(torch, lambda: svc(x))
    ref = outs["local"]
    same = {name: torch.equal(o["class_id"], ref["class_id"])
            and torch.equal(o["confidence"], ref["confidence"])
            for name, o in outs.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = clf.n_params
    del clf, svc, dec
    gc.collect()
    torch.cuda.empty_cache()

    lcfg = get_arch("llama3.2-1b")
    lm = zb.lm_service("llama3.2-1b")
    lp = init_transformer(lcfg, SEED, "cuda")
    toks = torch.from_numpy(rng.integers(0, lcfg.vocab, (2, 1024)).astype(
        np.int32)).cuda()
    lm_walls, lm_bad = [], []
    for i in range(3):
        before = kernels.launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits = lm.fn(lp, {"tokens": toks})
        torch.cuda.synchronize()
        lm_walls.append((time.perf_counter() - t1) * 1e3)
        delta = _launch_delta(before, kernels.launch_counts())
        if delta != {"flash_attention": 16, "rmsnorm": 33}:
            lm_bad.append((i, delta))
    lm_ok = tuple(logits.shape) == (2, 1024, lcfg.vocab) \
        and bool(torch.isfinite(logits).all().item())
    del lp, logits
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
           "device_profile": device_profile,
           "launches_per_forward_expected": want,
           "bad_launch_counts": bad, "peak_mem_gib": peak,
           "lm_arch": lcfg.name, "lm_batch": 2, "lm_seq": 1024,
           "lm_wall_ms_median": statistics.median(lm_walls[1:]),
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
    return counts


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


def _expected_launches(cfg, engine, paged):
    """Kernel launches the step trace implies: per forward, one
    attention launch a layer (none on an int8 cache, which plain
    attention reads, as in the JAX model), 2 * n_layers + 1 norms, and 7
    projections a layer through the dequantize-matmul of ``cfg.quant``
    (the tied LM head is the bf16 embedding table); an SSM stack instead
    makes one recurrence launch a layer (a plain step's decode is its
    T = 1 launch) and no attention, and its norms are ``ln1`` and the
    gated norm of each layer and ``ln_f``."""
    n_plain = engine.step_kinds.count("plain")
    n_mixed = engine.step_kinds.count("mixed")
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
          bf16=None):
    """16 requests (prompts of 64-512 tokens from the seed in the model's
    vocab, 32 new each) through the engine; every kernel count set to 0
    just before and read just after, and equal to what the step trace
    implies. Paged (``base``: the contiguous phase's record and
    tokens): the same requests on a pool of 288 pages of 16, which
    holds all 8 streams at once, so the schedule and the greedy tokens
    are the contiguous run's; the pool drains. ``bf16``: the bf16 serve
    phase's tokens, whose share a quantized run reproduces is printed
    (information, not a gate: quantization changes tokens)."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.quant import quantized_stats
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request
    from repro_torch.serving.sampler import Sampler

    cfg = model.cfg
    kw = dict(paged=True, page_size=16, num_pages=288) if paged else {}
    engine = Engine(model, params, max_batch=8, cache_len=1024,
                    prefill_chunk=128, sampler=Sampler(), seed=SEED, **kw)
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
           "state_bytes": _state_bytes(engine), "bad_requests": bad}
    rec["ok"] = not bad and counts == want
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
    the phase adds to a run, the profiler's own bookkeeping included."""
    t_phase = time.perf_counter()
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from repro_torch.serving.request import Request

    vocab = engine.model.cfg.vocab
    rng = np.random.default_rng(SEED + 1)
    for uid in range(100, 108):
        engine.submit(Request(uid=uid, prompt=rng.integers(0, vocab, 256),
                              max_new_tokens=16))
    n0 = len(engine.step_kinds)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            ms = getattr(evt, "device_time_total",
                         getattr(evt, "cuda_time_total", 0.0)) / 1e3
            rows.append((ms, evt.count, evt.key))
    rows.sort(reverse=True)
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
    kinds = engine.step_kinds[n0:]
    launches = sum(c for _, c, _ in rows)
    forwards = kinds.count("plain") + 2 * kinds.count("mixed")
    emit({"phase": phase, "requests": 8, "prompt_len": 256,
          "max_new_tokens": 16, "steps": len(kinds),
          "plain_steps": kinds.count("plain"),
          "mixed_steps": kinds.count("mixed"),
          "launches_per_forward": launches / forwards if forwards else None,
          "wall_ms_profiled": wall_ms, "device_kernel_ms": busy,
          "device_busy_share": busy / wall_ms if busy else None,
          "kernel_launches": launches,
          "decode_attention": _ms_matching(rows, "decode_"),
          "quant_matmul": _ms_matching(rows, "qmm_"),
          "top": [{"kernel": k[:90], "ms": ms, "calls": c}
                  for ms, c, k in rows[:12]],
          "host_top": [{"op": k[:60], "self_ms": ms, "calls": c}
                       for ms, c, k in host[:15]],
          "host_blocking_calls": blocking,
          "seconds": time.perf_counter() - t_phase})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.kernels.rmsnorm.kernel import fused_rmsnorm_triton
    from repro_torch.models.model import build

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
    x = torch.ones((1, 2048), device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        for r in (x.to(dtype), None):
            fused_rmsnorm_triton(x.to(dtype), r, x[0].to(dtype))
    torch.cuda.synchronize()
    ptxas = ptxas_table(_build.BUILD_LOG.values())
    spills = {k: v for k, v in ptxas.items() if "_mma_kernel" in k
              and (v.get("spill_stores") or v.get("spill_loads"))}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_s": t_nvcc, "ptxas": ptxas,
          "tensor_core_templates": sum("_mma_kernel" in k for k in ptxas),
          "tensor_core_spills": spills})
    if spills or not any("_mma_kernel" in k for k in ptxas):
        raise AssertionError(f"tensor-core templates missing or spilling: "
                             f"{spills}")

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
    profile(torch, engine)
    del engine
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
    ext_counts, engine, _, _ = serve(torch, ssm_model,
                                     ssm_model.init(SEED), phase="serve_ssm")
    profile(torch, engine, "profile_ssm")
    del engine, ssm_model
    gc.collect()
    # the Zoo: model services card against CPU, then the paper's
    # deployment example at full width
    model_vlm(torch)
    zoo_counts = zoo(torch)

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
        entry("rmsnorm", "triton", RMSNORM_SRC, RMSNORM_TPU, norm_err,
              timed(norm), counts, extra=("dtype",)),
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
        entry("ssd_extend", "cuda", SSD_SRC, SSD_EXT_TPU, ext_err,
              timed(ext), ext_counts, extra=("bound_by",)),
        entry("ssd", "cuda", SSD_SRC, SSD_TPU, ssd_err, timed(ssd),
              ssd_counts, extra=("bound_by",)),
        entry("flash_attention", "cuda", FLASH_SRC, FLASH_TPU, flash_err,
              flash, zoo_counts, extra=("bound_by", "plan"))]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
