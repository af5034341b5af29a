"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's kernels from this checkout, holds each against its
plain PyTorch version on the card, checks a 2-layer full-width
llama3.2-1b on the card against the same model on the CPU, and serves
the full 16-layer bf16 llama3.2-1b (weights from a seed) through
``repro_torch.serving.engine.Engine``, checking that both kernels ran on
that path as often as its step trace implies, then profiles a second
batch through the same engine (device busy share, kernel time by
kernel). Every phase prints one
JSON line; any failure raises and the script exits non-zero without the
final line. The second-to-last lines are the kernel summary (JSON) and
the card's name and power limit as ``nvidia-smi`` reports them; the last
line is ``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA
device, and when the port's package is not beside it.
"""
from __future__ import annotations

import json
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
RMSNORM_SRC = "src/repro_torch/kernels/rmsnorm/kernel.py"
RMSNORM_TPU = "src/repro/kernels/rmsnorm/kernel.py:30"
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


# --------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------- #
def decode_attention_cases(torch, flush):
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_reference

    dev = torch.device("cuda")
    Hq, Hkv, hd = 32, 8, 64
    # (name, B, T, S, window, special rows)
    cases = [
        ("decode", 8, 1, 1024, 0, None),
        ("chunk", 1, 128, 1024, 0, None),
        ("decode_window256", 8, 1, 1024, 256, None),
        ("decode_ragged_S1000", 8, 1, 1000, 0, None),
        ("chunk_all_masked_row", 2, 16, 1024, 0, "masked"),
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
            rec = {"phase": "kernels", "kernel": "decode_attention",
                   "case": name, "dtype": dname, "B": B, "T": T, "S": S,
                   "Hq": Hq, "Hkv": Hkv, "hd": hd, "window": window,
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
            emit(rec)
            out.append(rec)
            errs.append(err)
            if not ok:
                raise AssertionError(f"decode_attention {name} {dname}: "
                                     f"kernel disagrees with the plain "
                                     f"version: {rec}")
    return out, max(errs)


def rmsnorm_cases(torch, flush):
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm.kernel import fused_rmsnorm_triton
    from repro_torch.kernels.rmsnorm.ref import fused_rmsnorm_reference

    dev = torch.device("cuda")
    d, eps = 2048, 1e-5
    out, errs = [], []
    for N, with_res in ((8, True), (128, True), (8, False)):
        g = torch.Generator(device=dev).manual_seed(SEED)
        for dtype in (torch.float32, torch.bfloat16):
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
                   "case": f"N{N}" + ("" if with_res else "_no_residual"),
                   "dtype": dname, "N": N, "d": d, "max_abs_err": err,
                   "tol": TOL[dname], "ok": ok}
            if with_res and dtype == torch.bfloat16:
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


# --------------------------------------------------------------------- #
# phase 4: 2-layer full-width model, card against CPU
# --------------------------------------------------------------------- #
def model_check(torch):
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models.model import build

    cfg = get_arch("llama3.2-1b").replace(n_layers=2, dtype="float32",
                                          param_dtype="float32")
    t0 = time.perf_counter()
    cpu = build(cfg, "cpu")
    gpu = build(cfg, "cuda")
    p_cpu = cpu.init(SEED)
    p_gpu = _tree_to(p_cpu, gpu.device)
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
    rec = {"phase": "model", "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype, "extend_T": 128,
           "decode_steps": 8, "logits_max_abs_err": err, "tol": tol,
           "tokens_gpu": runs["gpu"][0], "tokens_cpu": runs["cpu"][0],
           "seconds": time.perf_counter() - t0}
    rec["ok"] = err <= tol and runs["gpu"][0] == runs["cpu"][0]
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"card and CPU disagree: {rec}")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


# --------------------------------------------------------------------- #
# phase 5: serve the full model through the engine
# --------------------------------------------------------------------- #
def serve(torch):
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request
    from repro_torch.serving.sampler import Sampler

    cfg = get_arch("llama3.2-1b")
    model = build(cfg)
    params = model.init(SEED)
    engine = Engine(model, params, max_batch=8, cache_len=1024,
                    prefill_chunk=128, sampler=Sampler(), seed=SEED)
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
    n_plain = engine.step_kinds.count("plain")
    n_mixed = engine.step_kinds.count("mixed")
    forwards = n_plain + 2 * n_mixed       # a mixed step runs two forwards
    want = {"decode_attention": cfg.n_layers * forwards,
            "rmsnorm": (2 * cfg.n_layers + 1) * forwards}
    toks = sum(len(r.tokens) for r in responses.values())
    bad = [uid for uid, r in responses.items()
           if r.finish_reason != "length" or len(r.tokens) != 32
           or not all(0 <= t < cfg.vocab for t in r.tokens)]
    rec = {"phase": "serve", "arch": cfg.name, "n_layers": cfg.n_layers,
           "dtype": cfg.dtype, "requests": len(responses),
           "prompt_lens": [int(x) for x in lens], "max_new_tokens": 32,
           "max_batch": 8, "cache_len": 1024, "prefill_chunk": 128,
           "plain_steps": n_plain, "mixed_steps": n_mixed,
           "launches": counts, "launches_expected": want,
           "tokens": toks, "wall_s": wall, "tok_per_s": toks / wall,
           "ttft_ms_p50": stats.get("ttft_ms_p50"),
           "ttft_ms_p99": stats.get("ttft_ms_p99"),
           "itl_ms_p50": stats.get("itl_ms_p50"),
           "itl_ms_p99": stats.get("itl_ms_p99"),
           "decode_ms_p50": stats.get("decode_ms_p50"),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "bad_requests": bad}
    rec["ok"] = not bad and counts == want
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"serve phase failed: {rec}")
    return counts, engine


# --------------------------------------------------------------------- #
# phase 6: where the device time goes (torch.profiler)
# --------------------------------------------------------------------- #
def profile(torch, engine):
    """A second batch through the warm engine under the profiler: device
    kernel time by kernel, and its share of the wall time (the rest is
    the device idling while the host launches work)."""
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
    busy = sum(ms for ms, _, _ in rows)
    emit({"phase": "profile", "requests": 8, "prompt_len": 256,
          "max_new_tokens": 16, "steps": len(engine.step_kinds) - n0,
          "wall_ms_profiled": wall_ms, "device_kernel_ms": busy,
          "device_busy_share": busy / wall_ms if busy else None,
          "kernel_launches": sum(c for _, c, _ in rows),
          "top": [{"kernel": k[:90], "ms": ms, "calls": c}
                  for ms, c, k in rows[:12]]})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.rmsnorm.kernel import fused_rmsnorm_triton

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
    ptxas = [ln.strip() for log in _build.BUILD_LOG.values()
             for ln in log.splitlines() if "registers" in ln
             or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_s": t_nvcc, "ptxas": ptxas})

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    attn, attn_err = decode_attention_cases(torch, flush)
    norm, norm_err = rmsnorm_cases(torch, flush)
    model_check(torch)
    counts, engine = serve(torch)
    profile(torch, engine)

    def entry(name, route, src, tpu, err, rows):
        head = rows[0]
        return {"name": name, "route": route, "source": src,
                "replaces": tpu, "launches": counts[name],
                "max_abs_err": err, "ms": head["kernel_ms"],
                "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"],
                "library_ms": head["library_ms"],
                "cases": [{k: r[k] for k in ("case", "kernel_ms", "plain_ms",
                                             "library_ms", "bound_ms")}
                          for r in rows]}

    timed_attn = [r for r in attn if "kernel_ms" in r]
    timed_norm = [r for r in norm if "kernel_ms" in r]
    emit({"kernels": [
        entry("decode_attention", "cuda", DECODE_ATTN_SRC, DECODE_ATTN_TPU,
              attn_err, timed_attn),
        entry("rmsnorm", "triton", RMSNORM_SRC, RMSNORM_TPU, norm_err,
              timed_norm)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
