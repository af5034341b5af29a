"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

This module imports ``torch``, ``numpy``, ``pytest`` and the port only:
the card's machine has no JAX, and ``tests/conftest.py`` imports it, so
on the card the module runs without that conftest (the command the
README names, which ``chip_smoke.py``'s ``card_tests`` phase runs):

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_card.py

Every test carries the ``cuda`` marker and skips without a CUDA device.
Tolerances: fp32 1e-4 (f32 arithmetic, sums in another order), bf16
2e-2 (bf16 inputs and outputs, p rounded to bf16 on the tensor-core
routes); the dequantize-matmuls and the SSD kernels relative to
max|plain|. The paged decode kernel must equal the contiguous one
exactly on the same logical data, on every route. Every kernel op
for inference only (decode attention, the quantized matmuls, the SSD
recurrence) refuses a backward pass: an
input that requires grad gives outputs whose backward raises, and none
gives the same outputs with no autograd node. The backward kernels
(flash attention: three launches; RMSNorm add / norm and gated: rows,
then the dscale reduction; the SSD dual form: seven launches) match
their plain versions and autograd of the plain forwards, bitwise
repeatable; reduced llama3.2-1b, mamba2-780m and jamba train on the
card (loss falling, the first five losses equal to the CPU's) and
``cfg.remat`` on equals off bit for bit in bf16 (llama, mamba2). The
train step captured as one CUDA graph (reduced llama, mamba2 and
qwen2-moe, bf16, remat on) equals the eager functional step bit for
bit over 3 steps with its launch counters, captures once, syncs the
host in neither an eager step nor a replay, and a capture that reads
the host raises on every later call.
The encoder-decoder's attention routes: the flash kernel non-causal at
Lq != Lk (``layers.full_attention``) and the decode-attention kernel
over a frozen memory's all-valid position row
(``layers.memory_attention``), each against plain
``gqa_attention(causal=False)``.
The serving engine's step programs run as CUDA graphs: greedy tokens,
temperature samples and launch counters equal the eager engine's at
reduced sizes (rings, bf16, paged, int8 KV, int8 weights, the edge
profile paged, mamba2, the MoE and hybrid stacks, pixtral's embedding
prefix and seamless's encoded memory), nothing is captured after
warm-up, and a capture that fails raises; on graphs a poisoned row is contained to that row and
a cancel frees its slot, neither building a program; speculative
engines (an int8 self-draft and the n-gram drafter, on rings, a bf16
pool and mamba2) give the eager engine's tokens and launch counters on
graphs, greedy and with a temperature, and capture nothing after
warm-up; prefix-cache hits
(copied in place on the rings, aliased on the pool) stream as the eager
and the cold engines, and a forced copy-on-write split syncs nothing. The Zoo's service programs (``Service.jitted()``,
the deployed call) replay the eager call bitwise (the reduced
classifier in fp32 and bf16, mamba2's ``model.lm`` on the SSD ``mma``
route), a route runs as segments, another params tree is another
capture, grad mode raises, and replays count their capture's launches.
The serving fleet on graphs: a replica crash fails over by replay with
every stream equal to one engine's and no capture on the warmed
survivor, and a drain / rejoin cycle frees the replaced engine's device
memory.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import kernel as dec_kernel
from repro_torch.kernels.decode_attention import ref as dec_ref
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.quant_matmul import kernel as qmm_kernel
from repro_torch.kernels.quant_matmul import ref as qmm_ref
from repro_torch.kernels.rmsnorm import kernel as norm_kernel
from repro_torch.kernels.rmsnorm import ref as norm_ref

S = 48
HKV = 2
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = (torch.float32, torch.bfloat16)


def _card():
    """The CUDA device, or a skip: the kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


def _decode_inputs(B, T, G, *, seed, masked_row=False, hd=64, s=S,
                   hkv=HKV):
    """q (B, T, Hq, hd), cache-layout k/v (B, s, hkv, hd), pos (B, s)
    and q_pos (B, T) as int32, float32 numpy: row b sits at a random
    depth, holds positions 0..depth+T-1 in their slots and -1 past
    them; with ``masked_row`` row 0 has every slot empty."""
    rng = np.random.default_rng(seed)
    Hq = G * hkv
    q = rng.normal(size=(B, T, Hq, hd)).astype(np.float32)
    k = rng.normal(size=(B, s, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, s, hkv, hd)).astype(np.float32)
    depth = rng.integers(0, s - T + 1, B)
    slots = np.arange(s)[None]
    pos = np.where(slots < (depth + T)[:, None], slots, -1).astype(np.int32)
    if masked_row:
        pos[0] = -1
    q_pos = (depth[:, None] + np.arange(T)[None]).astype(np.int32)
    return q, k, v, pos, q_pos


def _paged_from_contiguous(k, v, ps, *, seed):
    """Scatter cache-layout k/v (B, S, Hkv, hd) into page pools (P + 1,
    ps, Hkv, hd) through a seeded permutation of the pages: returns the
    pools and the (B, S // ps) int32 block table whose gathered view is
    k/v again. The spare pages and the trash page (the last) hold junk."""
    B, S_ = k.shape[:2]
    nb = S_ // ps
    P = B * nb + 2
    g = torch.Generator().manual_seed(seed)
    bt = torch.randperm(P, generator=g)[:B * nb].reshape(B, nb)
    kp = torch.randn((P + 1, ps) + tuple(k.shape[2:]), generator=g).to(
        device=k.device, dtype=k.dtype)
    vp = torch.randn_like(kp)
    kp[bt.to(k.device)] = k.reshape(B, nb, ps, *k.shape[2:])
    vp[bt.to(k.device)] = v.reshape(B, nb, ps, *v.shape[2:])
    return kp, vp, bt.to(device=k.device, dtype=torch.int32)


def _err(got, want):
    return (got.float() - want.float()).abs().max().item()


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    dev = _card()
    for T, G, window, masked in ((1, 4, 0, False), (8, 4, 16, True),
                                 (4, 1, 0, False)):
        for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            q, k, v, pos, q_pos = (torch.from_numpy(a).to(dev) for a in
                                   _decode_inputs(3, T, G, seed=T,
                                                  masked_row=masked, hd=64))
            q, k, v = q.to(dt), k.to(dt), v.to(dt)
            got = dec_kernel.decode_attention_cuda(q, k, v, pos, q_pos,
                                                   window=window)
            want = dec_ref.decode_attention_reference(q, k, v, pos, q_pos,
                                                      window=window)
            assert (got.float() - want.float()).abs().max().item() <= tol
            # the paged kernel on the same logical data, pages permuted:
            # within tol of its plain version, equal to the contiguous one
            for ps in (8, 16):
                kp, vp, bt = _paged_from_contiguous(k, v, ps, seed=ps)
                pgot = dec_kernel.paged_decode_attention_cuda(
                    q, kp, vp, bt, pos, q_pos, window=window)
                pwant = dec_ref.paged_decode_attention_reference(
                    q, kp, vp, bt, pos, q_pos, window=window)
                assert (pgot.float() - pwant.float()).abs().max().item() \
                    <= tol
                assert torch.equal(pgot, got)
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        x = torch.randn(16, 2048, device=dev).to(dt)
        r = torch.randn(16, 2048, device=dev).to(dt)
        s = torch.rand(2048, device=dev).to(dt)
        for res in (r, None):
            y, t = norm_kernel.fused_rmsnorm_cuda(x, res, s)
            y0, t0 = norm_ref.fused_rmsnorm_reference(x, res, s)
            assert (y.float() - y0.float()).abs().max().item() <= tol
            assert (t.float() - t0.float()).abs().max().item() <= tol
    # the dequantize-matmuls: ragged M and N, K split or not, K 34 (an odd
    # int4 group of 17; for int8 no multiple of 8); max|kernel - plain| <=
    # tol * max|plain|
    from repro_torch.quant import quantize_tensor
    g = torch.Generator(device=dev).manual_seed(0)
    for M, K, N, gs in ((1, 2048, 512, 32), (37, 256, 200, 32),
                        (8, 34, 48, 32), (128, 512, 384, 64)):
        w = 0.05 * torch.randn((K, N), generator=g, device=dev)
        for bits in (8, 4):
            qt = quantize_tensor(w, bits=bits, group_size=gs)
            for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
                x = torch.randn((M, K), generator=g, device=dev).to(dt)
                # bf16 on the tensor cores, but K 34 (int4: group 17;
                # int8: no multiple of 8); fp32 on the CUDA cores
                group = K // qt["scale"].shape[0] if bits == 4 else 0
                route = qmm_kernel.mma_plan(bits, M, N, K, group, dt).route
                assert route == ("mma" if dt == torch.bfloat16
                                 and K != 34 else "simt")
                if bits == 8:
                    got = qmm_kernel.quant_matmul_int8_cuda(x, qt["q"],
                                                            qt["scale"])
                    want = qmm_ref.quant_matmul_int8_reference(
                        x, qt["q"], qt["scale"])
                else:
                    got = qmm_kernel.quant_matmul_int4_cuda(x, qt["q4"],
                                                            qt["scale"])
                    want = qmm_ref.quant_matmul_int4_reference(
                        x, qt["q4"], qt["scale"])
                err = (got.float() - want.float()).abs().max().item()
                assert got.dtype == dt and got.shape == (M, N)
                assert err <= tol * want.float().abs().max().item()
    # the chunked SSD kernel: max|kernel - plain| <= 1e-4 * max|plain|
    # (f32 arithmetic, sums in another order); the recurrence kernel has
    # its own cases (test_ssd_extend_routes_match_plain_on_card)
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ref as ssd_ref

    def ssd_inputs(b, l, h, p, g, n, dtype=torch.float32):
        return (torch.randn((b, l, h, p), generator=g_, device=dev).to(dtype),
                0.001 + 0.1 * torch.rand((b, l, h), generator=g_, device=dev),
                -0.5 - 1.5 * torch.rand((h,), generator=g_, device=dev),
                torch.randn((b, l, g, n), generator=g_, device=dev).to(dtype),
                torch.randn((b, l, g, n), generator=g_, device=dev).to(dtype),
                torch.randn((h,), generator=g_, device=dev))

    def rel(got, want):
        return (got - want).abs().max().item() / want.abs().max().item()

    g_ = torch.Generator(device=dev).manual_seed(1)
    for b, l, h, p, g, n, chunk in ((1, 512, 48, 64, 1, 128, 256),
                                    (2, 64, 16, 32, 2, 32, 32),
                                    (1, 48, 6, 32, 3, 64, 16)):
        for dtype in (torch.float32, torch.bfloat16):
            x, dt_, A, Bm, Cm, D = ssd_inputs(b, l, h, p, g, n, dtype)
            s0 = torch.randn((b, h, p, n), generator=g_, device=dev)
            for init in (None, s0):
                y, s = ssd_kernel.ssd_cuda(x, dt_, A, Bm, Cm, D, chunk=chunk,
                                           initial_state=init)
                y0, s1 = ssd_ref.ssd_reference(x, dt_, A, Bm, Cm, D,
                                               chunk=chunk,
                                               initial_state=init)
                assert rel(y, y0) <= 1e-4 and rel(s, s1) <= 1e-4


@pytest.mark.cuda
def test_flash_kernel_matches_plain_on_card():
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    # (B, L, Hq, Hkv, hd, causal, window): G 4 at hd 160, G 1, a window,
    # non-causal, a ragged length
    for B, L, Hq, Hkv, hd, causal, window in [
            (2, 192, 8, 2, 160, True, 0), (1, 128, 4, 4, 64, True, 0),
            (2, 200, 8, 2, 64, True, 48), (1, 100, 4, 1, 128, False, 0)]:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            q = torch.randn((B, L, Hq, hd), generator=g, device=dev).to(dtype)
            k = torch.randn((B, L, Hkv, hd), generator=g, device=dev
                            ).to(dtype)
            v = torch.randn_like(k)
            got = flash_kernel.flash_attention_cuda(q, k, v, causal=causal,
                                                    window=window)
            rep = Hq // Hkv
            want = flash_ref.attention_reference(
                q.transpose(1, 2),
                k.transpose(1, 2).repeat_interleave(rep, dim=1),
                v.transpose(1, 2).repeat_interleave(rep, dim=1),
                causal=causal, window=window).transpose(1, 2)
            torch.cuda.synchronize()
            assert (got.float() - want.float()).abs().max().item() <= tol


# (B, T, G, Hkv, S, hd, window, masked row 0): R = T * G on both sides
# of the 16-row route threshold (mma_keys up to 16, mma_rows above), S
# split and not a multiple of the split (1000: 16 splits of 64 slots,
# the last one of 40), a fully masked row at T 1 (all of its splits
# masked: the combine's NEG_INF case) and at T 16, windows, hd 32 and
# 128, G 1, and the chunk shape of the main path (B 1, T 128, G 4)
DECODE_CASES = [
    (3, 1, 4, 2, 1000, 64, 0, True),
    (3, 3, 4, 2, 1000, 64, 0, False),
    (3, 4, 4, 2, 512, 64, 16, False),
    (3, 5, 4, 2, 512, 64, 0, False),
    (2, 16, 4, 2, 1024, 64, 0, True),
    (2, 16, 4, 2, 320, 64, 100, False),
    (1, 128, 4, 8, 1024, 64, 0, False),
    (3, 4, 1, 2, 100, 64, 0, False),
    (2, 1, 4, 2, 304, 128, 0, False),
    (2, 16, 2, 2, 304, 32, 64, True),
    # head_dim 256 (gemma2-class: G 2, a 4096-token window cut to 100
    # here), decode and a chunk, a masked row; G 3 / 5 / 6 / 12 at hd 128
    # (granite, qwen2.5, internlm2, starcoder2)
    (3, 1, 2, 2, 1000, 256, 0, True),
    (1, 128, 2, 2, 512, 256, 100, False),
    (2, 16, 2, 1, 320, 256, 0, True),
    (2, 1, 3, 2, 512, 128, 0, False),
    (1, 37, 5, 2, 512, 128, 0, False),
    (2, 2, 6, 2, 320, 128, 0, False),
    (2, 3, 12, 1, 320, 128, 0, False),
    # head_dim 160 (pixtral-12b: G 4): decode (mma_keys, 2 head-dim
    # slices of 2 warps), chunks (mma_rows, 32-row blocks), a masked row
    # and a window
    (3, 1, 4, 2, 1000, 160, 0, True),
    (1, 128, 4, 2, 512, 160, 0, False),
    (2, 16, 4, 2, 320, 160, 64, True),
    (1, 37, 4, 1, 304, 160, 0, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=lambda c: "B{}_T{}_G{}_Hkv{}_S{}_hd{}_w{}_{}"
                         .format(*c[:7], "masked" if c[7] else "live"))
def test_decode_routes_match_plain_on_card(case):
    """Every route and split of ``plan`` against the plain version; a
    fully masked row is the mean of V over all S slots; the paged kernel
    on permuted pages (page sizes 8 and 16 where they divide S) equals
    the contiguous kernel exactly."""
    dev = _card()
    B, T, G, hkv, s, hd, window, masked = case
    for dt in DTYPES:
        q, k, v, pos, q_pos = (torch.from_numpy(a).to(dev) for a in
                               _decode_inputs(B, T, G, seed=s + T + hd,
                                              masked_row=masked, hd=hd, s=s,
                                              hkv=hkv))
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
        pl = dec_kernel.plan(B, T, G * hkv, hkv, s, hd, dt)
        got = dec_kernel.decode_attention_cuda(q, k, v, pos, q_pos,
                                               window=window)
        want = dec_ref.decode_attention_reference(q, k, v, pos, q_pos,
                                                  window=window)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert _err(got, want) <= TOL[dt], (pl, _err(got, want))
        if masked:
            mean_v = v[0].float().mean(0).repeat_interleave(G, dim=0)
            assert _err(got[0], mean_v[None].expand_as(got[0])) <= TOL[dt]
        for ps in (8, 16):
            if s % ps:
                continue
            kp, vp, bt = _paged_from_contiguous(k, v, ps, seed=ps)
            pgot = dec_kernel.paged_decode_attention_cuda(
                q, kp, vp, bt, pos, q_pos, window=window)
            assert torch.equal(pgot, got), (pl, ps)


# (B, L, Hq, Hkv, hd, causal, window): hd 40 (zero-padded k-steps on
# the 64 tile), 64 and 160; G 1, 4 and 8; ragged L; a window whose first
# live tile is wholly masked for some rows; non-causal; hd 256 (Q
# fragments re-read from shared memory, 32-key tiles)
FLASH_CASES = [
    (2, 200, 8, 2, 40, True, 0),
    (1, 257, 8, 1, 64, True, 0),
    (2, 130, 4, 4, 64, True, 48),
    (1, 300, 16, 2, 160, True, 0),
    (2, 100, 8, 2, 160, False, 0),
    (1, 96, 8, 8, 40, False, 24),
    (1, 150, 4, 1, 256, True, 0),
    # the new families' groups: G 3 (granite), 5 (qwen2.5), 6
    # (internlm2), 12 (starcoder2) at hd 128, bq 21, 12, 10 and 5 query
    # positions a block; gemma2-class's hd 256 at G 2 under a window
    (1, 130, 6, 2, 128, True, 0),
    (2, 77, 10, 2, 128, True, 0),
    (1, 100, 12, 2, 128, True, 24),
    (1, 61, 12, 1, 128, True, 0),
    (1, 300, 4, 2, 256, True, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "B{}_L{}_Hq{}_Hkv{}_hd{}_causal{}_w{}"
                         .format(*c))
def test_flash_routes_match_plain_on_card(case):
    dev = _card()
    B, L, Hq, Hkv, hd, causal, window = case
    g = torch.Generator(device=dev).manual_seed(L + hd)
    for dt in DTYPES:
        q = torch.randn((B, L, Hq, hd), generator=g, device=dev).to(dt)
        k = torch.randn((B, L, Hkv, hd), generator=g, device=dev).to(dt)
        v = torch.randn((B, L, Hkv, hd), generator=g, device=dev).to(dt)
        got = flash_kernel.flash_attention_cuda(q, k, v, causal=causal,
                                                window=window)
        rep = Hq // Hkv
        want = flash_ref.attention_reference(
            q.transpose(1, 2),
            k.transpose(1, 2).repeat_interleave(rep, dim=1),
            v.transpose(1, 2).repeat_interleave(rep, dim=1),
            causal=causal, window=window).transpose(1, 2)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert _err(got, want) <= TOL[dt], (
            flash_kernel.plan(B, L, Hq, Hkv, hd, dt), _err(got, want))
        # a pure function of the inputs: a second launch is bitwise equal
        again = flash_kernel.flash_attention_cuda(q, k, v, causal=causal,
                                                  window=window)
        assert torch.equal(again, got)


# (B, Lq, Lk, H, hd): the encoder-decoder's non-causal shapes, Lq != Lk
# (the cache-free cross-attention: text rows against the frames) and
# Lq = Lk (the encoder's self-attention), G 1 as in seamless-m4t-medium
FLASH_CROSS_CASES = [
    (1, 37, 300, 4, 64),
    (2, 5, 128, 4, 64),
    (1, 256, 256, 4, 64),
    (2, 100, 64, 2, 160),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CROSS_CASES,
                         ids=lambda c: "B{}_Lq{}_Lk{}_H{}_hd{}".format(*c))
def test_flash_non_causal_cross_shapes_match_plain_on_card(case):
    """``layers.full_attention`` on the card is the flash kernel
    non-causal at Lq != Lk, against plain ``gqa_attention(causal=False)``
    (what it runs on the CPU)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import layers as L

    dev = _card()
    B, Lq, Lk, H, hd = case
    g = torch.Generator(device=dev).manual_seed(Lq + Lk)
    for dt in DTYPES:
        q = torch.randn((B, Lq, H, hd), generator=g, device=dev).to(dt)
        k = torch.randn((B, Lk, H, hd), generator=g, device=dev).to(dt)
        v = torch.randn((B, Lk, H, hd), generator=g, device=dev).to(dt)
        reset_launch_counts()
        got = L.full_attention(q, k, v)
        assert launch_counts()["flash_attention"] == 1
        want = L.gqa_attention(q.cpu(), k.cpu(), v.cpu(), causal=False)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert _err(got.cpu(), want) <= TOL[dt], _err(got.cpu(), want)


# (B, T, S, H, Hkv, hd): the cached cross-attention (T rows against an
# S-slot frozen memory): seamless's decode (mma_keys at G 1) and chunk
# (mma_rows), S split over blocks, and pixtral's hd 160 at G 4
MEMORY_CASES = [
    (3, 1, 48, 4, 4, 64),
    (1, 20, 300, 4, 4, 64),
    (4, 1, 1024, 4, 4, 64),
    (2, 3, 100, 8, 2, 160),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MEMORY_CASES,
                         ids=lambda c: "B{}_T{}_S{}_H{}_Hkv{}_hd{}"
                         .format(*c))
def test_memory_attention_matches_plain_on_card(case):
    """``layers.memory_attention`` on the card is the decode-attention
    kernel over the persistent all-valid position row (one tensor per
    device and S, broadcast over the batch), against plain
    ``gqa_attention(causal=False)``."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import layers as L

    dev = _card()
    B, T, S_, H, Hkv, hd = case
    g = torch.Generator(device=dev).manual_seed(S_ + T)
    for dt in DTYPES:
        q = torch.randn((B, T, H, hd), generator=g, device=dev).to(dt)
        k = torch.randn((B, S_, Hkv, hd), generator=g, device=dev).to(dt)
        v = torch.randn((B, S_, Hkv, hd), generator=g, device=dev).to(dt)
        reset_launch_counts()
        got = L.memory_attention(q, k, v)
        assert launch_counts()["decode_attention"] == 1
        want = L.gqa_attention(q.cpu(), k.cpu(), v.cpu(), causal=False)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert _err(got.cpu(), want) <= TOL[dt], _err(got.cpu(), want)
    row = L.memory_positions(S_, dev)
    assert row is L.memory_positions(S_, dev)
    assert row.data_ptr() == L.memory_positions(S_, "cuda").data_ptr()


# (M, K, N, gs, strided x, split): the int4 mma route at decode (M 1, 8
# on the 8-row tile), ragged rows of the 32-row tile (12; a chunk tail,
# 37) and a full chunk (128); groups of 32, 64 and 48 (a split boundary
# inside a group); ragged N (200, 16400, 8200; the first and the last
# not a multiple of 16); K not a multiple of the 64-row K tile (2080,
# 2016, 1056); x a view of wider rows
INT4_MMA_CASES = [
    (1, 2048, 512, 32, False, True),
    (8, 2048, 8192, 32, False, True),
    (8, 2016, 512, 48, True, True),
    (12, 1024, 1024, 64, True, True),
    (37, 2080, 200, 32, True, True),
    (37, 1056, 16400, 32, False, False),
    (128, 2048, 8192, 64, False, False),
    (128, 1024, 8200, 32, True, False),
    (128, 2048, 512, 32, True, True),
    (128, 2080, 200, 32, False, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", INT4_MMA_CASES,
                         ids=lambda c: "M{}_K{}_N{}_gs{}_{}_{}".format(
                             *c[:4], "strided" if c[4] else "dense",
                             "split" if c[5] else "whole"))
def test_int4_mma_route_matches_plain_on_card(case):
    """bf16 int4 on the tensor-core route: within 2e-2 max|plain| of the
    plain version (bf16 output rounding; the f32 sums run in another
    order), on the split or unsplit plan the case names, and bitwise
    equal across two calls (the splits are added in a fixed order)."""
    from repro_torch.quant import quantize_tensor
    dev = _card()
    M, K, N, gs, strided, split = case
    g = torch.Generator(device=dev).manual_seed(M + K + N)
    w = 0.05 * torch.randn((K, N), generator=g, device=dev)
    qt = quantize_tensor(w, bits=4, group_size=gs)
    assert K // qt["scale"].shape[0] == gs
    pl = qmm_kernel.mma_plan(4, M, N, K, gs, torch.bfloat16)
    assert pl.route == "mma" and (pl.splits > 1) == split, pl
    wide = torch.randn((M, K + 64 * strided), generator=g, device=dev)
    x = wide.to(torch.bfloat16)[:, :K]
    assert x.is_contiguous() != strided
    got = qmm_kernel.quant_matmul_int4_cuda(x, qt["q4"], qt["scale"])
    want = qmm_ref.quant_matmul_int4_reference(x, qt["q4"], qt["scale"])
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert torch.isfinite(got).all()
    assert _err(got, want) <= 2e-2 * want.float().abs().max().item(), (
        pl, _err(got, want))
    again = qmm_kernel.quant_matmul_int4_cuda(x, qt["q4"], qt["scale"])
    assert torch.equal(again, got)


# (M, K, N, strided x, split): every llama3.2-1b projection shape at
# decode (M 1, 8: the 8-row tile), a chunk tail (37) and a full chunk
# (128: the 32-row tile), split where the tiles give fewer than 132
# blocks; ragged N (200: no multiple of 16, 4-byte weight copies); K no
# multiple of the 64-row K tile (2080) nor of its 16-row k-step (2056);
# x a view of wider rows
INT8_MMA_CASES = [
    (M, K, N, False, None) for K, N in ((2048, 8192), (2048, 512),
                                        (2048, 2048), (8192, 2048))
    for M in (1, 8, 37, 128)] + [
    (8, 2048, 200, False, True),
    (37, 2048, 200, True, True),
    (8, 2080, 512, True, True),
    (128, 2080, 8192, False, False),
    (37, 2056, 512, False, True),
    (8, 2048, 8192, True, None),
    (128, 2048, 512, True, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", INT8_MMA_CASES,
                         ids=lambda c: "M{}_K{}_N{}_{}".format(
                             *c[:3], "strided" if c[3] else "dense"))
def test_int8_mma_route_matches_plain_on_card(case):
    """bf16 int8 on the tensor-core route: within 2e-2 max|plain| of the
    plain version (bf16 output rounding; the f32 sums run in another
    order), on the split or unsplit plan the case names where it names
    one, and bitwise equal across two calls (the splits are added in a
    fixed order)."""
    from repro_torch.quant import quantize_tensor
    dev = _card()
    M, K, N, strided, split = case
    g = torch.Generator(device=dev).manual_seed(M + K + N)
    w = 0.05 * torch.randn((K, N), generator=g, device=dev)
    qt = quantize_tensor(w, bits=8)
    pl = qmm_kernel.mma_plan(8, M, N, K, 0, torch.bfloat16)
    assert pl.route == "mma", pl
    assert split is None or (pl.splits > 1) == split, pl
    wide = torch.randn((M, K + 64 * strided), generator=g, device=dev)
    x = wide.to(torch.bfloat16)[:, :K]
    assert x.is_contiguous() != strided
    got = qmm_kernel.quant_matmul_int8_cuda(x, qt["q"], qt["scale"])
    want = qmm_ref.quant_matmul_int8_reference(x, qt["q"], qt["scale"])
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert torch.isfinite(got).all()
    assert _err(got, want) <= 2e-2 * want.float().abs().max().item(), (
        pl, _err(got, want))
    again = qmm_kernel.quant_matmul_int8_cuda(x, qt["q"], qt["scale"])
    assert torch.equal(again, got)


# (name, b, T, h, p, g, n, layout): mamba2-780m's decode (B 8, T 1) and
# chunk (B 1, T 128) shapes and two chunks (T 256); ragged T 5 and 37 at
# the reduced dims with 2 groups; p 32 with n 32 and 64. ``layout``:
# "packed", x, B and C slices of one conv-output row as the model passes
# them (16-byte copies); "offset", the same shifted by one float (4-byte
# copies); "dense", separate tensors
SSD_EXTEND_CASES = [
    ("decode", 8, 1, 48, 64, 1, 128, "packed"),
    ("chunk", 1, 128, 48, 64, 1, 128, "packed"),
    ("chunk_T256", 1, 256, 48, 64, 1, 128, "dense"),
    ("chunk_offset", 1, 128, 48, 64, 1, 128, "offset"),
    ("reduced_g2_T5", 2, 5, 16, 32, 2, 32, "dense"),
    ("reduced_g2_T37", 2, 37, 16, 32, 2, 32, "offset"),
    ("p32_n32", 3, 37, 8, 32, 1, 32, "packed"),
    ("p32_n64", 1, 37, 8, 32, 2, 64, "packed"),
    # Jamba's SSM heads: p 128, n 128, decode and a ragged chunk
    ("p128_decode", 8, 1, 16, 128, 1, 128, "packed"),
    ("p128_T37", 1, 37, 16, 128, 1, 128, "offset"),
]


def _ssd_extend_inputs(b, T, h, p, g, n, layout, *, seed,
                       dtype=torch.float32):
    """x, dt, A, B, C, D and a state on the card from a seeded generator
    (the kernels phase's distributions); x, B, C in ``dtype``, laid out
    as ``layout`` says."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(seed)
    d_in = h * p
    width = d_in + 2 * g * n + (layout == "offset")
    xbc = torch.randn((b, T, width), generator=gen, device=dev).to(dtype)
    if layout == "offset":
        xbc = xbc[..., 1:]
    x = xbc[..., :d_in].unflatten(-1, (h, p))
    B = xbc[..., d_in:d_in + g * n].unflatten(-1, (g, n))
    C = xbc[..., d_in + g * n:].unflatten(-1, (g, n))
    if layout == "dense":
        x, B, C = x.contiguous(), B.contiguous(), C.contiguous()
    dt = 0.001 + 0.1 * torch.rand((b, T, h), generator=gen, device=dev)
    A = -0.5 - 1.5 * torch.rand((h,), generator=gen, device=dev)
    D = torch.randn((h,), generator=gen, device=dev)
    s0 = torch.randn((b, h, p, n), generator=gen, device=dev)
    return x, dt, A, B, C, D, s0


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_EXTEND_CASES, ids=lambda c: c[0])
def test_ssd_extend_routes_match_plain_on_card(case):
    """The recurrence kernel on the route its plan picks: within 1e-4
    max|plain| of the plain loop of steps (f32, the readout summed in
    another order), y and the state; extending by t1 then T - t1 tokens
    gives the bits of extending by T at t1 = 1, the tile's edges (tile -
    1, tile, tile + 1) and 37, across routes (t1 = 1 is a T = 1 launch);
    a batch row with dt = 0 keeps its state bit for bit; ``ssd_step`` (x
    with a non-contiguous last dimension, which the wrapper copies) gives
    the bits of the T = 1 launch; in place (``out=state``) the result is
    the out-of-place one and ``ckpt`` receives the incoming state."""
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref

    name, b, T, h, p, g, n, layout = case
    x, dt, A, B, C, D, s0 = _ssd_extend_inputs(b, T, h, p, g, n, layout,
                                               seed=T + n)
    pl = ssd_kernel.extend_plan(b, T, h, p, g, n)
    assert pl.tt == (1 if T == 1 else ssd_kernel.EXT_TILE)

    def ext(t0, t1, state, **kw):
        return ssd_kernel.ssd_extend_cuda(
            state, x[:, t0:t1], dt[:, t0:t1], A, B[:, t0:t1], C[:, t0:t1],
            D, **kw)

    y, s = ext(0, T, s0)
    y0, s1 = ssd_ref.ssd_extend_reference(s0, x, dt, A, B, C, D)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    for got, want in ((y, y0), (s, s1)):
        assert _err(got, want) <= 1e-4 * want.abs().max().item(), (
            pl, _err(got, want))
    tile = ssd_kernel.EXT_TILE
    for t1 in sorted({1, tile - 1, tile, tile + 1, 37}):
        if t1 < T:
            ya, sa = ext(0, t1, s0)
            yb, sb = ext(t1, T, sa)
            assert torch.equal(torch.cat([ya, yb], 1), y), t1
            assert torch.equal(sb, s), t1
    dt0 = dt.clone()
    dt0[0] = 0.0
    _, sz = ssd_kernel.ssd_extend_cuda(s0, x, dt0, A, B, C, D)
    assert torch.equal(sz[0], s0[0])
    xt = x[:, 0].transpose(1, 2).contiguous().transpose(1, 2)
    assert xt.stride(-1) != 1
    ys, ss = ssd_ops.ssd_step(s0, xt, dt[:, 0], A, B[:, 0], C[:, 0], D)
    yk, sk = ext(0, 1, s0)
    assert torch.equal(ys, yk[:, 0]) and torch.equal(ss, sk)
    state, ckpt = s0.clone(), torch.empty_like(s0)
    yi, si = ext(0, T, state, out=state, ckpt=ckpt)
    assert si is state
    assert torch.equal(yi, y) and torch.equal(state, s)
    assert torch.equal(ckpt, s0)


# (name, b, l, h, p, g, n, chunk, layout): the dual form at mamba2-780m's
# full dims (b 1, l 1024 and b 2, l 512 at chunk 256), chunks 16, 32,
# 48, 64 and 128 (sub-chunks 16, 32, 16, 64, 128), g 2 and 3, p 32, n 32
# and 64, and a chunk of 8 (bf16 on the simt route); layouts as for the
# recurrence ("packed": slices of one conv-output row as the model passes
# them; "offset": shifted by one element, so staged without 16-byte
# copies; "dense": separate tensors)
SSD_CHUNK_CASES = [
    ("full_b1_l1024", 1, 1024, 48, 64, 1, 128, 256, "packed"),
    ("full_b2_l512", 2, 512, 48, 64, 1, 128, 256, "dense"),
    ("chunk16_g2", 2, 64, 16, 32, 2, 32, 16, "packed"),
    ("chunk32_g3", 1, 96, 6, 32, 3, 64, 32, "dense"),
    ("chunk48_g3", 1, 96, 6, 64, 3, 128, 48, "offset"),
    ("chunk64_p32_n64", 2, 128, 8, 32, 1, 64, 64, "packed"),
    ("chunk128_n32_g2", 1, 256, 8, 64, 2, 32, 128, "offset"),
    ("chunk8_simt", 1, 64, 4, 32, 1, 32, 8, "dense"),
    # Jamba's SSM heads: p 128, n 128 at its chunk 256 (mma: 8 warps in
    # the chunk states, 2 blocks an SM in the outputs) and a short chunk
    ("p128_n128_l512", 1, 512, 8, 128, 1, 128, 256, "packed"),
    ("p128_n128_chunk32", 2, 64, 4, 128, 1, 128, 32, "dense"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", SSD_CHUNK_CASES, ids=lambda c: c[0])
def test_ssd_routes_match_plain_on_card(case, dtype):
    """The dual form on the route its plan picks (bf16 with a chunk that
    is a multiple of 16: the tensor-core route in sub-chunks; else simt),
    from zero and from a given state: y and the final state each within
    1e-4 of max|plain| of the plain version (f32 arithmetic from the same
    inputs; the tensor-core route's split bf16 pairs keep 16 bits of each
    f32 operand), two calls bitwise equal, one launch counted a call."""
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ref as ssd_ref

    name, b, l, h, p, g, n, chunk, layout = case
    x, dt, A, B, C, D, s0 = _ssd_extend_inputs(b, l, h, p, g, n, layout,
                                               seed=l + n, dtype=dtype)
    pl = ssd_kernel.chunk_plan(b, l, h, p, n, chunk, dtype)
    assert pl.route == ("mma" if dtype == torch.bfloat16 and chunk % 16 == 0
                        else "simt")
    for init in (None, s0):
        before = ssd_kernel.ssd_cuda.launches
        y, s = ssd_kernel.ssd_cuda(x, dt, A, B, C, D, chunk=chunk,
                                   initial_state=init)
        y2, s2 = ssd_kernel.ssd_cuda(x, dt, A, B, C, D, chunk=chunk,
                                     initial_state=init)
        assert ssd_kernel.ssd_cuda.launches == before + 2
        y0, s1 = ssd_ref.ssd_reference(x, dt, A, B, C, D, chunk=chunk,
                                       initial_state=init)
        torch.cuda.synchronize()
        assert torch.isfinite(y).all() and torch.isfinite(s).all()
        for got, want in ((y, y0), (s, s1)):
            assert _err(got, want) <= 1e-4 * want.abs().max().item(), (
                pl, init is None, _err(got, want))
        assert torch.equal(y, y2) and torch.equal(s, s2), pl


# (N, d): mamba2-780m's d 1536 (ln1, ln_f) and d_in 3072 (the gated
# norm), llama3.2-1b's 2048, pixtral-12b's 5120; one row, a decode batch,
# a chunk and the Zoo's forward (B 2 x L 1024)
NORM_D = (1536, 2048, 3072, 5120, 8192, 16384)
NORM_N = (1, 8, 128, 2048)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["add", "norm", "gated"])
@pytest.mark.parametrize("d", NORM_D)
@pytest.mark.parametrize("N", NORM_N)
def test_rmsnorm_routes_match_plain_on_card(N, d, route):
    """The CUDA norm on each route of its plan against the plain version,
    bf16 and fp32 (TOL), and bitwise equal across two launches. The add
    route takes a strided residual; the gated route takes z as a strided
    slice of an in-projection row (mamba2-780m's row stride 6448 at d
    3072, 2 d + 304 otherwise) and y in f32 or in the activation dtype.
    Every route also takes the scale in the other dtype than its rows (an
    f32 scale on a bf16 row, a bf16 scale on an f32 row). The gated route
    in bf16 is held
    within 2e-2 of max(1, |plain|) element by element: its outputs reach
    past 8, where one rounding step of bf16 is 2^-4, and the sum of
    squares taken in another order may move one."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(N + d)
    assert norm_kernel.plan(N, d, torch.bfloat16, route).route == route
    for dt in DTYPES:
        other = torch.float32 if dt == torch.bfloat16 else torch.bfloat16
        x = torch.randn((N, d), generator=g, device=dev).to(dt)
        wide = torch.randn((N, 2 * d + 304), generator=g, device=dev).to(dt)
        scale = (1 + 0.1 * torch.randn((d,), generator=g, device=dev)).to(dt)
        if route == "gated":
            z = wide[:, :d]
            for y, s in ((x.float(), scale), (x, scale),
                         (x.float(), scale.to(other)),
                         (x, scale.to(other))):
                got = norm_kernel.gated_rmsnorm_cuda(y, z, s)
                want = norm_ref.gated_rmsnorm_reference(y, z, s)
                torch.cuda.synchronize()
                assert got.dtype == dt and torch.isfinite(got).all()
                err = _err(got, want) if dt == torch.float32 else (
                    (got.float() - want.float()).abs()
                    / want.float().abs().clamp(min=1)).max().item()
                assert err <= TOL[dt], (y.dtype, s.dtype, err)
                assert torch.equal(norm_kernel.gated_rmsnorm_cuda(y, z, s),
                                   got)
            continue
        res = wide[:, d + 1:2 * d + 1] if route == "add" else None
        for s in (scale, scale.to(other)):
            y, t = norm_kernel.fused_rmsnorm_cuda(x, res, s)
            y0, t0 = norm_ref.fused_rmsnorm_reference(x, res, s)
            torch.cuda.synchronize()
            assert y.dtype == dt and torch.isfinite(y).all()
            assert _err(y, y0) <= TOL[dt] and _err(t, t0) <= TOL[dt], \
                (s.dtype, _err(y, y0), _err(t, t0))
            y2, t2 = norm_kernel.fused_rmsnorm_cuda(x, res, s)
            assert torch.equal(y2, y) and torch.equal(t2, t)
            assert (t is x) == (route == "norm")


def _grad_cases(dev):
    """{op: (call, inputs)}: every kernel op at a small shape, ``call``
    taking the inputs and returning its outputs (a tensor or a tuple)."""
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.quant import quantize_tensor

    g = torch.Generator(device=dev).manual_seed(5)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    q, k, v, pos, q_pos = (torch.from_numpy(a).to(dev) for a in
                           _decode_inputs(2, 3, 2, seed=0))
    kp, vp, bt = _paged_from_contiguous(k, v, 8, seed=0)
    w = 0.05 * rn(256, 128)
    q8, q4 = quantize_tensor(w, bits=8), quantize_tensor(w, bits=4,
                                                         group_size=32)
    b, T, h, p, gr, n = 1, 16, 4, 32, 1, 32
    sx, sdt, sA, sB, sC, sD = (rn(b, T, h, p), 0.05 + 0.05 * rn(b, T, h).abs(),
                               -1 - rn(h).abs(), rn(b, T, gr, n),
                               rn(b, T, gr, n), rn(h))
    s0 = rn(b, h, p, n)
    return {
        "rmsnorm_add": (lambda x, r, s: norm_kernel.fused_rmsnorm_cuda(
            x, r, s), (rn(8, 1536), rn(8, 1536), rn(1536))),
        "rmsnorm_norm": (lambda x, s: norm_kernel.fused_rmsnorm_cuda(
            x, None, s)[0], (rn(8, 1536), rn(1536))),
        "rmsnorm_gated": (norm_kernel.gated_rmsnorm_cuda,
                          (rn(8, 3072), rn(8, 3072), rn(3072))),
        "quant_matmul_int8": (lambda x: qmm_kernel.quant_matmul_int8_cuda(
            x, q8["q"], q8["scale"]), (rn(8, 256).bfloat16(),)),
        "quant_matmul_int4": (lambda x: qmm_kernel.quant_matmul_int4_cuda(
            x, q4["q4"], q4["scale"]), (rn(8, 256).bfloat16(),)),
        "ssd": (lambda x, B, C: ssd_kernel.ssd_cuda(
            x, sdt, sA, B, C, sD, chunk=16), (sx, sB, sC)),
        "ssd_extend": (lambda x, st: ssd_kernel.ssd_extend_cuda(
            st, x, sdt, sA, sB, sC, sD), (sx, s0)),
        "ssd_step": (lambda x, st: ssd_ops.ssd_step(
            st, x[:, 0], sdt[:, 0], sA, sB[:, 0], sC[:, 0], sD), (sx, s0)),
        "decode_attention": (lambda q_: dec_kernel.decode_attention_cuda(
            q_, k, v, pos, q_pos), (q,)),
        "paged_decode_attention": (
            lambda q_: dec_kernel.paged_decode_attention_cuda(
                q_, kp, vp, bt, pos, q_pos), (q,)),
        "flash_attention": (lambda q_, k_, v_:
                            flash_kernel.flash_attention_cuda(q_, k_, v_),
                            (q, k, v)),
    }


#: the ops whose backward raises: each is for inference only
GRAD_OPS = ("quant_matmul_int8", "quant_matmul_int4", "ssd_extend",
            "ssd_step", "decode_attention", "paged_decode_attention")


@pytest.mark.cuda
@pytest.mark.parametrize("op", GRAD_OPS)
def test_kernel_op_refuses_a_backward_on_card(op):
    """With no gradient asked for, the op launches straight: no autograd
    node on its outputs. With its first input requiring grad it returns
    the same outputs, bit for bit, through a node whose backward raises
    (saying the op is for inference only) instead of giving the inputs
    no gradient. The flash, the RMSNorm (add, norm, gated) and the SSD
    dual-form ops have backward kernels (the tests below)."""
    dev = _card()
    call, inputs = _grad_cases(dev)[op]

    def outs(r):
        return r if isinstance(r, tuple) else (r,)

    want = outs(call(*inputs))
    assert all(o.grad_fn is None for o in want)
    leaf = inputs[0].detach().clone().requires_grad_()
    got = outs(call(leaf, *inputs[1:]))
    torch.cuda.synchronize()
    assert all(torch.equal(o.detach(), w) for o, w in zip(got, want))
    assert got[0].grad_fn is not None
    with pytest.raises(NotImplementedError, match="inference only"):
        got[0].float().sum().backward()


# (B, Lq, Lk, Hq, Hkv, hd, causal, window): llama's G 4 at hd 64, G 1 at
# hd 128, pixtral's hd 160, a window, non-causal Lq != Lk, a ragged
# length at hd 40 (zero-padded to the 64 tile), hd 256 at G 3 (bq 21);
# the mma route's edges: Lk 1000 (not a multiple of the 64-key tile),
# G 8 (bq 8), a window that crosses key tiles, hd 128 and 160 ragged
FLASH_BWD_CASES = [(2, 128, 128, 8, 2, 64, True, 0),
                   (1, 96, 96, 4, 4, 128, True, 0),
                   (1, 70, 70, 8, 2, 160, True, 0),
                   (1, 200, 200, 4, 1, 64, True, 48),
                   (1, 64, 300, 4, 4, 64, False, 0),
                   (2, 37, 37, 4, 2, 40, True, 0),
                   (1, 50, 50, 6, 2, 256, True, 0),
                   (1, 1000, 1000, 8, 2, 64, True, 0),
                   (1, 100, 100, 16, 2, 64, True, 0),
                   (1, 300, 300, 8, 2, 64, True, 100),
                   (1, 130, 130, 4, 2, 128, True, 0),
                   (1, 129, 129, 8, 2, 160, False, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_BWD_CASES,
                         ids=lambda c: "B{}_Lq{}_Lk{}_Hq{}_Hkv{}_hd{}_c{}_w{}"
                         .format(*c))
def test_flash_backward_matches_plain_on_card(case):
    """A backward through ``flash_attention_cuda`` runs the backward
    kernels (one count a call, three launches) on the route ``plan_bwd``
    names (bf16: ``mma``, dS rounded to bf16; fp32: ``simt``): dq, dk, dv
    within the gates of max|plain| of ``ref.attention_backward_reference``
    and of autograd of the plain forward on the card; bitwise repeatable
    (no atomics); the forward with its LSE equal to the plain launch's."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    dev = _card()
    B, Lq, Lk, Hq, Hkv, hd, causal, window = case
    g = torch.Generator(device=dev).manual_seed(Lq + hd)
    G = Hq // Hkv
    tr = lambda t: t.transpose(1, 2)  # noqa: E731
    for dt in DTYPES:
        q = torch.randn((B, Lq, Hq, hd), generator=g, device=dev).to(dt)
        k = torch.randn((B, Lk, Hkv, hd), generator=g, device=dev).to(dt)
        v = torch.randn((B, Lk, Hkv, hd), generator=g, device=dev).to(dt)
        do = torch.randn((B, Lq, Hq, hd), generator=g, device=dev).to(dt)
        plain_out = flash_kernel.flash_attention_cuda(
            q, k, v, causal=causal, window=window)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        reset_launch_counts()
        out = flash_kernel.flash_attention_cuda(*leaves, causal=causal,
                                                window=window)
        grads = torch.autograd.grad(out, leaves, do)
        again = torch.autograd.grad(flash_kernel.flash_attention_cuda(
            *leaves, causal=causal, window=window), leaves, do)
        counts = launch_counts()
        assert counts["flash_attention"] == 2
        assert counts["flash_attention_bwd"] == 2
        assert flash_kernel.plan_bwd(B, Lq, Lk, Hq, Hkv, hd, dt).route == \
            ("mma" if dt == torch.bfloat16 else "simt")
        want = flash_ref.attention_backward_reference(
            tr(q), tr(k), tr(v), tr(do), causal=causal, window=window)
        auto = [t.clone().float().requires_grad_() for t in (q, k, v)]
        flash_ref.attention_reference(
            tr(auto[0]), tr(auto[1]).repeat_interleave(G, 1),
            tr(auto[2]).repeat_interleave(G, 1), causal=causal,
            window=window).backward(tr(do.float()))
        torch.cuda.synchronize()
        assert torch.equal(out.detach(), plain_out)
        for got, w, a, rep in zip(grads, want, auto, again):
            assert got.dtype == dt and torch.isfinite(got).all()
            assert torch.equal(got, rep)
            scale = w.float().abs().max().item()
            assert _err(got, tr(w)) <= TOL[dt] * scale, _err(got, tr(w))
            assert _err(got, a.grad) <= TOL[dt] * scale, _err(got, a.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["add", "norm"])
@pytest.mark.parametrize("d", [2048, 5120, 100, 9000])
@pytest.mark.parametrize("N", [300, 301])
def test_rmsnorm_backward_matches_plain_on_card(route, d, N):
    """A backward through ``fused_rmsnorm_cuda`` on the add and norm
    routes runs ``fused_rmsnorm_bwd_cuda`` (rows, then the dscale
    reduction): dx, the residual's gradient and dscale within the gates
    of max|plain| of ``ref.fused_rmsnorm_backward_reference`` and of
    autograd of the plain forward, for f32 and bf16 rows with an f32 or
    a bf16 scale, N a multiple of the plan's rows a block (300) or not
    (301), rows held in registers or (f32 d 5120, d 9000) on the
    wide-row route; bitwise repeatable (no atomics); the add route's sum output
    taking a gradient of its own (dt) or none."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(d)
    for dt in DTYPES:
        x = torch.randn((N, d), generator=g, device=dev).to(dt)
        r = torch.randn((N, d), generator=g, device=dev).to(dt) \
            if route == "add" else None
        dy = torch.randn((N, d), generator=g, device=dev).to(dt)
        dtt = torch.randn((N, d), generator=g, device=dev).to(dt)
        for sdt in (torch.float32, dt):
            s = (1 + 0.1 * torch.randn((d,), generator=g, device=dev)).to(sdt)
            for with_dt in ((False, True) if route == "add" else (False,)):
                leaves = [t.clone().requires_grad_() for t in
                          ((x, r, s) if route == "add" else (x, s))]
                reset_launch_counts()
                y, t = norm_kernel.fused_rmsnorm_cuda(
                    leaves[0], leaves[1] if route == "add" else None,
                    leaves[-1])
                outs, gs = [y], [dy]
                if with_dt:
                    outs.append(t)
                    gs.append(dtt)
                got = torch.autograd.grad(outs, leaves, gs)
                assert launch_counts()["rmsnorm_bwd"] == 1
                rep = norm_kernel.fused_rmsnorm_bwd_cuda(
                    x, r, s, dy, dtt if with_dt else None)
                want = norm_ref.fused_rmsnorm_backward_reference(
                    x, r, s, dy, dtt if with_dt else None)
                torch.cuda.synchronize()
                assert torch.equal(rep[0], got[0])
                assert torch.equal(rep[1], got[-1])
                if route == "add":
                    assert torch.equal(got[1], got[0])
                for a, w in ((got[0], want[0]), (got[-1], want[1])):
                    assert a.dtype == w.dtype and torch.isfinite(a).all()
                    scale = w.float().abs().max().item()
                    assert _err(a, w) <= TOL[dt] * scale, _err(a, w)


#: (name, b, l, h, p, g, n, chunk, dtype, initial state, final-state
#: gradient[, sub-chunk]): chip_smoke.py's kernels_bwd shapes:
#: mamba2-780m's train shape, jamba's heads, fp32, a carried state,
#: groups, a bf16 chunk that is no multiple of 16 (the simt route),
#: jamba's heads with a carried state and a final-state gradient, the mma
#: route at a sub-chunk the caller gives
SSD_BWD_CASES = [
    ("mamba2_train", 4, 1024, 48, 64, 1, 128, 256, torch.bfloat16, False,
     False),
    ("jamba_heads", 1, 1024, 128, 128, 1, 128, 256, torch.bfloat16, False,
     False),
    ("fp32", 2, 512, 48, 64, 1, 128, 256, torch.float32, False, False),
    ("state", 2, 512, 16, 64, 1, 128, 128, torch.bfloat16, True, True),
    ("groups", 2, 512, 16, 32, 4, 64, 64, torch.bfloat16, False, True),
    ("bf16_chunk40_simt", 2, 320, 16, 64, 1, 128, 40, torch.bfloat16,
     False, True),
    ("jamba_state", 1, 512, 128, 128, 1, 128, 256, torch.bfloat16, True,
     True),
    ("sub64", 2, 512, 16, 64, 1, 128, 256, torch.bfloat16, True, True,
     64)]


def _ssd_bwd_inputs(dev, b, l, h, p, g, n, dtype, init, seed=0):
    """x, dt, A, B, C, D, s0 as the mixer makes them: x, B, C slices of
    one conv-output row (strided), dt = softplus, A = -exp(A_log) over
    1..16."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    xbc = torch.randn((b, l, h * p + 2 * g * n), generator=gen,
                      device=dev).to(dtype)
    x = xbc[..., :h * p].unflatten(-1, (h, p))
    B = xbc[..., h * p:h * p + g * n].unflatten(-1, (g, n))
    C = xbc[..., h * p + g * n:].unflatten(-1, (g, n))
    dt = torch.nn.functional.softplus(
        torch.randn((b, l, h), generator=gen, device=dev) - 3.0)
    A = -torch.linspace(1.0, 16.0, h, device=dev)
    D = torch.randn((h,), generator=gen, device=dev)
    s0 = torch.randn((b, h, p, n), generator=gen, device=dev) \
        if init else None
    return x, dt, A, B, C, D, s0


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_BWD_CASES, ids=lambda c: c[0])
def test_ssd_backward_matches_plain_on_card(case):
    """A backward through ``ssd_cuda`` runs ``ssd_bwd_cuda`` (one count a
    call) on the route ``bwd_plan`` picks (bf16 with a chunk that is a
    multiple of 16: ``mma``; else ``simt``): dx, ddt, dA, dB, dC, dD and
    the initial state's gradient within the gates of max|plain| of
    ``ref.ssd_backward_reference`` and of autograd of the plain forward
    (f32) on the card, in x's, B's and C's dtypes; bitwise repeatable (no
    atomics). A case with a sub-chunk runs the backward at it too
    (``_bwd_at_sub``), held to the same gates and repeated bitwise."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ref as ssd_ref

    dev = _card()
    _, b, l, h, p, g, n, chunk, dtype, init, dfin = case[:11]
    sub = case[11] if len(case) > 11 else 0
    route = "mma" if dtype == torch.bfloat16 and chunk % 16 == 0 else "simt"
    assert ssd_kernel.bwd_plan(b, l, h, p, n, chunk, dtype, sub).route \
        == route
    x, dt, A, B, C, D, s0 = _ssd_bwd_inputs(dev, b, l, h, p, g, n, dtype,
                                           init)
    gen = torch.Generator(device=dev).manual_seed(1)
    dy = torch.randn((b, l, h, p), generator=gen, device=dev)
    dfinal = torch.randn((b, h, p, n), generator=gen, device=dev) \
        if dfin else None
    ins = [x, dt, A, B, C, D] + ([s0] if init else [])
    leaves = [t.detach().clone().requires_grad_() for t in ins]
    reset_launch_counts()
    y, fin = ssd_kernel.ssd_cuda(*leaves[:6], chunk=chunk,
                                 initial_state=leaves[6] if init else None)
    outs = [(y, dy)] + ([(fin, dfinal)] if dfin else [])
    got = torch.autograd.grad([o for o, _ in outs], leaves,
                              [t for _, t in outs])
    assert launch_counts()["ssd_bwd"] == 1 and launch_counts()["ssd"] == 1
    rep = ssd_kernel.ssd_bwd_cuda(x, dt, A, B, C, D, dy, dfinal,
                                  chunk=chunk, initial_state=s0)
    at_sub = []
    if sub:
        at_sub = [ssd_kernel._bwd_at_sub(x, dt, A, B, C, D, dy, dfinal,
                                         chunk, s0, sub) for _ in range(2)]
    want = ssd_ref.ssd_backward_reference(x, dt, A, B, C, D, dy, dfinal,
                                          chunk=chunk, initial_state=s0)
    auto = [t.detach().float().requires_grad_() for t in ins]
    ya, fa = ssd_ref.ssd_reference(*auto[:6], chunk=chunk,
                                   initial_state=auto[6] if init else None)
    autos = torch.autograd.grad([ya] + ([fa] if dfin else []), auto,
                                [dy] + ([dfinal] if dfin else []))
    torch.cuda.synchronize()
    rep = [t for t in rep if t is not None]
    want = [t for t in want if t is not None]
    assert all(torch.equal(a, r) for a, r in zip(got, rep))
    at_sub = [[t for t in r if t is not None] for r in at_sub]
    if at_sub:
        assert all(torch.equal(a, r) for a, r in zip(*at_sub))
    tol = TOL[dtype]
    for outs in [got] + at_sub[:1]:
        for a, w, u in zip(outs, want, autos):
            assert a.dtype == w.dtype and a.shape == w.shape
            assert torch.isfinite(a).all()
            scale = w.float().abs().max().item()
            assert _err(a, w) <= tol * scale, (_err(a, w), scale)
            assert _err(a, u) <= tol * scale, (_err(a, u), scale)


#: (N, d, z's row stride, dtype): mamba2's train rows (z of a 6448-wide
#: in-projection row), jamba's d_inner (z of a 33152-wide row), fp32, an
#: N that is no multiple of the rows a block (two rows of d 1536), fp32
#: at jamba's d_inner (the wide-row route)
GATED_BWD_CASES = [(4096, 3072, 6448, torch.bfloat16),
                   (1024, 16384, 33152, torch.bfloat16),
                   (4096, 3072, 6448, torch.float32),
                   (4095, 1536, 3328, torch.bfloat16),
                   (1024, 16384, 33152, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", GATED_BWD_CASES,
                         ids=lambda c: "N{}_d{}_{}".format(
                             c[0], c[1], str(c[3])[6:]))
def test_gated_rmsnorm_backward_matches_plain_on_card(case):
    """A backward through ``gated_rmsnorm_cuda`` runs
    ``gated_rmsnorm_bwd_cuda`` (one count a call): dy (f32, the SSD
    output's), dz (read in place from its strided row, given back
    contiguous) and dscale within the gates of max|plain| of
    ``ref.gated_rmsnorm_backward_reference`` and of autograd of the plain
    forward (f32); bitwise repeatable (no atomics)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    dev = _card()
    N, d, stride, dtype = case
    plan = norm_kernel.plan_bwd(N, d, dtype, "gated")
    if N == 4095:               # the last block holds a partial row slot
        assert N % plan.rows
    gen = torch.Generator(device=dev).manual_seed(d)
    y = torch.randn((N, d), generator=gen, device=dev)
    z = torch.randn((N, stride), generator=gen, device=dev).to(dtype)[:, :d]
    s = (1 + 0.1 * torch.randn((d,), generator=gen, device=dev)).to(dtype)
    dout = torch.randn((N, d), generator=gen, device=dev).to(dtype)
    leaves = [t.clone().requires_grad_() for t in (y, z, s)]
    reset_launch_counts()
    got = torch.autograd.grad(norm_kernel.gated_rmsnorm_cuda(*leaves),
                              leaves, dout)
    assert launch_counts()["rmsnorm_gated_bwd"] == 1
    rep = norm_kernel.gated_rmsnorm_bwd_cuda(y, z, s, dout)
    want = norm_ref.gated_rmsnorm_backward_reference(y, z, s, dout)
    auto = [t.float().requires_grad_() for t in (y, z, s)]
    autos = torch.autograd.grad(norm_ref.gated_rmsnorm_reference(*auto),
                                auto, dout.float())
    torch.cuda.synchronize()
    assert all(torch.equal(a, r) for a, r in zip(got, rep))
    for a, w, u in zip(got, want, autos):
        assert a.dtype == w.dtype and torch.isfinite(a).all()
        scale = w.float().abs().max().item()
        assert _err(a, w) <= TOL[dtype] * scale, (_err(a, w), scale)
        assert _err(a, u) <= TOL[dtype] * scale, (_err(a, u), scale)


def _train_pair(dev, arch="llama3.2-1b", **kw):
    """Reduced ``arch`` (``kw`` replaced) built on the card and on the
    CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build
    cfg = get_arch(arch, variant="reduced").replace(**kw)
    return build(cfg, device=dev), build(cfg, device="cpu")


#: (arch, steps, the fall of the loss asked, first five to last five)
SSM_TRAIN_CASES = [("mamba2-780m", 60, 1.0),
                   ("jamba-1.5-large-398b", 60, 0.05)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSM_TRAIN_CASES, ids=lambda c: c[0])
def test_reduced_ssm_stack_trains_on_card(case):
    """Reduced mamba2-780m and jamba-1.5-large-398b (fp32: the dual
    form's ``simt`` route, the f32 norms) train on the card through the
    SSD, gated-norm, RMSNorm and (jamba) flash backward kernels: the
    mean of the last five losses below the first five's by the case's
    margin (the CPU's own run falls by 3.4 and 0.27 over 80 steps), the
    first five losses equal to the CPU's on the same weights and batches
    within 1e-4 relative, launches a step as the stack asks."""
    from repro_torch.core.pytree import tree_map
    from repro_torch.data.pipeline import batches_for
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import block_spec, n_blocks
    from repro_torch.training.optimizer import AdamW, cosine_schedule
    from repro_torch.training.train_loop import init_train_state, train

    dev = _card()
    arch, steps, fall = case
    card, cpu = _train_pair(dev, arch)
    opt = AdamW(lr=cosine_schedule(3e-3, 5, 80))
    state = init_train_state(card, opt, seed=0)
    cpu_state = tree_map(lambda t: t.cpu(), state)
    reset_launch_counts()
    _, hist = train(card, opt, batches_for(card.cfg, 8, 64, seed=1),
                    steps=steps, log_every=1, state=state)
    counts = launch_counts()
    n_ssm = sum(mixer == "ssm" for mixer, _ in block_spec(card.cfg)) \
        * n_blocks(card.cfg)
    assert counts["ssd_bwd"] == counts["ssd"] == steps * n_ssm
    assert counts["rmsnorm_gated_bwd"] == steps * n_ssm
    losses = [h["loss"] for h in hist]
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - fall, losses
    _, cpu_hist = train(cpu, opt, batches_for(cpu.cfg, 8, 64, seed=1),
                        steps=5, log_every=1, state=cpu_state)
    for a, b in zip(cpu_hist, hist[:5]):
        assert abs(a["loss"] - b["loss"]) <= 1e-4 * a["loss"], (a, b)


@pytest.mark.cuda
def test_ssm_remat_on_equals_off_on_card():
    """Reduced mamba2-780m in bf16 (the dual form's ``mma`` route): with
    ``cfg.remat`` the SSD and gated-norm forwards run twice a layer, and
    the loss, the gradient norm and the parameters after a step are the
    same bits with it on and off."""
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.data.pipeline import batches_for
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.training.optimizer import AdamW, constant_schedule
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)

    dev = _card()
    opt = AdamW(lr=constant_schedule(1e-3))
    out = []
    for remat in (False, True):
        model, _ = _train_pair(dev, "mamba2-780m", dtype="bfloat16",
                               param_dtype="bfloat16", remat=remat)
        batch = next(batches_for(model.cfg, 4, 128, seed=0))
        reset_launch_counts()
        state, m = make_train_step(model, opt)(
            init_train_state(model, opt, seed=0), batch)
        torch.cuda.synchronize()
        out.append((state, m, launch_counts()))
    (s0, m0, c0), (s1, m1, c1) = out
    nl = model.cfg.n_layers
    assert c0["ssd"] == nl and c1["ssd"] == 2 * nl
    assert c0["ssd_bwd"] == c1["ssd_bwd"] == nl
    assert c0["rmsnorm_gated_bwd"] == c1["rmsnorm_gated_bwd"] == nl
    # the forward's norms (ln1 and the gated norm a layer, ln_f), then the
    # recomputed block's two a layer
    assert c0["rmsnorm"] == 2 * nl + 1 and c1["rmsnorm"] == 4 * nl + 1
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(s0["params"]), tree_leaves(s1["params"])))


@pytest.mark.cuda
def test_reduced_llama_trains_on_card():
    """Reduced llama3.2-1b (fp32, flash ``simt`` and the f32 norm) trains
    80 steps on the card through the backward kernels, its loss falling
    by more than 0.5 (``tests/test_training.py``'s end-to-end test), its
    first five losses equal to the CPU's on the same weights and batches
    within 1e-4 relative."""
    from repro_torch.core.pytree import tree_map
    from repro_torch.data.pipeline import batches_for
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.training.optimizer import AdamW, cosine_schedule
    from repro_torch.training.train_loop import init_train_state, train

    dev = _card()
    card, cpu = _train_pair(dev)
    opt = AdamW(lr=cosine_schedule(3e-3, 5, 80))
    state = init_train_state(card, opt, seed=0)
    cpu_state = tree_map(lambda t: t.cpu(), state)
    reset_launch_counts()
    _, hist = train(card, opt, batches_for(card.cfg, 8, 64, seed=1),
                    steps=80, log_every=1, state=state)
    counts = launch_counts()
    assert counts["flash_attention_bwd"] == 80 * 2
    assert counts["rmsnorm_bwd"] == 80 * 5
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.5, hist[-1]
    assert all(np.isfinite(h["loss"]) for h in hist)
    _, cpu_hist = train(cpu, opt, batches_for(cpu.cfg, 8, 64, seed=1),
                        steps=5, log_every=1, state=cpu_state)
    for a, b in zip(cpu_hist, hist[:5]):
        assert abs(a["loss"] - b["loss"]) <= 1e-4 * a["loss"], (a, b)


@pytest.mark.cuda
def test_remat_on_equals_off_on_card():
    """``cfg.remat`` reruns each block's forward kernels in the backward:
    in bf16 the loss, the gradient norm and the parameters after a step
    are the same bits with it on and off, and the flash forward runs
    twice a layer with it on."""
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.data.pipeline import batches_for
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.training.optimizer import AdamW, constant_schedule
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)

    dev = _card()
    opt = AdamW(lr=constant_schedule(1e-3))
    out = []
    for remat in (False, True):
        model, _ = _train_pair(dev, dtype="bfloat16", param_dtype="bfloat16",
                               n_kv_heads=2, remat=remat)
        batch = next(batches_for(model.cfg, 4, 128, seed=0))
        reset_launch_counts()
        state, m = make_train_step(model, opt)(
            init_train_state(model, opt, seed=0), batch)
        torch.cuda.synchronize()
        out.append((state, m, launch_counts()))
    (s0, m0, c0), (s1, m1, c1) = out
    assert c0["flash_attention"] == 2 and c1["flash_attention"] == 4
    assert c0["flash_attention_bwd"] == c1["flash_attention_bwd"] == 2
    assert c0["rmsnorm"] == 5 and c1["rmsnorm"] == 9
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(s0["params"]), tree_leaves(s1["params"])))


#: the captured train step's cases: reduced stacks in bf16 with remat
#: (the tensor-core routes, the recompute inside the graph)
GRAPH_TRAIN_ARCHS = ("llama3.2-1b", "mamba2-780m", "qwen2-moe-a2.7b")


def _graph_train_setup(dev, arch):
    from repro_torch.data.pipeline import batches_for
    from repro_torch.training.optimizer import AdamW, cosine_schedule
    from repro_torch.training.train_loop import init_train_state

    model, _ = _train_pair(dev, arch, dtype="bfloat16",
                           param_dtype="bfloat16", remat=True)
    opt = AdamW(lr=cosine_schedule(1e-3, 2, 10))
    data = batches_for(model.cfg, 4, 128, seed=0)
    return model, opt, init_train_state(model, opt, seed=0), \
        [next(data) for _ in range(5)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", GRAPH_TRAIN_ARCHS)
def test_captured_train_step_equals_eager_on_card(arch):
    """``make_train_step`` on the card: the first call warms up, the
    second captures the whole step once and replays, later calls replay;
    over 3 steps from one state the metrics, every parameter and moment
    and the step counters are the eager functional step's bits, the
    launch counters the eager step's; the caller's state is left as it
    was, and two more steps capture nothing."""
    from repro_torch import kernels
    from repro_torch.core.pytree import tree_leaves, tree_map
    from repro_torch.training.train_loop import TrainProgram, make_train_step

    dev = _card()
    model, opt, state0, batches = _graph_train_setup(dev, arch)
    keep = tree_map(lambda t: t.clone(), state0)
    runs = []
    for graphs in (False, None):
        step = make_train_step(model, opt, graphs=graphs)
        kernels.reset_launch_counts()
        s, ms = state0, []
        for batch in batches[:3]:
            s, m = step(s, batch)
            ms.append({k: v.clone() for k, v in m.items()})
        torch.cuda.synchronize()
        runs.append((tree_map(lambda t: t.clone(), s), ms,
                     kernels.launch_counts(), step))
    (es, em, ec, _), (gs, gm, gc_, prog) = runs
    assert isinstance(prog, TrainProgram) and prog.graphs
    assert prog.cache_size() == 1 and prog.pool_bytes > 0
    assert all(set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
               for a, b in zip(em, gm))
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(es), tree_leaves(gs)))
    assert ec == gc_ and any(ec.values())
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(state0), tree_leaves(keep)))
    graph = prog.graph
    s = gs
    for batch in batches[3:]:
        s, _ = prog(s, batch)
    assert prog.graph is graph and prog.cache_size() == 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", GRAPH_TRAIN_ARCHS)
def test_train_steps_sync_nothing_on_card(arch):
    """Under ``torch.cuda.set_sync_debug_mode("error")`` neither an eager
    functional step (after one warm-up) nor a replay of the captured step
    synchronizes the host with the card: the batch goes up from pinned
    memory, the MoE route counts its experts on the device."""
    from repro_torch.training.train_loop import make_train_step

    dev = _card()
    model, opt, state0, batches = _graph_train_setup(dev, arch)
    eager = make_train_step(model, opt, graphs=False)
    s, _ = eager(state0, batches[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s, _ = eager(s, batches[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    del s
    step = make_train_step(model, opt)
    s, _ = step(state0, batches[0])
    s, _ = step(s, batches[1])                   # capture and replay
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s, m = step(s, batches[2])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert step.cache_size() == 1
    assert torch.isfinite(m["loss"]).item()


@pytest.mark.cuda
def test_moe_router_stays_f32_under_tf32_on_card():
    """The MoE router's product runs in full f32 even when the process
    allows TF32 matmuls: its error against an f64 product is a tenth of
    TF32's at least (a TF32 router can flip a top-k), and the caller's
    precision setting comes back unchanged."""
    from repro_torch.models.moe import _router_logits

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((64, 2048), generator=g, device=dev)
    w = torch.randn((2048, 60), generator=g, device=dev)
    want = x.double() @ w.double()
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        got = _router_logits(x, w)
        tf32 = x @ w
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    err = (got.double() - want).abs().max().item()
    err_tf32 = (tf32.double() - want).abs().max().item()
    assert err * 10 < err_tf32, (err, err_tf32)


# --------------------------------------------------------------------- #
# the engine's step programs as CUDA graphs
# --------------------------------------------------------------------- #
#: engine configurations at reduced size: (variant, cfg changes, engine
#: arguments); every kernel of the serve path runs inside a captured step
GRAPH_CASES = {
    "rings": ("reduced", {}, {}),
    "rings_bf16": ("reduced", {"dtype": "bfloat16",
                               "param_dtype": "bfloat16"}, {}),
    "paged": ("reduced", {}, {"paged": True, "page_size": 8}),
    "int8_kv": ("reduced", {}, {"kv_cache_dtype": "int8"}),
    "int8_weights": ("reduced", {"quant": "int8"}, {}),
    "edge_paged_bf16": ("reduced+edge", {"dtype": "bfloat16",
                                         "param_dtype": "bfloat16"},
                        {"paged": True, "page_size": 8}),
    "mamba2": ("reduced", {}, {}),
    # the MoE family (dense routing inside the captured steps) and the
    # hybrid's super-block (one KV ring and seven SSM states a block)
    "qwen2_moe": ("reduced", {}, {}),
    "qwen2_moe_paged_bf16": ("reduced", {"dtype": "bfloat16",
                                         "param_dtype": "bfloat16"},
                             {"paged": True, "page_size": 8}),
    "jamba": ("reduced", {}, {}),
    # the frontend families: pixtral's embedding chunk and seamless's
    # encode, eager between the captured steps
    "pixtral": ("reduced", {}, {}),
    "seamless_bf16": ("reduced", {"dtype": "bfloat16",
                                  "param_dtype": "bfloat16"}, {}),
}

#: the architecture of each graph case (llama3.2-1b by default)
GRAPH_ARCH = {"mamba2": "mamba2-780m", "qwen2_moe": "qwen2-moe-a2.7b",
              "qwen2_moe_paged_bf16": "qwen2-moe-a2.7b",
              "jamba": "jamba-1.5-large-398b", "pixtral": "pixtral-12b",
              "seamless_bf16": "seamless-m4t-medium"}


def _graph_model(case):
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build
    from repro_torch.quant import quantize_for_cfg

    variant, changes, kw = GRAPH_CASES[case]
    arch = GRAPH_ARCH.get(case, "llama3.2-1b")
    cfg = get_arch(arch, variant=variant).replace(**changes)
    model = build(cfg, device="cuda")
    return model, quantize_for_cfg(model.init(0), cfg), kw


def _graph_serve(model, params, kw, graphs, sampler=None, batches=1):
    """Five requests on three slots (chunks of 8), ``batches`` times
    (with frames drawn after each prompt for a frontend model); returns
    the engine, the tokens by uid and the launch counters of the run,
    set to 0 just before it."""
    from repro_torch import kernels
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request

    engine = Engine(model, params, max_batch=3, cache_len=64,
                    prefill_chunk=8, sampler=sampler, seed=0,
                    graphs=graphs, **kw)
    rng = np.random.default_rng(0)
    kernels.reset_launch_counts()
    fe = model.cfg.frontend
    for batch in range(batches):
        for uid in range(5 * batch, 5 * batch + 5):
            prompt = rng.integers(0, model.cfg.vocab,
                                  int(rng.integers(3, 30)))
            emb = None if fe is None else rng.normal(
                size=(fe.n_tokens, fe.d_embed)).astype(np.float32)
            engine.submit(Request(
                uid=uid, prompt=prompt, embeddings=emb,
                max_new_tokens=int(rng.integers(2, 9))))
        engine.run()
        if batch == 0:
            engine.mark_steady()
    torch.cuda.synchronize()
    tokens = {u: list(r.tokens) for u, r in engine.responses.items()}
    return engine, tokens, kernels.launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_graph_steps_match_eager_steps_on_card(case):
    """Greedy tokens and launch counters of a graphed engine equal the
    eager engine's on the same requests; every program the graphed
    engine built is a captured graph (nothing falls back to eager), one
    plain program and one mixed program a slot that admitted; a second
    batch after ``mark_steady()`` captures nothing."""
    _card()
    model, params, kw = _graph_model(case)
    eager, want, want_counts = _graph_serve(model, params, kw, False,
                                            batches=2)
    graphed, got, got_counts = _graph_serve(model, params, kw, None,
                                            batches=2)
    assert graphed.graphs and not eager.graphs
    assert got == want
    assert got_counts == want_counts and sum(got_counts.values()) > 0
    assert all(p.graph is not None for p in graphed._programs.values())
    assert graphed.program_cache_sizes() == eager.program_cache_sizes() \
        == {"step": 1, "mixed": 3}
    c = graphed.metrics.counters
    assert c["steady_compiles"].value == 0
    # one build a program: the 4 step programs, and a frontend model's
    # admission programs (seamless's encode, pixtral's embedding chunk a
    # slot), which program_cache_sizes leaves out as JAX's does
    frontend = {"pixtral": 3, "seamless_bf16": 1}.get(case, 0)
    assert len(graphed._programs) == 4 + frontend
    assert c["compiles_total"].value == 4 + frontend


@pytest.mark.cuda
def test_graph_steps_sample_as_eager_steps_with_a_temperature_on_card():
    """The engine's generator is registered with every graph: replays
    advance it as the eager calls do, so one seed gives one stream."""
    from repro_torch.serving.sampler import Sampler

    _card()
    model, params, kw = _graph_model("rings")
    sampler = Sampler(temperature=0.9, top_k=50)
    _, want, _ = _graph_serve(model, params, kw, False, sampler, batches=2)
    _, got, _ = _graph_serve(model, params, kw, None, sampler, batches=2)
    assert got == want
    assert len({t for toks in got.values() for t in toks}) > 5


#: speculative engines on graphs at reduced size: (a GRAPH_CASES
#: configuration, the speculative arguments)
SPEC_GRAPH_CASES = {
    "int8@1_rings": ("rings", dict(draft="int8@1", spec_gamma=4)),
    "int8@1_bf16_paged": ("rings_bf16", dict(draft="int8@1", spec_gamma=4,
                                             paged=True, page_size=8)),
    "ngram_rings": ("rings", dict(draft="ngram", spec_gamma=4)),
    "ngram_mamba2": ("mamba2", dict(draft="ngram", spec_gamma=4)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SPEC_GRAPH_CASES))
def test_spec_graph_steps_match_eager_steps_on_card(case):
    """A speculative engine's greedy tokens and launch counters on graphs
    equal its eager twin's; every program is a captured graph, the spec
    step and one admit chunk a slot that admitted; the second batch,
    after ``mark_steady()``, captures nothing."""
    _card()
    base, spec_kw = SPEC_GRAPH_CASES[case]
    model, params, kw = _graph_model(base)
    kw = dict(kw, **spec_kw)
    eager, want, want_counts = _graph_serve(model, params, kw, False,
                                            batches=2)
    graphed, got, got_counts = _graph_serve(model, params, kw, None,
                                            batches=2)
    assert graphed.graphs and not eager.graphs
    assert got == want
    assert got_counts == want_counts and sum(got_counts.values()) > 0
    assert all(p.graph is not None for p in graphed._programs.values())
    progs = graphed.program_cache_sizes()
    assert progs == eager.program_cache_sizes()
    assert set(progs) == {"step", "admit_chunk"} and progs["step"] == 1
    assert graphed.metrics.counters["steady_compiles"].value == 0
    assert graphed.metrics.counters["compiles_total"].value \
        == sum(progs.values())
    assert "spec" in graphed.step_kinds
    if kw.get("paged"):
        assert graphed.latency_stats()["kv_pages_live"] == 0


@pytest.mark.cuda
def test_spec_graph_steps_sample_as_eager_steps_with_a_temperature_on_card():
    """The spec step's draws (the draft's samples, the accept test, the
    resample) come from the engine's generator, registered with the
    graph: one seed gives one stream on graphs and eagerly."""
    from repro_torch.serving.sampler import Sampler

    _card()
    model, params, kw = _graph_model("rings")
    kw = dict(kw, draft="int8@1", spec_gamma=3)
    sampler = Sampler(temperature=0.9, top_k=50)
    _, want, _ = _graph_serve(model, params, kw, False, sampler, batches=2)
    _, got, _ = _graph_serve(model, params, kw, None, sampler, batches=2)
    assert got == want
    assert len({t for toks in got.values() for t in toks}) > 5


def _steady_engine(model, params, kw, **extra):
    """A graphed engine (three slots, chunks of 8) warmed until every
    slot admitted once, then marked steady."""
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request

    engine = Engine(model, params, max_batch=3, cache_len=64,
                    prefill_chunk=8, seed=0, **kw, **extra)
    for uid in range(3):
        engine.submit(Request(uid=1000 + uid, prompt=np.arange(5) + uid,
                              max_new_tokens=8))
    engine.run()
    assert engine.graphs
    assert engine.program_cache_sizes() == {"step": 1, "mixed": 3}
    engine.mark_steady()
    return engine


def _lifecycle_requests(model):
    from repro_torch.serving.request import Request

    rng = np.random.default_rng(1)
    return [Request(uid=uid, prompt=rng.integers(0, model.cfg.vocab, L),
                    max_new_tokens=16) for uid, L in enumerate((6, 11, 4, 9))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rings", "paged"])
def test_poisoned_row_is_contained_on_graphs_on_card(case):
    """The nan_logits fault on graphs: one row finishes with "error",
    every other stream equals a fault-free graphed run's, and poisoning
    and clearing the buffer (in place, outside the graphs) build no
    program."""
    from repro_torch.serving.faults import Faults

    _card()
    model, params, kw = _graph_model(case)
    clean = _steady_engine(model, params, kw, faults=False)
    for r in _lifecycle_requests(model):
        clean.submit(r)
    want = {u: list(r.tokens) for u, r in clean.run().items() if u < 1000}
    sched = Faults(seed=0)
    engine = _steady_engine(model, params, kw, faults=sched)
    progs = engine.program_cache_sizes()
    sched.on("nan_logits", step=engine._steps + 6, slot=1)
    for r in _lifecycle_requests(model):
        engine.submit(r)
    got = {u: r for u, r in engine.run().items() if u < 1000}
    errors = [u for u, r in got.items() if r.finish_reason == "error"]
    assert len(errors) == 1
    for u, r in got.items():
        if u not in errors:
            assert r.finish_reason == "length" and r.tokens == want[u], u
    assert got[errors[0]].tokens == want[errors[0]][:len(
        got[errors[0]].tokens)]
    assert engine.program_cache_sizes() == progs
    assert engine.metrics.counters["steady_compiles"].value == 0
    assert engine.latency_stats()["faults_injected"] == 1
    assert not bool(engine._poison.any())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rings", "paged"])
def test_cancel_of_an_active_slot_on_graphs_frees_it_on_card(case):
    """Cancelling a decoding stream on graphs polls, deactivates its row
    in place and frees the slot: the queued request takes that slot and
    streams as in a run without the cancel; nothing is captured."""
    _card()
    model, params, kw = _graph_model(case)
    clean = _steady_engine(model, params, kw)
    for r in _lifecycle_requests(model):
        clean.submit(r)
    want = {u: list(r.tokens) for u, r in clean.run().items() if u < 1000}
    engine = _steady_engine(model, params, kw)
    progs = engine.program_cache_sizes()
    for r in _lifecycle_requests(model):
        engine.submit(r)
    for _ in range(2):
        engine.tick(4)
    slot = next(b for b, r in enumerate(engine.slots)
                if r is not None and r.uid == 1)
    assert [r.uid for r in engine.queue] == [3]
    assert engine.cancel(1)
    assert not bool(engine.active[slot])
    engine.tick(2)                       # two chunks of 8: armed
    assert engine.slots[slot] is not None and engine.slots[slot].uid == 3
    got = engine.run()
    assert got[1].finish_reason == "cancelled"
    assert 0 < len(got[1].tokens) < 16
    assert got[1].tokens == want[1][:len(got[1].tokens)]
    for u in (0, 2, 3):
        assert got[u].finish_reason == "length" and got[u].tokens == want[u]
    assert engine.program_cache_sizes() == progs
    assert engine.metrics.counters["steady_compiles"].value == 0
    if case == "paged":
        assert engine.latency_stats()["kv_pages_live"] == 0


def _shared_head_requests(model):
    """Five requests behind one 16-token head (the last shares only its
    first 8 tokens: a partial hit), 8 new tokens each."""
    from repro_torch.serving.request import Request

    rng = np.random.default_rng(2)
    head = rng.integers(0, model.cfg.vocab, 16)
    tails = [rng.integers(0, model.cfg.vocab, n) for n in (5, 9, 3, 12)]
    prompts = [np.concatenate([head, t]) for t in tails]
    prompts.append(np.concatenate([head[:8],
                                   rng.integers(0, model.cfg.vocab, 14)]))
    return [Request(uid=u, prompt=p, max_new_tokens=8)
            for u, p in enumerate(prompts)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rings", "rings_bf16", "int8_kv", "paged"])
def test_prefix_hits_on_graphs_match_eager_and_cold_on_card(case):
    """Prefix-cache hits on a steady graphed engine: the head is copied
    into the slot in place (rings; int8 scales too) or aliased (pool)
    between replays, and every stream equals the eager engine's hot run
    and a cold graphed run; nothing is captured after warm-up, so the
    graphs read the copies through the cache's persistent leaves."""
    _card()
    model, params, kw = _graph_model(case)
    runs = {}
    for name, extra in (("cold", dict(prefix_cache_tokens=0)),
                        ("hot", dict(prefix_cache_tokens=256)),
                        ("eager", dict(prefix_cache_tokens=256,
                                       graphs=False))):
        if name == "eager":
            from repro_torch.serving.engine import Engine

            engine = Engine(model, params, max_batch=3, cache_len=64,
                            prefill_chunk=8, seed=0, **kw, **extra)
        else:
            engine = _steady_engine(model, params, kw, **extra)
        progs = engine.program_cache_sizes()
        for r in _shared_head_requests(model):
            engine.submit(r)
        got = {u: list(r.tokens) for u, r in engine.run().items()
               if u < 1000}
        runs[name] = (got, engine)
        if name != "eager":
            assert engine.program_cache_sizes() == progs
            assert engine.metrics.counters["steady_compiles"].value == 0
    assert runs["hot"][0] == runs["cold"][0] == runs["eager"][0]
    hot = runs["hot"][1]
    st = hot.latency_stats()
    assert st["prefix_hits"] == 4 and st["prefix_hit_tokens"] == 56
    if case == "paged":
        assert st["kv_alias_pages"] == 7 and st["kv_cow_splits"] == 0
        while hot.prefix_cache.drop_lru():
            pass
        assert hot._paged.live_pages == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["paged", "edge_paged_bf16"])
def test_forced_page_split_syncs_nothing_on_card(case):
    """A copy-on-write split forced on the card (an entry's pages aliased
    into a second slot, then a write over them): the pool pages are
    duplicated bitwise, and the split makes no host sync and no blocking
    copy (the page pairs go up from pinned memory)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _card()
    model, params, kw = _graph_model(case)
    engine = _steady_engine(model, params, kw, prefix_cache_tokens=256)
    engine.submit(_shared_head_requests(model)[0])
    engine.run()
    (pages,) = engine.prefix_cache.entries()
    st = engine._paged
    st.release_slot(2)
    st.alias_prefix(2, pages)
    before = {k: engine.cache["sub0"][k][:, pages].clone()
              for k in ("kp", "vp", "kp_scale", "vp_scale")
              if k in engine.cache["sub0"]}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        assert engine._provision(2, 0, 16)
    torch.cuda.synchronize()
    calls = {e.key: e.count for e in prof.key_averages()
             if e.device_type == DeviceType.CPU}
    assert st.cow_splits == 2
    # (the profiler's own stop syncs the device once: not counted here)
    assert calls.get("cudaMemcpyAsync", 0) >= 1    # the runtime was seen
    assert calls.get("cudaStreamSynchronize", 0) == 0
    assert calls.get("cudaMemcpy", 0) == 0
    new = [int(p) for p in st.block_tables[2, :2]]
    assert set(new).isdisjoint(pages)
    for k, want in before.items():
        assert torch.equal(engine.cache["sub0"][k][:, new], want), k
    st.release_slot(2)
    st.check_invariants([pages])


# --------------------------------------------------------------------- #
# the Zoo's service programs as CUDA graphs
# --------------------------------------------------------------------- #
def _card_classifier(dtype, seed=0):
    """The reduced pixtral-12b classifier (10 classes) ``>>`` its label
    decoder on the card in ``dtype`` (fp32 runs the f32 flash route),
    weights from ``seed``, and an embeddings batch (B 2, 16 tokens)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import zoo_builders as zb

    cfg = get_arch("pixtral-12b", variant="reduced")
    if dtype == torch.bfloat16:
        cfg = cfg.replace(dtype="bfloat16", param_dtype="bfloat16")
    clf = zb.classifier_service_for(cfg, 10, arch="pixtral-12b")
    clf = clf.with_params(clf.metadata["init_params"](seed, "cuda"))
    x = np.random.default_rng(seed).normal(0, 1, (2, 16, 64))
    return clf >> zb.label_decoder(10), {"embeddings": torch.from_numpy(
        x.astype(np.float32)).to("cuda", dtype)}


def _same_tree(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same_tree(a[k], b[k]) for k in a)
    return torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_captured_service_matches_its_eager_call_on_card(dtype):
    """``Service.jitted()`` on the card: the first call warms up and
    captures once; replays equal the eager call bitwise (the same
    kernels on the same inputs), for the first inputs and for new input
    values, which give new outputs; nothing is captured after the first
    call, and every output is a fresh tensor."""
    from repro_torch.core.program import ServiceProgram

    _card()
    svc, x = _card_classifier(dtype)
    x2 = {"embeddings": torch.flip(x["embeddings"], dims=(0,)) * 0.5}
    prog = svc.jitted()
    assert isinstance(prog, ServiceProgram)
    want, want2 = svc(x), svc(x2)
    outs = [prog(svc.params, x) for _ in range(3)]
    assert prog.cache_size() == 1 and prog.pool_bytes > 0
    got2 = prog(svc.params, x2)
    assert prog.cache_size() == 1
    assert all(_same_tree(o, want) for o in outs)
    assert _same_tree(got2, want2)
    assert not torch.equal(want["confidence"], want2["confidence"])
    assert len({o["confidence"].data_ptr() for o in outs}) == 3


@pytest.mark.cuda
def test_captured_ssm_lm_replays_the_mma_route_bitwise_on_card():
    """``model.lm`` on mamba2-780m at full width cut to 2 layers, bf16,
    B 1, 256 tokens: the SSD dual form runs its ``mma`` route (three
    launches, the last two programmatic dependents) inside the graph,
    and the replays equal the eager call bitwise, launch counts
    included."""
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.core import zoo_builders as zb
    from repro_torch.kernels.ssd_scan.kernel import chunk_plan
    from repro_torch.models.transformer import init_transformer

    _card()
    cfg = get_arch("mamba2-780m").replace(n_layers=2)
    s = cfg.ssm
    h = s.expand * cfg.d_model // s.head_dim
    assert chunk_plan(1, 256, h, s.head_dim, s.d_state, s.chunk,
                      torch.bfloat16).route == "mma"
    lm = zb.lm_service_for(cfg, arch="mamba2-780m")
    params = init_transformer(cfg, 0, "cuda")
    toks = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, 256)).astype(np.int32)).cuda()}
    kernels.reset_launch_counts()
    want = lm(toks, params=params)
    eager = kernels.launch_counts()
    prog = lm.jitted()
    for _ in range(3):
        assert torch.equal(prog(params, toks), want)
    got = kernels.launch_counts()
    assert eager["ssd"] == 2
    assert got == {k: 4 * v for k, v in eager.items()}
    assert prog.cache_size() == 1


@pytest.mark.cuda
def test_deployed_route_matches_the_undeployed_one_on_card():
    """pre >> route(sel, [small, big]) on the card, deployed all local
    (one group, which the program splits around the route) and split
    after its first stage: both branches, twice each, equal the eager
    undeployed call; the captures stop growing once both branches ran."""
    from repro_torch.core import compose
    from repro_torch.core.deploy import DeploymentPlan, deploy
    from repro_torch.core.netmodel import NetworkModel
    from repro_torch.core.service import (Service, Signature, TensorSpec,
                                          service_from_fn)

    _card()
    g = torch.Generator().manual_seed(0)

    def linear(name, d_in, d_out):
        w = (torch.randn(d_in, d_out, generator=g) * 0.1).cuda()
        return service_from_fn(name, lambda p, x: x @ p["w"],
                               torch.zeros(4, d_in, device="cuda"),
                               params={"w": w})

    small, big = linear("small", 8, 4), linear("big", 8, 4)
    # pre doubles its input, so the selector sees the input's sign
    pre = service_from_fn("pre", lambda p, x: x @ p["w"],
                          torch.zeros(4, 8, device="cuda"),
                          params={"w": 2 * torch.eye(8, device="cuda")})
    sel = Service(name="sel", fn=lambda p, x: (x.mean() > 0).to(torch.int32),
                  signature=Signature(small.signature.inputs,
                                      TensorSpec((), "int32")))
    svc = pre >> compose.route(sel, [small, big])
    stages = [pre, svc.parts[1]]
    deps = [deploy(svc, DeploymentPlan.all_local(svc), stages=stages),
            deploy(svc, DeploymentPlan.split(svc, 1, NetworkModel(seed=0)),
                   stages=stages)]
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (4, 8)).astype(np.float32)).cuda()
    for sign in (1.0, -1.0, 1.0, -1.0):
        xs = sign * x.abs()
        want = svc(xs)
        for dep in deps:
            out, _ = dep.call(xs)
            assert torch.equal(out, want)
    sizes = [sum(fn.cache_size() for _, fn, _ in dep._compiled.values())
             for dep in deps]
    assert sizes == [3, 4]     # head + 2 branches; pre, head + 2 branches


@pytest.mark.cuda
def test_a_new_params_tree_is_a_new_capture_on_card():
    """A graph reads fixed addresses: another params tree (new weights
    from another seed) is another capture, whose replays give the new
    weights' output; the first tree's capture still replays its own."""
    _card()
    svc, x = _card_classifier(torch.bfloat16)
    other, _ = _card_classifier(torch.bfloat16, seed=1)
    prog = svc.jitted()
    want, want_other = svc(x), other(x)
    assert not torch.equal(want["confidence"], want_other["confidence"])
    for _ in range(2):
        assert _same_tree(prog(svc.params, x), want)
        assert _same_tree(prog(other.params, x), want_other)
    assert prog.cache_size() == 2


@pytest.mark.cuda
def test_a_captured_call_under_grad_mode_raises_on_card():
    _card()
    svc, x = _card_classifier(torch.float32)
    params = {"stage0": {"backbone": svc.params["stage0"]["backbone"],
                         "head": {"w": svc.params["stage0"]["head"]["w"]
                                  .clone().requires_grad_()}},
              "stage1": None}
    prog = svc.jitted()
    with pytest.raises(RuntimeError, match="make_train_step"):
        prog(params, x)
    assert prog.cache_size() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("replays", [1, 4])
def test_replays_count_their_capture_launches_on_card(replays):
    """After the warm-up and N replays the launch counters hold N + 1
    times one forward's: 2 flash attentions and 2 n_layers + 1 norms."""
    from repro_torch import kernels

    _card()
    svc, x = _card_classifier(torch.bfloat16)
    prog = svc.jitted()
    kernels.reset_launch_counts()
    for _ in range(replays + 1):
        prog(svc.params, x)
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    assert counts == {"flash_attention": 2 * (replays + 1),
                      "rmsnorm": 5 * (replays + 1)}


#: the fleet's replicas on the card: two slots, chunks of 8, a pool of
#: 8-token pages and a prefix cache (``tests/test_fleet.py``'s arguments)
FLEET_EK = dict(max_batch=2, cache_len=64, prefill_chunk=8,
                prefix_cache_tokens=256, paged=True, page_size=8)


def _fleet_requests(model, n, uid0=0):
    from repro_torch.serving.request import Request

    rng = np.random.default_rng(23)
    head = rng.integers(0, model.cfg.vocab, 16)
    out = []
    for i in range(n):
        body = rng.integers(0, model.cfg.vocab, int(rng.integers(4, 12)))
        out.append(Request(uid=uid0 + i, max_new_tokens=16,
                           prompt=np.concatenate([head, body]) if i % 2
                           else body))
    return out


def _warm_replica(engine, uid0=-100):
    """Admit into both slots once: every program captured."""
    from repro_torch.serving.request import Request

    for i in range(2):
        engine.submit(Request(uid=uid0 - i, prompt=np.arange(5) + i,
                              max_new_tokens=4))
    engine.run()
    assert engine.program_cache_sizes() == {"step": 1, "mixed": 2}


@pytest.mark.cuda
def test_fleet_crash_failover_matches_one_engine_on_card():
    """A 2-replica fleet on graphs (fp32, reduced) through a
    ``replica_crash``: every stream, the migrated ones included, equals
    one graphed engine's tokens, and the warmed survivor captures
    nothing after ``reset_stats``."""
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.fleet import DEAD, Fleet
    from repro_torch.serving.sampler import Sampler

    _card()
    model, params, _ = _graph_model("rings")
    one = Engine(model, params, sampler=Sampler(), **FLEET_EK)
    for r in _fleet_requests(model, 6):
        one.submit(r)
    want = {u: list(r.tokens) for u, r in one.run().items()}
    fl = Fleet(model, params, replicas=2, faults="replica_crash@2/0",
               degrade_factor=1e9,
               engine_kwargs=dict(FLEET_EK, sampler=Sampler()))
    for rep in fl.replicas:
        _warm_replica(rep.engine)
    fl.reset_stats()
    for r in _fleet_requests(model, 6):
        fl.submit(r)
    got = fl.run()
    st = fl.latency_stats()
    assert fl.replicas[0].state == DEAD and st["requests_migrated"] >= 1
    assert all(r.finish_reason == "length" for r in got.values())
    assert {u: list(r.tokens) for u, r in got.items()} == want
    assert fl.steady_compiles()[1] == 0
    assert fl.replicas[1].engine.program_cache_sizes() == \
        {"step": 1, "mixed": 2}
    assert all(p.graph is not None
               for p in fl.replicas[1].engine._programs.values())


@pytest.mark.cuda
def test_fleet_rejoin_frees_the_replaced_engine_on_card():
    """Two drain / rejoin cycles of replica 0: ``memory_allocated()``
    after the second rejoin's warm-up equals its value after the first
    to within less than the replaced engine's cache: its cache, graphs
    and graph pool are freed. (That no reference or cycle is left is
    held on the CPU, ``tests/test_torch_fleet.py``.)"""
    from repro_torch.serving.fleet import DRAINED, Fleet
    from repro_torch.serving.sampler import Sampler

    _card()
    model, params, _ = _graph_model("rings")
    fl = Fleet(model, params, replicas=2, degrade_factor=1e9,
               engine_kwargs=dict(FLEET_EK, sampler=Sampler()))
    for r in _fleet_requests(model, 4):
        fl.submit(r)
    fl.run()
    mem, leak = [], 0
    for cycle in range(2):
        fl.drain(0)
        fl.tick()                        # an idle replica parks at a tick
        assert fl.replicas[0].state == DRAINED
        leak = sum(t.nbytes for t in
                   _cache_leaves(fl.replicas[0].engine.cache))
        fl.rejoin(0)
        _warm_replica(fl.replicas[0].engine, uid0=-100 - 10 * cycle)
        torch.cuda.synchronize()
        mem.append(torch.cuda.memory_allocated())
    assert leak > 0 and abs(mem[1] - mem[0]) < leak


def _cache_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _cache_leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


@pytest.mark.cuda
def test_a_failed_train_capture_raises_on_card():
    """A loss that reads the host runs in the warm-up, then the step's
    capture raises, naming the step, on every later call: no fall back
    to eager, nothing captured, the state left at the warm-up's step."""
    from repro_torch.training.train_loop import make_train_step

    dev = _card()
    model, opt, state0, batches = _graph_train_setup(dev, "llama3.2-1b")

    class _Reads:
        device, cfg = model.device, model.cfg

        @staticmethod
        def train_loss(params, batch):
            loss, metrics = model.train_loss(params, batch)
            float(loss.detach())                      # a host sync
            return loss, metrics

    step = make_train_step(_Reads(), opt)
    s, _ = step(state0, batches[0])
    for batch in batches[1:3]:
        with pytest.raises(RuntimeError,
                           match="the train step of llama3.2-1b.*capture"):
            step(s, batch)
        assert step.cache_size() == 0
    assert int(step.state["step"]) == 1 and step.calls == 1
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_a_failed_capture_raises_on_card(monkeypatch):
    """A body that syncs the host cannot be captured: the engine raises
    and does not fall back to eager. (Last in the module: the capture
    is left invalid.)"""
    from repro_torch.serving import engine as engine_mod

    _card()
    model, params, kw = _graph_model("rings")
    real = engine_mod._guarded_sample

    def syncing(sampler, gen, logits):
        float(logits.sum())                       # a host sync
        return real(sampler, gen, logits)

    monkeypatch.setattr(engine_mod, "_guarded_sample", syncing)
    with pytest.raises(RuntimeError):
        _graph_serve(model, params, kw, None)
    torch.cuda.synchronize()
