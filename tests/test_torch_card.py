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
refuses a backward pass: an input that requires grad gives outputs whose
backward raises, and none gives the same outputs with no autograd node.
The serving engine's step programs run as CUDA graphs: greedy tokens,
temperature samples and launch counters equal the eager engine's at
reduced sizes (rings, bf16, paged, int8 KV, int8 weights, the edge
profile paged, mamba2), nothing is captured after warm-up, and a capture
that fails raises; on graphs a poisoned row is contained to that row and
a cancel frees its slot, neither building a program. The Zoo's service programs (``Service.jitted()``,
the deployed call) replay the eager call bitwise (the reduced
classifier in fp32 and bf16, mamba2's ``model.lm`` on the SSD ``mma``
route), a route runs as segments, another params tree is another
capture, grad mode raises, and replays count their capture's launches.
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
NORM_D = (1536, 2048, 3072, 5120)
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


GRAD_OPS = ("rmsnorm_add", "rmsnorm_norm", "rmsnorm_gated",
            "quant_matmul_int8", "quant_matmul_int4", "ssd", "ssd_extend",
            "ssd_step", "decode_attention", "paged_decode_attention",
            "flash_attention")


@pytest.mark.cuda
@pytest.mark.parametrize("op", GRAD_OPS)
def test_kernel_op_refuses_a_backward_on_card(op):
    """With no gradient asked for, the op launches straight: no autograd
    node on its outputs. With its first input requiring grad it returns
    the same outputs, bit for bit, through a node whose backward raises
    (naming ROADMAP item 12) instead of giving the inputs no gradient."""
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
    with pytest.raises(NotImplementedError, match="item 12"):
        got[0].float().sum().backward()


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
}


def _graph_model(case):
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build
    from repro_torch.quant import quantize_for_cfg

    variant, changes, kw = GRAPH_CASES[case]
    arch = "mamba2-780m" if case == "mamba2" else "llama3.2-1b"
    cfg = get_arch(arch, variant=variant).replace(**changes)
    model = build(cfg, device="cuda")
    return model, quantize_for_cfg(model.init(0), cfg), kw


def _graph_serve(model, params, kw, graphs, sampler=None, batches=1):
    """Five requests on three slots (chunks of 8), ``batches`` times;
    returns the engine, the tokens by uid and the launch counters of the
    run, set to 0 just before it."""
    from repro_torch import kernels
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request

    engine = Engine(model, params, max_batch=3, cache_len=64,
                    prefill_chunk=8, sampler=sampler, seed=0,
                    graphs=graphs, **kw)
    rng = np.random.default_rng(0)
    kernels.reset_launch_counts()
    for batch in range(batches):
        for uid in range(5 * batch, 5 * batch + 5):
            engine.submit(Request(
                uid=uid, prompt=rng.integers(0, model.cfg.vocab,
                                             int(rng.integers(3, 30))),
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
    assert c["compiles_total"].value == 4


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
    with pytest.raises(RuntimeError, match="item 12"):
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
