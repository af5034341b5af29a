"""The port's CUDA and Triton kernels against their plain PyTorch
versions, on the card.

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
exactly on the same logical data, on every route.
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
            y, t = norm_kernel.fused_rmsnorm_triton(x, res, s)
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
    # the SSD kernels: max|kernel - plain| <= 1e-4 * max|plain| (f32
    # arithmetic, sums in another order); the extend kernel bitwise
    # compositional, identity at dt = 0, and ssd_step its T = 1 launch
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
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
    for b, T, h, p, g, n in ((8, 1, 48, 64, 1, 128), (1, 37, 48, 64, 1, 128),
                             (2, 5, 16, 32, 2, 32)):
        x, dt_, A, Bm, Cm, D = ssd_inputs(b, T, h, p, g, n)
        s0 = torch.randn((b, h, p, n), generator=g_, device=dev)
        y, s = ssd_kernel.ssd_extend_cuda(s0, x, dt_, A, Bm, Cm, D)
        y0, s1 = ssd_ref.ssd_extend_reference(s0, x, dt_, A, Bm, Cm, D)
        assert rel(y, y0) <= 1e-4 and rel(s, s1) <= 1e-4
        t1 = T // 2
        if t1:
            ya, sa = ssd_kernel.ssd_extend_cuda(
                s0, x[:, :t1], dt_[:, :t1], A, Bm[:, :t1], Cm[:, :t1], D)
            yb, sb = ssd_kernel.ssd_extend_cuda(
                sa, x[:, t1:], dt_[:, t1:], A, Bm[:, t1:], Cm[:, t1:], D)
            assert torch.equal(torch.cat([ya, yb], 1), y)
            assert torch.equal(sb, s)
        # x whose last dimension is not contiguous (as an einsum may
        # leave the conv output) is copied by the wrapper
        xt = x[:, 0].transpose(1, 2).contiguous().transpose(1, 2)
        ys, ss = ssd_ops.ssd_step(s0, xt, dt_[:, 0], A, Bm[:, 0],
                                  Cm[:, 0], D)
        yk, sk = ssd_kernel.ssd_extend_cuda(s0, x[:, :1], dt_[:, :1], A,
                                            Bm[:, :1], Cm[:, :1], D)
        assert torch.equal(ys, yk[:, 0]) and torch.equal(ss, sk)
        state, ckpt = s0.clone(), torch.empty_like(s0)
        ssd_kernel.ssd_extend_cuda(state, x, torch.zeros_like(dt_), A, Bm,
                                   Cm, D, out=state, ckpt=ckpt)
        assert torch.equal(state, s0) and torch.equal(ckpt, s0)
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
