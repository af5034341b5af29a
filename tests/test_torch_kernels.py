"""The PyTorch port's kernel ops against the JAX package.

On the CPU each op runs its plain PyTorch version; it is held against the
JAX oracle (``ref.py``) and the Pallas kernel in interpret mode on the
same inputs, made with numpy from a seed. The CUDA/Triton kernels run
only on a card: ``test_kernels_match_plain_on_card`` (decode attention,
both layouts, RMSNorm and the dequantize-matmuls) carries the
``cuda`` marker and skips without one (``python3 chip_smoke.py`` holds
them at full width).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.kernel import \
    decode_attention_pallas  # noqa: E402
from repro.kernels.decode_attention.ref import \
    decode_attention_reference as jax_decode_ref  # noqa: E402
from repro.kernels.rmsnorm.kernel import fused_rmsnorm_pallas  # noqa: E402
from repro.kernels.rmsnorm.ref import \
    fused_rmsnorm_reference as jax_rmsnorm_ref  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as dec_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as dec_ref  # noqa: E402
from repro_torch.kernels.quant_matmul import kernel as qmm_kernel  # noqa: E402
from repro_torch.kernels.quant_matmul import ref as qmm_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as norm_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as norm_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as norm_ref  # noqa: E402

S = 48
HD = 16
HKV = 2


def _decode_inputs(B, T, G, *, seed, masked_row=False, dtype=np.float32,
                   hd=HD):
    """q (B, T, Hq, hd), cache-layout k/v (B, S, Hkv, hd), pos (B, S) and
    q_pos (B, T) as int32: row b sits at a random depth, holds positions
    0..depth+T-1 in their slots and -1 past them."""
    rng = np.random.default_rng(seed)
    Hq = G * HKV
    q = rng.normal(size=(B, T, Hq, hd)).astype(dtype)
    k = rng.normal(size=(B, S, HKV, hd)).astype(dtype)
    v = rng.normal(size=(B, S, HKV, hd)).astype(dtype)
    depth = rng.integers(0, S - T + 1, B)
    slots = np.arange(S)[None]
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
    B, S = k.shape[:2]
    nb = S // ps
    P = B * nb + 2
    g = torch.Generator().manual_seed(seed)
    bt = torch.randperm(P, generator=g)[:B * nb].reshape(B, nb)
    kp = torch.randn((P + 1, ps) + tuple(k.shape[2:]), generator=g).to(
        device=k.device, dtype=k.dtype)
    vp = torch.randn_like(kp)
    kp[bt.to(k.device)] = k.reshape(B, nb, ps, *k.shape[2:])
    vp[bt.to(k.device)] = v.reshape(B, nb, ps, *v.shape[2:])
    return kp, vp, bt.to(device=k.device, dtype=torch.int32)


def _jax_heads(x):
    """(B, S, Hkv, hd) cache layout -> the JAX kernel's (B, Hkv, S, hd)."""
    return jnp.transpose(jnp.asarray(x), (0, 2, 1, 3))


_jax_decode = jax.jit(jax_decode_ref, static_argnames="window")
_jax_rmsnorm = jax.jit(jax_rmsnorm_ref)


def _port_decode(q, k, v, pos, q_pos, window=0):
    return dec_ops.cached_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos), torch.from_numpy(q_pos), window=window)


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("T", [1, 4, 8])
def test_decode_attention_plain_matches_jax_ref(T, G, window):
    q, k, v, pos, q_pos = _decode_inputs(3, T, G, seed=T * 10 + G + window)
    got = _port_decode(q, k, v, pos, q_pos, window)
    want = _jax_decode(jnp.asarray(q), _jax_heads(k), _jax_heads(v),
                       jnp.asarray(pos), jnp.asarray(q_pos), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("T,G,window", [(1, 4, 0), (8, 1, 16), (4, 4, 16)])
def test_decode_attention_plain_matches_pallas_interpret(T, G, window):
    q, k, v, pos, q_pos = _decode_inputs(3, T, G, seed=T + G + window)
    got = _port_decode(q, k, v, pos, q_pos, window)
    pal = decode_attention_pallas(
        jnp.asarray(q), _jax_heads(k), _jax_heads(v), jnp.asarray(pos),
        jnp.asarray(q_pos), window=window, bk=16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pal), atol=1e-5,
                               rtol=0)


def test_decode_attention_fully_masked_row_is_mean_v():
    """A row whose every slot is masked (a freshly reset or idle slot in
    a mixed step) gives the mean of V over the slots, not zeros or NaN,
    in the port and in both JAX versions."""
    q, k, v, pos, q_pos = _decode_inputs(2, 4, 4, seed=7, masked_row=True)
    got = _port_decode(q, k, v, pos, q_pos).numpy()
    mean_v = np.repeat(v[0].mean(0), 4, axis=0)             # (Hq, hd)
    np.testing.assert_allclose(got[0], np.broadcast_to(mean_v, got[0].shape),
                               atol=1e-5, rtol=0)
    pal = decode_attention_pallas(
        jnp.asarray(q), _jax_heads(k), _jax_heads(v), jnp.asarray(pos),
        jnp.asarray(q_pos), bk=16, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pal), atol=1e-5, rtol=0)


def test_decode_attention_bf16_matches_jax():
    q, k, v, pos, q_pos = _decode_inputs(2, 4, 4, seed=11)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = dec_ops.cached_decode_attention(tq, tk, tv, torch.from_numpy(pos),
                                          torch.from_numpy(q_pos))
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = _jax_decode(jq, jnp.transpose(jk, (0, 2, 1, 3)),
                          jnp.transpose(jv, (0, 2, 1, 3)), jnp.asarray(pos),
                          jnp.asarray(q_pos))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=0)


def test_decode_attention_base_position_expands_per_query():
    """q_pos given as the (B,) base expands to base + t, as the JAX op."""
    q, k, v, pos, q_pos = _decode_inputs(2, 4, 2, seed=3)
    args = [torch.from_numpy(x) for x in (q, k, v, pos)]
    full = dec_ops.cached_decode_attention(*args, torch.from_numpy(q_pos))
    base = dec_ops.cached_decode_attention(
        *args, torch.from_numpy(q_pos[:, 0].copy()))
    assert torch.equal(full, base)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("N,d", [(8, 128), (16, 256)])
@pytest.mark.parametrize("with_res", [True, False])
def test_rmsnorm_plain_matches_jax(N, d, with_res, dtype, tol):
    rng = np.random.default_rng(N + d)
    x = rng.normal(size=(N, d)).astype(np.float32)
    r = rng.normal(size=(N, d)).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    y, t = norm_ops.fused_rmsnorm(
        torch.from_numpy(x).to(tdt),
        torch.from_numpy(r).to(tdt) if with_res else None,
        torch.from_numpy(scale).to(tdt))
    jr = jnp.asarray(r, jdt) if with_res else jnp.zeros((N, d), jdt)
    wants = [_jax_rmsnorm(jnp.asarray(x, jdt), jr, jnp.asarray(scale, jdt))]
    if N == 8 and with_res:   # the Pallas kernel in interpret mode
        wants.append(fused_rmsnorm_pallas(jnp.asarray(x, jdt), jr,
                                          jnp.asarray(scale, jdt), bn=8,
                                          interpret=True))
    for want_y, want_t in wants:
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(want_y, np.float32), atol=tol,
                                   rtol=0)
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(want_t, np.float32), atol=tol,
                                   rtol=0)


def test_rmsnorm_leading_axes_and_no_residual_passthrough():
    x = torch.randn(2, 3, 64, generator=torch.Generator().manual_seed(0))
    scale = torch.ones(64)
    y, t = norm_ops.fused_rmsnorm(x, None, scale)
    assert t is x and y.shape == x.shape
    y2, _ = norm_ref.fused_rmsnorm_reference(x.reshape(6, 64), None, scale)
    assert torch.equal(y.reshape(6, 64), y2)


# --------------------------------------------------------------------- #
# dispatch: CUDA -> kernel, CPU -> plain version, nothing else
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("ps", [8, 16])
def test_paged_plain_equals_contiguous_plain(ps):
    """The same logical K/V scattered over permuted pages gives exactly
    the contiguous op's output (the paged op gathers, then defers)."""
    q, k, v, pos, q_pos = (torch.from_numpy(a) for a in
                           _decode_inputs(3, 4, 4, seed=ps, masked_row=True))
    kp, vp, bt = _paged_from_contiguous(k, v, ps, seed=ps)
    got = dec_ops.paged_decode_attention(q, kp, vp, bt, pos, q_pos,
                                         window=16)
    want = dec_ops.cached_decode_attention(q, k, v, pos, q_pos, window=16)
    assert torch.equal(got, want)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernel launched for CPU tensors")
    monkeypatch.setattr(dec_kernel, "decode_attention_cuda", boom)
    monkeypatch.setattr(norm_kernel, "fused_rmsnorm_triton", boom)
    q, k, v, pos, q_pos = (torch.from_numpy(a) for a in
                           _decode_inputs(1, 1, 1, seed=0))
    dec_ops.cached_decode_attention(q, k, v, pos, q_pos)
    norm_ops.fused_rmsnorm(torch.ones(2, 8), torch.ones(2, 8), torch.ones(8))


def test_dispatch_rejects_other_devices():
    meta = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="all on CUDA or all on the CPU"):
        dispatch.use_kernel(meta)
    with pytest.raises(ValueError):
        norm_ops.fused_rmsnorm(meta, None, torch.ones(8))


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA and Triton wrappers launch or raise: handed CPU tensors
    they raise before building or importing anything."""
    q, k, v, pos, q_pos = (torch.from_numpy(a) for a in
                           _decode_inputs(1, 1, 1, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        dec_kernel.decode_attention_cuda(q, k, v, pos, q_pos)
    with pytest.raises(ValueError, match="CUDA"):
        norm_kernel.fused_rmsnorm_triton(torch.ones(2, 8), None,
                                         torch.ones(8))


# --------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------- #
@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    dev = torch.device("cuda")
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
    # the dequantize-matmuls: ragged M and N, K split or not, an odd int4
    # group (K 34, gs 17); max|kernel - plain| <= tol * max|plain|
    from repro_torch.quant import quantize_tensor
    g = torch.Generator(device=dev).manual_seed(0)
    for M, K, N, gs in ((1, 2048, 512, 32), (37, 256, 200, 32),
                        (8, 34, 48, 32), (128, 512, 384, 64)):
        w = 0.05 * torch.randn((K, N), generator=g, device=dev)
        for bits in (8, 4):
            qt = quantize_tensor(w, bits=bits, group_size=gs)
            for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
                x = torch.randn((M, K), generator=g, device=dev).to(dt)
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
