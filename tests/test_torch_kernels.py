"""The PyTorch port's kernel ops against the JAX package.

On the CPU each op runs its plain PyTorch version; it is held against the
JAX oracle (``ref.py``) and the Pallas kernel in interpret mode on the
same inputs, made with numpy from a seed. The CUDA/Triton kernels run
only on a card: ``test_kernels_match_plain_on_card`` carries the
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
from repro_torch.kernels.rmsnorm import kernel as norm_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as norm_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as norm_ref  # noqa: E402

S = 48
HD = 16
HKV = 2


def _decode_inputs(B, T, G, *, seed, masked_row=False, dtype=np.float32):
    """q (B, T, Hq, hd), cache-layout k/v (B, S, Hkv, hd), pos (B, S) and
    q_pos (B, T) as int32: row b sits at a random depth, holds positions
    0..depth+T-1 in their slots and -1 past them."""
    rng = np.random.default_rng(seed)
    Hq = G * HKV
    q = rng.normal(size=(B, T, Hq, HD)).astype(dtype)
    k = rng.normal(size=(B, S, HKV, HD)).astype(dtype)
    v = rng.normal(size=(B, S, HKV, HD)).astype(dtype)
    depth = rng.integers(0, S - T + 1, B)
    slots = np.arange(S)[None]
    pos = np.where(slots < (depth + T)[:, None], slots, -1).astype(np.int32)
    if masked_row:
        pos[0] = -1
    q_pos = (depth[:, None] + np.arange(T)[None]).astype(np.int32)
    return q, k, v, pos, q_pos


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
                                                  masked_row=masked))
            q, k, v = q.to(dt), k.to(dt), v.to(dt)
            got = dec_kernel.decode_attention_cuda(q, k, v, pos, q_pos,
                                                   window=window)
            want = dec_ref.decode_attention_reference(q, k, v, pos, q_pos,
                                                      window=window)
            assert (got.float() - want.float()).abs().max().item() <= tol
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        x = torch.randn(16, 2048, device=dev).to(dt)
        r = torch.randn(16, 2048, device=dev).to(dt)
        s = torch.rand(2048, device=dev).to(dt)
        for res in (r, None):
            y, t = norm_kernel.fused_rmsnorm_triton(x, res, s)
            y0, t0 = norm_ref.fused_rmsnorm_reference(x, res, s)
            assert (y.float() - y0.float()).abs().max().item() <= tol
            assert (t.float() - t0.float()).abs().max().item() <= tol
