"""The PyTorch port's kernel ops against the JAX package.

On the CPU each op runs its plain PyTorch version; it is held against the
JAX oracle (``ref.py``) and the Pallas kernel in interpret mode on the
same inputs, made with numpy from a seed. The CUDA/Triton kernels run
only on a card: their tests live in ``tests/test_torch_card.py``, which
imports no JAX so that it runs on the card's machine
(``python3 chip_smoke.py`` holds them at full width too).
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
# the kernel's route and split, held on the CPU
# --------------------------------------------------------------------- #
def test_plan_routes_of_the_main_path():
    """llama3.2-1b's shapes (Hq 32, Hkv 8, hd 64, S 1024): a chunk of 128
    takes the row-tiled tensor-core route, a decode step at B 8 the
    key-split one on at least 132 blocks, B 1 more splits than B 8, and
    fp32 the CUDA-core route unsplit."""
    bf, f32 = torch.bfloat16, torch.float32
    chunk = dec_kernel.plan(1, 128, 32, 8, 1024, 64, bf)
    assert chunk.path == "mma_rows" and chunk.rows == 64
    assert chunk.row_blocks == 8 and chunk.blocks >= 132
    dec8 = dec_kernel.plan(8, 1, 32, 8, 1024, 64, bf)
    assert dec8.path == "mma_keys" and dec8.blocks >= 132
    assert dec8.blocks == 8 * 8 * dec8.splits and dec8.splits > 1
    dec1 = dec_kernel.plan(1, 1, 32, 8, 1024, 64, bf)
    assert dec1.path == "mma_keys" and dec1.splits > dec8.splits
    for T in (1, 128):
        p = dec_kernel.plan(8, T, 32, 8, 1024, 64, f32)
        assert p.path == "simt" and p.splits == 1 and p.per == 1024


@pytest.mark.parametrize("T,G,path", [(3, 4, "mma_keys"),
                                      (4, 4, "mma_keys"),
                                      (5, 4, "mma_rows"),
                                      (16, 1, "mma_keys"),
                                      (17, 1, "mma_rows")])
def test_plan_route_threshold(T, G, path):
    """R = T * G rows a sequence: one 16-row tile up to 16, 64-row tiles
    above."""
    p = dec_kernel.plan(4, T, G * 8, 8, 1024, 64, torch.bfloat16)
    assert p.path == path
    assert p.row_blocks == -(-T * G // p.rows)


@pytest.mark.parametrize("B,T,S", [(8, 1, 1024), (8, 1, 1000), (1, 1, 1000),
                                   (1, 128, 1000), (3, 7, 48), (2, 1, 65),
                                   (64, 1, 4096), (1, 1, 64)])
def test_plan_splits_cover_s_in_whole_tiles(B, T, S):
    """Every split is non-empty, covers whole 64-slot tiles but the last,
    and together they cover S exactly once; the block count is the grid
    the kernel launches."""
    p = dec_kernel.plan(B, T, 32, 8, S, 64, torch.bfloat16)
    assert 1 <= p.splits <= dec_kernel.MAX_SPLITS
    if p.splits > 1:
        assert p.per % dec_kernel.BK == 0
    assert p.per * (p.splits - 1) < S <= p.per * p.splits
    assert p.blocks == B * 8 * p.row_blocks * p.splits
    if S == 1000 and p.splits > 1:
        assert S % p.per, "the last split of S 1000 is ragged"


def _split_model(q, k, v, pos, q_pos, window, per):
    return dec_ref.decode_attention_split_reference(
        *(torch.from_numpy(a) for a in (q, k, v, pos, q_pos)),
        window=window, per=per)


@pytest.mark.parametrize("per", [16, 20, 48])
@pytest.mark.parametrize("T,G,window", [(1, 4, 0), (4, 4, 16), (8, 1, 0)])
def test_split_combine_matches_one_pass_and_jax(T, G, window, per):
    """The split-and-combine arithmetic of the kernel's split route
    (splits of 16 or 20 slots over S 48: the last ragged at 20; rows at
    random depths leave whole splits masked; row 0 fully masked) gives
    the one-pass plain version and the JAX oracle within fp32 rounding
    (1e-5: the same f32 sums, regrouped by split)."""
    q, k, v, pos, q_pos = _decode_inputs(3, T, G, seed=per + T + G,
                                         masked_row=True)
    got = _split_model(q, k, v, pos, q_pos, window, per)
    one = _port_decode(q, k, v, pos, q_pos, window)
    want = _jax_decode(jnp.asarray(q), _jax_heads(k), _jax_heads(v),
                       jnp.asarray(pos), jnp.asarray(q_pos), window=window)
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    mean_v = np.repeat(v[0].mean(0), G, axis=0)
    np.testing.assert_allclose(got[0].numpy(),
                               np.broadcast_to(mean_v, got[0].shape),
                               atol=1e-5, rtol=0)


def test_split_combine_at_the_plans_split():
    """At the shapes of a decode step (B 8, G 4, S 1000: the plan's 4
    splits of 256, the last of 232) the split model agrees with the
    one-pass plain version, hd 64 as on the card."""
    B, G = 8, 4
    rng = np.random.default_rng(5)
    Hkv, s_len, hd = 2, 1000, 64
    q = rng.normal(size=(B, 1, G * Hkv, hd)).astype(np.float32)
    k = rng.normal(size=(B, s_len, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, s_len, Hkv, hd)).astype(np.float32)
    depth = rng.integers(0, s_len, B)
    pos = np.where(np.arange(s_len)[None] <= depth[:, None],
                   np.arange(s_len)[None], -1).astype(np.int32)
    pos[1] = -1
    q_pos = depth[:, None].astype(np.int32)
    p = dec_kernel.plan(B, 1, G * 8, 8, s_len, hd, torch.bfloat16)
    assert p.splits > 1 and s_len % p.per
    got = _split_model(q, k, v, pos, q_pos, 0, p.per)
    one = _port_decode(q, k, v, pos, q_pos)
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=1e-5, rtol=0)


def _c_signature(src, name):
    """The ctypes types of an ``extern "C"`` entry point's parameters,
    read from its CUDA source."""
    import ctypes
    import re
    from pathlib import Path
    text = (Path(dec_kernel.__file__).parents[2] / "csrc" / src).read_text()
    m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", text, re.S)
    kinds = []
    for param in m.group(1).split(","):
        param = param.strip()
        if "*" in param:
            kinds.append(ctypes.c_void_p)
        elif param.startswith("long long"):
            kinds.append(ctypes.c_longlong)
        else:
            assert param.startswith("int "), param
            kinds.append(ctypes.c_int)
    return kinds


@pytest.mark.parametrize("src,name", [
    ("decode_attention.cu", "decode_attention_launch"),
    ("decode_attention.cu", "paged_decode_attention_launch"),
    ("flash_attention.cu", "flash_attention_launch")])
def test_argtypes_match_the_c_signature(src, name):
    """A ctypes signature that drifts from the C one would pass shifted
    arguments: held here, where no compiler runs."""
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    wrapper = dec_kernel if src.startswith("decode") else flash_kernel
    assert wrapper.ARGTYPES[name] == _c_signature(src, name)
