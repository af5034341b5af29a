"""The PyTorch port's kernel ops against the JAX package.

On the CPU each op runs its plain PyTorch version; it is held against the
JAX oracle (``ref.py``) and the Pallas kernel in interpret mode on the
same inputs, made with numpy from a seed. The CUDA kernels run only on
a card: their tests live in ``tests/test_torch_card.py``, which
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
from repro.models.layers import rms_norm as jax_rms_norm  # noqa: E402
from repro_torch.kernels import _autograd, dispatch  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as dec_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as dec_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as norm_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as norm_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as norm_ref  # noqa: E402
from repro_torch.models import layers as torch_layers  # noqa: E402

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


def _jax_gated(y, z, scale, eps=1e-5):
    """The JAX model's gated norm (``repro/models/ssm.py``), y cast to the
    activation dtype (z's) first, as the mixer casts the SSD output."""
    return jax_rms_norm({"scale": scale},
                        y.astype(z.dtype) * jax.nn.silu(
                            z.astype(jnp.float32)).astype(z.dtype), eps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("y_f32", [True, False])
def test_gated_plain_is_the_mixers_old_expression_bitwise(dtype, y_f32):
    """The gated op's plain version equals, bit for bit, what the mixer
    ran before the op existed: the SSD output cast to the activation
    dtype, times silu(f32 z) cast to it, through ``layers.rms_norm``; z a
    strided slice of a wider projection output."""
    g = torch.Generator().manual_seed(3)
    y = torch.randn(2, 5, 96, generator=g)
    z = torch.randn(2, 5, 96 * 2 + 20, generator=g).to(dtype)[..., :96]
    scale = (1 + 0.1 * torch.randn(96, generator=g)).to(dtype)
    got = norm_ops.gated_rmsnorm(y if y_f32 else y.to(dtype), z, scale,
                                 eps=1e-5)
    old, _ = torch_layers.rms_norm(
        {"scale": scale}, y.to(dtype) * torch.nn.functional.silu(
            z.float()).to(dtype), 1e-5)
    assert got.dtype == dtype and torch.equal(got, old)


@pytest.mark.parametrize("route", ["add", "norm", "gated"])
def test_rmsnorm_plain_grads_match_jax(route):
    """On the CPU the ops stay differentiable: autograd of the plain
    versions against ``jax.grad`` of the JAX expressions, every input,
    fp32 at 1e-5."""
    rng = np.random.default_rng(11)
    N, d = 8, 96
    a, b, gy, gt = (rng.normal(size=(N, d)).astype(np.float32)
                    for _ in range(4))
    scale = (1 + 0.1 * rng.normal(size=(d,))).astype(np.float32)

    def jax_loss(a, b, s):
        if route == "gated":
            return jnp.sum(_jax_gated(a, b, s) * gy)
        y, t = jax_rmsnorm_ref(a, b if route == "add" else 0 * a, s)
        return jnp.sum(y * gy) + (jnp.sum(t * gt) if route == "add" else 0)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(a, b, scale)
    ta, tb, ts = (torch.from_numpy(v).requires_grad_() for v in
                  (a, b, scale))
    if route == "gated":
        loss = (norm_ops.gated_rmsnorm(ta, tb, ts) * torch.from_numpy(gy)
                ).sum()
    else:
        y, t = norm_ops.fused_rmsnorm(ta, tb if route == "add" else None, ts)
        loss = (y * torch.from_numpy(gy)).sum()
        if route == "add":
            loss = loss + (t * torch.from_numpy(gt)).sum()
    loss.backward()
    got = (ta.grad, tb.grad, ts.grad)
    for i, (g_, w) in enumerate(zip(got, want)):
        if route == "norm" and i == 1:
            assert g_ is None
            continue
        np.testing.assert_allclose(g_.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 100, 1536, 2048, 3072, 5120, 16384])
@pytest.mark.parametrize("N", [13, 2048])
def test_rmsnorm_plan_covers_a_row_without_a_spare_warp(N, d, dtype):
    """A row's threads hold its 16-byte units with no idle warp and no
    power-of-two padding (mamba2's d 1536 and 3072 and pixtral-12b's
    5120 in bf16 mask no lane); rows short of 128 threads share a block;
    the grid covers every row once; one unit a thread for a few rows,
    two for many wide ones; a row past the kernel's limit raises."""
    unit = 16 // dtype.itemsize
    p = norm_kernel.plan(N, d, dtype)
    assert p.nv in norm_kernel.NVS[dtype]
    assert p.tpr % 32 == 0 and p.threads == p.tpr * p.rows <= 1024
    assert (p.tpr - 32) * p.nv * unit < d <= p.tpr * p.nv * unit
    assert p.rows == max(1, 128 // p.tpr)
    assert (p.blocks - 1) * p.rows < N <= p.blocks * p.rows
    wide = N >= 1024 and d >= 256 * unit
    assert p.nv == max(-(-d // (1024 * unit)), 2 if wide else 1)
    if dtype == torch.bfloat16 and d in (1536, 3072, 5120):
        assert p.tpr * p.nv * unit == d
    with pytest.raises(ValueError, match="row limit"):
        norm_kernel.plan(N, norm_kernel.NVS[dtype][-1] * 1024 * unit + 1,
                         dtype)


def test_autograd_launch_enters_a_node_only_for_a_gradient():
    """``_autograd.launch`` calls the launch straight unless grad mode is
    on and an input requires grad; then the outputs carry a node whose
    backward raises, with the values unchanged."""
    def fn(a, b, k):
        return a * b + k, a - b

    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(4, generator=g), torch.randn(4, generator=g)
    out = _autograd.launch("op", fn, a, b, 1.0)
    assert all(o.grad_fn is None for o in out)
    a.requires_grad_()
    with torch.no_grad():
        assert _autograd.launch("op", fn, a, b, 1.0)[0].grad_fn is None
    got = _autograd.launch("op", fn, a, b, 1.0)
    assert all(o.grad_fn is not None for o in got)
    assert all(torch.equal(o.detach(), w) for o, w in zip(got, out))
    with pytest.raises(NotImplementedError,
                       match="op has no backward kernel yet.*item 12"):
        got[1].sum().backward()


@pytest.mark.parametrize("route", ["add", "norm", "gated"])
def test_rmsnorm_wrappers_refuse_a_backward(route, monkeypatch):
    """Both norm wrappers run their launch through ``_autograd.launch``:
    an input that requires grad gives outputs whose backward raises; none
    gives plain outputs. (The launch, checks included, is replaced by
    the plain version on CPU tensors here.)"""
    def plain(route_, a, b, scale, eps):
        if route_ == "gated":
            return norm_ref.gated_rmsnorm_reference(a, b, scale, eps)
        y, t = norm_ref.fused_rmsnorm_reference(a, b, scale, eps)
        return (y, t) if route_ == "add" else y

    monkeypatch.setattr(norm_kernel, "_launch", plain)
    g = torch.Generator().manual_seed(1)
    x, r = torch.randn(3, 64, generator=g), torch.randn(3, 64, generator=g)
    scale = torch.ones(64)

    def call():
        if route == "gated":
            return norm_kernel.gated_rmsnorm_cuda(x, r, scale)
        return norm_kernel.fused_rmsnorm_cuda(
            x, r if route == "add" else None, scale)[0]

    want = call()
    assert want.grad_fn is None
    x.requires_grad_()
    got = call()
    assert got.grad_fn is not None and torch.equal(got.detach(), want)
    with pytest.raises(NotImplementedError, match="item 12"):
        got.sum().backward()


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
    monkeypatch.setattr(norm_kernel, "fused_rmsnorm_cuda", boom)
    monkeypatch.setattr(norm_kernel, "gated_rmsnorm_cuda", boom)
    q, k, v, pos, q_pos = (torch.from_numpy(a) for a in
                           _decode_inputs(1, 1, 1, seed=0))
    dec_ops.cached_decode_attention(q, k, v, pos, q_pos)
    norm_ops.fused_rmsnorm(torch.ones(2, 8), torch.ones(2, 8), torch.ones(8))
    norm_ops.gated_rmsnorm(torch.ones(2, 8), torch.ones(2, 8), torch.ones(8))


def test_dispatch_rejects_other_devices():
    meta = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="all on CUDA or all on the CPU"):
        dispatch.use_kernel(meta)
    with pytest.raises(ValueError):
        norm_ops.fused_rmsnorm(meta, None, torch.ones(8))


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise: handed CPU tensors they raise
    before building anything."""
    q, k, v, pos, q_pos = (torch.from_numpy(a) for a in
                           _decode_inputs(1, 1, 1, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        dec_kernel.decode_attention_cuda(q, k, v, pos, q_pos)
    with pytest.raises(ValueError, match="CUDA"):
        norm_kernel.fused_rmsnorm_cuda(torch.ones(2, 8), None,
                                       torch.ones(8))
    with pytest.raises(ValueError, match="CUDA"):
        norm_kernel.gated_rmsnorm_cuda(torch.ones(2, 8), torch.ones(2, 8),
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
        elif param.startswith("float "):
            kinds.append(ctypes.c_float)
        else:
            assert param.startswith("int "), param
            kinds.append(ctypes.c_int)
    return kinds


@pytest.mark.parametrize("src,name", [
    ("decode_attention.cu", "decode_attention_launch"),
    ("decode_attention.cu", "paged_decode_attention_launch"),
    ("flash_attention.cu", "flash_attention_launch"),
    ("rmsnorm.cu", "rmsnorm_launch"),
    ("quant_matmul.cu", "quant_matmul_launch"),
    ("quant_matmul.cu", "quant_matmul_mma_launch"),
    ("ssd_scan.cu", "ssd_extend_launch"),
    ("ssd_scan.cu", "ssd_chunk_launch"),
    ("ssd_scan.cu", "ssd_chunk_mma_launch")])
def test_argtypes_match_the_c_signature(src, name):
    """A ctypes signature that drifts from the C one would pass shifted
    arguments: held here, where no compiler runs."""
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.quant_matmul import kernel as qmm_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    wrapper = {"decode_attention.cu": dec_kernel,
               "flash_attention.cu": flash_kernel,
               "rmsnorm.cu": norm_kernel,
               "quant_matmul.cu": qmm_kernel,
               "ssd_scan.cu": ssd_kernel}[src]
    assert wrapper.ARGTYPES[name] == _c_signature(src, name)
