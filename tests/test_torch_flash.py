"""The PyTorch port's flash-attention op against the JAX package.

On the CPU the op runs its plain PyTorch version (``ref.attention_reference``
with GQA heads expanded); it is held against the JAX oracle (``ref.py``)
and against the JAX op with ``use_pallas=True, interpret=True``, so the
Pallas kernels themselves (``flash_attention_pallas`` at G = 1,
``flash_attention_gqa_pallas`` at G > 1) run in interpret mode, as
``tests/test_kernels.py`` runs them. Inputs are made with numpy from a
seed. Tolerances: fp32 1e-5, bf16 2e-2 (the bf16 inputs are exact in
both packages; the outputs round once to bf16 after f32 arithmetic that
sums in another order). The CUDA kernel runs only on a card: its tests
live in ``tests/test_torch_card.py``, which imports no JAX so that it
runs on the card's machine (``python3 chip_smoke.py`` holds it at full
width too).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as jax_ops  # noqa: E402
from repro.kernels.flash_attention.ref import \
    attention_reference as jax_attention_ref  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402

HKV = 2
HD = 16
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
#: (causal, window): causal, causal within a window, neither
MASKS = [(True, 0), (True, 24), (False, 0)]


def _inputs(B, L, Hq, Hkv, hd, seed):
    """q (B, L, Hq, hd), k/v (B, L, Hkv, hd) in the model's layout."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, L, Hq, hd)).astype(np.float32),
            rng.normal(size=(B, L, Hkv, hd)).astype(np.float32),
            rng.normal(size=(B, L, Hkv, hd)).astype(np.float32))


def _t(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _j(x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", MASKS)
def test_plain_reference_matches_jax_ref(causal, window, dtype):
    q, k, v = _inputs(2, 40, 3, 3, HD, seed=7 + window)
    heads = (0, 2, 1, 3)
    got = ref.attention_reference(
        *(_t(a.transpose(heads), dtype) for a in (q, k, v)),
        causal=causal, window=window)
    want = jax_attention_ref(*(_j(a.transpose(heads), dtype)
                               for a in (q, k, v)),
                             causal=causal, window=window)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("G", [1, 2, 4])
def test_ops_match_jax_pallas_interpret(G, causal, window, dtype):
    """``gqa_flash`` (model layout) and ``mha_attention`` (per-head
    layout) against the JAX op on its Pallas route in interpret mode:
    G = 1 reaches ``flash_attention_pallas``, G > 1
    ``flash_attention_gqa_pallas``."""
    q, k, v = _inputs(2, 64, G * HKV, HKV, HD, seed=G * 100 + window)
    want = jax_ops.gqa_flash(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                             causal=causal, window=window, use_pallas=True,
                             interpret=True, bq=32, bk=32)
    tq, tk, tv = (_t(a, dtype) for a in (q, k, v))
    got = ops.gqa_flash(tq, tk, tv, causal=causal, window=window)
    got_heads = ops.mha_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                                  tv.transpose(1, 2), causal=causal,
                                  window=window)
    assert got.shape == q.shape and got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(_np(got_heads.transpose(1, 2)), _np(want),
                               atol=TOL[dtype], rtol=0)


def test_first_live_tile_wholly_masked_rows_match_pallas():
    """With 16-row tiles and a window of 20, query tile [32, 48) still
    reads key tile [0, 16), but row 47 sees only keys > 27: its first live
    tile is wholly masked. The Pallas kernel's finite NEG_INF lets that
    tile pollute the row's sums until a real score wipes them (alpha =
    0); with -inf the row would be NaN. The port's result equals it."""
    q, k, v = _inputs(1, 64, 4, 2, HD, seed=3)
    want = jax_ops.gqa_flash(_j(q, "float32"), _j(k, "float32"),
                             _j(v, "float32"), causal=True, window=20,
                             use_pallas=True, interpret=True, bq=16, bk=16)
    got = ops.gqa_flash(*(_t(a, "float32") for a in (q, k, v)),
                        causal=True, window=20)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)


def test_ops_on_cpu_launch_nothing():
    q, k, v = (_t(a, "float32") for a in _inputs(1, 8, 4, 2, 8, seed=0))
    before = launch_counts()
    ops.gqa_flash(q, k, v)
    assert launch_counts() == before


def test_self_attention_kernel_route_checks_positions(monkeypatch):
    """The kernel route places queries and keys at arange(L): handed
    anything else it raises before the kernel; handed arange(L) it gives
    the flash op's result. Positions None (what ``forward_train`` and
    ``prefill_into_cache`` pass) are arange(L) by construction and are
    not checked, so a forward adds no check per layer. (The route is
    forced here on CPU tensors, where the op itself runs its plain
    version.)"""
    cfg = get_arch("llama3.2-1b", variant="reduced")
    q, k, v = (_t(a, "float32") for a in _inputs(2, 16, 4, 2, 8, seed=1))
    monkeypatch.setattr(layers, "use_kernel", lambda *ts: True)
    checks = []
    check = layers._assert_from_zero
    monkeypatch.setattr(layers, "_assert_from_zero",
                        lambda *a: checks.append(a) or check(*a))
    want = ops.gqa_flash(q, k, v, causal=True)
    assert torch.equal(layers._self_attention(q, k, v, cfg, None, 0), want)
    assert checks == []
    got = layers._self_attention(q, k, v, cfg, torch.arange(16), 0)
    assert torch.equal(got, want) and len(checks) == 1
    with pytest.raises(RuntimeError, match="arange"):
        layers._self_attention(q, k, v, cfg, torch.arange(16) + 3, 0)
    with pytest.raises(ValueError, match="arange"):
        layers._self_attention(q, k, v, cfg, torch.arange(16)[None], 0)


def test_backward_through_the_kernel_raises(monkeypatch):
    """Where a gradient could be asked for, the launch sits in an
    autograd node: its output has a grad_fn, and a backward pass runs
    the backward launch (``flash_attention_bwd_cuda``) on the saved q, k,
    v, output and LSE instead of giving q, k, v no gradient (before the
    backward kernels the node raised: hence the name). Its gradients
    reach q, k and v as autograd's of the plain forward do. (The device
    check is lifted and both launches replaced by the plain versions on
    CPU tensors here.)"""
    def plain(q, k, v, causal, window, with_lse=False):
        out = ops.gqa_flash(q, k, v, causal=causal, window=window)
        return (out, torch.zeros(q.shape[0], q.shape[2], q.shape[1])) \
            if with_lse else out

    calls = []

    def plain_bwd(q, k, v, out, lse, dout, *, causal=True, window=0):
        calls.append((out.shape, lse.shape, causal, window))
        tr = lambda t: t.transpose(1, 2)  # noqa: E731
        return tuple(tr(g) for g in ref.attention_backward_reference(
            tr(q), tr(k), tr(v), tr(dout), causal=causal, window=window))

    monkeypatch.setattr(flash_kernel, "_check", lambda *a: None)
    monkeypatch.setattr(flash_kernel, "_launch", plain)
    monkeypatch.setattr(flash_kernel, "flash_attention_bwd_cuda", plain_bwd)
    q, k, v = (_t(a, "float32") for a in _inputs(1, 8, 4, 2, 8, seed=2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_kernel.flash_attention_cuda(*leaves, window=3)
    assert out.grad_fn is not None
    out.sum().backward()
    assert calls == [((1, 8, 4, 8), (1, 4, 8), True, 3)]
    want = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.gqa_flash(*want, window=3).sum().backward()
    for a, b in zip(leaves, want):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6)


def test_wrapper_refuses_cpu_tensors():
    q, k, v = (_t(a, "float32") for a in _inputs(1, 8, 2, 1, 8, seed=4))
    with pytest.raises(ValueError, match="CUDA"):
        flash_kernel.flash_attention_cuda(q, k, v)


@pytest.mark.parametrize("hd,tile", [(8, 32), (40, 64), (64, 64),
                                     (96, 128), (128, 128), (160, 160),
                                     (168, 256), (256, 256)])
def test_plan_routes_by_dtype_and_head_dim_tile(hd, tile):
    """bf16 takes the tensor cores, fp32 the CUDA cores; the head-dim
    tile is the smallest that holds hd (the dimensions past hd are zero
    k-steps)."""
    bf = flash_kernel.plan(2, 1024, 32, 8, hd, torch.bfloat16)
    f32 = flash_kernel.plan(2, 1024, 32, 8, hd, torch.float32)
    assert (bf.path, f32.path) == ("mma", "simt")
    assert bf.hd_tile == f32.hd_tile == tile
    assert bf.bq == 16 and bf.blocks == 2 * 8 * 64


@pytest.mark.parametrize("G,bq", [(1, 64), (4, 16), (8, 8), (64, 1)])
def test_plan_groups_heads_into_64_rows(G, bq):
    p = flash_kernel.plan(1, 100, G * 2, 2, 64, torch.bfloat16)
    assert p.bq == bq and p.blocks == 2 * -(-100 // bq)


@pytest.mark.parametrize("hd,tile", [(8, 32), (40, 64), (64, 64),
                                     (96, 128), (128, 128), (160, 160),
                                     (168, 256), (256, 256)])
def test_plan_bwd_routes_by_dtype_and_head_dim_tile(hd, tile):
    """The backward's route by the dtype alone, as the forward's: bf16 on
    the tensor cores (64 keys a dK/dV block, 8 warps at tiles 160 and
    256, dQ key tiles of 64, 32 at 64 and 256), fp32 on the CUDA cores
    (256 threads, 64 keys a tile up to 128, 32 above); the forward's
    head-dim tile and query grouping; D's lanes the fewest power of two
    that hold a row's 16-byte units (at most a warp), 8 warps a block."""
    B, L, Lk, Hq, Hkv = 2, 1024, 1000, 32, 8
    bf = flash_kernel.plan_bwd(B, L, Lk, Hq, Hkv, hd, torch.bfloat16)
    f32 = flash_kernel.plan_bwd(B, L, Lk, Hq, Hkv, hd, torch.float32)
    fwd = flash_kernel.plan(B, L, Hq, Hkv, hd, torch.bfloat16)
    assert (bf.route, f32.route) == ("mma", "simt")
    assert bf.hd_tile == f32.hd_tile == tile
    assert bf.bq == f32.bq == 16 and bf.dq_blocks == fwd.blocks
    assert bf.key_tile == 64
    assert bf.dkdv_threads == (256 if tile >= 160 else 128)
    assert bf.dq_key_tile == (32 if tile in (64, 256) else 64)
    assert f32.key_tile == f32.dq_key_tile == (64 if tile <= 128 else 32)
    assert f32.dkdv_threads == 256
    for p, es in ((bf, 2), (f32, 4)):
        units = hd * es // 16
        assert p.dot_lanes in (1, 2, 4, 8, 16, 32)
        assert p.dot_lanes >= min(units, 32) > p.dot_lanes // 2
        assert p.dot_blocks == -(-B * L * Hq // (8 * 32 // p.dot_lanes))
        assert p.dkdv_blocks == B * Hkv * -(-Lk // p.key_tile)


@pytest.mark.parametrize("G,bq", [(1, 64), (3, 21), (4, 16), (8, 8),
                                  (64, 1)])
def test_plan_bwd_groups_heads_into_64_rows(G, bq):
    """dQ takes the forward's blocks of 64 grouped rows (G heads x 64 / G
    positions); dK/dV one block a (batch, KV head, 64 keys), the whole
    group's rows walked inside it."""
    p = flash_kernel.plan_bwd(1, 100, 130, G * 2, 2, 64, torch.bfloat16)
    assert p.bq == bq and p.dq_blocks == 2 * -(-100 // bq)
    assert p.dkdv_blocks == 2 * 3
