"""The PyTorch port's edge profile (int8/int4 weights, int8 KV) against
the JAX package's.

Everything runs on the CPU, with inputs made by numpy from a seed:

* (a) QTensor leaves: the port's ``quantize_tensor`` / ``quantize_params``
  give bit-equal leaves to JAX's for the same float weights (int8, int4
  with group 32, an odd group, an odd d_in falling back to int8), and
  ``unpack_int4`` agrees with JAX on all 256 byte values;
* (b) the plain ``quant_matmul`` against JAX's ``ref.py`` oracle and the
  Pallas kernels in interpret mode (f32 1e-5; bf16 within 1e-2 of the
  output's largest magnitude, one bf16 rounding apart);
* (c) int8 KV caches, contiguous and paged, bit-equal to JAX's (int8
  values, scales, ``pos``, ``step``) after masked extends, decode steps
  and prefill. The layers run on dyadic weights and inputs without RoPE,
  so both packages compute K and V exactly and only the cache code is
  compared; attention outputs agree within 1e-5;
* (d) the quantized model (``reduced+edge``, and ``reduced`` with int8
  weights) against JAX's on the same JAX-quantized weights (logits 1e-4);
* (e) the port's ``Engine`` against JAX's on the same quantized weights,
  contiguous and paged, ``prefill_chunk`` 0 and 8: greedy tokens
  identical. Quantized runs are compared with JAX's quantized runs, never
  with full precision (two such JAX tests are red in the reference);
* (f) dispatch, the wrappers' refusals, the configuration, the bridge's
  checks and the serve CLI.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import quant as jq  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.kernels.quant_matmul import ref as jax_qref  # noqa: E402
from repro.kernels.quant_matmul.kernel import (  # noqa: E402
    quant_matmul_int4_pallas, quant_matmul_int8_pallas)
from repro.models import layers as JL  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro.serving import paged_kv as jax_paged_kv  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro.serving.sampler import Sampler as JaxSampler  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import quant as tq  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.quant_matmul import kernel as qkernel  # noqa: E402
from repro_torch.kernels.quant_matmul import ops as qops  # noqa: E402
from repro_torch.kernels.quant_matmul import ref as qref  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.serving import paged_kv  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

LOGIT_TOL = 1e-4
ATTN_TOL = 1e-5

# The suite runs in several worker processes at once, each beside JAX's
# own thread pool: torch's intra-op threads on top of them oversubscribe
# the cores (a run of this file took 7x longer), so torch keeps to one.
torch.set_num_threads(1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _same_tree(got, want):
    """Every leaf bit-equal, with the same dtype and keys."""
    assert isinstance(got, dict) == isinstance(want, dict)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same_tree(got[k], want[k])
        return
    got = bridge.cache_to_numpy({"x": got})["x"] \
        if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


# --------------------------------------------------------------------- #
# (a) QTensor leaves
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shape,bits,gs", [
    ((64, 48), 8, 32), ((3, 128, 20), 8, 32), ((64, 48), 4, 32),
    ((2, 256, 40), 4, 32), ((34, 24), 4, 32), ((2, 96, 16), 4, 64),
])
def test_quantize_tensor_bit_equal_jax(shape, bits, gs):
    """int8 per channel, int4 in groups of 32 and 64, and K = 34 whose
    group shrinks to the odd divisor 17."""
    w = np.random.default_rng(sum(shape) + bits).normal(
        0, 0.05, shape).astype(np.float32)
    w[..., 0, 0] = 0.0
    want = _np(jq.quantize_tensor(jnp.asarray(w), bits=bits, group_size=gs))
    got = tq.quantize_tensor(torch.from_numpy(w), bits=bits, group_size=gs)
    _same_tree(got, want)
    if bits == 4:
        ng = shape[-2] // tq.qtensor.int4_group_size(shape[-2], gs)
        assert got["scale"].shape[-2] == ng
        assert ng == want["scale"].shape[-2]
    assert tq.qtensor_nbytes(got) == jq.qtensor_nbytes(want)
    np.testing.assert_array_equal(
        tq.dequantize_tensor(got).numpy(),
        np.asarray(jq.dequantize_tensor(jq.quantize_tensor(
            jnp.asarray(w), bits=bits, group_size=gs))))


def test_odd_group_is_17_for_k34():
    assert tq.qtensor.int4_group_size(34, 32) == 17
    shapes = tq.qtensor.qtensor_shapes((34, 24), 4, 32)
    assert shapes["q4"][0] == (17, 24) and shapes["scale"][0] == (2, 24)


def test_unpack_int4_all_256_bytes_match_jax():
    b = np.arange(-128, 128, dtype=np.int8).reshape(1, 256)
    got = tq.unpack_int4(torch.from_numpy(b)).numpy()
    want = np.asarray(jq.unpack_int4(jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    assert got.min() == -8 and got.max() == 7
    # pack inverts unpack on every byte, in both packages
    repacked = tq.pack_int4(torch.from_numpy(got)).numpy()
    np.testing.assert_array_equal(repacked, b)
    np.testing.assert_array_equal(
        repacked, np.asarray(jq.pack_int4(jnp.asarray(want))))


def _reduced_params(variant="reduced", **kw):
    jc = jax_get_arch("llama3.2-1b", variant=variant).replace(**kw)
    return jc, jax_build(jc).init(jax.random.PRNGKey(0))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_bit_equal_jax(bits):
    jc, jp = _reduced_params()
    want = _np(jq.quantize_params(jp, bits=bits, group_size=32))
    tc = get_arch("llama3.2-1b", variant="reduced")
    dense = bridge.params_from_jax(_np(jp), tc, "cpu")
    got = tq.quantize_params(dense, bits=bits, group_size=32)
    _same_tree(got, want)
    # the embedding table and the norms stay dense; every projection is
    # quantized at the requested precision
    assert isinstance(got["embed"]["table"], torch.Tensor)
    key = "q4" if bits == 4 else "q"
    assert set(got["blocks"]["sub0"]["mlp"]["wo"]["w"]) == {key, "scale"}
    st, jst = tq.quantized_stats(got), jq.quantized_stats(want)
    assert st == jst and st["n_quantized"] == 7 and st["n_dense"] == 0
    back = tq.dequantize_params(got)
    jback = _np(jq.dequantize_params(want))
    for a, b in zip(jax.tree.leaves(bridge.params_to_numpy(back)),
                    jax.tree.leaves(jback)):
        np.testing.assert_array_equal(a, b)


def test_odd_d_in_falls_back_to_int8_as_jax():
    rng = np.random.default_rng(3)
    tree = {"a": {"w": rng.normal(size=(2, 33, 16)).astype(np.float32)},
            "b": {"w": rng.normal(size=(34, 8)).astype(np.float32),
                  "bias": rng.normal(size=(8,)).astype(np.float32)},
            "router": {"w": rng.normal(size=(8, 4)).astype(np.float32)},
            "embed": {"table": rng.normal(size=(10, 8)).astype(np.float32)}}
    want = _np(jq.quantize_params(jax.tree.map(jnp.asarray, tree), bits=4))
    got = tq.quantize_params(jax.tree.map(torch.from_numpy, tree), bits=4)
    _same_tree(got, want)
    assert "q" in got["a"]["w"] and "q4" in got["b"]["w"]
    assert isinstance(got["router"]["w"], torch.Tensor)


def test_quantize_for_cfg_knob_and_edge_variant():
    for variant in ("edge", "reduced+edge", "edge+reduced"):
        tc = get_arch("llama3.2-1b", variant=variant)
        jc = jax_get_arch("llama3.2-1b", variant=variant)
        for f in ("name", "quant", "quant_group", "kv_quant", "n_layers",
                  "d_model", "dtype"):
            assert getattr(tc, f) == getattr(jc, f), f
    assert tc.quant == "int4" and tc.kv_quant
    p = {"x": {"w": torch.ones(4, 4)}}
    assert tq.quantize_for_cfg(p, get_arch("llama3.2-1b")) is p
    assert "q" in tq.quantize_for_cfg(
        p, get_arch("llama3.2-1b").replace(quant="int8"))["x"]["w"]


# --------------------------------------------------------------------- #
# (b) the plain quant_matmul
# --------------------------------------------------------------------- #
def _qmm_inputs(M, K, N, bits, gs=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(0, 0.05, (K, N)).astype(np.float32)
    qt = _np(jq.quantize_tensor(jnp.asarray(w), bits=bits, group_size=gs))
    return x, qt


def _port_qt(qt):
    return {k: torch.from_numpy(np.array(v)) for k, v in qt.items()}


def _jax_ref(x, qt):
    if "q" in qt:
        return jax_qref.quant_matmul_int8_reference(x, qt["q"], qt["scale"])
    return jax_qref.quant_matmul_int4_reference(x, qt["q4"], qt["scale"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,bits", [
    (1, 64, 48, 8), (5, 34, 20, 8), (16, 128, 200, 8),
    (1, 64, 48, 4), (5, 34, 20, 4), (16, 128, 200, 4),
])
def test_quant_matmul_plain_matches_jax_ref(M, K, N, bits, dtype):
    x, qt = _qmm_inputs(M, K, N, bits, seed=M + K + N + bits)
    tdt = getattr(torch, dtype)
    got = qops.quant_matmul(torch.from_numpy(x).to(tdt), _port_qt(qt))
    assert got.dtype == tdt and got.shape == (M, N)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    want = np.asarray(_jax_ref(jx, qt), np.float32)
    tol = 1e-5 if dtype == "float32" else 1e-2 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("bits,K,gs", [(8, 64, 32), (4, 64, 32),
                                       (4, 34, 32), (4, 128, 64)])
def test_quant_matmul_plain_matches_pallas_interpret(bits, K, gs):
    M, N = 16, 48
    x, qt = _qmm_inputs(M, K, N, bits, gs=gs, seed=K + bits)
    got = qops.quant_matmul(torch.from_numpy(x), _port_qt(qt)).numpy()
    if bits == 8:
        pal = quant_matmul_int8_pallas(jnp.asarray(x), qt["q"], qt["scale"],
                                       bm=8, interpret=True)
    else:
        pal = quant_matmul_int4_pallas(jnp.asarray(x), qt["q4"],
                                       qt["scale"], bm=8, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pal), atol=1e-5, rtol=0)


def test_quant_matmul_leading_axes_and_noncontiguous_x():
    x, qt = _qmm_inputs(12, 64, 24, 4, seed=9)
    t = _port_qt(qt)
    x3 = torch.from_numpy(x).reshape(2, 6, 64)
    y3 = qops.quant_matmul(x3, t)
    assert y3.shape == (2, 6, 24)
    y2 = qref.quant_matmul_int4_reference(torch.from_numpy(x), t["q4"],
                                          t["scale"])
    assert torch.equal(y3.reshape(12, 24), y2)
    xt = torch.from_numpy(np.ascontiguousarray(x.T)).T     # a strided view
    assert not xt.is_contiguous()
    assert torch.equal(qops.quant_matmul(xt, t), y2)


def test_quant_cpu_tensors_take_the_plain_version(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernel launched for CPU tensors")
    monkeypatch.setattr(qkernel, "quant_matmul_int8_cuda", boom)
    monkeypatch.setattr(qkernel, "quant_matmul_int4_cuda", boom)
    before = launch_counts()
    for bits in (8, 4):
        x, qt = _qmm_inputs(3, 64, 16, bits)
        qops.quant_matmul(torch.from_numpy(x), _port_qt(qt))
    assert launch_counts() == before


def test_quant_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise: handed CPU tensors they raise
    before building anything, and count nothing."""
    before = launch_counts()
    for bits, fn in ((8, qkernel.quant_matmul_int8_cuda),
                     (4, qkernel.quant_matmul_int4_cuda)):
        x, qt = _qmm_inputs(3, 64, 16, bits)
        t = _port_qt(qt)
        with pytest.raises(ValueError, match="CUDA"):
            fn(torch.from_numpy(x), t["q4" if bits == 4 else "q"],
               t["scale"])
    assert launch_counts() == before


def test_quant_kernel_plan_fills_the_card():
    """The K split of the decode and chunk shapes of llama3.2-1b: about
    two waves of 132 SMs where the columns alone give fewer blocks, at
    most 16 splits of a multiple of 64 rows that cover K exactly once."""
    for M in (1, 8, 37, 128):
        for K, N in ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)):
            blocks, splits, kper = qkernel.plan(M, N, K)
            assert 1 <= splits <= 16 and kper % 64 == 0
            assert (splits - 1) * kper < K <= splits * kper
            if M <= 8:
                assert blocks >= 64
    assert qkernel.plan(8, 512, 2048) == (64, 16, 128)
    assert qkernel.plan(128, 8192, 2048)[1] == 1


# (dtype, gs, N, K, route of int4, route of int8): int4 takes a group of
# a multiple of 16, int8 a K of a multiple of 8 (x's rows are copied 16
# bytes at a time); both N a multiple of 4 and bf16 x
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype,gs,N,K,route4,route8", [
    (torch.bfloat16, 32, 8192, 2048, "mma", "mma"),
    (torch.bfloat16, 64, 512, 2048, "mma", "mma"),
    (torch.bfloat16, 16, 200, 2048, "mma", "mma"),
    (torch.bfloat16, 48, 2048, 2016, "mma", "mma"),
    (torch.float32, 32, 8192, 2048, "simt", "simt"),
    (torch.bfloat16, 17, 48, 34, "simt", "simt"),
    (torch.bfloat16, 8, 2048, 2048, "simt", "mma"),
    (torch.bfloat16, 32, 202, 2048, "simt", "simt"),
    (torch.bfloat16, 4, 2048, 2052, "simt", "simt"),
])
def test_int4_plan_route_by_dtype_and_group(bits, dtype, gs, N, K, route4,
                                            route8):
    """``mma_plan`` sends bf16 x to the tensor cores where N is a multiple
    of 4 and, int4, the group a multiple of 16 or, int8, K a multiple of
    8; everything else stays on simt with plan's split."""
    pl = qkernel.mma_plan(bits, 8, N, K, gs, dtype)
    assert pl.route == (route4 if bits == 4 else route8)
    if pl.route == "simt":
        assert (pl.blocks, pl.splits, pl.kper) == qkernel.plan(8, N, K)
        assert pl.bk == qkernel.SIMT_BK[bits]


_LLAMA_KN = ((2048, 8192), (2048, 512), (2048, 2048), (8192, 2048))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M", [1, 8, 16, 17, 37, 128, 512])
@pytest.mark.parametrize("K,N", _LLAMA_KN + ((2080, 200), (34 * 16, 48)))
def test_int4_plan_tiles_cover_k_once(bits, M, K, N):
    """mma splits are whole K tiles that cover K exactly once; K is split
    only when the unsplit grid has fewer than 132 blocks; int8 and int4
    take the same tiles and splits."""
    pl = qkernel.mma_plan(bits, M, N, K, 16, torch.bfloat16)
    assert pl.route == "mma" and pl.bk == 64 and pl.bn == 128
    assert pl.bm == (8 if M <= 8 else 32)
    assert pl.kper % pl.bk == 0 and 1 <= pl.splits <= qkernel.MMA_MAX_SPLITS
    assert (pl.splits - 1) * pl.kper < K <= pl.splits * pl.kper
    base = -(-N // pl.bn) * -(-M // pl.bm)
    assert pl.blocks == base * pl.splits
    assert (pl.splits > 1) <= (base < 132)
    assert pl == qkernel.mma_plan(12 - bits, M, N, K, 16, torch.bfloat16)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M", [1, 8])
@pytest.mark.parametrize("K,N", _LLAMA_KN)
def test_int4_plan_decode_walks_three_tiles_and_fills_the_card(bits, M, K,
                                                               N):
    """At llama3.2-1b's decode shapes every split, the last one too,
    walks at least 3 K tiles (the ring has tiles in flight); the wide
    shapes give 132 SMs a block each, and the narrow ones (N 512, 2048:
    4 and 16 column tiles) take the finest split of whole tiles that
    keeps 3 tiles in every split."""
    pl = qkernel.mma_plan(bits, M, N, K, 32, torch.bfloat16)
    assert pl.route == "mma"
    tiles, per = -(-K // pl.bk), pl.kper // pl.bk
    assert per >= 3 and tiles - (pl.splits - 1) * per >= 3
    if N * K >= 2048 * 8192:
        assert pl.blocks >= 132
    else:
        finer = per - 1
        assert finer < 3 or tiles - (-(-tiles // finer) - 1) * finer < 3


# --------------------------------------------------------------------- #
# (c) int8 KV caches, bit for bit
# --------------------------------------------------------------------- #
_B, _S, _PS = 3, 16, 4


def _layer_cfgs():
    """Reduced llama with G = 2, no RoPE, int8 KV: JAX's and the port's."""
    kw = dict(n_kv_heads=2, rope=False, kv_quant=True)
    return (jax_get_arch("llama3.2-1b", variant="reduced").replace(**kw),
            get_arch("llama3.2-1b", variant="reduced").replace(**kw))


def _dyadic(rng, shape, step, hi):
    return (rng.integers(-hi, hi + 1, shape) * step).astype(np.float32)


def _layer_params(cfg, seed=0):
    """Attention weights in multiples of 1/64 and inputs in multiples of
    1/8: every product and sum of the projections is exact in f32, so
    both packages compute the same K and V bits."""
    rng = np.random.default_rng(seed)
    d, hd = cfg.d_model, cfg.hd
    shapes = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
              "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}
    return {k: {"w": _dyadic(rng, s, 1 / 64, 8)} for k, s in shapes.items()}


def _x(rng, T, d):
    return _dyadic(rng, (_B, T, d), 1 / 8, 16)


def _to_t(p):
    return jax.tree.map(torch.from_numpy, p)


def _jax_ops():
    """JAX's layers, compiled as its model runs them (XLA computes the KV
    scale ``max|x| / 127`` as ``max|x| * (1/127)`` there, and so does the
    port)."""
    jc, _ = _layer_cfgs()
    ext = jax.jit(lambda p, x, c, n: JL.extend_into_cache(
        p, x, jc, c, lengths=n))
    dec = jax.jit(lambda p, x, c: JL.attention_block(p, x, jc, cache=c))
    return ext, dec


def test_int8_contiguous_cache_bit_equal_jax():
    """Masked extends (a row idle, rows advancing by part of the chunk),
    decode steps and a ring that wraps: int8 K/V, scales, pos and step
    bit-equal after every call; prefill with and without lengths too."""
    jc, tc = _layer_cfgs()
    p = _layer_params(tc)
    jp, tp = jax.tree.map(jnp.asarray, p), _to_t(p)
    ext, dec = _jax_ops()
    rng = np.random.default_rng(1)
    H, hd = tc.n_kv_heads, tc.hd
    jcache = JL.make_kv_cache(_B, _S, H, hd, jnp.float32, quant=True)
    tcache = TL.make_kv_cache(_B, _S, H, hd, torch.float32, "cpu",
                              quant=True)
    _same_tree(tcache, _np(jcache))
    assert tcache["k"].dtype == torch.int8 and \
        tcache["k_scale"].shape == (_B, _S, H)
    for lens in ([8, 5, 0], [3, 8, 0], None, [6, 2, 8], [8, 8, 8]):
        if lens is None:                       # a decode step
            x = _x(rng, 1, tc.d_model)
            jy, jcache = dec(jp, jnp.asarray(x), jcache)
            ty, _ = TL.attention_block(tp, torch.from_numpy(x), tc,
                                       cache=tcache)
            keep = np.ones((_B, 1), bool)
        else:
            x = _x(rng, 8, tc.d_model)
            n = np.array(lens, np.int32)
            jy, jcache = ext(jp, jnp.asarray(x), jcache, jnp.asarray(n))
            ty, _ = TL.extend_into_cache(tp, torch.from_numpy(x), tc,
                                         tcache,
                                         lengths=torch.from_numpy(n))
            keep = np.arange(8)[None] < n[:, None]
        np.testing.assert_allclose(ty.numpy()[keep], np.asarray(jy)[keep],
                                   atol=ATTN_TOL, rtol=0)
        _same_tree(tcache, _np(jcache))
    assert int(tcache["step"].max()) > _S          # the ring wrapped
    for length in (None, np.array([5, 0, 12], np.int32)):
        x = _x(rng, 12, tc.d_model)
        jcache = JL.make_kv_cache(_B, _S, H, hd, jnp.float32, quant=True)
        tcache = TL.make_kv_cache(_B, _S, H, hd, torch.float32, "cpu",
                                  quant=True)
        kw = {} if length is None else {"length": length}
        jy, jcache = jax.jit(lambda p, x, c, **kw: JL.prefill_into_cache(
            p, x, jc, c, **kw))(jp, jnp.asarray(x), jcache,
                                **{k: jnp.asarray(v) for k, v in kw.items()})
        ty, _ = TL.prefill_into_cache(
            tp, torch.from_numpy(x), tc, tcache,
            **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                                   atol=ATTN_TOL, rtol=0)
        _same_tree(tcache, _np(jcache))


def _logical(cache, dtype_view=False):
    """Gathered int8 K/V and scales at pos >= 0, with pos and step."""
    c = bridge.cache_to_numpy(cache) if isinstance(
        next(iter(cache.values())), torch.Tensor) else _np(cache)
    bt = c["bt"]
    B, NB = bt.shape

    def g(key):
        pool = c[key]
        return pool[bt].reshape((B, NB * pool.shape[1]) + pool.shape[2:])
    live = c["pos"] >= 0
    return ({key: g(key)[live] for key in ("kp", "vp", "kp_scale",
                                            "vp_scale")},
            c["pos"], c["step"])


def test_int8_paged_cache_bit_equal_jax():
    """The same masked extends and decode steps on an int8 page pool:
    logical int8 K/V and scales at pos >= 0, pos, step and the tables
    bit-equal to JAX's; masked entries went to the trash page and the
    pages no table maps stay zero. The gathered, dequantized view is the
    port's contiguous int8 cache, dequantized, exactly."""
    jc, tc = _layer_cfgs()
    p = _layer_params(tc, seed=2)
    jp, tp = jax.tree.map(jnp.asarray, p), _to_t(p)
    ext, dec = _jax_ops()
    rng = np.random.default_rng(4)
    H, hd, pool = tc.n_kv_heads, tc.hd, 14
    jcache = JL.make_paged_kv_cache(_B, _S, H, hd, jnp.float32,
                                    page_size=_PS, num_pages=pool,
                                    quant=True)
    tcache = TL.make_paged_kv_cache(_B, _S, H, hd, torch.float32, "cpu",
                                    page_size=_PS, num_pages=pool,
                                    quant=True)
    ccache = TL.make_kv_cache(_B, _S, H, hd, torch.float32, "cpu",
                              quant=True)
    _same_tree(tcache, _np(jcache))
    st = paged_kv.PagedKVState(_B, _S, _PS, pool)
    depth = np.zeros(_B, int)
    for lens in ([8, 5, 0], [3, 8, 0], None, [1, 0, 1]):
        n = np.ones(_B, np.int32) if lens is None else np.array(lens,
                                                                np.int32)
        for b in range(_B):
            st.prepare_write(b, int(depth[b]), int(n[b]))
        bt = st.block_tables.copy()
        jcache = dict(jcache, bt=jnp.asarray(bt))
        tcache["bt"].copy_(torch.from_numpy(bt))
        T = 1 if lens is None else (8 if max(lens) > 1 else 1)
        x = _x(rng, T, tc.d_model)
        if lens is None:
            jy, jcache = dec(jp, jnp.asarray(x), jcache)
            ty, _ = TL.attention_block(tp, torch.from_numpy(x), tc,
                                       cache=tcache)
            cy, _ = TL.attention_block(tp, torch.from_numpy(x), tc,
                                       cache=ccache)
        else:
            jy, jcache = ext(jp, jnp.asarray(x), jcache, jnp.asarray(n))
            ty, _ = TL.extend_into_cache(tp, torch.from_numpy(x), tc,
                                         tcache,
                                         lengths=torch.from_numpy(n))
            cy, _ = TL.extend_into_cache(tp, torch.from_numpy(x), tc,
                                         ccache,
                                         lengths=torch.from_numpy(n))
        keep = np.arange(T)[None] < n[:, None]
        np.testing.assert_allclose(ty.numpy()[keep], np.asarray(jy)[keep],
                                   atol=ATTN_TOL, rtol=0)
        assert torch.equal(ty[torch.from_numpy(keep)],
                           cy[torch.from_numpy(keep)])
        got, gpos, gstep = _logical(tcache)
        want, wpos, wstep = _logical(jcache)
        np.testing.assert_array_equal(gpos, wpos)
        np.testing.assert_array_equal(gstep, wstep)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
        depth += n
        k, v = TL.paged_kv_view(tcache, torch.float32)
        live = torch.from_numpy(gpos >= 0)
        S = k.shape[1]
        kc = TL._dequantize_kv(ccache["k"], ccache["k_scale"], torch.float32)
        vc = TL._dequantize_kv(ccache["v"], ccache["v_scale"], torch.float32)
        assert torch.equal(k[live], kc[:, :S][live])
        assert torch.equal(v[live], vc[:, :S][live])
    unmapped = sorted(set(range(pool)) - set(st.block_tables.ravel()))
    assert unmapped
    for key in ("kp", "vp", "kp_scale", "vp_scale"):
        assert not tcache[key][unmapped].any()


# --------------------------------------------------------------------- #
# (d) the quantized model
# --------------------------------------------------------------------- #
def _jitted(jm):
    return dataclasses.replace(
        jm, decode_step=jax.jit(jm.decode_step), prefill=jax.jit(jm.prefill),
        extend_into_cache=jax.jit(jm.extend_into_cache,
                                  static_argnames="last_only"))


def _quant_pair(variant, quant="", kv_quant=None, scale=1.0):
    """JAX's and the port's model on the same JAX-quantized weights."""
    jc = jax_get_arch("llama3.2-1b", variant=variant).replace(n_kv_heads=2)
    tc = get_arch("llama3.2-1b", variant=variant).replace(n_kv_heads=2)
    if quant:
        jc, tc = jc.replace(quant=quant), tc.replace(quant=quant)
    if kv_quant is not None:
        jc, tc = jc.replace(kv_quant=kv_quant), tc.replace(kv_quant=kv_quant)
    jm = jax_build(jc)
    jp = jax.tree.map(lambda a: a * scale if a.ndim >= 2 else a,
                      jm.init(jax.random.PRNGKey(0)))
    jp = jq.quantize_for_cfg(jp, jc)
    tm = build(tc, device="cpu")
    tp = bridge.params_from_jax(_np(jp), tc, "cpu")
    return jm, jp, tm, tp


_MODEL_CASES = {"edge": ("reduced+edge", "", None),
                "int8_weights": ("reduced", "int8", None),
                "int8_weights_int8_kv": ("reduced", "int8", True)}


@pytest.mark.parametrize("case", sorted(_MODEL_CASES))
def test_quantized_model_matches_jax(case):
    """Chunked extends at per-row lengths, decode steps and a prefill:
    logits within 1e-4 of JAX's quantized model."""
    jm, jp, tm, tp = _quant_pair(*_MODEL_CASES[case])
    jm = _jitted(jm)
    toks = np.random.default_rng(5).integers(0, 1024, (3, 20)).astype(
        np.int32)
    jcache, tcache = jm.make_cache(3, 32), tm.make_cache(3, 32)
    assert (tcache["sub0"]["k"].dtype == torch.int8) == tm.cfg.kv_quant
    lens = np.array([8, 5, 0], np.int32)
    jl, jcache = jm.extend_into_cache(jp, jnp.asarray(toks[:, :8]), jcache,
                                      jnp.asarray(lens))
    tl, _ = tm.extend_into_cache(tp, torch.from_numpy(toks[:, :8]).long(),
                                 tcache, torch.from_numpy(lens))
    for b, n in enumerate(lens):
        np.testing.assert_allclose(tl[b, :n].numpy(), np.asarray(jl)[b, :n],
                                   atol=LOGIT_TOL, rtol=0)
    for t in range(3):
        nxt = toks[:, 8 + t:9 + t]
        jl, jcache = jm.decode_step(jp, jnp.asarray(nxt), jcache)
        tl, _ = tm.decode_step(tp, torch.from_numpy(nxt).long(), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0)
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :12])},
                       jm.make_cache(3, 16))
    tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :12]).long()},
                       tm.make_cache(3, 16))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)


def test_bridge_checks_quantized_trees():
    jm, jp, tm, tp = _quant_pair("reduced+edge")
    tree = _np(jp)
    qt = tp["blocks"]["sub0"]["attn"]["wq"]["w"]
    assert qt["q4"].dtype == torch.int8 and qt["scale"].dtype == \
        torch.float32
    bad = jax.tree.map(lambda a: a, tree)
    bad["blocks"]["sub0"]["attn"]["wq"]["w"]["q4"] = \
        tree["blocks"]["sub0"]["attn"]["wq"]["w"]["q4"].astype(np.int32)
    with pytest.raises(ValueError, match="dtype"):
        bridge.params_from_jax(bad, tm.cfg, "cpu")
    with pytest.raises(ValueError, match="keys"):
        bridge.params_from_jax(tree, tm.cfg.replace(quant="int8"), "cpu")
    with pytest.raises(ValueError, match="shape"):
        bridge.params_from_jax(tree, tm.cfg.replace(quant_group=64), "cpu")
    with pytest.raises(ValueError, match="shape"):
        bridge.params_from_jax(tree, tm.cfg.replace(quant=""), "cpu")


def test_bridge_crosses_jax_int8_caches():
    """JAX's int8 caches, contiguous and paged, cross leaf for leaf and
    serve: the port's decode step runs on them."""
    jm, jp, tm, tp = _quant_pair("reduced+edge")
    for paged in (False, True):
        jcache = jm.make_paged_cache(2, 16, page_size=4, num_pages=9) \
            if paged else jm.make_cache(2, 16)
        tree = _np(jcache)
        got = bridge.cache_from_jax(tree, "cpu")
        _same_tree(got, tree)
        keys = {"kp_scale", "vp_scale"} if paged else {"k_scale", "v_scale"}
        assert keys <= set(got["sub0"])
        tm.decode_step(tp, torch.zeros((2, 1), dtype=torch.long), got)
        assert int(got["sub0"]["step"].max()) == 1


# --------------------------------------------------------------------- #
# (e) the engine
# --------------------------------------------------------------------- #
_ENGINE = {}


def _engine_pair(kind):
    if kind not in _ENGINE:
        variant, quant = {"edge": ("reduced+edge", ""),
                          "int8": ("reduced", "int8")}[kind]
        # weights scaled up so greedy streams of the random model vary
        _ENGINE[kind] = _quant_pair(variant, quant, scale=8.0)
    return _ENGINE[kind]


def _requests():
    rng = np.random.default_rng(1)
    return [(uid, rng.integers(0, 1024, L), mx)
            for uid, (L, mx) in enumerate([(5, 6), (17, 4), (9, 1),
                                           (30, 7), (3, 5), (12, 9)])]


@pytest.mark.parametrize("kind,paged,chunk,kv", [
    ("edge", False, 0, ""), ("edge", False, 8, ""), ("edge", True, 0, ""),
    ("edge", True, 8, ""), ("int8", False, 8, ""), ("int8", True, 0, ""),
    ("int8", False, 0, "int8"), ("int8", True, 8, "int8"),
])
def test_quantized_engine_matches_jax_engine(kind, paged, chunk, kv):
    """The same requests through JAX's and the port's engine on the same
    quantized weights: token streams and finish reasons identical; a
    paged pool drains. ``kv="int8"`` asks the engine for the int8 cache
    (``kv_cache_dtype``), which rebuilds the model as JAX does."""
    jm, jp, tm, tp = _engine_pair(kind)
    kw = dict(max_batch=2, cache_len=48, prefill_chunk=chunk,
              kv_cache_dtype=kv)
    if paged:
        kw.update(paged=True, page_size=8)
    je = JaxEngine(jm, jp, sampler=JaxSampler(), **kw)
    te = Engine(tm, tp, **kw)
    for uid, prompt, mx in _requests():
        je.submit(JaxRequest(uid=uid, prompt=prompt, max_new_tokens=mx))
        te.submit(Request(uid=uid, prompt=prompt, max_new_tokens=mx))
    jr, tr = je.run(), te.run()
    assert sorted(tr) == sorted(jr)
    for uid in jr:
        assert tr[uid].tokens == jr[uid].tokens, uid
        assert tr[uid].finish_reason == jr[uid].finish_reason, uid
    assert len(set(tr[3].tokens)) > 1
    assert te.model.cfg.kv_quant == (kind == "edge" or kv == "int8")
    sub = te.cache["sub0"]
    assert (sub["kp" if paged else "k"].dtype == torch.int8) == \
        te.model.cfg.kv_quant
    if paged:
        st = te.latency_stats()
        assert st["kv_pages_live"] == 0 and st["preemptions"] == 0
        te._paged.check_invariants()


def test_engine_pages_carry_their_scales():
    """A slot's batch-1 view passes the scale pools whole, like the K/V
    pools, and a copy-on-write split copies the scales with the values."""
    from repro_torch.serving.engine import _slot_view
    _, _, tm, tp = _engine_pair("edge")
    te = Engine(tm, tp, max_batch=2, cache_len=32, paged=True, page_size=8)
    te.submit(Request(uid=0, prompt=np.arange(11), max_new_tokens=2))
    te.run()
    view = _slot_view(te.cache, 1)["sub0"]
    for key in ("kp", "vp", "kp_scale", "vp_scale"):
        assert view[key].data_ptr() == te.cache["sub0"][key].data_ptr()
        assert view[key].shape == te.cache["sub0"][key].shape
    assert view["pos"].shape[1] == 1
    sub = te.cache["sub0"]
    for key in ("kp", "vp", "kp_scale", "vp_scale"):
        sub[key][:, 0] = 1
    te._copy_pages([(0, 3)])
    for key in ("kp", "vp", "kp_scale", "vp_scale"):
        assert torch.equal(sub[key][:, 3], sub[key][:, 0])


# --------------------------------------------------------------------- #
# (f) the serve CLI
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("argv,paged,kv8", [
    (["--variant", "reduced+edge", "--paged", "--page-size", "8"], True,
     True),
    (["--variant", "reduced", "--quant", "int8"], False, False),
    (["--variant", "reduced", "--quant", "int4", "--kv-cache-dtype",
      "int8"], False, True),
])
def test_serve_cli_quantized_on_cpu(argv, paged, kv8, capsys):
    from repro_torch.launch import serve
    responses, stats = serve.main(argv + [
        "--arch", "llama3.2-1b", "--device", "cpu", "--requests", "6",
        "--max-new", "8", "--max-batch", "4", "--cache-len", "64",
        "--prefill-chunk", "8", "--temperature", "0"])
    out = capsys.readouterr().out
    assert "tokens=48" in out and "weights=int" in out
    assert ("kv=int8" in out) == kv8
    if paged:
        assert "live=0" in out
    assert all(r.finish_reason == "length" and len(r.tokens) == 8
               for r in responses.values())
