"""The port's frontend families at the model level against the JAX
package: the encoder-decoder (seamless-m4t-medium, ``models/encdec.py``)
and the VLM's embedding prefix (pixtral-12b).

On the CPU in fp32 at the ``reduced`` width (2 encoder and 2 decoder
layers, d_model 256, 16 frontend tokens of 64 dims), the JAX package's
weights crossed through ``repro_torch.bridge``, frames and tokens from
a numpy seed. Logits, losses and cache leaves within 1e-4 (f32 sums in
another order; the bound ``test_torch_families_models.py`` uses),
positions and depths exact:

* seamless: ``encode`` and ``cross_kv_all``; ``prefill`` of right-padded
  rows, decodes and a chunked ``extend`` (every cache leaf, the memory
  included); ``forward_train`` and ``train_loss``; the ``edge`` variant
  (int4 weights: an int8 self ring beside a memory in the model dtype,
  its leaves JAX's); the port's own decode-matches-forward (as
  ``tests/test_decode_consistency.py`` holds JAX's); ``set_cache_steps``
  over a cache with bare ``xk``/``xv`` tensors; the full-width
  parameter tree; the quantized leaf set;
* pixtral: ``Model.prefill`` with ``embeddings`` and a text ``length``
  (logits and every cache leaf) and ``train_loss`` with embeddings,
  the two faults this slice repairs (the facade ignored the
  embeddings), and the embedding chunk through ``extend_into_cache``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import quant as jq  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import encdec as JED  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import encdec as ED  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.model import build, param_shapes  # noqa: E402
from repro_torch.quant.qtensor import is_qtensor  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-4
SEAMLESS, PIXTRAL = "seamless-m4t-medium", "pixtral-12b"


@functools.lru_cache(maxsize=None)
def _pair(arch, variant="reduced"):
    jc = jax_get_arch(arch, variant=variant)
    tc = get_arch(arch, variant=variant)
    jm, tm = jax_build(jc), build(tc, device="cpu")
    jp = jq.quantize_for_cfg(jm.init(jax.random.PRNGKey(0)), jc)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, jm, jp, tc, tm, tp


def _inputs(cfg, B, L_tok, seed):
    rng = np.random.default_rng(seed)
    fe = cfg.frontend
    toks = rng.integers(0, cfg.vocab, (B, L_tok)).astype(np.int32)
    frames = rng.normal(0, 1, (B, fe.n_tokens, fe.d_embed)).astype(
        np.float32)
    return toks, frames


def _t(a):
    a = torch.from_numpy(np.asarray(a))
    return a.long() if a.dtype == torch.int32 else a


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               atol=tol, rtol=0)


def _caches_close(tcache, jcache, tol=TOL, rows=None):
    """Every leaf of the port's cache against JAX's: floats within
    ``tol``, integers (positions, depths, int8 K/V) exact. ``rows``: the
    batch rows to compare (all by default)."""
    got = bridge.cache_to_numpy(tcache)
    want = jax.tree.map(np.asarray, jcache)

    def walk(g, w, path):
        if isinstance(w, dict):
            assert set(g) == set(w), path
            for k in w:
                walk(g[k], w[k], path + (k,))
            return
        assert g.shape == w.shape and g.dtype == w.dtype, (path, g.shape,
                                                           w.shape)
        if rows is not None:
            g, w = g[:, rows], w[:, rows]
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=str(path))
        else:
            _close(g, w, tol)

    walk(got, want, ())


# --------------------------------------------------------------------- #
# the encoder-decoder
# --------------------------------------------------------------------- #
def test_encode_and_cross_kv_match_jax():
    jc, jm, jp, tc, tm, tp = _pair(SEAMLESS)
    _, frames = _inputs(tc, 2, 4, seed=1)
    jmem = JED.encode(jp, jc, frames)
    tmem = ED.encode(tp, tc, _t(frames))
    _close(tmem, jmem)
    jxk, jxv = JED.cross_kv_all(jp, jc, jmem)
    txk, txv = ED.cross_kv_all(tp, tc, tmem)
    assert tuple(txk.shape) == (tc.n_layers, 2, tc.frontend.n_tokens,
                                tc.n_kv_heads, tc.hd)
    _close(txk, jxk)
    _close(txv, jxv)
    # the facade's encode_memory is the same pair
    fk, fv = tm.encode_memory(tp, _t(frames))
    assert torch.equal(fk, txk) and torch.equal(fv, txv)


def test_prefill_decode_extend_match_jax():
    jc, jm, jp, tc, tm, tp = _pair(SEAMLESS)
    toks, frames = _inputs(tc, 2, 10, seed=2)
    length = np.array([10, 6], np.int32)
    batch = {"tokens": toks, "embeddings": frames, "length": length}
    jcache = jm.make_cache(2, 32)
    jlo, jcache = jax.jit(jm.prefill)(jp, batch, jcache)
    tcache = tm.make_cache(2, 32)
    tlo, _ = tm.prefill(tp, {k: _t(v) for k, v in batch.items()}, tcache)
    _close(tlo, jlo)
    _caches_close(tcache, jcache)
    rng = np.random.default_rng(5)
    jdec = jax.jit(jm.decode_step)
    for _ in range(3):
        nxt = rng.integers(0, tc.vocab, (2, 1)).astype(np.int32)
        jlo, jcache = jdec(jp, nxt, jcache)
        tlo, _ = tm.decode_step(tp, _t(nxt), tcache)
        _close(tlo, jlo)
    # chunked extend: a full chunk and a short row, then the verify
    # window (every row by T)
    jext = jax.jit(jm.extend_into_cache)
    for T, lens in ((6, [6, 2]), (4, [1, 4])):
        ext = rng.integers(0, tc.vocab, (2, T)).astype(np.int32)
        lens = np.array(lens, np.int32)
        jlo, jcache = jext(jp, ext, jcache, lens)
        tlo, _ = tm.extend_into_cache(tp, _t(ext), tcache, _t(lens))
        for b, n in enumerate(lens):
            _close(tlo[b, :n], np.asarray(jlo)[b, :n])
    ver = rng.integers(0, tc.vocab, (2, 3)).astype(np.int32)
    jlo, jcache = jax.jit(jm.verify_step)(jp, ver, jcache)
    tlo, _ = tm.verify_step(tp, _t(ver), tcache)
    _close(tlo, jlo)
    _caches_close(tcache, jcache)
    assert tm.cache_steps(tcache).tolist() == \
        np.asarray(jm.cache_steps(jcache)).tolist()


def test_forward_train_and_loss_match_jax():
    jc, jm, jp, tc, tm, tp = _pair(SEAMLESS)
    toks, frames = _inputs(tc, 2, 9, seed=3)
    jl, ja = JED.forward_train(jp, jc, toks, frames)
    tl, ta = ED.forward_train(tp, tc, _t(toks), _t(frames))
    _close(tl, jl)
    assert float(ta) == float(ja) == 0.0
    jloss, _ = jm.train_loss(jp, {"tokens": toks, "embeddings": frames})
    tloss, _ = tm.train_loss(tp, {"tokens": _t(toks),
                                  "embeddings": _t(frames)})
    _close(tloss, jloss)


def test_edge_variant_caches_match_jax():
    """``edge``: int4 weights (the cross-attention, ``frontend_proj`` and
    the LM head quantized too) and an int8 self ring with f32 scales,
    while the memory stays in the model dtype. The prefill's logits
    (read from the unrounded K/V) are held to 1e-4. The port's and
    JAX's K/V before rounding differ by f32 sum order (~1e-7), so an
    entry that close to a rounding tie may land one int8 step apart (1
    of 32768 here); such a step moves a decode's logits by up to ~2e-4,
    so the decodes and the extend that read the int8 ring are held to
    1e-3, and the int8 leaves to one step at no more than 1 in 1000
    entries; scales, the memory, positions and depths as elsewhere."""
    jc, jm, jp, tc, tm, tp = _pair(SEAMLESS, "reduced+edge")
    assert is_qtensor(tp["dec_layers"]["cross_attn"]["wq"]["w"])
    assert is_qtensor(tp["frontend_proj"]["w"])
    toks, frames = _inputs(tc, 2, 8, seed=4)
    batch = {"tokens": toks, "embeddings": frames}
    jcache = jm.make_cache(2, 32)
    tcache = tm.make_cache(2, 32)
    assert tcache["self"]["k"].dtype == torch.int8
    assert "k_scale" in tcache["self"]
    assert tcache["xk"].dtype == torch.float32
    jlo, jcache = jax.jit(jm.prefill)(jp, batch, jcache)
    tlo, _ = tm.prefill(tp, {k: _t(v) for k, v in batch.items()}, tcache)
    _close(tlo, jlo)
    rng = np.random.default_rng(6)
    for _ in range(2):
        nxt = rng.integers(0, tc.vocab, (2, 1)).astype(np.int32)
        jlo, jcache = jax.jit(jm.decode_step)(jp, nxt, jcache)
        tlo, _ = tm.decode_step(tp, _t(nxt), tcache)
        _close(tlo, jlo, 1e-3)
    ext = rng.integers(0, tc.vocab, (2, 4)).astype(np.int32)
    jlo, jcache = jax.jit(jm.extend_into_cache)(jp, ext, jcache)
    tlo, _ = tm.extend_into_cache(tp, _t(ext), tcache)
    _close(tlo, jlo, 1e-3)
    got = bridge.cache_to_numpy(tcache)
    for k in ("k", "v"):
        d = np.abs(got["self"][k].astype(np.int32)
                   - np.asarray(jcache["self"][k]).astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, k
        _close(got["self"][k + "_scale"], jcache["self"][k + "_scale"])
    for k in ("pos", "step"):
        np.testing.assert_array_equal(got["self"][k],
                                      np.asarray(jcache["self"][k]))
    for k in ("xk", "xv"):
        _close(got[k], jcache[k])


def test_decode_matches_forward():
    """The port's own consistency, as ``tests/test_decode_consistency.py``
    holds JAX's: prefill of L tokens then ``extra`` decodes give the
    cache-free forward's logits at every position."""
    _, _, _, tc, tm, tp = _pair(SEAMLESS)
    B, Lp, extra = 2, 12, 4
    toks, frames = _inputs(tc, B, Lp + extra, seed=7)
    full, _ = ED.forward_train(tp, tc, _t(toks), _t(frames))
    cache = tm.make_cache(B, Lp + extra)
    lo, _ = tm.prefill(tp, {"tokens": _t(toks[:, :Lp]),
                            "embeddings": _t(frames)}, cache)
    _close(lo[:, 0], full[:, Lp - 1])
    for i in range(extra):
        lo, _ = tm.decode_step(tp, _t(toks[:, Lp + i:Lp + i + 1]), cache)
        if Lp + i < toks.shape[1]:
            _close(lo[:, 0], full[:, Lp + i])


def test_set_cache_steps_passes_the_memory_through():
    _, _, _, tc, tm, tp = _pair(SEAMLESS)
    toks, frames = _inputs(tc, 2, 6, seed=8)
    cache = tm.make_cache(2, 16)
    tm.prefill(tp, {"tokens": _t(toks), "embeddings": _t(frames)}, cache)
    pos = cache["self"]["pos"].clone()
    xk = cache["xk"].clone()
    out = tm.rollback(cache, torch.tensor([2, 5]))
    assert out is cache
    assert tm.cache_steps(cache).tolist() == [2, 5]
    assert TT.cache_steps(cache).tolist() == [2, 5]
    assert torch.equal(cache["self"]["pos"], pos)
    assert torch.equal(cache["xk"], xk)


def test_param_shapes_full_width_as_jax():
    tc, jc = get_arch(SEAMLESS), jax_get_arch(SEAMLESS)
    want = jax.eval_shape(jax_build(jc).init, jax.random.PRNGKey(0))
    got = param_shapes(tc)          # the tree the bridge checks against

    def same(g, w, path):
        if isinstance(w, dict):
            assert set(g) == set(w), path
            for k in w:
                same(g[k], w[k], path + (k,))
        else:
            assert tuple(g) == tuple(w.shape), path

    same(got, want, ())


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_leaf_set_as_jax(quant):
    """``quantize_for_cfg`` quantizes the same leaves as JAX's: every
    projection (encoder, self- and cross-attention, MLPs,
    ``frontend_proj``, the LM head), not the norms or the table."""
    jc, jm, jp, tc, tm, tp = _pair(SEAMLESS)
    jq_tree = jq.quantize_for_cfg(jp, jc.replace(quant=quant))
    from repro_torch.quant import quantize_for_cfg
    tq_tree = quantize_for_cfg(tp, tc.replace(quant=quant))

    def paths(tree, is_q, path=()):
        if is_q(tree):
            return {path}
        if isinstance(tree, dict):
            return set().union(*(paths(v, is_q, path + (k,))
                                 for k, v in tree.items()))
        return set()

    from repro.quant.qtensor import is_qtensor as jax_is_q
    got, want = paths(tq_tree, is_qtensor), paths(jq_tree, jax_is_q)
    assert got == want
    assert ("frontend_proj", "w") in got and ("lm_head", "w") in got


def test_routes_on_cpu_are_plain_attention():
    """On CPU tensors the encoder's and the cross-attention's routes are
    plain ``gqa_attention(causal=False)``, the JAX model's."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 5, 4, 16), generator=g)
    k = torch.randn((2, 7, 2, 16), generator=g)
    v = torch.randn((2, 7, 2, 16), generator=g)
    want = L.gqa_attention(q, k, v, causal=False)
    assert torch.equal(L.full_attention(q, k, v), want)
    assert torch.equal(L.memory_attention(q, k, v), want)
    row = L.memory_positions(7, "cpu")
    assert row is L.memory_positions(7, "cpu")
    assert row.tolist() == list(range(7))


def test_encdec_without_an_encoder_raises():
    cfg = get_arch("llama3.2-1b").replace(family="encdec")
    with pytest.raises(NotImplementedError):
        build(cfg, device="cpu")
    _, _, _, tc, tm, tp = _pair(SEAMLESS)
    assert not tm.supports_paged
    with pytest.raises(NotImplementedError):
        tm.make_paged_cache(2, 32, page_size=8, num_pages=8)


# --------------------------------------------------------------------- #
# the VLM's embedding prefix
# --------------------------------------------------------------------- #
def test_vlm_prefill_with_embeddings_matches_jax():
    """``Model.prefill`` runs the projected frontend prefix before the
    text and counts it into ``length``: logits and every cache leaf are
    JAX's (the facade used to drop the embeddings)."""
    jc, jm, jp, tc, tm, tp = _pair(PIXTRAL)
    toks, frames = _inputs(tc, 2, 9, seed=11)
    length = np.array([9, 4], np.int32)
    batch = {"tokens": toks, "embeddings": frames, "length": length}
    jcache = jm.make_cache(2, 40)
    jlo, jcache = jax.jit(jm.prefill)(jp, batch, jcache)
    tcache = tm.make_cache(2, 40)
    tlo, _ = tm.prefill(tp, {k: _t(v) for k, v in batch.items()}, tcache)
    _close(tlo, jlo)
    _caches_close(tcache, jcache)
    assert tm.cache_steps(tcache).tolist() == [16 + 9, 16 + 4]


def test_vlm_train_loss_with_embeddings_matches_jax():
    """``train_loss`` runs the prefix and drops its positions before the
    loss, as JAX's does."""
    jc, jm, jp, tc, tm, tp = _pair(PIXTRAL)
    toks, frames = _inputs(tc, 2, 10, seed=12)
    jloss, jm_ = jm.train_loss(jp, {"tokens": toks, "embeddings": frames})
    tloss, tm_ = tm.train_loss(tp, {"tokens": _t(toks),
                                    "embeddings": _t(frames)})
    _close(tloss, jloss)
    _close(tm_["lm_loss"], jm_["lm_loss"])


def test_vlm_embedding_chunk_matches_jax():
    """The engine's embedding chunk: ``extend_into_cache`` with tokens
    None and the frames as ``embeddings`` (every row by n_tokens), then
    a text chunk, equal to JAX's."""
    jc, jm, jp, tc, tm, tp = _pair(PIXTRAL)
    toks, frames = _inputs(tc, 2, 5, seed=13)
    jcache = jm.make_cache(2, 40)
    tcache = tm.make_cache(2, 40)
    jlo, jcache = jax.jit(
        lambda p, e, c: jm.extend_into_cache(p, None, c, embeddings=e))(
        jp, frames, jcache)
    tlo, _ = tm.extend_into_cache(tp, None, tcache, embeddings=_t(frames))
    _close(tlo, jlo)
    lens = np.array([5, 3], np.int32)
    jlo, jcache = jax.jit(jm.extend_into_cache)(jp, toks, jcache, lens)
    tlo, _ = tm.extend_into_cache(tp, _t(toks), tcache, _t(lens))
    for b, n in enumerate(lens):
        _close(tlo[b, :n], np.asarray(jlo)[b, :n])
    _caches_close(tcache, jcache)
