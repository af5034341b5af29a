"""The PyTorch port's dense decoder against the JAX package's.

The same weights (JAX's, crossed over with ``repro_torch.bridge``) and
the same token inputs (numpy, from a seed) go through both models on the
CPU in fp32. Every mode is compared: ``forward_train``, ``prefill``,
``decode_step`` and ``extend_step`` (logits within 1e-4, every cache
leaf within 1e-5, positions exactly), at G = 1 (the ``reduced``
variant) and G = 2 (``n_kv_heads=2``), since ``reduced`` alone does not
exercise grouped-query attention. The JAX model runs both its plain
attention and its ``use_decode_kernel=True`` route.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.model import build  # noqa: E402

LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
KV_HEADS = [None, 2]                     # G = 1 (reduced), G = 2


def _jitted(jm):
    """The JAX model with its step functions jitted (one compile per
    shape instead of one per op)."""
    import dataclasses
    return dataclasses.replace(
        jm, train_loss=jax.jit(jm.train_loss), prefill=jax.jit(jm.prefill),
        decode_step=jax.jit(jm.decode_step),
        extend_into_cache=jax.jit(jm.extend_into_cache,
                                  static_argnames="last_only"))


def _pair(n_kv=None, **kw):
    jc = jax_get_arch("llama3.2-1b", variant="reduced")
    tc = get_arch("llama3.2-1b", variant="reduced")
    if n_kv:
        kw["n_kv_heads"] = n_kv
    if kw:
        tc = tc.replace(**kw)
        jc = jc.replace(**kw)
    jm, tm = _jitted(jax_build(jc)), build(tc, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jm, jp, tm, tp


_MODELS = {}


def _models(n_kv):
    if n_kv not in _MODELS:
        _MODELS[n_kv] = _pair(n_kv)
    return _MODELS[n_kv]


def _tokens(shape, seed, vocab=1024):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _t(a):
    return torch.from_numpy(np.array(a)).long()


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


def _same_cache(tcache, jcache):
    t_np = bridge.cache_to_numpy(tcache)
    j_np = jax.tree.map(np.asarray, jcache)
    for sub in j_np:
        for leaf in ("k", "v"):
            _close(t_np[sub][leaf], j_np[sub][leaf], CACHE_TOL)
        for leaf in ("pos", "step"):
            assert t_np[sub][leaf].dtype == np.int32
            np.testing.assert_array_equal(t_np[sub][leaf], j_np[sub][leaf])


# --------------------------------------------------------------------- #
# bridge
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trips_params_and_cache(dtype):
    jc = jax_get_arch("llama3.2-1b", variant="reduced").replace(
        dtype=dtype, param_dtype=dtype)
    tc = get_arch("llama3.2-1b", variant="reduced").replace(
        dtype=dtype, param_dtype=dtype)
    jm = jax_build(jc)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    back = bridge.params_to_numpy(bridge.params_from_jax(tree, tc, "cpu"))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    ctree = jax.tree.map(np.asarray, jm.make_cache(2, 16))
    cback = bridge.cache_to_numpy(bridge.cache_from_jax(ctree, "cpu"))
    for a, b in zip(jax.tree.leaves(ctree), jax.tree.leaves(cback)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_bridge_rejects_mismatched_tree():
    jm, jp, _, _ = _models(None)
    tree = jax.tree.map(np.asarray, jp)
    tc = get_arch("llama3.2-1b", variant="reduced").replace(n_kv_heads=2)
    with pytest.raises(ValueError, match="shape"):
        bridge.params_from_jax(tree, tc, "cpu")
    del tree["ln_f"]
    with pytest.raises(ValueError, match="keys"):
        bridge.params_from_jax(tree, tc, "cpu")


# --------------------------------------------------------------------- #
# every mode against JAX
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n_kv", KV_HEADS)
def test_forward_train_matches_jax(n_kv):
    jm, jp, tm, tp = _models(n_kv)
    toks = _tokens((2, 12), seed=0)
    jl, _ = jm.train_loss(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.train_loss(tp, {"tokens": _t(toks)})
    assert abs(float(jl) - float(tl)) < LOGIT_TOL
    from repro.models import transformer as JT
    from repro_torch.models import transformer as TT
    jlog, _ = JT.forward_train(jp, jm.cfg, jnp.asarray(toks))
    tlog, _ = TT.forward_train(tp, tm.cfg, _t(toks))
    _close(tlog, jlog)


@pytest.mark.parametrize("n_kv", KV_HEADS)
def test_prefill_decode_extend_match_jax(n_kv):
    """Prefill with per-row lengths (one of them 0), then a decode step,
    then an extend whose rows advance by 3, 0 and 1 of T = 4 tokens:
    logits at every valid position and every cache leaf agree."""
    jm, jp, tm, tp = _models(n_kv)
    toks = _tokens((3, 16), seed=1)
    length = np.array([8, 0, 5], np.int32)
    jcache, tcache = jm.make_cache(3, 24), tm.make_cache(3, 24)
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :8]),
                                 "length": jnp.asarray(length)}, jcache)
    tl, tcache = tm.prefill(tp, {"tokens": _t(toks[:, :8]),
                                 "length": torch.from_numpy(length)}, tcache)
    _close(tl, jl)
    _same_cache(tcache, jcache)
    jl, jcache = jm.decode_step(jp, jnp.asarray(toks[:, 8:9]), jcache)
    tl, tcache = tm.decode_step(tp, _t(toks[:, 8:9]), tcache)
    _close(tl, jl)
    _same_cache(tcache, jcache)
    lens = np.array([3, 0, 1], np.int32)
    before = bridge.cache_to_numpy(tcache)
    jl, jcache = jm.extend_into_cache(jp, jnp.asarray(toks[:, 9:13]), jcache,
                                      jnp.asarray(lens))
    tl, tcache = tm.extend_into_cache(tp, _t(toks[:, 9:13]), tcache,
                                      torch.from_numpy(lens))
    for b, n in enumerate(lens):
        _close(tl[b, :n], np.asarray(jl)[b, :n])
    _same_cache(tcache, jcache)
    # the masked tail is left as it was: row 1 entirely, row 0 past t=3
    after = bridge.cache_to_numpy(tcache)
    for leaf in ("k", "v", "pos"):
        np.testing.assert_array_equal(after["sub0"][leaf][:, 1],
                                      before["sub0"][leaf][:, 1])
    step0 = int(before["sub0"]["step"][0, 0])
    tail = [(step0 + t) % 24 for t in (3,)]
    for leaf in ("k", "v", "pos"):
        np.testing.assert_array_equal(after["sub0"][leaf][:, 0, tail],
                                      before["sub0"][leaf][:, 0, tail])


@pytest.mark.parametrize("n_kv", KV_HEADS)
def test_extend_last_only_and_full_window_match_jax(n_kv):
    jm, jp, tm, tp = _models(n_kv)
    toks = _tokens((2, 6), seed=2)
    jcache, tcache = jm.make_cache(2, 16), tm.make_cache(2, 16)
    jl, jcache = jm.extend_into_cache(jp, jnp.asarray(toks), jcache)
    tl, tcache = tm.extend_into_cache(tp, _t(toks), tcache)
    _close(tl, jl)
    lens = np.array([2, 4], np.int32)
    more = _tokens((2, 4), seed=3)
    jl, jcache = jm.extend_into_cache(jp, jnp.asarray(more), jcache,
                                      jnp.asarray(lens), last_only=True)
    tl, tcache = tm.extend_into_cache(tp, _t(more), tcache,
                                      torch.from_numpy(lens), last_only=True)
    assert tl.shape == (2, 1, tm.cfg.vocab)
    _close(tl, jl)
    _same_cache(tcache, jcache)


@pytest.mark.parametrize("n_kv", KV_HEADS)
def test_cached_paths_match_jax_decode_kernel_route(n_kv):
    """JAX with ``use_decode_kernel=True`` (its decode-attention op, the
    route a TPU takes to the Pallas kernel) against the port, whose
    cached attention always goes through its decode-attention op."""
    _, jp, tm, tp = _models(n_kv)
    jcfg = jax_get_arch("llama3.2-1b", variant="reduced").replace(
        use_decode_kernel=True, **({"n_kv_heads": n_kv} if n_kv else {}))
    jm = _jitted(jax_build(jcfg))
    toks = _tokens((2, 9), seed=4)
    jcache, tcache = jm.make_cache(2, 16), tm.make_cache(2, 16)
    lens = np.array([5, 8], np.int32)
    jl, jcache = jm.extend_into_cache(jp, jnp.asarray(toks[:, :8]), jcache,
                                      jnp.asarray(lens))
    tl, tcache = tm.extend_into_cache(tp, _t(toks[:, :8]), tcache,
                                      torch.from_numpy(lens))
    for b, n in enumerate(lens):
        _close(tl[b, :n], np.asarray(jl)[b, :n])
    jl, jcache = jm.decode_step(jp, jnp.asarray(toks[:, 8:]), jcache)
    tl, tcache = tm.decode_step(tp, _t(toks[:, 8:]), tcache)
    _close(tl, jl)
    _same_cache(tcache, jcache)


def test_sliding_window_ring_matches_jax():
    """A window-8 ring: prefill 6 tokens, then decode past the ring's end
    so slots are overwritten and the window mask does the hiding."""
    jm, jp, tm, tp = _pair(2, sliding_window=8)
    toks = _tokens((2, 6), seed=5)
    jcache, tcache = jm.make_cache(2, 32), tm.make_cache(2, 32)
    assert tcache["sub0"]["k"].shape[2] == 8
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jcache)
    tl, tcache = tm.prefill(tp, {"tokens": _t(toks)}, tcache)
    for _ in range(6):
        _close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None]
        jl, jcache = jm.decode_step(jp, jnp.asarray(nxt), jcache)
        tl, tcache = tm.decode_step(tp, _t(nxt), tcache)
    _close(tl, jl)
    _same_cache(tcache, jcache)


@pytest.mark.parametrize("n_kv", KV_HEADS)
def test_greedy_prefill_decode_loop_token_identical(n_kv):
    """16 greedy tokens after a prefill: each side follows its own argmax
    and the two streams are identical (weights scaled up so the random
    model's stream is not one repeated token)."""
    jm, jp, tm, _ = _models(n_kv)
    jp = jax.tree.map(lambda a: a * 8 if a.ndim >= 2 else a, jp)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg, "cpu")
    prompt = _tokens((1, 7), seed=6)
    jcache, tcache = jm.make_cache(1, 32), tm.make_cache(1, 32)
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, jcache)
    tl, tcache = tm.prefill(tp, {"tokens": _t(prompt)}, tcache)
    jstream, tstream = [], []
    step = jm.decode_step
    for _ in range(16):
        jstream.append(int(jnp.argmax(jl[0, -1])))
        tstream.append(int(torch.argmax(tl[0, -1])))
        jl, jcache = step(jp, jnp.asarray([[jstream[-1]]]), jcache)
        tl, tcache = tm.decode_step(tp, _t([[tstream[-1]]]), tcache)
    assert tstream == jstream
    assert len(set(tstream)) > 1


def test_set_cache_steps_rewinds_steps_only():
    from repro_torch.models import transformer as TT
    _, _, tm, tp = _models(None)
    cache = tm.make_cache(2, 16)
    tm.extend_into_cache(tp, _t(_tokens((2, 5), seed=7)), cache)
    pos = cache["sub0"]["pos"].clone()
    TT.set_cache_steps(cache, torch.tensor([2, 5]))
    assert TT.cache_steps(cache).tolist() == [2, 5]
    assert torch.equal(cache["sub0"]["pos"], pos)


def test_unported_configs_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_arch("qwen2-moe-a2.7b")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_arch("llama3.2-1b", variant="reduced+spec")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build(get_arch("llama3.2-1b").replace(family="moe"), device="cpu")
    assert get_arch("llama3.2-1b", variant="reduced+swa").sliding_window \
        == 4096


def test_param_shapes_full_width():
    """The port's full-width tree has the JAX config's parameter count."""
    from repro.configs import param_count
    from repro_torch.models.transformer import param_shapes
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(
        param_shapes(get_arch("llama3.2-1b")),
        is_leaf=lambda x: isinstance(x, tuple)))
    # JAX's analytic count leaves out the final norm's d scales
    assert n == param_count(jax_get_arch("llama3.2-1b")) + 2048
    assert 1.2e9 < n < 1.3e9
