"""The PyTorch port's paged KV serving against the JAX package's.

Everything runs on the CPU with the same inputs on both sides (numpy
from a seed; weights through ``repro_torch.bridge``), fp32:

* (a) the host allocator: the same seeded op sequences give identical
  block tables, refcounts, free lists, ``stats()`` and exceptions on
  JAX's and the port's ``PagedKVState``;
* (b) the plain ``paged_decode_attention`` against JAX's oracle and the
  Pallas kernel in interpret mode (1e-5), on a permuted block table with
  trash entries;
* (c) the model's paged chunked admission and decode against JAX's
  paged model, both attention routes (logits 1e-4, logical K/V at
  ``pos >= 0`` 1e-5, ``pos``/``step`` equal), and the port's paged
  cache against its own contiguous one (bit-equal logits and view);
* (d) the paged ``Engine`` against JAX's paged ``Engine``: identical
  token streams and finish reasons, the same preemption count under pool
  pressure, and a pool that drains;
* (e) the engine's paged errors, and (f) the serve CLI with ``--paged``.

Trash-page contents are never compared between the two packages: JAX's
scatter order on duplicate indices is unspecified, so only logical views
at ``pos >= 0`` and the logits of rows that are kept are held equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.kernels.decode_attention.kernel import \
    paged_decode_attention_pallas  # noqa: E402
from repro.kernels.decode_attention.ref import \
    paged_decode_attention_reference as jax_paged_ref  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro.serving import paged_kv as jax_paged_kv  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro.serving.sampler import Sampler as JaxSampler  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as dec_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.serving import paged_kv  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5


# --------------------------------------------------------------------- #
# (a) the host allocator, op for op
# --------------------------------------------------------------------- #
_B, _KV_LEN, _PS, _POOL = 3, 32, 8, 9


def _replay(mod, ops, pool=_POOL):
    """Drive one package's ``PagedKVState`` through the engine's op
    vocabulary from an integer op stream; return every observable after
    every op (block tables, refcounts, free list, stats, the exception
    raised or None)."""
    st = mod.PagedKVState(_B, _KV_LEN, _PS, pool)
    depths = [None] * _B
    entries = []
    trail = []
    for op, a, n in ops:
        b = a % _B
        err = None
        try:
            if op == 0:                        # provision a write
                if depths[b] is None:
                    depths[b] = 0
                copies = st.prepare_write(b, depths[b], n + 1)
                depths[b] += n + 1
                err = ("copies", copies)
            elif op == 1 and depths[b] and depths[b] >= _PS:
                k = min(a % (depths[b] // _PS) + 1, st.n_blocks)
                entries.append(st.snapshot_prefix(b, k * _PS))
            elif op == 2 and entries:          # alias into a free slot
                free = [i for i in range(_B) if depths[i] is None]
                if free:
                    e = entries[a % len(entries)]
                    st.alias_prefix(free[0], e)
                    depths[free[0]] = len(e) * _PS
            elif op == 3 and depths[b] is not None:
                st.release_slot(b)
                depths[b] = None
            elif op == 4 and entries:
                st.release_pages(entries.pop(a % len(entries)))
            elif op == 5 and depths[b]:
                depths[b] = max(0, depths[b] - (n % (2 * _PS)))
                st.shrink(b, depths[b])
            elif op == 6:                      # forced exhaustion
                st.prepare_write(b, 0, _KV_LEN * (pool + 1))
        except Exception as e:                 # noqa: BLE001
            err = (type(e).__name__, str(e))
        st.check_invariants(entries)
        trail.append((st.block_tables.tolist(), st.alloc.refcount.tolist(),
                      list(st.alloc._free), st.stats(), st.can_admit(n),
                      st.dirty, err))
    return trail


def _ops(seed, steps=200):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, 7)), int(rng.integers(0, 8)),
             int(rng.integers(0, 16))) for _ in range(steps)]


@pytest.mark.parametrize("seed", range(6))
def test_page_state_matches_jax_op_for_op(seed):
    want = _replay(jax_paged_kv, _ops(seed))
    got = _replay(paged_kv, _ops(seed))
    assert got == want
    # the streams exercise every outcome, exhaustion included
    kinds = {t[-1][0] for t in got if t[-1] is not None}
    assert "PagePoolExhausted" in kinds and "copies" in kinds


def test_page_state_guards_match_jax():
    """Double free, retain of a free page, a non-aligned snapshot and the
    module constants behave as in the JAX copy."""
    for mod in (jax_paged_kv, paged_kv):
        st = mod.PagedKVState(1, 16, 8, 4)
        st.prepare_write(0, 0, 8)
        page = int(st.block_tables[0, 0])
        st.release_slot(0)
        with pytest.raises(AssertionError, match="double free"):
            st.alloc.release(page)
        with pytest.raises(AssertionError, match="retain of unallocated"):
            st.alloc.retain(page)
        with pytest.raises(AssertionError, match="page-aligned"):
            st.snapshot_prefix(0, 5)
    assert paged_kv.POOL_KEYS == jax_paged_kv.POOL_KEYS
    assert [paged_kv.num_blocks(n, 8) for n in (1, 8, 9, 64)] == \
        [jax_paged_kv.num_blocks(n, 8) for n in (1, 8, 9, 64)]


# --------------------------------------------------------------------- #
# (b) the paged attention op
# --------------------------------------------------------------------- #
_HD, _HKV, _NB = 16, 2, 6


def _paged_inputs(B, T, G, ps, *, seed):
    """q (B, T, Hq, hd), pools (P+1, ps, Hkv, hd) of random junk, a block
    table that is a seeded permutation of pool pages with the blocks past
    each row's depth at the trash page, and pos/q_pos: row b holds
    positions 0..depth+T-1 and -1 past them (row 0 fully masked)."""
    rng = np.random.default_rng(seed)
    Hq, S = G * _HKV, _NB * ps
    P = B * _NB + 3
    q = rng.normal(size=(B, T, Hq, _HD)).astype(np.float32)
    kp = rng.normal(size=(P + 1, ps, _HKV, _HD)).astype(np.float32)
    vp = rng.normal(size=(P + 1, ps, _HKV, _HD)).astype(np.float32)
    bt = rng.permutation(P)[:B * _NB].reshape(B, _NB).astype(np.int32)
    depth = rng.integers(0, S - T + 1, B)
    slots = np.arange(S)[None]
    pos = np.where(slots < (depth + T)[:, None], slots, -1).astype(np.int32)
    pos[0] = -1
    live_blocks = -(-(depth + T) // ps)
    bt[np.arange(_NB)[None] >= live_blocks[:, None]] = P     # trash
    q_pos = (depth[:, None] + np.arange(T)[None]).astype(np.int32)
    return q, kp, vp, bt, pos, q_pos


_jax_paged = jax.jit(jax_paged_ref, static_argnames="window")


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("T", [1, 4, 8])
def test_paged_attention_plain_matches_jax(T, G, window):
    ps = 8
    args = _paged_inputs(3, T, G, ps, seed=100 * T + 10 * G + window)
    assert (args[3] == args[1].shape[0] - 1).any()      # trash entries
    got = dec_ops.paged_decode_attention(
        *(torch.from_numpy(a) for a in args), window=window).numpy()
    jargs = [jnp.asarray(a) for a in args]
    want = _jax_paged(*jargs, window=window)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    pal = paged_decode_attention_pallas(*jargs, window=window,
                                        interpret=True)
    np.testing.assert_allclose(got, np.asarray(pal), atol=1e-5, rtol=0)


def test_paged_attention_equals_contiguous_on_gathered_view():
    """The paged op is the contiguous op on the gathered logical view,
    exactly, for a base (B,) ``q_pos`` too; its fully masked row is the
    mean of V over that view (trash junk included)."""
    q, kp, vp, bt, pos, q_pos = (torch.from_numpy(a) for a in
                                 _paged_inputs(2, 4, 4, 8, seed=3))
    k, v = TL.paged_kv_view({"kp": kp, "vp": vp, "bt": bt})
    want = dec_ops.cached_decode_attention(q, k, v, pos, q_pos)
    got = dec_ops.paged_decode_attention(q, kp, vp, bt, pos,
                                         q_pos[:, 0].contiguous())
    assert torch.equal(got, want)
    mean_v = v[0].mean(0).repeat_interleave(4, dim=0)
    torch.testing.assert_close(got[0], mean_v.expand_as(got[0]), atol=1e-5,
                               rtol=0)


def test_paged_cpu_tensors_take_the_plain_version(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernel launched for CPU tensors")
    monkeypatch.setattr(dec_kernel, "paged_decode_attention_cuda", boom)
    before = launch_counts()
    dec_ops.paged_decode_attention(*(torch.from_numpy(a) for a in
                                     _paged_inputs(1, 1, 1, 8, seed=0)))
    assert launch_counts() == before
    assert before["paged_decode_attention"] == 0


def test_paged_kernel_wrapper_refuses_cpu_tensors():
    args = [torch.from_numpy(a) for a in _paged_inputs(1, 1, 1, 8, seed=0)]
    with pytest.raises(ValueError, match="CUDA"):
        dec_kernel.paged_decode_attention_cuda(*args)


# --------------------------------------------------------------------- #
# (c) the model on a paged cache
# --------------------------------------------------------------------- #
def _jitted(jm):
    return dataclasses.replace(
        jm, decode_step=jax.jit(jm.decode_step),
        extend_into_cache=jax.jit(jm.extend_into_cache,
                                  static_argnames="last_only"))


def _model_pair(use_kernel=False):
    jc = jax_get_arch("llama3.2-1b", variant="reduced").replace(
        n_kv_heads=2, use_decode_kernel=use_kernel)
    tc = get_arch("llama3.2-1b", variant="reduced").replace(n_kv_heads=2)
    jm = _jitted(jax_build(jc))
    jp = jax_build(jc.replace(use_decode_kernel=False)).init(
        jax.random.PRNGKey(0))
    tm = build(tc, device="cpu")
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jm, jp, tm, tp


_PAIR = {}


def _pair(use_kernel):
    if use_kernel not in _PAIR:
        _PAIR[use_kernel] = _model_pair(use_kernel)
    return _PAIR[use_kernel]


def _push(st, jcache, tcache):
    """The host tables into both caches, as each engine pushes them."""
    jcache = jax_paged_kv.walk_attn(jcache, lambda nd: {
        **nd, "bt": jnp.broadcast_to(jnp.asarray(st.block_tables),
                                     nd["bt"].shape)})
    for sub in tcache.values():
        sub["bt"].copy_(torch.from_numpy(st.block_tables.copy())[None])
    return jcache, tcache


def _logical(cache_np, sub, i):
    """Layer i's gathered (B, S, Hkv, hd) K and V and its pos."""
    node = cache_np[sub]
    bt = node["bt"][i]
    k = node["kp"][i][bt].reshape(bt.shape[0], -1, *node["kp"].shape[3:])
    v = node["vp"][i][bt].reshape(bt.shape[0], -1, *node["vp"].shape[3:])
    return k, v, node["pos"][i]


def _same_paged_cache(tcache, jcache):
    t_np = bridge.cache_to_numpy(tcache)
    j_np = jax.tree.map(np.asarray, jcache)
    for sub in j_np:
        for key in ("pos", "step", "bt"):
            np.testing.assert_array_equal(t_np[sub][key], j_np[sub][key])
        for i in range(j_np[sub]["pos"].shape[0]):
            tk, tv, pos = _logical(t_np, sub, i)
            jk, jv, _ = _logical(j_np, sub, i)
            live = pos >= 0
            np.testing.assert_allclose(tk[live], jk[live], atol=CACHE_TOL,
                                       rtol=0)
            np.testing.assert_allclose(tv[live], jv[live], atol=CACHE_TOL,
                                       rtol=0)


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "decode_kernel"])
def test_paged_model_matches_jax(use_kernel):
    """Batch 3, cache 32 in pages of 8: chunked extends at per-row
    lengths (row 2 idle, so fully masked), two decode steps, and a masked
    T=1 extend (the paged engine's plain step). Logits of kept rows,
    logical K/V at pos >= 0 and pos/step/bt agree after every call."""
    jm, jp, tm, tp = _pair(use_kernel)
    B, S, ps, pool = 3, 32, 8, 10
    st = jax_paged_kv.PagedKVState(B, S, ps, pool)
    jcache = jm.make_paged_cache(B, S, page_size=ps, num_pages=pool)
    tcache = tm.make_paged_cache(B, S, page_size=ps, num_pages=pool)
    assert tcache["sub0"]["kp"].shape == (tm.cfg.n_layers, pool + 1, ps, 2,
                                           tm.cfg.hd)
    toks = np.random.default_rng(5).integers(0, 1024, (B, 24)).astype(
        np.int32)
    depth = np.zeros(B, int)
    for lens in ([8, 5, 0], [3, 8, 0]):
        lens = np.array(lens, np.int32)
        for b in range(B):
            st.prepare_write(b, depth[b], int(lens[b]))
        jcache, tcache = _push(st, jcache, tcache)
        chunk = np.stack([toks[b, depth[b]:depth[b] + 8] for b in range(B)])
        jl, jcache = jm.extend_into_cache(jp, jnp.asarray(chunk), jcache,
                                          jnp.asarray(lens))
        tl, _ = tm.extend_into_cache(tp, torch.from_numpy(chunk).long(),
                                     tcache, torch.from_numpy(lens))
        for b, n in enumerate(lens):
            np.testing.assert_allclose(tl[b, :n].numpy(),
                                       np.asarray(jl)[b, :n],
                                       atol=LOGIT_TOL, rtol=0)
        _same_paged_cache(tcache, jcache)
        depth += lens
    for t in range(2):
        for b in range(B):
            st.prepare_write(b, depth[b], 1)
        jcache, tcache = _push(st, jcache, tcache)
        nxt = toks[:, 16 + t:17 + t]
        jl, jcache = jm.decode_step(jp, jnp.asarray(nxt), jcache)
        tl, _ = tm.decode_step(tp, torch.from_numpy(nxt).long(), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0)
        _same_paged_cache(tcache, jcache)
        depth += 1
    lens = np.array([1, 0, 1], np.int32)
    for b in range(B):
        st.prepare_write(b, depth[b], int(lens[b]))
    jcache, tcache = _push(st, jcache, tcache)
    nxt = toks[:, 18:19]
    jl, jcache = jm.extend_into_cache(jp, jnp.asarray(nxt), jcache,
                                      jnp.asarray(lens), last_only=True)
    tl, _ = tm.extend_into_cache(tp, torch.from_numpy(nxt).long(), tcache,
                                 torch.from_numpy(lens), last_only=True)
    for b in (0, 2):
        np.testing.assert_allclose(tl[b].numpy(), np.asarray(jl)[b],
                                   atol=LOGIT_TOL, rtol=0)
    _same_paged_cache(tcache, jcache)


def _feed(tm, tp, cache, prompt, chunk=8, state=None):
    """Feed ``prompt`` through chunked batch-1 extends, provisioning
    pages (paged) as the engine does. Returns the last logits."""
    lo = None
    for base in range(0, len(prompt), chunk):
        n = min(chunk, len(prompt) - base)
        if state is not None:
            assert state.prepare_write(0, base, n) == []
            cache["sub0"]["bt"].copy_(
                torch.from_numpy(state.block_tables.copy())[None])
        buf = np.zeros((1, chunk), np.int64)
        buf[0, :n] = prompt[base:base + n]
        lo, _ = tm.extend_into_cache(tp, torch.from_numpy(buf), cache,
                                     torch.tensor([n], dtype=torch.int32),
                                     last_only=True)
    return lo


def test_paged_view_bit_equality_after_admission():
    """After identical chunked admission the port's paged cache, gathered
    through its block table, is bit-identical to its contiguous cache at
    the logical positions, and the next-token logits are bit-equal."""
    _, _, tm, tp = _pair(False)
    Lp, S, ps = 13, 32, 8
    prompt = np.random.default_rng(42).integers(0, 1024, Lp)
    st = paged_kv.PagedKVState(1, S, ps, 8)
    pc = tm.make_paged_cache(1, S, page_size=ps, num_pages=8)
    cc = tm.make_cache(1, S)
    lo_p = _feed(tm, tp, pc, prompt, state=st)
    lo_c = _feed(tm, tp, cc, prompt)
    assert torch.equal(lo_p, lo_c)
    for i in range(tm.cfg.n_layers):
        layer = {k: v[i] for k, v in pc["sub0"].items()}
        k, v = TL.paged_kv_view(layer)
        assert torch.equal(k[:, :Lp], cc["sub0"]["k"][i][:, :Lp])
        assert torch.equal(v[:, :Lp], cc["sub0"]["v"][i][:, :Lp])
        for key in ("pos", "step"):
            assert torch.equal(layer[key], cc["sub0"][key][i])
    assert st.cow_splits == 0


def test_paged_cache_unported_layouts_raise():
    """The int8 pool is ported: its leaves have JAX's keys, shapes and
    dtypes (int8 pools, f32 scale pools of one scale per slot and head).
    A paged cache of an SSM stack (mamba2-780m) raises as JAX's does."""
    from repro.models import transformer as JT
    from repro_torch.models import transformer as TT
    _, _, tm, _ = _pair(False)
    jcfg = jax_get_arch("llama3.2-1b", variant="reduced").replace(
        n_kv_heads=2, kv_quant=True)
    quant = build(tm.cfg.replace(kv_quant=True), device="cpu")
    got = quant.make_paged_cache(2, 20, page_size=8, num_pages=5)
    want = jax.tree.map(np.asarray, JT.make_paged_cache(
        jcfg, 2, 20, page_size=8, num_pages=5))
    assert set(got["sub0"]) == set(want["sub0"]) == {
        "kp", "vp", "kp_scale", "vp_scale", "bt", "pos", "step"}
    for key, leaf in want["sub0"].items():
        t = bridge.cache_to_numpy({"x": got["sub0"][key]})["x"]
        assert t.shape == leaf.shape and t.dtype == leaf.dtype, key
        np.testing.assert_array_equal(t, leaf)
    assert got["sub0"]["kp_scale"].shape == (tm.cfg.n_layers, 6, 8, 2)
    assert got["sub0"]["kp"].dtype == torch.int8
    assert tm.supports_paged and quant.supports_paged
    ssm_cfg = get_arch("mamba2-780m", variant="reduced")
    with pytest.raises(NotImplementedError, match="attention-only"):
        JT.make_paged_cache(jax_get_arch("mamba2-780m", variant="reduced"),
                            1, 16, page_size=8, num_pages=4)
    with pytest.raises(NotImplementedError, match="attention-only"):
        TT.make_paged_cache(ssm_cfg, 1, 16, page_size=8, num_pages=4)
    assert not build(ssm_cfg, device="cpu").supports_paged


def test_bridge_crosses_a_jax_paged_cache():
    """A JAX engine's paged cache holds read-only ``np.broadcast_to``
    block tables after a push; it crosses leaf for leaf, each leaf a
    tensor of its own."""
    je = JaxEngine(_JM, _JP, max_batch=2, cache_len=32, sampler=JaxSampler(),
                   prefill_chunk=8, paged=True, page_size=8)
    je.submit(JaxRequest(uid=0, prompt=np.arange(11), max_new_tokens=3))
    je.run()
    je._paged.prepare_write(1, 0, 9)             # a live table to push
    je._push_block_tables()
    tree = jax.tree.map(np.asarray, je.cache)
    bt = tree["sub0"]["bt"]
    assert not bt.flags.writeable and 0 in bt.strides
    got = bridge.cache_from_jax(tree, "cpu")
    assert set(got["sub0"]) == {"kp", "vp", "bt", "pos", "step"}
    assert got["sub0"]["bt"].dtype == torch.int32
    back = bridge.cache_to_numpy(got)
    for key in ("kp", "vp", "bt", "pos", "step"):
        np.testing.assert_array_equal(back["sub0"][key], tree["sub0"][key])
    # each layer's table is a tensor of its own, not a view of one row
    assert bt[1, 1, 0] != 7
    got["sub0"]["bt"][0, 1, 0] = 7
    assert int(got["sub0"]["bt"][1, 1, 0]) == bt[1, 1, 0]
    # the crossed cache serves: the port's paged decode runs on it
    _TM.decode_step(_TP, torch.zeros((2, 1), dtype=torch.long),
                    bridge.cache_from_jax(tree, "cpu"))


# --------------------------------------------------------------------- #
# (d) the paged engine
# --------------------------------------------------------------------- #
def _engine_models():
    jc = jax_get_arch("llama3.2-1b", variant="reduced").replace(n_kv_heads=2)
    tc = get_arch("llama3.2-1b", variant="reduced").replace(n_kv_heads=2)
    jm, tm = jax_build(jc), build(tc, device="cpu")
    # weights scaled up so greedy streams of the random model vary
    jp = jax.tree.map(lambda a: a * 8 if a.ndim >= 2 else a,
                      jm.init(jax.random.PRNGKey(0)))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jm, jp, tm, tp


_JM, _JP, _TM, _TP = _engine_models()


def _serve_both(reqs, **kw):
    """The same (uid, prompt, max_new) requests through JAX's and the
    port's engine with the same arguments; returns both engines, their
    responses and the port's requests."""
    je = JaxEngine(_JM, _JP, sampler=JaxSampler(), **kw)
    te = Engine(_TM, _TP, **kw)
    treqs = [Request(uid=uid, prompt=prompt, max_new_tokens=mx)
             for uid, prompt, mx in reqs]
    for (uid, prompt, mx), req in zip(reqs, treqs):
        je.submit(JaxRequest(uid=uid, prompt=prompt, max_new_tokens=mx))
        te.submit(req)
    return je, je.run(), te, te.run(), treqs


def _assert_same(jr, tr):
    assert sorted(tr) == sorted(jr)
    for uid in jr:
        assert tr[uid].tokens == jr[uid].tokens, uid
        assert tr[uid].finish_reason == jr[uid].finish_reason, uid


def _drained(te):
    st = te.latency_stats()
    assert st["kv_pages_live"] == 0
    assert st["kv_pages_free"] == st["kv_pages_total"] == te.num_pages
    te._paged.check_invariants()
    return st


@pytest.mark.parametrize("chunk", [0, 8])
def test_paged_engine_matches_jax_engine(chunk):
    rng = np.random.default_rng(1)
    reqs = [(uid, rng.integers(0, 1024, L), mx)
            for uid, (L, mx) in enumerate([(5, 6), (17, 4), (9, 1),
                                           (30, 7), (3, 5), (12, 9)])]
    je, jr, te, tr, _ = _serve_both(reqs, max_batch=2, cache_len=48,
                                 prefill_chunk=chunk, paged=True,
                                 page_size=8)
    _assert_same(jr, tr)
    assert len(set(tr[3].tokens)) > 1
    st = _drained(te)
    jst = je.latency_stats()
    for key in ("kv_pages_total", "kv_page_size", "kv_pages_released",
                "kv_cow_splits", "preemptions", "chunked_admissions"):
        assert st[key] == jst[key], key
    assert st["kv_pages_released"] > 0 and st["preemptions"] == 0


def test_paged_engine_matches_contiguous_engine():
    rng = np.random.default_rng(2)
    reqs = [(uid, rng.integers(0, 1024, L), 5)
            for uid, L in enumerate((3, 11, 7, 20))]

    def run(**kw):
        te = Engine(_TM, _TP, max_batch=2, cache_len=32, prefill_chunk=8,
                    **kw)
        for uid, p, mx in reqs:
            te.submit(Request(uid=uid, prompt=p, max_new_tokens=mx))
        return {u: r.tokens for u, r in te.run().items()}, te
    base, _ = run()
    out, te = run(paged=True, page_size=8)
    assert out == base
    _drained(te)
    assert set(te.step_kinds) == {"plain", "mixed"}


def test_page_exhaustion_backpressure_matches_jax():
    """A pool of 4 pages (one full stream) serves two 20-token prompts by
    queueing the second until the first releases its pages."""
    rng = np.random.default_rng(42)
    reqs = [(uid, rng.integers(0, 1024, 20), 4) for uid in range(2)]
    je, jr, te, tr, _ = _serve_both(reqs, max_batch=2, cache_len=32,
                                 paged=True, page_size=8, num_pages=4)
    _assert_same(jr, tr)
    assert all(len(r.tokens) == 4 for r in tr.values())
    st = _drained(te)
    assert st["preemptions"] == je.latency_stats()["preemptions"] == 0
    # the second request waited: the two admissions never overlapped
    assert st["chunked_admissions"] == 2


def test_pool_pressure_preempts_and_resumes_as_jax():
    """A pool of 5 pages of 8: both streams admit, then outgrow the pool
    mid-decode; one is preempted, requeued and resumed by replay. The
    streams equal JAX's (and an unpreempted run), with the same number
    of preemptions."""
    rng = np.random.default_rng(1)
    reqs = [(0, rng.integers(0, 1024, 12), 12),
            (1, rng.integers(0, 1024, 13), 12)]
    kw = dict(max_batch=2, cache_len=32, prefill_chunk=8)
    je, jr, te, tr, treqs = _serve_both(reqs, paged=True, page_size=8,
                                        num_pages=5, **kw)
    _assert_same(jr, tr)
    st = _drained(te)
    assert st["preemptions"] >= 1
    assert st["preemptions"] == je.latency_stats()["preemptions"]
    assert sum(r.preemptions for r in treqs) == st["preemptions"]
    base = Engine(_TM, _TP, **kw)
    for uid, prompt, mx in reqs:
        base.submit(Request(uid=uid, prompt=prompt, max_new_tokens=mx))
    assert {u: r.tokens for u, r in tr.items()} == \
        {u: r.tokens for u, r in base.run().items()}


def test_pool_drains_where_the_jax_engine_keeps_a_page():
    """Four slots on a 9-page pool with 8 requests: provisioning polls
    and preempts; a poll inside provisioning can finish the very slot
    being provisioned. The port allocates nothing for it then, so the
    pool drains; the JAX engine allocates the page anyway and holds it
    until the slot is reused (here: never). Streams, finish reasons and
    preemptions agree."""
    rng = np.random.default_rng(0)
    reqs = [(uid, rng.integers(0, 1024, int(rng.integers(8, 17))), 12)
            for uid in range(8)]
    je, jr, te, tr, _ = _serve_both(reqs, max_batch=4, cache_len=64,
                                 prefill_chunk=8, paged=True, page_size=8,
                                 num_pages=9)
    _assert_same(jr, tr)
    st = _drained(te)
    assert st["preemptions"] >= 1
    assert st["preemptions"] == je.latency_stats()["preemptions"]


# --------------------------------------------------------------------- #
# (e) errors and (f) the CLI
# --------------------------------------------------------------------- #
def test_paged_engine_errors():
    with pytest.raises(ValueError, match="cannot hold one full stream"):
        Engine(_TM, _TP, max_batch=2, cache_len=32, paged=True,
               page_size=8, num_pages=3)
    te = Engine(_TM, _TP, max_batch=1, cache_len=32, paged=True,
                page_size=8)
    assert te.num_pages == 1 * 4 + 2 * 1           # the default sizing
    with pytest.raises(ValueError, match="KV capacity"):
        te.submit(Request(uid=0, prompt=np.arange(40), max_new_tokens=2))
    swa = build(_TM.cfg.replace(sliding_window=16), device="cpu")
    te = Engine(swa, _TP, max_batch=1, cache_len=32, paged=True,
                page_size=8)
    with pytest.raises(ValueError, match="KV capacity"):
        te.submit(Request(uid=0, prompt=np.arange(20), max_new_tokens=2))


def test_serve_cli_paged_on_cpu(capsys):
    from repro_torch.launch import serve
    responses, stats = serve.main([
        "--arch", "llama3.2-1b", "--variant", "reduced", "--device", "cpu",
        "--requests", "8", "--max-new", "12", "--max-batch", "4",
        "--cache-len", "64", "--prefill-chunk", "8", "--temperature", "0",
        "--paged", "--page-size", "8"])
    out = capsys.readouterr().out
    assert "kv pages: total=40 live=0" in out and "tokens=96" in out
    assert stats["n_finished"] == 8 and stats["kv_pages_live"] == 0
    assert all(r.finish_reason == "length" and len(r.tokens) == 12
               for r in responses.values())
