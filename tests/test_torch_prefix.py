"""The PyTorch port's prefix cache against the JAX package's.

On the CPU, at the reduced width ``tests/test_torch_engine.py`` uses
(``n_kv_heads=2``, the same bridged weights on both sides, greedy), with
prompts made from a numpy seed:

* the trie (``serving/prefix_cache.py``): the JAX unit script, ``wants``'
  coverage check, ``on_evict`` and seeded op sequences give the same
  returns and ``stats()`` on both copies;
* the slot copies: the port's in-place materialize, extract and position
  stamp, and its copy-on-write page copy (a forced split: an alias into a
  second slot, then a write on a shared page), on a JAX engine's cache
  crossed through ``repro_torch.bridge``, equal the JAX engine's slot
  programs bitwise, leaf for leaf;
* the engine, on the rings and the paged pool: hits (whole and partial),
  eviction under the token cap, int8 KV, LRU reclaim under page pressure,
  the chaos schedule, a preemption while prefix pages are shared and the
  forced-exhaustion ladder give tokens and finish reasons identical to
  the JAX engine's, the prefix stats equal JAX's and the pools drain;
  the pool serves hits by page alias with no copy;
* the SSM engine builds no prefix cache, the ``continuous`` variant and
  the serve CLI's ``--prefix-cache-tokens`` work, and a hit after
  ``mark_steady`` builds nothing and warns nothing (a standing divergence:
  the JAX engine jits a materialize program per hit length).
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro.serving import prefix_cache as jax_prefix_cache  # noqa: E402
from repro.serving import telemetry as jax_telemetry  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro.serving.sampler import Sampler as JaxSampler  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.serving import prefix_cache, telemetry  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402


def _models():
    jc = jax_get_arch("llama3.2-1b", variant="reduced").replace(n_kv_heads=2)
    tc = get_arch("llama3.2-1b", variant="reduced").replace(n_kv_heads=2)
    jm, tm = jax_build(jc), build(tc, device="cpu")
    # weights scaled up so greedy streams of the random model vary
    jp = jax.tree.map(lambda a: a * 8 if a.ndim >= 2 else a,
                      jm.init(jax.random.PRNGKey(0)))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jm, jp, tm, tp


_JM, _JP, _TM, _TP = _models()
_V = 1024
_RNG = np.random.default_rng(61)
_HEAD = _RNG.integers(0, _V, 16)
#: three prompts behind one 16-token head, and one sharing only its first
#: 8 tokens (a partial hit)
_SHARED = [np.concatenate([_HEAD, _RNG.integers(0, _V, n)])
           for n in (9, 5, 12)] \
    + [np.concatenate([_HEAD[:8], _RNG.integers(0, _V, 14)])]

#: engine arguments of each layout, with the prefix cache on
LAYOUTS = {
    "ring": dict(prefill_chunk=8, prefix_cache_tokens=256),
    "paged": dict(prefill_chunk=8, prefix_cache_tokens=256, paged=True,
                  page_size=8),
}
PREFIX_KEYS = ("prefix_entries", "prefix_tokens", "prefix_hits",
               "prefix_misses", "prefix_hit_tokens", "prefix_evictions")
POOL_KEYS = ("kv_pages_total", "kv_pages_live", "kv_pages_free",
             "kv_alias_pages", "kv_cow_splits", "kv_pages_released")


def _serve_both(prompts, max_new=6, faults=None, **kw):
    """The same requests through the JAX and the port's engine with the
    same arguments; returns (JAX engine, port engine, the port's
    requests)."""
    kw.setdefault("max_batch", 2)
    kw.setdefault("cache_len", 64)
    je = JaxEngine(_JM, _JP, sampler=JaxSampler(), faults=_jax_faults(faults),
                   **kw)
    te = Engine(_TM, _TP, faults=faults if faults is not None else False,
                **kw)
    treqs = [Request(uid=u, prompt=p, max_new_tokens=max_new)
             for u, p in enumerate(prompts)]
    for u, (p, r) in enumerate(zip(prompts, treqs)):
        je.submit(JaxRequest(uid=u, prompt=p, max_new_tokens=max_new))
        te.submit(r)
    je.run()
    te.run()
    return je, te, treqs


def _jax_faults(spec):
    from repro.serving import faults as jax_faults

    if spec is None:
        return jax_faults.NoFaults()
    return jax_faults.Faults.parse(spec)


def _out(engine):
    return {u: (list(r.tokens), r.finish_reason)
            for u, r in engine.responses.items()}


def _same(je, te, keys=PREFIX_KEYS):
    """Tokens, finish reasons and the named stats equal on both sides."""
    assert _out(te) == _out(je)
    js, ts = je.latency_stats(), te.latency_stats()
    for k in keys:
        if k in js:
            assert ts[k] == js[k], k
    return ts


def _cold(prompts, max_new=6, **kw):
    """The port's streams with the prefix cache off."""
    kw = dict(kw, prefix_cache_tokens=0)
    kw.setdefault("max_batch", 2)
    kw.setdefault("cache_len", 64)
    te = Engine(_TM, _TP, faults=False, **kw)
    for u, p in enumerate(prompts):
        te.submit(Request(uid=u, prompt=p, max_new_tokens=max_new))
    te.run()
    return {u: toks for u, (toks, _) in _out(te).items()}


def _drain(te):
    """Drop every entry: the pool must end empty, its invariants whole."""
    while te.prefix_cache.drop_lru():
        pass
    assert te._paged.live_pages == 0
    assert te._paged.free_pages == te.num_pages
    te._paged.check_invariants()


# --------------------------------------------------------------------- #
# the trie, no engine
# --------------------------------------------------------------------- #
def _unit_script(mod):
    """JAX's trie unit test as a trail of every return and stats()."""
    pc = mod.PrefixCache(capacity_tokens=64, chunk=8)
    trail = [(pc.bucket(7), pc.bucket(8), pc.bucket(31))]
    a = list(range(40))
    trail.append(pc.wants(a))
    pc.insert(a, 32, kv="A")
    trail.append(pc.wants(a))
    trail.append(pc.lookup(a[:33]))
    trail.append(pc.lookup(a[:20] + [999] * 30))
    trail.append(pc.lookup([999, 998]))
    trail.append(pc.lookup(a[:32]))
    b = [1000 + i for i in range(40)]
    pc.insert(b, 32, kv="B")
    c = [2000 + i for i in range(24)]
    pc.insert(c, 16, kv="C")
    trail.append((pc.tokens, pc.evictions, len(pc)))
    trail.append(pc.lookup(a[:33]))
    trail.append(pc.lookup(b))
    trail.append(pc.lookup(c[:17]))
    trail.append(pc.stats())
    return trail


def test_trie_unit_script_matches_jax():
    got, want = _unit_script(prefix_cache), _unit_script(jax_prefix_cache)
    assert got == want
    assert got[0] == (0, 8, 16) and got[1] == 32 and got[2] == 0
    assert got[3] == ("A", 32, 32) and got[4] == ("A", 32, 16)
    assert got[5][0] is None and got[6][2] == 16
    assert got[7][0] <= 64 and got[7][1] >= 1 and got[8][0] is None


def test_wants_is_coverage_as_jax():
    """A prompt covered by a longer stored entry wants nothing stored."""
    trails = []
    for mod in (jax_prefix_cache, prefix_cache):
        pc = mod.PrefixCache(capacity_tokens=256, chunk=8)
        a = list(range(40))
        pc.insert(a, 32, kv="A")
        trails.append((pc.wants(a[:24] + [999]), pc.lookup(a[:24] + [999]),
                       pc.wants([7] * 40), pc.tokens, len(pc), pc.stats()))
    assert trails[1] == trails[0]
    assert trails[1][:5] == (0, ("A", 32, 16), 32, 32, 1)


def test_on_evict_fires_with_the_entry_as_jax():
    trails = []
    for mod in (jax_prefix_cache, prefix_cache):
        released = []
        pc = mod.PrefixCache(capacity_tokens=16, chunk=8,
                             on_evict=lambda e: released.append(e["kv"]))
        pc.insert(list(range(20)), 16, kv=[3, 4])
        pc.insert([100 + i for i in range(20)], 16, kv=[5, 6])
        step = (pc.evictions, list(released))
        trails.append((step, pc.drop_lru(), list(released), pc.drop_lru(),
                       pc.stats()))
    assert trails[1] == trails[0]
    assert trails[1][:4] == ((1, [[3, 4]]), True, [[3, 4], [5, 6]], False)


def _op_trail(mod, seed):
    """A seeded stream of lookups, wants, inserts and drops over prompts
    that share heads at several depths."""
    rng = np.random.default_rng(seed)
    heads = [list(rng.integers(0, 50, 40)) for _ in range(3)]
    pc = mod.PrefixCache(capacity_tokens=96, chunk=8,
                         on_evict=lambda e: None)
    trail = []
    for i in range(120):
        h = heads[int(rng.integers(0, 3))]
        cut = int(rng.integers(0, 41))
        prompt = h[:cut] + list(rng.integers(0, 50, int(rng.integers(1, 20))))
        op = int(rng.integers(0, 4))
        if op == 0:
            got = pc.lookup(prompt)
        elif op == 1:
            got = pc.wants(prompt)
        elif op == 2:
            P = pc.wants(prompt)
            got = pc.insert(prompt, P, kv=i)
        else:
            got = pc.drop_lru()
        trail.append((op, got, pc.stats(), [e["kv"] for e in
                                            pc._entries.values()]))
    return trail


@pytest.mark.parametrize("seed", range(4))
def test_trie_matches_jax_op_for_op(seed):
    got, want = _op_trail(prefix_cache, seed), _op_trail(jax_prefix_cache,
                                                          seed)
    assert got == want
    hits = [t for t in got if t[0] == 0 and t[1][0] is not None]
    assert hits and any(t[2]["prefix_evictions"] for t in got)


def test_entries_lists_every_kv_least_recent_first():
    pc = prefix_cache.PrefixCache(capacity_tokens=64, chunk=8)
    pc.insert(list(range(20)), 16, kv="A")
    pc.insert([50 + i for i in range(20)], 16, kv="B")
    pc.lookup(list(range(17)))              # A becomes the newest
    assert pc.entries() == ["B", "A"]
    assert pc.drop_lru() and pc.entries() == ["A"]


# --------------------------------------------------------------------- #
# the slot copies against the JAX engine's slot programs, bitwise
# --------------------------------------------------------------------- #
def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_equal(got, want):
    assert set(got) == set(want)
    for name in want:
        assert set(got[name]) == set(want[name]), name
        for k in want[name]:
            np.testing.assert_array_equal(
                bridge.cache_to_numpy({"x": {k: got[name][k]}})["x"][k],
                np.asarray(want[name][k]), err_msg=f"{name}/{k}")


def _warm_pair(kv_dtype="", paged=False):
    """A JAX engine that served two prompts behind one head (so it holds
    an entry and a cache with two written slots) and a port engine of the
    same arguments on a copy of that cache."""
    kw = dict(max_batch=2, cache_len=32, prefill_chunk=8,
              prefix_cache_tokens=64, kv_cache_dtype=kv_dtype)
    if paged:
        kw.update(paged=True, page_size=8)
    je = JaxEngine(_JM, _JP, sampler=JaxSampler(), **kw)
    for u, p in enumerate(_SHARED[:2]):
        je.submit(JaxRequest(uid=u, prompt=p, max_new_tokens=3))
    je.run()
    te = Engine(_TM, _TP, **kw)
    te.cache = bridge.cache_from_jax(_np(je.cache), "cpu")
    return je, te


@pytest.mark.parametrize("kv", ["", "int8"], ids=["fp32", "int8"])
@pytest.mark.parametrize("upto", [8, 16], ids=["partial", "whole"])
def test_materialize_matches_jax_slot_program(kv, upto):
    """The entry's first ``upto`` positions copied into slot 1 in place,
    the position row stamped: every cache leaf equals the JAX engine's
    ``materialize`` program on the same cache and entry."""
    je, te = _warm_pair(kv)
    (entry,) = [e["kv"] for e in je.prefix_cache._entries.values()]
    cache = _np(je.cache)
    part = jax.tree.map(lambda t: t[:, :, :upto], entry)
    want = _np(je._get_slot_fn("materialize", upto)(cache, part,
                                                    jnp.int32(1)))
    te._materialize(1, bridge.cache_from_jax(_np(entry), "cpu"), upto)
    _assert_tree_equal(te.cache, want)
    pos = te.cache["sub0"]["pos"][:, 1]
    assert pos[:, :upto].eq(torch.arange(upto)).all() \
        and pos[:, upto:].eq(-1).all()
    assert te.cache["sub0"]["step"][:, 1].eq(upto).all()


@pytest.mark.parametrize("kv", ["", "int8"], ids=["fp32", "int8"])
def test_extract_matches_jax_slot_program(kv):
    """The clone of slot 0's first 16 positions equals the JAX engine's
    ``extract`` program, and later writes to the slot leave it as it
    was."""
    je, te = _warm_pair(kv)
    want = _np(je._get_slot_fn("extract", 16)(_np(je.cache), jnp.int32(0)))
    got = te._extract(0, 16)
    _assert_tree_equal(got, want)
    assert set(got["sub0"]) == ({"k", "v", "k_scale", "v_scale"} if kv
                                else {"k", "v"})
    te._reset_slot(0)
    te.cache["sub0"]["k"][:, 0].fill_(3)
    _assert_tree_equal(got, want)


@pytest.mark.parametrize("upto", [0, 16])
def test_position_stamp_matches_jax_reset_program(upto):
    """The paged hit's stamp (``upto`` > 0) and the plain reset equal the
    JAX engine's ``reset`` program with P = ``upto``."""
    je, te = _warm_pair(paged=True)
    want = _np(je._get_slot_fn("reset", upto)(_np(je.cache), jnp.int32(1)))
    te._reset_slot(1, upto)
    _assert_tree_equal(te.cache, want)


@pytest.mark.parametrize("kv", ["", "int8"], ids=["fp32", "int8"])
def test_forced_split_copies_pages_as_jax(kv, monkeypatch):
    """A forced copy-on-write split: alias the published entry's pages
    into slot 1, then provision a write over both shared pages. The pool
    leaves after the port's ``_copy_pages`` equal the JAX engine's page
    copy program on the same pools and (src, dst) pairs, bitwise."""
    je, te = _warm_pair(kv, paged=True)
    st = te._paged
    # the host allocator's state crosses too: the entry pins its pages
    st.alloc.refcount[:] = je._paged.alloc.refcount
    st.alloc._free[:] = je._paged.alloc._free
    st.block_tables[:] = je._paged.block_tables
    (pages,) = [e["kv"] for e in je.prefix_cache._entries.values()]
    st.release_slot(1)
    st.alias_prefix(1, pages)
    before = jax.tree.map(np.copy, bridge.cache_to_numpy(te.cache))
    seen = []
    real = te._copy_pages
    monkeypatch.setattr(te, "_copy_pages",
                        lambda copies: (seen.append(list(copies)),
                                        real(copies)))
    assert te._provision(1, 0, 16)
    assert len(seen) == 1 and len(seen[0]) == 2 and st.cow_splits == 2
    src = jnp.asarray([s for s, _ in seen[0]], jnp.int32)
    dst = jnp.asarray([d for _, d in seen[0]], jnp.int32)
    want = _np(je._get_page_copy(2)(before, src, dst))
    _assert_tree_equal(te.cache, want)
    for s, d in seen[0]:
        np.testing.assert_array_equal(te.cache["sub0"]["kp"][:, d].numpy(),
                                      te.cache["sub0"]["kp"][:, s].numpy())
    st.check_invariants([pages])


# --------------------------------------------------------------------- #
# the engine against the JAX engine
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_hits_match_cold_and_jax(layout):
    """Requests behind a shared head: every hit, the partial one too,
    serves tokens identical to the cold run and to the JAX engine, with
    JAX's prefix (and pool) stats; the pool serves hits by alias and
    drains once the entries go."""
    je, te, _ = _serve_both(_SHARED, **LAYOUTS[layout])
    st = _same(je, te, PREFIX_KEYS + POOL_KEYS)
    assert {u: t for u, (t, _) in _out(te).items()} == _cold(
        _SHARED, **LAYOUTS[layout])
    assert st["prefix_hits"] == 3 and st["prefix_hit_tokens"] == 40
    assert st["prefix_entries"] >= 1
    if layout == "paged":
        assert st["kv_alias_pages"] == 5 and st["kv_cow_splits"] == 0
        _drain(te)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_eviction_under_the_token_cap_matches_jax(layout):
    """Four distinct 16-token heads under a 32-token budget: LRU entries
    go, stored tokens stay under the cap and every stream is the cold
    one; on the pool each eviction released its pages."""
    rng = np.random.default_rng(7)
    prompts = [np.concatenate([rng.integers(0, _V, 16),
                               rng.integers(0, _V, 4)]) for _ in range(4)]
    kw = dict(LAYOUTS[layout], prefix_cache_tokens=32)
    je, te, _ = _serve_both(prompts, **kw)
    st = _same(je, te, PREFIX_KEYS + POOL_KEYS)
    assert {u: t for u, (t, _) in _out(te).items()} == _cold(prompts, **kw)
    assert st["prefix_tokens"] <= 32 and st["prefix_evictions"] >= 2
    if layout == "paged":
        assert te._paged.live_pages == 2 * len(te.prefix_cache)
        _drain(te)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_int8_kv_hits_match_jax(layout):
    """With an int8 KV cache the entries carry the scales: hits equal the
    JAX engine's int8 run and the port's own cold int8 run."""
    kw = dict(LAYOUTS[layout], kv_cache_dtype="int8")
    je, te, _ = _serve_both(_SHARED, **kw)
    st = _same(je, te, PREFIX_KEYS + POOL_KEYS)
    assert st["prefix_hits"] == 3
    assert {u: t for u, (t, _) in _out(te).items()} == _cold(_SHARED, **kw)
    if layout == "ring":
        (entry, _) = te.prefix_cache.entries()
        assert entry["sub0"]["k"].dtype == torch.int8
        assert set(entry["sub0"]) == {"k", "v", "k_scale", "v_scale"}
    else:
        _drain(te)


def test_lru_reclaim_while_shared_matches_jax():
    """A 5-page pool: the reclaim loop evicts A's just-published entry
    (still aliased by A itself) to admit B, B waits for A's pages; both
    stream as cold, and the surviving entries drain the pool."""
    rng = np.random.default_rng(8)
    pa, pb = rng.integers(0, _V, 20), rng.integers(0, _V, 24)
    kw = dict(LAYOUTS["paged"], prefix_cache_tokens=64, num_pages=5,
              cache_len=32)
    je, te, _ = _serve_both([pa, pb], max_new=4, **kw)
    st = _same(je, te, PREFIX_KEYS + POOL_KEYS + ("preemptions",))
    assert st["prefix_evictions"] >= 1
    assert {u: t for u, (t, _) in _out(te).items()} == _cold(
        [pa, pb], max_new=4, prefill_chunk=8, cache_len=32)
    _drain(te)


def test_pool_hits_alias_pages_with_no_copy(monkeypatch):
    """On the pool a hit bumps refcounts: alias pages counted, and the
    rings' materialize and extract copies never run."""
    def refuse(*a, **k):
        raise AssertionError("a ring copy ran on the paged pool")

    monkeypatch.setattr(Engine, "_materialize", refuse)
    monkeypatch.setattr(Engine, "_extract", refuse)
    je, te, _ = _serve_both(_SHARED, **LAYOUTS["paged"])
    st = _same(je, te, PREFIX_KEYS + POOL_KEYS)
    assert st["kv_alias_pages"] >= 2 * (16 // 8)
    assert te.program_cache_sizes() == {"step": 1, "mixed": 2}
    _drain(te)


CHAOS = "nan_logits@6/1,page_alloc@9x2,slow_step@4+0.002"


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("schedule", ["", CHAOS], ids=["empty", "chaos"])
def test_chaos_schedule_in_prefix_mode_matches_jax(layout, schedule):
    """The chaos suite's ``prefix`` mode: one stream errors, the others
    equal the fault-free run and JAX's; an empty schedule is invisible
    (tokens and programs)."""
    prompts = [_HEAD[:8].tolist() + list(np.random.default_rng(u).integers(
        0, _V, n)) for u, n in enumerate((5, 9, 12, 7))]
    prompts = [np.asarray(p) for p in prompts]
    clean = _cold(prompts, max_new=10, **LAYOUTS[layout])
    je, te, _ = _serve_both(prompts, max_new=10, faults=schedule,
                            **LAYOUTS[layout])
    st = _same(je, te, PREFIX_KEYS + POOL_KEYS + (
        "slot_errors", "faults_injected", "preemptions"))
    out = _out(te)
    assert st["slot_errors"] == (1 if schedule else 0)
    for u, (toks, reason) in out.items():
        if reason != "error":
            assert reason == "length" and toks == clean[u], u
    assert te.program_cache_sizes() == {"step": 1, "mixed": 2}
    if layout == "paged":
        snap = te.metrics.snapshot()["collected"]
        assert snap["prefix_hits"] == st["prefix_hits"]
        _drain(te)


def test_preempt_while_prefix_pages_shared_matches_jax():
    """A 6-page pool forces a victim while the head's pages are aliased:
    refcounts stay exact through evict and resume, the streams equal the
    ring run, and dropping the entries drains the pool."""
    rng = np.random.default_rng(5)
    head = rng.integers(0, _V, 16)
    prompts = [np.concatenate([head, rng.integers(0, _V, n)])
               for n in (4, 6)]
    kw = dict(LAYOUTS["paged"], cache_len=48, num_pages=6)
    je, te, treqs = _serve_both(prompts, max_new=14, **kw)
    st = _same(je, te, PREFIX_KEYS + POOL_KEYS + ("preemptions",))
    assert st["preemptions"] >= 1 and st["prefix_hits"] >= 1
    ring = _cold(prompts, max_new=14, prefill_chunk=8, cache_len=48)
    assert {u: t for u, (t, _) in _out(te).items()} == ring
    assert [r.preemptions for r in treqs] == \
        [je.requests[u].preemptions for u in range(2)]
    _drain(te)


def test_forced_exhaustion_runs_through_the_prefix_rung_as_jax():
    """The forced ``page_alloc`` of the lifecycle suite (twice, from the
    fifth step on), with two prefix entries stored: each firing evicts an
    entry, the ladder's first rung, which costs no poll, so neither engine
    polls or preempts there and the port agrees with JAX. (The standing
    divergence of the lifecycle suite's
    ``test_forced_exhaustion_on_a_slot_the_poll_finished_diverges`` needs
    an empty cache, where the rung frees nothing.)"""
    from repro.serving import faults as jax_faults
    from repro_torch.serving import faults

    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, _V, L) for L in (5, 9)]
    heads = [np.concatenate([np.random.default_rng(100 + u).integers(
        0, _V, 16), np.arange(3)]) for u in range(2)]
    sides = []
    for mod, mk in ((jax_faults, JaxRequest), (faults, Request)):
        sched = mod.Faults(seed=0)
        kw = dict(LAYOUTS["paged"], max_batch=2, cache_len=64, faults=sched)
        e = JaxEngine(_JM, _JP, sampler=JaxSampler(), **kw) \
            if mod is jax_faults else Engine(_TM, _TP, **kw)
        for u, p in enumerate(heads):
            e.submit(mk(uid=10 + u, prompt=p, max_new_tokens=2))
        e.run()
        assert len(e.prefix_cache) == 2
        sched.on("page_alloc", step=e._steps + 5, times=2)
        e.submit(mk(uid=0, prompt=prompts[0], max_new_tokens=3))
        e.submit(mk(uid=1, prompt=prompts[1], max_new_tokens=20))
        e.run()
        st = e.latency_stats()
        sides.append((_out(e), st["preemptions"], st["prefix_evictions"],
                      st["prefix_entries"],
                      sched.stats()["faults_fired_page_alloc"]))
        while e.prefix_cache.drop_lru():
            pass
        assert e._paged.live_pages == 0
    assert sides[1] == sides[0]
    assert sides[1][1:3] == (0, 2) and sides[1][4] == 2


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_collected_prefix_stats_and_counters_match_jax(layout):
    """The registry's ``collected`` block carries the prefix stats, equal
    to JAX's; the host-side counters agree, and ``reset_stats`` zeroes the
    prefix counters but keeps the entries, as in JAX."""
    je, te, _ = _serve_both(_SHARED, max_new=4, **LAYOUTS[layout])
    got, want = te.metrics.snapshot(), je.metrics.snapshot()
    assert got["collected"] == want["collected"]
    assert got["collected"]["prefix_hits"] == 3
    for k in ("tokens_emitted", "steps_total", "chunked_admissions",
              "steps_mixed", "steps_plain"):
        assert got["counters"].get(k) == want["counters"].get(k), k
    je.reset_stats()
    te.reset_stats()
    js, ts = je.latency_stats(), te.latency_stats()
    for k in PREFIX_KEYS:
        assert ts[k] == js[k], k
    assert ts["prefix_hits"] == 0 and ts["prefix_entries"] >= 1


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tracer_admission_base_is_the_hit_length_as_jax(layout):
    """``recorder.on_admission`` receives the hit length: the traced
    spans' ``args`` equal the JAX tracer's."""
    from repro_torch.serving import tracing

    je = JaxEngine(_JM, _JP, sampler=JaxSampler(), recorder=True,
                   max_batch=2, cache_len=64, **LAYOUTS[layout])
    te = Engine(_TM, _TP, recorder=True, max_batch=2, cache_len=64,
                **LAYOUTS[layout])
    for u, p in enumerate(_SHARED):
        je.submit(JaxRequest(uid=u, prompt=p, max_new_tokens=4))
        te.submit(Request(uid=u, prompt=p, max_new_tokens=4))
    je.run()
    te.run()
    got = {k: v["args"] for k, v in
           tracing.complete_spans(te.export_trace()).items()}
    from repro.serving import tracing as jax_tracing
    want = {k: v["args"] for k, v in
            jax_tracing.complete_spans(je.export_trace()).items()}
    assert got == want
    assert [te.recorder.requests[u]["base"] for u in range(4)] \
        == [0, 16, 16, 8]


def test_resumed_admission_publishes_nothing():
    """A preempted stream re-admits with its generated tokens appended:
    it may hit, but it publishes nothing (its prompt was published on its
    first admission)."""
    te = Engine(_TM, _TP, max_batch=2, cache_len=64, faults=False,
                **LAYOUTS["ring"])
    te.submit(Request(uid=0, prompt=_SHARED[0], max_new_tokens=20))
    te.tick(4)
    te.tick(4)
    entries = len(te.prefix_cache)
    assert entries == 1 and te._preempt_one()
    inserted = []
    real = te.prefix_cache.insert
    te.prefix_cache.insert = lambda *a: (inserted.append(a), real(*a))
    te.run()
    assert inserted == [] and len(te.prefix_cache) == entries
    assert te.responses[0].tokens == _cold(_SHARED[:1], max_new=20,
                                           **LAYOUTS["ring"])[0]
    assert te.latency_stats()["prefix_hits"] == 1


def test_ssm_engine_builds_no_prefix_cache():
    """An SSM stack has no per-position KV to share: the engine builds
    without a prefix cache and raises nothing, as the JAX engine does."""
    cfg = get_arch("mamba2-780m", variant="reduced")
    jcfg = jax_get_arch("mamba2-780m", variant="reduced")
    jm = jax_build(jcfg)
    je = JaxEngine(jm, jm.init(jax.random.PRNGKey(0)), sampler=JaxSampler(),
                   max_batch=2, cache_len=32, prefill_chunk=8,
                   prefix_cache_tokens=64)
    model = build(cfg, device="cpu")
    te = Engine(model, model.init(0), max_batch=2, cache_len=32,
                prefill_chunk=8, prefix_cache_tokens=64)
    assert je.prefix_cache is None and te.prefix_cache is None
    te.submit(Request(uid=0, prompt=np.arange(12), max_new_tokens=3))
    assert len(te.run()[0].tokens) == 3
    assert "prefix_hits" not in te.latency_stats()


def test_continuous_variant_matches_jax():
    for base in ("reduced", ""):
        v = "+".join(filter(None, (base, "continuous")))
        got = get_arch("llama3.2-1b", variant=v)
        want = jax_get_arch("llama3.2-1b", variant=v)
        assert (got.name, got.prefill_chunk, got.prefix_cache_tokens) == \
            (want.name, want.prefill_chunk, want.prefix_cache_tokens)
    cfg = get_arch("llama3.2-1b", variant="reduced+continuous")
    assert cfg.name.endswith("-cont") and cfg.prefix_cache_tokens == 8192
    te = Engine(build(cfg.replace(n_kv_heads=2), device="cpu"), _TP,
                max_batch=2, cache_len=64)
    assert te.prefill_chunk == 64 and te.prefix_cache.capacity == 8192
    assert Engine(_TM, _TP, max_batch=2, cache_len=64,
                  prefix_cache_tokens=64).prefix_cache.chunk == 64


def test_hit_after_steady_builds_nothing_and_warns_nothing():
    """A standing divergence: the JAX engine jits a ``materialize``
    program the first time a hit length comes, and warns after
    ``reset_stats``; the port copies in place outside the step programs,
    so the same hit builds nothing and warns nothing."""
    prompt = np.arange(12) % _V
    je = JaxEngine(_JM, _JP, sampler=JaxSampler(), max_batch=1,
                   cache_len=64, prefix_cache_tokens=64, prefill_chunk=4)
    te = Engine(_TM, _TP, max_batch=1, cache_len=64,
                prefix_cache_tokens=64, prefill_chunk=4)
    for e, mk in ((je, JaxRequest), (te, Request)):
        e.submit(mk(uid=0, prompt=prompt, max_new_tokens=3))
        e.run()
        e.reset_stats()
        e.submit(mk(uid=1, prompt=prompt, max_new_tokens=3))
    with pytest.warns(jax_telemetry.RecompileWarning, match="materialize"):
        je.run()
    progs = te.program_cache_sizes()
    with warnings.catch_warnings():
        warnings.simplefilter("error", telemetry.RecompileWarning)
        te.run()
    assert te.latency_stats()["prefix_hits"] == 1
    assert te.program_cache_sizes() == progs == {"step": 1, "mixed": 1}
    assert te.metrics.counters["steady_compiles"].value == 0
    assert je.metrics.counters["steady_compiles"].value >= 1
    assert te.responses[1].tokens == je.responses[1].tokens


@pytest.mark.parametrize("args", [
    ["--variant", "reduced+continuous"],
    ["--variant", "reduced", "--prefill-chunk", "8", "--paged",
     "--page-size", "8", "--prefix-cache-tokens", "256"],
], ids=["continuous", "paged_flag"])
def test_serve_cli_prefix_cache_on_cpu(args, capsys):
    from repro_torch.launch import serve

    responses, stats = serve.main([
        "--arch", "llama3.2-1b", "--device", "cpu", "--requests", "6",
        "--max-new", "6", "--max-batch", "2", "--cache-len", "64",
        "--prompt-len", "40", "--temperature", "0", *args])
    out = capsys.readouterr().out
    assert "prefix hits=" in out and "reused tokens=" in out
    assert stats["n_finished"] == 6 and "prefix_misses" in stats
    assert stats["prefix_hits"] + stats["prefix_misses"] == 6
    if "--paged" in args:
        # only the entries still pin pages (whole pages of 8)
        assert 0 < stats["kv_pages_live"] <= stats["prefix_tokens"] // 8


def test_serve_cli_flag_zero_turns_the_cache_off(capsys):
    from repro_torch.launch import serve

    _, stats = serve.main([
        "--arch", "llama3.2-1b", "--variant", "reduced+continuous",
        "--device", "cpu", "--requests", "3", "--max-new", "4",
        "--max-batch", "2", "--cache-len", "64", "--temperature", "0",
        "--prefix-cache-tokens", "0"])
    assert "prefix_hits" not in stats
    assert "prefix hits=" not in capsys.readouterr().out
