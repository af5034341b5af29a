"""The PyTorch port's serving fleet against the JAX package's.

On the CPU, at the reduced width of ``tests/test_fleet.py``, with the
same weights on both sides (the JAX package's init scaled by 8, so the
random model's greedy streams vary, crossed through
``repro_torch.bridge``), that file's engine arguments (2 slots, chunks of
8, a paged pool of 8-token pages, a 256-token prefix cache) and its
workloads. Each scenario runs the same script through both packages'
``Fleet`` and holds equal the tokens and finish reasons of every
request, the deterministic counters, the breaker states, the replica
states and death reasons and ``latency_stats()``'s key set, with
``degrade_factor`` large on both sides so that wall-clock noise cannot
route them apart. This file: the router and breaker op for op over a
seeded sequence of calls, the health model on fixed walls, the fault
sites, clean serving, validation and cancel edges, a router drop, one
weight storage for every replica, ``rejoin`` leaving nothing of the
engine it replaced, and the serve CLI's ``--replicas`` / ``--hedge`` /
``--drain`` against the JAX CLI. ``tests/test_torch_fleet_failover.py``
holds the failover, hedging, drain, deadline and trace scenarios.
"""
import contextlib
import gc
import io
import re
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro.serving import faults as jax_faults  # noqa: E402
from repro.serving import fleet as jax_fleet  # noqa: E402
from repro.serving import router as jax_router  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro.serving.sampler import Sampler as JaxSampler  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.serving import faults, fleet, router  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.serving.sampler import Sampler  # noqa: E402

torch.set_num_threads(1)


def _models():
    jc = jax_get_arch("llama3.2-1b", variant="reduced").replace(n_kv_heads=2)
    tc = get_arch("llama3.2-1b", variant="reduced").replace(n_kv_heads=2)
    jm, tm = jax_build(jc), build(tc, device="cpu")
    jp = jax.tree.map(lambda a: a * 8 if a.ndim >= 2 else a,
                      jm.init(jax.random.PRNGKey(0)))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jm, jp, tm, tp


_JM, _JP, _TM, _TP = _models()
VOCAB = _TM.cfg.vocab

#: ``tests/test_fleet.py``'s engine arguments (the sampler per package)
EK = dict(max_batch=2, cache_len=64, prefill_chunk=8,
          prefix_cache_tokens=256, paged=True, page_size=8)
#: counters that do not read the wall clock
COUNTERS = ("dispatches", "failovers", "requests_migrated", "router_drops",
            "redispatches", "hedges_issued", "hedges_won", "hedges_wasted",
            "drains", "rejoins", "fleet_timeouts", "fleet_errors",
            "replica_deaths", "fleet_cancellations")


class Side:
    """One package's fleet and request types, driven by one script."""

    def __init__(self, name):
        self.name = name
        if name == "jax":
            self.mod, self.Request = jax_fleet, JaxRequest
            self.model, self.params = _JM, _JP
            self.ek = dict(EK, sampler=JaxSampler())
        else:
            self.mod, self.Request = fleet, Request
            self.model, self.params = _TM, _TP
            self.ek = dict(EK, sampler=Sampler())

    def fleet(self, replicas=2, **kw):
        kw.setdefault("engine_kwargs", self.ek)
        kw.setdefault("degrade_factor", 1e9)
        return self.mod.Fleet(self.model, self.params, replicas=replicas,
                              **kw)

    def requests(self, reqs):
        return [self.Request(uid=r["uid"], prompt=r["prompt"],
                             max_new_tokens=r["max_new"], **r.get("kw", {}))
                for r in reqs]


SIDES = ("jax", "torch")


def workload(n=4, max_new=12, uid0=0, shared_head=True):
    """``tests/test_fleet.py``'s workload, as plain dicts for both sides."""
    rng = np.random.default_rng(23)
    head = rng.integers(0, VOCAB, 16)
    reqs = []
    for i in range(n):
        body = rng.integers(0, VOCAB, int(rng.integers(4, 12)))
        prompt = (np.concatenate([head, body])
                  if shared_head and i % 2 else body)
        reqs.append({"uid": uid0 + i, "prompt": prompt, "max_new": max_new})
    return reqs


def single_engine(reqs):
    """The port's one-engine tokens on the same requests."""
    eng = Engine(_TM, _TP, sampler=Sampler(), **EK)
    for r in reqs:
        eng.submit(Request(uid=r["uid"], prompt=r["prompt"],
                           max_new_tokens=r["max_new"]))
    return {u: list(r.tokens) for u, r in eng.run().items()}


def outcome(fl):
    """What must agree between the packages after a scenario."""
    st = fl.latency_stats()
    return {
        "streams": {u: (list(r.tokens), r.finish_reason, r.finished)
                    for u, r in fl.responses.items()},
        "counters": {k: st.get(k, 0) for k in COUNTERS},
        "affinity_hits": fl.router.affinity_hits,
        "breakers": {k: v for k, v in fl.router.stats().items()
                     if k.startswith("breaker_")},
        "replicas": [(r.state, r.death_reason) for r in fl.replicas],
        "stats_keys": sorted(k for k in st if not k.startswith("replica_")
                             or k.endswith("_state")),
        "replica_keys": {k: sorted(v) for k, v in st.items()
                         if isinstance(v, dict)},
        "gauges": {k: v for k, v in st.items()
                   if k.startswith("gauge_")},
    }


def both(script):
    """Run ``script(side)`` on both packages; returns (jax, torch)."""
    return [script(Side(name)) for name in SIDES]


# ------------------------------------------------------------------ #
# router / breaker / health / sites (no engine work)
# ------------------------------------------------------------------ #
def test_circuit_breaker_state_machine():
    """``tests/test_fleet.py``'s breaker script, on both packages."""
    for mod in (router, jax_router):
        b = mod.CircuitBreaker(failure_threshold=2, cooldown_ticks=3)
        assert b.allows and b.state == b.CLOSED
        b.record_failure()
        assert b.allows
        b.record_failure()
        assert not b.allows and b.state == b.OPEN and b.opens == 1
        for _ in range(3):
            b.tick()
        assert b.state == b.HALF_OPEN and b.allows
        b.record_failure()
        assert b.state == b.OPEN and b.opens == 2
        for _ in range(3):
            b.tick()
        b.record_success()
        assert b.state == b.CLOSED and b.allows


def test_router_affinity_then_least_loaded_and_sheds():
    """``tests/test_fleet.py``'s two router scripts, on both packages."""
    for mod in (router, jax_router):
        r = mod.Router(affinity_tokens=4)
        prompt = np.asarray([1, 2, 3, 4, 9, 9])
        cands = [(0, 0, 3), (1, 0, 1), (2, 1, 0)]
        assert r.route(prompt, cands) == 1
        r.note_dispatch(prompt, 0)
        assert r.route(prompt, cands) == 0 and r.affinity_hits == 1
        assert r.route(np.asarray([1, 2, 3, 4, 7]), cands) == 0
        assert r.route(prompt, cands, exclude=[0]) == 1
        r.forget_replica(0)
        assert r.route(prompt, cands) == 1
        r = mod.Router()
        r.breaker(0).force_open()
        r.breaker(1).force_open()
        assert r.route(np.asarray([1]), [(0, 0, 0), (1, 0, 0)]) is None
        assert r.sheds == 1
        for _ in range(r.breaker(0).cooldown_ticks):
            r.tick()
        assert r.route(np.asarray([1]), [(0, 0, 0), (1, 0, 0)]) == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_router_and_breakers_match_jax_over_a_seeded_call_sequence(seed):
    """A seeded sequence of ``route`` / ``note_dispatch`` /
    ``forget_replica`` / ``record_*`` / ``force_open`` / ``reset`` /
    ``tick`` calls: every return value, the affinity map and
    ``stats()`` equal JAX's after each call."""
    rng = np.random.default_rng(seed)
    ours = router.Router(affinity_tokens=3, breaker_threshold=2,
                         breaker_cooldown=3)
    theirs = jax_router.Router(affinity_tokens=3, breaker_threshold=2,
                               breaker_cooldown=3)
    heads = [rng.integers(0, 5, 6) for _ in range(5)]
    for _ in range(400):
        op = rng.integers(0, 8)
        rid = int(rng.integers(0, 4))
        prompt = heads[int(rng.integers(0, len(heads)))]
        if op <= 2:
            n = int(rng.integers(0, 5))
            cands = [(int(c), int(rng.integers(0, 2)),
                      int(rng.integers(0, 4)))
                     for c in rng.choice(4, n, replace=False)]
            excl = [int(x) for x in rng.choice(4, int(rng.integers(0, 2)))]
            got = [r.route(prompt, cands, exclude=excl)
                   for r in (ours, theirs)]
        elif op == 3:
            got = [r.note_dispatch(prompt, rid) for r in (ours, theirs)]
        elif op == 4:
            got = [r.forget_replica(rid) for r in (ours, theirs)]
        elif op == 5:
            meth = ("record_failure", "record_success", "force_open",
                    "reset")[int(rng.integers(0, 4))]
            got = [getattr(r.breaker(rid), meth)() for r in (ours, theirs)]
        else:
            got = [r.tick() for r in (ours, theirs)]
        assert got[0] == got[1]
        assert ours.affinity == theirs.affinity
        assert ours.stats() == theirs.stats()


def test_health_model_matches_jax_on_fixed_walls():
    """``_health_update`` fed the same walls, progress and budgets on
    both sides: the state, EWMA, strikes and overruns after each, and
    the fleet lane's events, are equal (degrade, recover, a stall strike,
    a budget overrun, death by hang)."""
    walls = [0.01, 0.011, 0.012, 0.2, 0.01, 0.009, 0.3, 0.3, 0.01,
             0.01, 0.5, 0.01, 0.01, 0.01]
    work = [1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1]
    made = [4, 4, 4, 4, 4, 0, 4, 4, 0, 0, 4, 0, 0, 0]

    def script(side):
        fl = side.fleet(replicas=1, degrade_factor=4.0, hang_ticks=3,
                        tick_budget_s=0.4)
        r = fl.replicas[0]
        seq = []
        for w, h, n in zip(walls, work, made):
            r.ticks += 1
            fl._health_update(r, w, bool(h), n)
            seq.append((r.state, round(r.ewma_s or 0.0, 12),
                        r.stall_strikes, r.overruns, r.death_reason))
        return seq, [(e["name"], e["args"]) for e in fl._events]

    jx, pt = both(script)
    assert pt == jx
    states = {s for s, *_ in pt[0]}
    assert {fleet.HEALTHY, fleet.DEGRADED, fleet.DEAD} <= states


def test_fleet_sites_registered_and_nearest_site_hint():
    assert fleet.FLEET_SITES == jax_fleet.FLEET_SITES
    for s in fleet.FLEET_SITES:
        assert s in faults.SITES
    spec = "replica_crash@3/1,replica_hang@2,router_drop"
    got, want = (
        [(s.site, s.step, s.slot) for s in mod.Faults.parse(spec).specs]
        for mod in (faults, jax_faults))
    assert got == want
    for mod in (faults, jax_faults):
        with pytest.raises(ValueError, match="did you mean 'nan_logits'"):
            mod.Faults.parse("nan_logit@3")
        with pytest.raises(ValueError,
                           match="did you mean 'replica_crash'"):
            mod.Faults(seed=0).on("replica_crush")


def test_request_identity_equality_in_containers():
    from collections import deque
    a = Request(uid=1, prompt=np.asarray([1, 2, 3]))
    b = Request(uid=1, prompt=np.asarray([4, 5]))
    q = deque([a])
    assert b not in q and a in q
    q.remove(a)
    assert not q


# ------------------------------------------------------------------ #
# clean serving
# ------------------------------------------------------------------ #
def test_fleet_matches_jax_and_single_engine_greedy():
    reqs = workload(4)

    def script(side):
        fl = side.fleet(replicas=2)
        for r in side.requests(reqs):
            fl.submit(r)
        fl.run()
        return outcome(fl)

    jx, pt = both(script)
    assert pt == jx
    assert {u: s[0] for u, s in pt["streams"].items()} \
        == single_engine(reqs)
    assert all(s[1] == "length" for s in pt["streams"].values())
    assert pt["counters"]["dispatches"] == 4
    assert pt["counters"]["replica_deaths"] == 0
    assert pt["affinity_hits"] >= 1


def test_fleet_submit_validation_and_cancel_edges():
    def script(side):
        fl = side.fleet(replicas=1)
        R, out = side.Request, []
        for bad in (R(uid=0, prompt=np.asarray([], np.int32)),
                    R(uid=0, prompt=np.asarray([1]), max_new_tokens=0),
                    R(uid=0, prompt=np.asarray([1.5])),
                    R(uid=0, prompt=np.asarray([1]), deadline_s=-1.0)):
            with pytest.raises(ValueError) as err:
                fl.submit(bad)
            out.append(str(err.value))
        fl.submit(R(uid=0, prompt=np.asarray([1, 2]), max_new_tokens=2))
        with pytest.raises(ValueError) as err:
            fl.submit(R(uid=0, prompt=np.asarray([3])))
        out.append(str(err.value))
        out += [fl.cancel(99), fl.cancel(0), fl.cancel(0),
                fl.responses[0].finish_reason]
        fl.run()
        # a live copy on a replica, cancelled through Engine.cancel
        fl.submit(R(uid=1, prompt=np.asarray([5, 6, 7]), max_new_tokens=8))
        fl.tick(2)
        out += [fl.cancel(1), fl.replicas[0].engine.responses[1]
                .finish_reason]
        fl.run()
        return out, outcome(fl)

    jx, pt = both(script)
    assert pt == jx
    assert pt[0][5:9] == [False, True, False, "cancelled"]
    assert pt[0][9:] == [True, "cancelled"]
    assert pt[1]["counters"]["fleet_cancellations"] == 2


def test_router_drop_is_detected_and_redispatched():
    reqs = workload(3, max_new=8)

    def script(side):
        fl = side.fleet(replicas=2, faults="router_drop@1")
        for r in side.requests(reqs):
            fl.submit(r)
        fl.run()
        return outcome(fl)

    jx, pt = both(script)
    assert pt == jx
    assert {u: s[0] for u, s in pt["streams"].items()} \
        == single_engine(reqs)
    assert pt["counters"]["router_drops"] == 1
    assert pt["counters"]["redispatches"] == 1


# ------------------------------------------------------------------ #
# one device: one weight storage, a rejoin frees what it replaced
# ------------------------------------------------------------------ #
def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def test_replicas_share_one_weight_storage():
    fl = Side("torch").fleet(replicas=3)
    want = [t.data_ptr() for t in _leaves(_TP)]
    assert len(want) > 10
    for r in fl.replicas:
        assert [t.data_ptr() for t in _leaves(r.engine.params)] == want
    caches = {t.data_ptr() for r in fl.replicas
              for t in _leaves(r.engine.cache)}
    assert len(caches) == 3 * len(list(_leaves(fl.replicas[0].engine.cache)))


def test_rejoin_leaves_no_reference_to_the_replaced_engine():
    """A drained replica's engine, and a dead one's (with a stream still
    in its slots), are gone once ``rejoin`` returns: the fleet drops
    them and ``Engine._release`` breaks the cycles through the step
    programs' bodies and the prefix cache's eviction hook, so no
    garbage-collector pass is needed (and none leaves them alive)."""
    side = Side("torch")
    fl = side.fleet(replicas=2)
    for r in side.requests(workload(4, max_new=10)):
        fl.submit(r)
    fl.tick()
    fl.drain(0)
    fl.run()
    assert fl.replicas[0].state == fleet.DRAINED
    old = weakref.ref(fl.replicas[0].engine)
    assert len(old()._programs) > 0 and old().prefix_cache is not None
    was = gc.isenabled()
    gc.disable()
    try:
        fl.rejoin(0)
        assert old() is None
    finally:
        if was:
            gc.enable()
    fl._kill(1, "crash")
    dead = weakref.ref(fl.replicas[1].engine)
    fl.rejoin(1)
    gc.collect()
    assert dead() is None
    for r in side.requests(workload(2, max_new=4, uid0=50)):
        fl.submit(r)
    assert all(r.ok for r in fl.run().values())


# ------------------------------------------------------------------ #
# the serve CLI
# ------------------------------------------------------------------ #
CLI = ["--variant", "reduced", "--requests", "8", "--max-new", "12",
       "--max-batch", "2", "--cache-len", "64", "--prefill-chunk", "8",
       "--temperature", "0", "--paged", "--page-size", "8",
       "--prefix-cache-tokens", "256", "--replicas", "3"]


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        responses, stats = main(argv)
    return buf.getvalue(), responses, stats


def _counts(text, keys):
    return {k: re.search(rf"\b{re.escape(k)}=(\d+)", text).group(1)
            for k in keys}


def test_cli_fleet_counts_match_the_jax_cli(tmp_path):
    """``--replicas 3 --faults replica_crash@3/0 --drain 1@0``: the
    summary's counts, every replica's state and ticks and each stream's
    length and finish reason equal the JAX CLI's (each CLI makes its
    own weights from the seed, so the tokens themselves differ); the
    ``--json`` keys are JAX's plus ``device``."""
    argv = CLI + ["--faults", "replica_crash@3/0", "--drain", "1@0"]
    jtext, jresp, _ = _cli(jax_serve.main,
                           argv + ["--json", str(tmp_path / "j.json")])
    ptext, presp, _ = _cli(serve.main, argv + [
        "--device", "cpu", "--json", str(tmp_path / "p.json")])
    keys = ("finished", "ok", "tokens", "dispatches", "affinity_hits",
            "deaths", "failovers", "migrated", "router_drops", "drains",
            "rejoins", "timeouts")
    assert _counts(ptext, keys) == _counts(jtext, keys)
    assert _counts(ptext, keys)["deaths"] == "1"
    assert _counts(ptext, keys)["rejoins"] == "1"
    reps = [re.sub(r"step_ewma=\S+", "", ln) for ln in jtext.splitlines()
            if ln.startswith("  replica ")]
    assert [re.sub(r"step_ewma=\S+", "", ln) for ln in ptext.splitlines()
            if ln.startswith("  replica ")] == reps
    assert {u: (len(r.tokens), r.finish_reason) for u, r in presp.items()} \
        == {u: (len(r.tokens), r.finish_reason) for u, r in jresp.items()}
    import json
    jk = set(json.loads((tmp_path / "j.json").read_text()))
    pk = set(json.loads((tmp_path / "p.json").read_text()))
    assert pk == jk | {"device"}


def test_cli_hedge_delivers_every_token_once_as_the_jax_cli():
    """``--hedge``: how many hedges fire reads the wall clock (the
    fleet's p99 TTFT), so the two CLIs may hedge differently; what each
    delivers does not: every request ok with its whole budget, every
    hedge won or wasted."""
    jtext, jresp, jst = _cli(jax_serve.main, CLI + ["--hedge"])
    ptext, presp, pst = _cli(serve.main, CLI + ["--hedge", "--device",
                                                "cpu"])
    keys = ("finished", "ok", "tokens", "deaths", "failovers", "migrated")
    assert _counts(ptext, keys) == _counts(jtext, keys)
    assert " hedge" in ptext.splitlines()[0]
    assert {u: (len(r.tokens), r.finish_reason) for u, r in presp.items()} \
        == {u: (len(r.tokens), r.finish_reason) for u, r in jresp.items()}
    for st in (pst, jst):
        assert st["hedges_won"] + st["hedges_wasted"] == st["hedges_issued"]


def test_cli_refusals_give_the_jax_text():
    """A frontend architecture under ``--replicas > 1`` and malformed
    ``--drain`` entries exit with the JAX CLI's text; without a CUDA
    device the fleet path exits with the single-engine path's error."""
    argv = ["--arch", "pixtral-12b", "--variant", "reduced",
            "--replicas", "2", "--requests", "1"]
    with pytest.raises(SystemExit) as jerr:
        jax_serve.main(argv)
    with pytest.raises(SystemExit) as perr:
        serve.main(argv + ["--device", "cpu"])
    assert str(perr.value) == str(jerr.value)
    assert "frontend-embedding archs" in str(perr.value)
    for spec in ("1", "a@2", "1@x", "0@1,2"):
        with pytest.raises(SystemExit) as jerr:
            jax_serve._parse_drains(spec)
        with pytest.raises(SystemExit) as perr:
            serve._parse_drains(spec)
        assert str(perr.value) == str(jerr.value)
    assert serve._parse_drains("1@2.5, 0@1") \
        == jax_serve._parse_drains("1@2.5, 0@1") == [(1.0, 0), (2.5, 1)]
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as err:
            serve.main(["--replicas", "3"])
        assert "CUDA device is required" in str(err.value)
