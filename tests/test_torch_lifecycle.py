"""The PyTorch port's engine lifecycle against the JAX package's.

Cancel, deadlines, priorities, fault injection and request tracing, on
the CPU, at the reduced width ``tests/test_torch_engine.py`` uses, with
the same weights on both sides (``repro_torch.bridge``) and greedy
sampling:

* the fault schedule: ``Faults.parse`` gives the same specs, ``fire`` the
  same sequence (the ``%p`` dice included), ``from_env`` the same
  schedule, and an unknown site names the same nearest site;
* the engine, in three modes (the whole prompt in one chunk, chunks of 8,
  paged with pages of 8): a chaos schedule (NaN logits, forced page
  exhaustion, a host stall), a cancel in each of the three states at
  fixed tick counts and a priority displacement give the port and JAX
  identical tokens and finish reasons for every request; an expired
  deadline times out with no token in both, and a mid-stream timeout
  keeps a prefix of the same clean stream in both (the cut depends on
  the wall clock);
* the tracer's per-request spans carry JAX's names and ``args``, the
  registry's snapshot and ``latency_stats()`` JAX's keys; an empty fault
  schedule and the tracer leave tokens and ``program_cache_sizes()`` as
  they were, and no lifecycle event builds a program;
* the serve CLI's ``--faults``, ``--deadline``, ``--trace-out``,
  ``--trace-dir`` and ``--metrics-jsonl`` on ``--device cpu``.
"""
import dataclasses
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro.serving import faults as jax_faults  # noqa: E402
from repro.serving import telemetry as jax_telemetry  # noqa: E402
from repro.serving import tracing as jax_tracing  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro.serving.sampler import Sampler as JaxSampler  # noqa: E402
from repro.training import metrics as jax_metrics  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.serving import faults, telemetry, tracing  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.training import metrics  # noqa: E402


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
_RNG = np.random.default_rng(41)
_PROMPTS = [_RNG.integers(0, 1024, L) for L in (5, 9, 30, 7, 12, 3)]

#: engine arguments of each serving mode
MODES = {
    "whole": dict(prefill_chunk=0),
    "chunked": dict(prefill_chunk=8),
    "paged": dict(prefill_chunk=8, paged=True, page_size=8),
}
#: the chaos schedule (as the JAX package's chaos suite: NaN logits,
#: forced page exhaustion, a host stall)
CHAOS = "nan_logits@6/1,page_alloc@9x2,slow_step@4+0.002"


class _Side:
    """One package's engine and request types, driven by one script."""

    def __init__(self, name, mode, **kw):
        self.name = name
        args = dict(MODES[mode], max_batch=2, cache_len=64)
        args.update(kw)
        if name == "jax":
            if isinstance(args.get("faults"), faults.Faults):
                args["faults"] = _jax_schedule(args["faults"])
            self.engine = JaxEngine(_JM, _JP, sampler=JaxSampler(), **args)
            self.request = JaxRequest
        else:
            self.engine = Engine(_TM, _TP, **args)
            self.request = Request

    def submit(self, uid, prompt, max_new, **kw):
        self.engine.submit(self.request(uid=uid, prompt=prompt,
                                        max_new_tokens=max_new, **kw))

    def out(self):
        return {u: (list(r.tokens), r.finish_reason)
                for u, r in self.engine.responses.items()}


def _jax_schedule(port_faults):
    """The JAX package's copy of a port schedule (same specs, same seed)."""
    specs = [jax_faults.FaultSpec(**{k: v for k, v in
                                     dataclasses.asdict(s).items()
                                     if k != "fired"})
             for s in port_faults.specs]
    return jax_faults.Faults(seed=port_faults.seed, specs=specs)


def _both(mode, **kw):
    return [_Side(name, mode, **kw) for name in ("jax", "torch")]


def _serve(side, n=4, max_new=10):
    for uid, p in enumerate(_PROMPTS[:n]):
        side.submit(uid, p, max_new)
    side.engine.run()
    return side.out()


def _clean(mode, n=4, max_new=10, **kw):
    """The port's fault-free streams of the first ``n`` prompts."""
    side = _Side("torch", mode, faults=False, **kw)
    return {u: toks for u, (toks, _) in _serve(side, n, max_new).items()}


# --------------------------------------------------------------------- #
# the fault schedule, no engine
# --------------------------------------------------------------------- #
SCHEDULES = [
    "nan_logits@12/1,page_alloc@30x2,slow_step+0.05",
    "transport_drop x-1 %0.5".replace(" ", ""),
    "page_alloc@3x-1%0.25,nan_logits/3,slow_step@2x3+0.125",
    " truncated_checkpoint , transport_latency+0.5 ",
]


@pytest.mark.parametrize("text", SCHEDULES)
def test_parse_gives_jax_specs(text):
    got = faults.Faults.parse(text, seed=3)
    want = jax_faults.Faults.parse(text, seed=3)
    assert [dataclasses.asdict(s) for s in got.specs] \
        == [dataclasses.asdict(s) for s in want.specs]
    assert got.seed == want.seed == 3


def _fire_trail(mod, text, seed):
    f = mod.Faults.parse(text, seed=seed)
    trail = []
    for step in range(40):
        for site, ctx in (("slow_step", {}), ("nan_logits", {}),
                          ("page_alloc", {"slot": step % 3}),
                          ("transport_drop", {"attempt": step % 4,
                                              "op": "fetch"})):
            spec = f.fire(site, step=step, **ctx)
            trail.append(None if spec is None else
                         (site, spec.step, spec.slot, spec.delay_s,
                          spec.fired))
    return trail, f.stats()


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("text", SCHEDULES[:3])
def test_fire_sequence_matches_jax(text, seed):
    got, got_stats = _fire_trail(faults, text, seed)
    want, want_stats = _fire_trail(jax_faults, text, seed)
    assert got == want
    assert got_stats == want_stats
    assert any(t is not None for t in got)


@pytest.mark.parametrize("env", [
    {}, {"REPRO_FAULTS": ""},
    {"REPRO_FAULTS": "slow_step@2+0.1"},
    {"REPRO_FAULTS": "nan_logits@3/1,page_alloc x-1%0.5".replace(" ", ""),
     "REPRO_FAULTS_SEED": "9"},
])
def test_from_env_matches_jax(env):
    assert faults.ENV_VAR == jax_faults.ENV_VAR == "REPRO_FAULTS"
    got, want = faults.from_env(env), jax_faults.from_env(env)
    assert got.enabled == want.enabled
    if want.enabled:
        assert got.seed == want.seed
        assert [dataclasses.asdict(s) for s in got.specs] \
            == [dataclasses.asdict(s) for s in want.specs]
    else:
        assert isinstance(got, faults.NoFaults)


@pytest.mark.parametrize("text", ["nan_logit@3", "page_aloc",
                                  "slowstep+0.1", "warp_core_breach"])
def test_unknown_site_names_the_nearest_site_as_jax(text):
    with pytest.raises(ValueError) as got:
        faults.Faults.parse(text)
    with pytest.raises(ValueError) as want:
        jax_faults.Faults.parse(text)
    assert str(got.value).split(" (")[0] == str(want.value).split(" (")[0]
    assert "unknown fault site" in str(got.value)


@pytest.mark.parametrize("text", ["nan_logits@@3", "page_alloc@x", "Bad"])
def test_bad_spec_raises_as_jax(text):
    with pytest.raises(ValueError, match="bad fault spec"):
        jax_faults.Faults.parse(text)
    with pytest.raises(ValueError, match="bad fault spec"):
        faults.Faults.parse(text)


def test_site_catalogue_and_registration():
    assert {"page_alloc", "nan_logits", "slow_step", "transport_drop",
            "transport_latency", "truncated_checkpoint"} \
        <= faults.known_sites()
    with pytest.raises(ValueError, match="bad fault site name"):
        faults.register_site("Not-A-Site")
    name = faults.register_site("lifecycle_test_site")
    assert name in faults.known_sites()
    assert faults.Faults().on(name).fire(name) is not None


# --------------------------------------------------------------------- #
# the registry, the recorder interface, tracing and the metrics log
# --------------------------------------------------------------------- #
def _registry_ops(mod):
    reg = mod.MetricsRegistry()
    reg.counter("tokens").inc(5)
    reg.counter("compiles", persist=True).inc(2)
    reg.gauge("active").set(3)
    h = reg.histogram("lat", cap=16)
    for i in range(40):
        h.observe(0.001 * ((7 * i) % 23))
    s = reg.get_series("step_wall_s")
    for v in (0.1, 0.3, 0.2):
        s.append(v)
    reg.get_series("compiles_log").append({"program": "step"})
    reg.add_collector(lambda: {"faults_fired_total": 1})
    before = reg.snapshot()
    reg.reset()
    return before, reg.snapshot()


def test_registry_snapshot_matches_jax():
    assert _registry_ops(telemetry) == _registry_ops(jax_telemetry)
    xs = [0.001 * i for i in range(1, 101)]
    assert telemetry.percentile(xs, 50) == jax_telemetry.percentile(xs, 50)
    got, want = {}, {}
    telemetry.pct_stats(got, "lat_ms", xs, (50, 99))
    jax_telemetry.pct_stats(want, "lat_ms", xs, (50, 99))
    assert got == want


def test_watchdog_hands_every_build_to_the_recorder():
    seen = []

    class Rec(telemetry.Recorder):
        enabled = True

        def on_compile(self, name, elapsed_s, steady, ts):
            seen.append((name, steady))

    wd = telemetry.CompileWatchdog(telemetry.MetricsRegistry(), Rec())
    wd.record("step", 0.1, step=0, ts=0.0)
    wd.arm()
    with pytest.warns(telemetry.RecompileWarning):
        wd.record("mixed", 0.2, step=5, ts=1.0)
    assert seen == [("step", False), ("mixed", True)]
    hooks = [n for n in dir(jax_telemetry.Recorder) if n.startswith("on_")]
    assert hooks == [n for n in dir(telemetry.Recorder)
                     if n.startswith("on_")]


def test_merge_and_validate_match_jax():
    def part(mod):
        tr = mod.Tracer()
        tr.t0 = 0.0
        req = Request(uid=1, prompt=np.arange(4))
        tr.on_submit(req)
        tr.requests[1]["submitted"] = 1.0
        tr.on_admission(req, 0, 0, "chunked")
        tr.requests[1]["admitted"] = 2.0
        tr.on_chunk(req, 0, 0, 4, True)
        tr.requests[1]["chunks"][0] = (2.5, 0, 4, True)
        tr.on_first_token(req, 3.0)
        tr.on_emit(req, 0, 2, 4.0)
        tr.on_finish(req, "length", 5.0)
        tr.on_fault("nan_logits", 3, 3.5)
        tr.on_steps([(2.0, 3.0, "mixed"), (3.0, 4.0, "plain")])
        tr.on_poll(4.0, 1, {"kv_pages_live": 2, "kv_pages_free": 6})
        tr.on_compile("step", 0.25, False, 2.0)
        return tr.export_chrome_trace()

    got, want = part(tracing), part(jax_tracing)
    assert got == want
    assert tracing.validate_chrome_trace(got) == []
    parts = [("replica 0", 10, got, 0.0), ("replica 1", 11, got, 12.5)]
    extra = [{"name": "failover", "ph": "i", "ts": 1.0, "pid": 99,
              "tid": 0, "s": "t"}]
    assert tracing.merge_chrome_traces(parts, extra) \
        == jax_tracing.merge_chrome_traces(parts, extra)
    assert (tracing.QUEUE_TID, tracing.STEP_TID, tracing.COMPILE_TID,
            tracing.FAULT_TID) == (jax_tracing.QUEUE_TID,
                                   jax_tracing.STEP_TID,
                                   jax_tracing.COMPILE_TID,
                                   jax_tracing.FAULT_TID)
    assert tracing.validate_chrome_trace({"traceEvents": []}) \
        == jax_tracing.validate_chrome_trace({"traceEvents": []})
    bad = {"traceEvents": [{"name": "x", "ph": "X", "ts": 0, "pid": 1,
                            "dur": -1}, {"ph": "Q"}]}
    assert tracing.validate_chrome_trace(bad) \
        == jax_tracing.validate_chrome_trace(bad)


def test_metrics_logger_matches_jax(tmp_path):
    rows = []
    for mod, name in ((metrics, "port"), (jax_metrics, "jax")):
        p = tmp_path / f"{name}.jsonl"
        with mod.MetricsLogger(str(p), run_name="t") as log:
            log.log("serve", step=1, loss=torch.tensor(2.5))
            log.log("serve", step=2, loss=2.25)
        rows.append([{k: v for k, v in r.items() if k != "ts"}
                     for r in mod.read_jsonl(p)])
    assert rows[0] == rows[1]
    assert rows[0][0]["loss"] == 2.5 and rows[0][1]["step"] == 2


# --------------------------------------------------------------------- #
# the engine under faults, cancel, deadlines and priorities
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", list(MODES))
def test_chaos_schedule_matches_jax(mode):
    clean = _clean(mode)
    outs, counts = [], []
    for side in _both(mode, faults=CHAOS):
        outs.append(_serve(side))
        st = side.engine.latency_stats()
        counts.append({k: st[k] for k in ("slot_errors", "faults_injected",
                                          "preemptions", "decode_steps")})
        assert st["slot_errors"] == 1
        assert st["faults_injected"] == \
            side.engine.faults.stats()["faults_fired_total"] >= 2
        if mode == "paged":
            assert st["faults_injected"] == 4   # page_alloc fired twice
            assert st["kv_pages_live"] == 0
            side.engine._paged.check_invariants()
    got, want = outs[1], outs[0]
    assert got == want
    assert counts[1] == counts[0]
    assert sum(r == "error" for _, r in got.values()) == 1
    for uid, (toks, reason) in got.items():
        if reason != "error":
            assert reason == "length" and toks == clean[uid], uid


def _cancel_script(side):
    """Five requests on two slots: cancel the last one while it is
    queued, a decoding one after four steps, and the 30-token prompt
    after the first step of its admission. Returns each cancel's result
    and the state the request was in."""
    e = side.engine
    for uid, p in enumerate(_PROMPTS[:5]):
        side.submit(uid, p, {0: 20, 1: 20, 2: 4}.get(uid, 6))

    def state(uid):
        if any(r.uid == uid for r in e.queue):
            return "queued"
        if e._admit is not None and e._admit.req.uid == uid:
            return "admitting"
        return "active" if any(r is not None and r.uid == uid
                               for r in e.slots) else "done"

    trail = []
    for ticks, uid in ((0, 4), (4, 0), (1, 2)):
        for _ in range(ticks):
            e.tick(1)
        trail.append((uid, state(uid), e.cancel(uid)))
    trail.append((99, "unknown", e.cancel(99)))
    e.run()
    trail.append((0, "done", e.cancel(0)))
    return trail


@pytest.mark.parametrize("mode", list(MODES))
def test_cancel_in_each_state_matches_jax(mode):
    clean = _clean(mode, n=5, max_new=20)
    trails, outs = [], []
    for side in _both(mode):
        trails.append(_cancel_script(side))
        outs.append(side.out())
        st = side.engine.latency_stats()
        assert st["cancellations"] == 3
        assert not side.engine.has_work
        if mode == "paged":
            assert st["kv_pages_live"] == 0
            side.engine._paged.check_invariants()
    assert trails[1] == trails[0]
    got = outs[1]
    assert got == outs[0]
    states = [s for _, s, _ in trails[1][:3]]
    want_states = ["queued", "active", "admitting"] if mode != "whole" \
        else ["queued", "active", "active"]   # one chunk: no mid-admission
    assert states == want_states
    assert [ok for *_, ok in trails[1]] == [True, True, True, False, False]
    assert [got[u][1] for u in (4, 0, 2)] == ["cancelled"] * 3
    assert got[4][0] == []
    # mid-admission: nothing sampled yet; with one chunk the request was
    # armed, and keeps its first token
    assert len(got[2][0]) == (1 if mode == "whole" else 0)
    # the decoding request keeps a prefix of its clean stream; the freed
    # slot serves the queued request, whose stream is its clean one
    assert 0 < len(got[0][0]) < 20
    assert got[0][0] == clean[0][:len(got[0][0])]
    assert got[3] == (clean[3][:6], "length")


@pytest.mark.parametrize("mode", list(MODES))
def test_priority_displacement_matches_jax(mode):
    """Two priority-0 streams fill both slots; a priority-5 request
    displaces the one with the most slack (no deadline beats a far one,
    whatever the slot), which resumes behind it by replay."""
    clean = _clean(mode, n=3, max_new=24)
    outs, victims = [], []
    for side in _both(mode):
        e = side.engine
        side.submit(0, _PROMPTS[0], 24, deadline_s=1e3)
        side.submit(1, _PROMPTS[1], 24)
        for _ in range(2):
            e.tick(2)
        side.submit(2, _PROMPTS[2], 4, priority=5)
        e.tick(1)
        victims.append([r.uid for r in e.queue])
        e.run()
        outs.append(side.out())
        assert e.requests[1].preemptions == 1
        assert e.requests[0].preemptions == 0
        assert e.latency_stats()["preemptions"] == 1
    assert victims[1] == victims[0] == [1]       # behind the displacer
    assert outs[1] == outs[0]
    for uid, n in ((0, 24), (1, 24), (2, 4)):
        assert outs[1][uid] == (clean[uid][:n], "length"), uid


@pytest.mark.parametrize("mode", list(MODES))
def test_expired_deadline_times_out_as_jax(mode):
    clean = _clean(mode, n=2, max_new=6)
    outs = []
    for side in _both(mode, max_batch=1):
        side.submit(0, _PROMPTS[0], 6)
        side.submit(1, _PROMPTS[1], 6, deadline_s=1e-6)
        time.sleep(0.01)
        side.engine.run()
        outs.append(side.out())
        assert side.engine.latency_stats()["timeouts"] == 1
    assert outs[1] == outs[0]
    assert outs[1][1] == ([], "timeout")
    assert outs[1][0] == (clean[0], "length")


@pytest.mark.parametrize("mode", list(MODES))
def test_midstream_deadline_keeps_a_prefix_as_jax(mode):
    """A host stall blows the deadline after the first tokens: both
    packages time the stream out keeping a prefix of one clean stream;
    where it is cut depends on the wall clock, so only prefixes are
    compared."""
    clean = _clean(mode, n=1, max_new=40)[0]
    for side in _both(mode, max_batch=1,
                      faults=faults.Faults(seed=0).on(
                          "slow_step", step=2, delay_s=0.3)):
        side.submit(0, _PROMPTS[0], 40, deadline_s=0.15)
        side.engine.run()
        toks, reason = side.out()[0]
        assert reason == "timeout", side.name
        assert 0 < len(toks) < 40 and toks == clean[:len(toks)], side.name
        assert side.engine.latency_stats()["timeouts"] == 1
        assert not side.engine.has_work


def test_forced_exhaustion_on_a_slot_the_poll_finished_diverges():
    """A standing divergence (ROADMAP section 3): a forced ``page_alloc``
    whose poll finishes the very slot being provisioned. The port
    allocates nothing for that slot and returns, so the schedule's second
    firing lands on the next slot's provisioning, where a poll already
    ran: no victim. The JAX engine fires again for the finished slot and
    preempts the live stream. Both fire twice; tokens and finish reasons
    agree (the victim resumes by replay)."""
    outs, pre = [], []
    for side in _both("paged", faults="page_alloc@5x2"):
        side.submit(0, _PROMPTS[0], 3)        # done on the device by step 5
        side.submit(1, _PROMPTS[1], 20)
        side.engine.run()
        outs.append(side.out())
        pre.append(side.engine.latency_stats()["preemptions"])
        assert side.engine.faults.stats()["faults_fired_page_alloc"] == 2
        assert side.engine.latency_stats()["kv_pages_live"] == 0
    assert outs[1] == outs[0]
    assert pre == [1, 0]                       # JAX, the port


def test_submit_validates_the_deadline():
    e = Engine(_TM, _TP, max_batch=2, cache_len=64)
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError, match="deadline_s must be positive"):
            e.submit(Request(uid=0, prompt=np.arange(3), deadline_s=bad))
    e.submit(Request(uid=0, prompt=np.arange(3), deadline_s=5.0,
                     priority=2))
    assert e.requests[0].priority == 2 and e._deadline_armed


@pytest.mark.parametrize("mode", list(MODES))
def test_env_schedule_reaches_engine(mode, monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "nan_logits@3/0")
    monkeypatch.setenv(faults.ENV_VAR + "_SEED", "4")
    outs = []
    for side in _both(mode):
        assert side.engine.faults.enabled and side.engine.faults.seed == 4
        outs.append(_serve(side, n=2))
        assert side.engine.latency_stats()["slot_errors"] == 1
    assert outs[1] == outs[0]


# --------------------------------------------------------------------- #
# invisibility, programs, the tracer and the stats' keys
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", list(MODES))
def test_empty_schedule_and_tracer_are_invisible(mode):
    want = _serve(_Side("jax", mode, faults=False))
    runs = []
    for kw in ({"faults": False}, {"faults": faults.Faults(seed=0)},
               {"faults": False, "recorder": True}):
        side = _Side("torch", mode, **kw)
        runs.append((_serve(side), side.engine.program_cache_sizes()))
        assert side.engine.latency_stats()["faults_injected"] == 0
    assert all(r == runs[0] for r in runs)
    assert runs[0][0] == want


@pytest.mark.parametrize("mode", list(MODES))
def test_lifecycle_events_build_no_program(mode):
    """After a warm-up that admitted into both slots, poison, a cancel,
    a timeout and a priority displacement build no step program."""
    sched = faults.Faults(seed=0)
    e = Engine(_TM, _TP, max_batch=2, cache_len=64, faults=sched,
               **MODES[mode])
    for uid in range(2):
        e.submit(Request(uid=uid, prompt=_PROMPTS[uid], max_new_tokens=6))
    e.run()
    progs = e.program_cache_sizes()
    assert progs == {"step": 1, "mixed": 2}
    e.mark_steady()
    sched.on("nan_logits", step=e._steps + 3, slot=1)
    for uid in range(10, 13):
        e.submit(Request(uid=uid, prompt=_PROMPTS[uid - 10],
                         max_new_tokens=12))
    e.tick(4)
    assert e.cancel(10)            # slot 0; slot 1's stream was poisoned
    e.submit(Request(uid=15, prompt=_PROMPTS[5], max_new_tokens=12))
    e.tick(4)                      # 12 and 15 fill both slots
    e.submit(Request(uid=13, prompt=_PROMPTS[3], max_new_tokens=4,
                     priority=3))
    e.submit(Request(uid=14, prompt=_PROMPTS[4], max_new_tokens=4,
                     deadline_s=1e-6))
    e.run()
    reasons = {u: r.finish_reason for u, r in e.responses.items()
               if u >= 10}
    assert reasons == {10: "cancelled", 11: "error", 12: "length",
                       13: "length", 14: "timeout", 15: "length"}
    st = e.latency_stats()
    assert st["faults_injected"] == 1 and st["preemptions"] == 1
    assert e.program_cache_sizes() == progs
    assert e.metrics.counters["steady_compiles"].value == 0
    assert not bool(e._poison.any())


@pytest.mark.parametrize("mode", list(MODES))
def test_tracer_spans_match_jax(mode, tmp_path):
    spans, outs = [], []
    for side in _both(mode, recorder=True, faults=CHAOS):
        outs.append(_serve(side))
        path = str(tmp_path / f"{side.name}.json")
        trace = side.engine.export_trace(path)
        assert tracing.validate_chrome_trace(path) == []
        spans.append({k: v["args"] for k, v in
                      tracing.complete_spans(trace).items()})
        kinds = {e["name"] for e in trace["traceEvents"]
                 if e.get("tid") == tracing.STEP_TID and e["ph"] == "X"}
        assert kinds == {"plain", "mixed"}
        assert any(e["ph"] == "C" and e["name"] == "active_slots"
                   for e in trace["traceEvents"])
        assert any(e.get("tid") == tracing.FAULT_TID
                   for e in trace["traceEvents"] if e["ph"] == "i")
    assert outs[1] == outs[0]
    assert spans[1] == spans[0]
    assert len(spans[1]) == 4
    for uid, (toks, reason) in outs[1].items():
        assert spans[1][f"req {uid}"]["generated"] == len(toks)
        assert spans[1][f"req {uid}"]["finish"] == reason
    assert outs[1] == _serve(_Side("torch", mode, faults=CHAOS))


#: the port's own count of polls that read the trace back
_PORT_COUNTERS = {"trace_polls"}


@pytest.mark.parametrize("mode", list(MODES))
def test_snapshot_and_latency_stats_keys_match_jax(mode):
    snaps, stats = [], []
    for side in _both(mode, faults=CHAOS):
        _serve(side)
        snaps.append(side.engine.metrics.snapshot())
        stats.append(side.engine.latency_stats())
    got, want = snaps[1], snaps[0]
    assert set(got) == set(want)
    assert set(got["counters"]) - _PORT_COUNTERS == set(want["counters"])
    for k in ("gauges", "histograms", "series", "collected"):
        assert set(got[k]) == set(want[k]), k
    assert set(stats[1]) == set(stats[0])
    # the host-side counts agree too (compiles differ: JAX also jits
    # its slot programs)
    for k in set(want["counters"]) - {"compiles_total", "steady_compiles"}:
        assert got["counters"][k] == want["counters"][k], k
    assert got["collected"] == want["collected"]
    for k in ("active_slots", "queue_depth") + (
            ("kv_pages_free",) if mode == "paged" else ()):
        assert got["gauges"][k] == want["gauges"][k], k
    for k, v in stats[0].items():
        if not k.endswith(("_mean", "_p50", "_p95", "_p99")):
            assert stats[1][k] == v, k


def test_export_trace_requires_a_recorder():
    e = Engine(_TM, _TP, max_batch=2, cache_len=64)
    with pytest.raises(RuntimeError, match="recorder=True"):
        e.export_trace()


@pytest.mark.parametrize("mode", ["chunked", "paged"])
def test_profiler_window_writes_a_trace(mode, tmp_path):
    e = Engine(_TM, _TP, max_batch=2, cache_len=64, profile_steps=3,
               trace_dir=str(tmp_path / "prof"), **MODES[mode])
    want = _serve(_Side("torch", mode))
    for uid, p in enumerate(_PROMPTS[:4]):
        e.submit(Request(uid=uid, prompt=p, max_new_tokens=10))
    e.run()
    assert {u: (list(r.tokens), r.finish_reason)
            for u, r in e.responses.items()} == want
    assert e.profile_trace and e.profile_trace.startswith(
        str(tmp_path / "prof"))
    with open(e.profile_trace) as f:
        trace = json.load(f)
    names = {ev.get("name", "") for ev in trace["traceEvents"]}
    assert any("aten::" in n for n in names)


def test_a_profiler_that_cannot_write_disables_the_window(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    e = Engine(_TM, _TP, max_batch=2, cache_len=64, prefill_chunk=8,
               trace_dir=str(blocker / "prof"))
    for uid, p in enumerate(_PROMPTS[:2]):
        e.submit(Request(uid=uid, prompt=p, max_new_tokens=10))
    out = e.run()
    assert all(r.ok for r in out.values())
    assert e.profile_trace is None


# --------------------------------------------------------------------- #
# the serve CLI
# --------------------------------------------------------------------- #
def test_serve_cli_lifecycle_flags_on_cpu(tmp_path, capsys):
    from repro_torch.launch import serve

    trace = tmp_path / "trace.json"
    log = tmp_path / "run.jsonl"
    responses, stats = serve.main([
        "--arch", "llama3.2-1b", "--variant", "reduced", "--device", "cpu",
        "--requests", "5", "--max-new", "8", "--max-batch", "2",
        "--cache-len", "64", "--prefill-chunk", "8", "--temperature", "0",
        "--paged", "--page-size", "8",
        "--faults", "nan_logits@5/1,page_alloc@8x2,slow_step@3+0.001",
        "--deadline", "600", "--trace-out", str(trace),
        "--trace-dir", str(tmp_path / "prof"),
        "--metrics-jsonl", str(log), "--log-every", "0.05"])
    out = capsys.readouterr().out
    assert stats["faults_injected"] == 4 and stats["slot_errors"] == 1
    assert stats["n_finished"] == 5 and stats["timeouts"] == 0
    assert "resilience:" in out and "chrome trace written" in out
    assert "profiler trace written" in out
    assert tracing.validate_chrome_trace(str(trace)) == []
    rows = metrics.read_jsonl(log)
    assert rows[-1]["kind"] == "final" and rows[0]["kind"] == "serve"
    assert rows[-1]["faults_injected"] == 4
    assert len(responses) == 5


def test_serve_cli_deadline_times_requests_out(capsys):
    from repro_torch.launch import serve

    _, stats = serve.main([
        "--arch", "llama3.2-1b", "--variant", "reduced", "--device", "cpu",
        "--requests", "3", "--max-new", "40", "--max-batch", "1",
        "--cache-len", "64", "--prefill-chunk", "8", "--temperature", "0",
        "--faults", "slow_step@2+0.3", "--deadline", "0.2"])
    assert stats["timeouts"] >= 1
    assert "timeouts=" in capsys.readouterr().out
