"""The PyTorch port's serving fleet against the JAX package's: failover,
hedging, drain and rejoin, a deadline in the fleet queue and the merged
trace (``tests/test_fleet.py``'s scenarios, its four slow-marked ones
included). The sides, weights, engine arguments and workloads are
``tests/test_torch_fleet.py``'s; each scenario holds equal the tokens
and finish reasons, the deterministic counters, the breaker states, the
replica states and death reasons and ``latency_stats()``'s key set, and
where JAX's test compares with one engine, the port's fleet equals the
port's single engine.
"""
import time

import pytest

torch = pytest.importorskip("torch")

from repro.serving import tracing as jax_tracing  # noqa: E402
from repro_torch.serving import fleet, tracing  # noqa: E402
from test_torch_fleet import (both, outcome, single_engine,  # noqa: E402
                              workload)

torch.set_num_threads(1)


def _served(reqs, **kw):
    """A script: a fleet of ``kw`` serving ``reqs`` to the end."""
    def script(side):
        fl = side.fleet(**kw)
        for r in side.requests(reqs):
            fl.submit(r)
        fl.run(max_steps=500)
        return outcome(fl)
    return script


def _tokens(out):
    return {u: s[0] for u, s in out["streams"].items()}


def test_crash_failover_no_loss_token_identical():
    reqs = workload(6, max_new=20)
    jx, pt = both(_served(reqs, replicas=3, faults="replica_crash@2/0"))
    assert pt == jx
    assert all(s[2] and s[1] == "length" for s in pt["streams"].values())
    assert _tokens(pt) == single_engine(reqs)
    c = pt["counters"]
    assert c["replica_deaths"] == 1 and c["failovers"] == 1
    assert c["requests_migrated"] >= 1
    assert pt["replicas"][0] == (fleet.DEAD, "crash")
    assert pt["gauges"]["gauge_replica_0_health"] == 2
    assert pt["breakers"]["breaker_0_state"] == "open"


def test_replica_hang_watchdog_kills_and_migrates():
    reqs = workload(4, max_new=20)
    jx, pt = both(_served(reqs, replicas=2, hang_ticks=3,
                          faults="replica_hang@2/0"))
    assert pt == jx
    assert all(s[1] == "length" for s in pt["streams"].values())
    assert _tokens(pt) == single_engine(reqs)
    assert pt["replicas"][0] == (fleet.DEAD, "hang")
    assert pt["counters"]["requests_migrated"] >= 1


def test_all_replicas_dead_fails_loudly_not_forever():
    jx, pt = both(_served(workload(2, max_new=8), replicas=1,
                          faults="replica_crash@1/0", hang_ticks=2))
    assert pt == jx
    assert all(s[2] and s[1] == "error" for s in pt["streams"].values())
    assert pt["counters"]["fleet_errors"] == 2


def test_hedge_wins_when_primary_hangs():
    reqs = workload(1, max_new=8)
    jx, pt = both(_served(reqs, replicas=2, hedge=True, hedge_delay_s=0.0,
                          hang_ticks=4, faults="replica_hang@1/0"))
    assert pt == jx
    assert pt["streams"][0][1] == "length"
    assert _tokens(pt) == single_engine(reqs)
    assert pt["counters"]["hedges_issued"] == 1
    assert pt["counters"]["hedges_won"] == 1


def test_hedge_loser_cancelled_tokens_exactly_once():
    """Single-step ticks keep first tokens several ticks away, so the
    zero-delay hedge window opens before anything binds; the loser goes
    through ``Engine.cancel`` and no token is delivered twice."""
    reqs = workload(2, max_new=10)

    def script(side):
        fl = side.fleet(replicas=2, hedge=True, hedge_delay_s=0.0)
        for r in side.requests(reqs):
            fl.submit(r)
        for _ in range(1000):
            if not fl.has_work:
                break
            fl.tick(1)
        cancelled = sorted(
            (r.rid, u) for r in fl.replicas
            for u, er in r.engine.responses.items()
            if er.finish_reason == "cancelled")
        return outcome(fl), cancelled

    (jx, jc), (pt, pc) = both(script)
    assert pt == jx and pc == jc
    assert all(s[1] == "length" for s in pt["streams"].values())
    assert _tokens(pt) == single_engine(reqs)
    c = pt["counters"]
    assert c["hedges_issued"] >= 1
    assert c["hedges_won"] + c["hedges_wasted"] == c["hedges_issued"]
    assert len(pc) == c["hedges_issued"]


def test_drain_finishes_streams_then_rejoin_serves_again():
    def script(side):
        fl = side.fleet(replicas=2)
        for r in side.requests(workload(4, max_new=10)):
            fl.submit(r)
        fl.tick()                        # streams live on both replicas
        fl.drain(0)
        states = [fl.replicas[0].state]
        fl.run()
        states.append(fl.replicas[0].state)
        with pytest.raises(ValueError) as err:
            fl.rejoin(1)
        fl.rejoin(0)
        states.append(fl.replicas[0].state)
        fl.submit(side.Request(uid=100, prompt=[3, 1, 4, 1, 5],
                               max_new_tokens=4))
        fl.run()
        return outcome(fl), states, str(err.value)

    jx, pt = both(script)
    assert pt == jx
    out, states, err = pt
    assert states == [fleet.DRAINING, fleet.DRAINED, fleet.HEALTHY]
    assert "nothing to rejoin" in err
    assert all(s[1] == "length" for s in out["streams"].values())
    assert out["counters"]["drains"] == 1 and out["counters"]["rejoins"] == 1


def test_deadline_expires_in_fleet_queue_never_admitted():
    def script(side):
        fl = side.fleet(replicas=1, max_outstanding=1)
        long_req = side.requests(workload(1, max_new=24))[0]
        fl.submit(long_req)
        fl.tick()                        # the replica is at capacity
        fl.submit(side.Request(uid=50, prompt=[1, 2, 3], max_new_tokens=4,
                               deadline_s=1e-6))
        time.sleep(0.01)
        fl.run()
        seen = [50 in r.engine.responses for r in fl.replicas]
        return outcome(fl), seen

    jx, pt = both(script)
    assert pt == jx
    out, seen = pt
    assert out["streams"][50] == ([], "timeout", True)
    assert out["streams"][0][1] == "length"
    assert out["counters"]["fleet_timeouts"] == 1
    assert seen == [False]


def test_fleet_trace_merges_per_replica_lanes(tmp_path):
    """The merged trace of a crash: valid, a lane a replica (pid
    ``100 + rid``) and the fleet's (99) holding ``replica_dead`` and
    ``failover``; the lanes, each lane's span names and the fleet lane's
    instants are JAX's. The ``compile`` spans are left out of the
    comparison: they name the programs each package builds, and the JAX
    engine also jits a slot reset the port runs eagerly."""
    def script(side):
        fl = side.fleet(replicas=2, trace=True, faults="replica_crash@2/0")
        for r in side.requests(workload(3, max_new=8)):
            fl.submit(r)
        fl.run()
        path = tmp_path / f"{side.name}.json"
        trace = fl.export_trace(str(path))
        ev = trace["traceEvents"]
        return (outcome(fl), path.exists(), trace,
                sorted({(e["pid"], e["args"]["name"]) for e in ev
                        if e.get("ph") == "M"
                        and e["name"] == "process_name"}),
                sorted({(e["pid"], e["name"]) for e in ev
                        if e.get("ph") == "X"
                        and not e["name"].startswith("compile ")}),
                [(e["name"], e["args"]) for e in ev
                 if e.get("pid") == 99 and e.get("ph") == "i"])

    jx, pt = both(script)
    assert pt[0] == jx[0]
    assert pt[3:] == jx[3:]
    assert pt[1] and tracing.validate_chrome_trace(pt[2]) == []
    assert jax_tracing.validate_chrome_trace(pt[2]) == []
    assert (99, "fleet") in pt[3]
    assert (100, "replica 0") in pt[3] and (101, "replica 1") in pt[3]
    fleet_lane = [name for name, _ in pt[5]]
    assert "replica_dead" in fleet_lane and "failover" in fleet_lane
