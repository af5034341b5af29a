"""The port's step programs, program counts and recompile watchdog
against the JAX engine's, on the CPU.

The JAX engine compiles each step into one jitted program and watches
its jit caches (``program_cache_sizes``, ``telemetry.CompileWatchdog``);
the port builds each step as a ``StepProgram``, a CUDA graph on the
card and an eager body on the CPU, and records every build with its own
watchdog. Here: the two watchdogs given the same calls agree on their
counters, their ``compiles`` series and the call that warns; the port's
``program_cache_sizes()`` has the JAX dict's keys for the same run and
stays flat over a second batch; a program built after ``mark_steady()``
(or ``reset_stats()``) warns and counts as a steady compile;
``graphs=True`` on the CPU raises; the step bodies update the decode
state in place, as a graph needs; and a stand-in program (no card) holds
the replay accounting of the kernel launch counters. The engines'
token streams against JAX's are held by ``test_torch_engine.py``,
``test_torch_paged.py``, ``test_torch_quant.py`` and
``test_torch_ssm.py``, which run the same step bodies.
"""
import contextlib
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro.serving import telemetry as jax_telemetry  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro.serving.sampler import Sampler as JaxSampler  # noqa: E402
from repro_torch import bridge, kernels  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.serving import telemetry  # noqa: E402
from repro_torch.serving.engine import Engine, StepProgram  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402


def _models():
    jc = jax_get_arch("llama3.2-1b", variant="reduced").replace(n_kv_heads=2)
    tc = get_arch("llama3.2-1b", variant="reduced").replace(n_kv_heads=2)
    jm, tm = jax_build(jc), build(tc, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jm, jp, tm, tp


_JM, _JP, _TM, _TP = _models()


# --------------------------------------------------------------------- #
# the watchdog against JAX's
# --------------------------------------------------------------------- #
#: call sequences: ("r", program, elapsed_s, step) records a build,
#: ("a",) arms, ("reset",) resets the registry (persistent counters stay)
WATCHDOG_CALLS = {
    "warm_then_steady": [("r", "step", 0.1, 0), ("a",),
                         ("r", "mixed", 0.2, 5)],
    "armed_first": [("a",), ("r", "step", 0.05, 0), ("r", "step", 0.07, 1)],
    "many_warm": [("r", "mixed", 0.3, 0), ("r", "step", 0.1, 1),
                  ("r", "mixed", 0.25, 3), ("a",), ("a",),
                  ("r", "mixed", 0.4, 9), ("r", "step", 0.001, 12)],
    "reset_keeps_totals": [("r", "step", 0.1, 0), ("reset",), ("a",),
                           ("r", "mixed", 0.2, 4), ("reset",),
                           ("r", "mixed", 0.3, 6)],
}


def _drive(mod, calls):
    """Run ``calls`` on a fresh registry and watchdog of module ``mod``:
    returns the counters, the ``compiles`` series and, per call, the
    program names it warned about."""
    reg = mod.MetricsRegistry()
    wd = mod.CompileWatchdog(reg) if mod is telemetry else \
        mod.CompileWatchdog(reg, mod.Recorder())
    warned = []
    for i, call in enumerate(calls):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            if call[0] == "a":
                wd.arm()
            elif call[0] == "reset":
                reg.reset()
            else:
                _, name, elapsed, step = call
                wd.record(name, elapsed, step=step, ts=float(i))
        warned.append([w.message.program for w in got
                       if isinstance(w.message, mod.RecompileWarning)])
    counters = {k: reg.counter(k).value
                for k in ("compiles_total", "steady_compiles")}
    return counters, list(reg.get_series("compiles").values), warned


@pytest.mark.parametrize("calls", list(WATCHDOG_CALLS.values()),
                         ids=list(WATCHDOG_CALLS))
def test_watchdog_matches_jax_watchdog(calls):
    assert _drive(telemetry, calls) == _drive(jax_telemetry, calls)


def test_recompile_warning_speaks_of_a_capture():
    w = telemetry.RecompileWarning("mixed", 0.25, 7)
    assert isinstance(w, UserWarning)
    assert (w.program, w.elapsed_s, w.step) == ("mixed", 0.25, 7)
    assert "CUDA graph capture" in str(w) and "XLA" not in str(w)


def test_persistent_counter_survives_a_registry_reset():
    for mod in (telemetry, jax_telemetry):
        reg = mod.MetricsRegistry()
        reg.counter("kept", persist=True).inc(3)
        reg.counter("dropped").inc(2)
        reg.reset()
        assert (reg.counter("kept").value, reg.counter("dropped").value) \
            == (3, 0), mod.__name__


# --------------------------------------------------------------------- #
# program counts against the JAX engine's
# --------------------------------------------------------------------- #
def _batch(rng, uids, vocab):
    return [(uid, rng.integers(0, vocab, int(rng.integers(3, 20))),
             int(rng.integers(1, 6))) for uid in uids]


@pytest.mark.parametrize("paged", [False, True], ids=["rings", "paged"])
def test_program_cache_sizes_match_jax_and_stay_flat(paged):
    """Both engines serve the same two batches (4 requests on 2 slots,
    so both slots admit in the first): the port's dict has the JAX
    dict's keys before and after each batch, one plain program and one
    mixed program per slot, and the second batch builds nothing."""
    kw = dict(max_batch=2, cache_len=32, prefill_chunk=8)
    if paged:
        kw.update(paged=True, page_size=8)
    je = JaxEngine(_JM, _JP, sampler=JaxSampler(), **kw)
    te = Engine(_TM, _TP, **kw)
    assert te.program_cache_sizes().keys() == \
        je.program_cache_sizes().keys()
    rng = np.random.default_rng(3)
    sizes = []
    for uids in (range(4), range(4, 8)):
        for uid, prompt, mx in _batch(rng, uids, _TM.cfg.vocab):
            je.submit(JaxRequest(uid=uid, prompt=prompt, max_new_tokens=mx))
            te.submit(Request(uid=uid, prompt=prompt, max_new_tokens=mx))
        jr, tr = je.run(), te.run()
        assert all(tr[u].tokens == jr[u].tokens for u in uids)
        assert te.program_cache_sizes().keys() == \
            je.program_cache_sizes().keys()
        sizes.append(te.program_cache_sizes())
    assert sizes[0] == sizes[1] == {"step": 1, "mixed": 2}
    counters = te.metrics.counters
    assert counters["compiles_total"].value == 3
    assert counters["steady_compiles"].value == 0
    assert [e["program"] for e in te.metrics.get_series("compiles").values
            ].count("mixed") == 2


@pytest.mark.parametrize("arm", ["mark_steady", "reset_stats"])
def test_program_for_a_new_slot_after_steady_warns(arm):
    """After warm-up on slot 0 alone, the watchdog is armed; a second
    batch that admits into slot 1 builds its mixed program, which warns
    and counts as a steady compile (mirrors the JAX engine's steady-state
    recompile test). The warm-up's builds stay counted."""
    te = Engine(_TM, _TP, max_batch=2, cache_len=32, prefill_chunk=8)
    te.submit(Request(uid=0, prompt=np.arange(12), max_new_tokens=3))
    te.run()
    assert te.program_cache_sizes() == {"step": 1, "mixed": 1}
    getattr(te, arm)()
    for uid in (1, 2):
        te.submit(Request(uid=uid, prompt=np.arange(5) + uid,
                          max_new_tokens=3))
    with pytest.warns(telemetry.RecompileWarning, match="mixed"):
        te.run()
    c = te.metrics.counters
    assert c["steady_compiles"].value == 1
    assert c["compiles_total"].value == 3
    assert te.program_cache_sizes() == {"step": 1, "mixed": 2}
    assert [e["steady"] for e in te.metrics.get_series("compiles").values
            ][-1] is True


def test_no_build_after_warm_up_is_silent():
    te = Engine(_TM, _TP, max_batch=2, cache_len=32, prefill_chunk=8)
    for uid in range(3):
        te.submit(Request(uid=uid, prompt=np.arange(9) + uid,
                          max_new_tokens=4))
    te.run()
    te.mark_steady()
    for uid in range(3, 6):
        te.submit(Request(uid=uid, prompt=np.arange(7) + uid,
                          max_new_tokens=4))
    with warnings.catch_warnings():
        warnings.simplefilter("error", telemetry.RecompileWarning)
        te.run()
    assert te.metrics.counters["steady_compiles"].value == 0


# --------------------------------------------------------------------- #
# the choice of mode, and what a graph needs of the step bodies
# --------------------------------------------------------------------- #
def test_graphs_true_on_the_cpu_raises():
    with pytest.raises(ValueError, match="graphs=True needs a CUDA"):
        Engine(_TM, _TP, max_batch=2, cache_len=32, graphs=True)
    assert not Engine(_TM, _TP, max_batch=2, cache_len=32).graphs
    assert not Engine(_TM, _TP, max_batch=2, cache_len=32,
                      graphs=False).graphs


@pytest.mark.parametrize("paged", [False, True], ids=["rings", "paged"])
def test_step_bodies_update_static_buffers_in_place(paged):
    """A captured graph reads fixed addresses: across plain and mixed
    steps, admissions, finishes and slot reuse, the decode state, the
    staging buffer and every cache leaf keep their storage, and a CPU
    engine builds its programs without capturing any."""
    kw = dict(paged=True, page_size=8) if paged else {}
    te = Engine(_TM, _TP, max_batch=2, cache_len=32, prefill_chunk=8, **kw)

    def ptrs():
        bufs = [te.tokens, te.remaining, te.active, te.eos, te._stage]
        bufs += [t for sub in te.cache.values() for t in sub.values()]
        return [t.data_ptr() for t in bufs]

    before = ptrs()
    rng = np.random.default_rng(5)
    for uid, prompt, mx in _batch(rng, range(5), _TM.cfg.vocab):
        te.submit(Request(uid=uid, prompt=prompt, max_new_tokens=mx))
    out = te.run()
    assert all(r.finished for r in out.values())
    assert {"plain", "mixed"} <= set(te.step_kinds)
    assert ptrs() == before
    assert te._programs and all(p.graph is None
                                for p in te._programs.values())


# --------------------------------------------------------------------- #
# replay accounting of the launch counters, with a stand-in program
# --------------------------------------------------------------------- #
class _StandInGraph:
    """Records nothing and replays nothing: counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _StandInProgram(StepProgram):
    """A ``StepProgram`` whose graph is a stand-in: the capture runs the
    body once with no recording, as a capture would trace it."""

    def _new_graph(self, generator):
        return _StandInGraph()

    @staticmethod
    def _recording(graph, pool, stream):
        return contextlib.nullcontext()


@pytest.mark.parametrize("replays", [1, 3])
def test_replays_add_the_launches_their_capture_recorded(replays):
    """A body that "launches" the norm twice and one decode attention:
    the capture leaves the counters as they were (a capture runs no
    kernel), each replay adds what the capture recorded, and a call
    returns a copy of the captured output."""
    wrappers = kernels._WRAPPERS
    calls = []

    def body():
        calls.append(1)
        wrappers["rmsnorm"].launches += 2
        wrappers["decode_attention"].launches += 1
        return torch.arange(4)

    kernels.reset_launch_counts()
    wrappers["ssd_extend"].launches = 5        # untouched by the body
    prog = _StandInProgram(body)
    prog.capture()
    assert kernels.launch_counts()["rmsnorm"] == 0
    assert prog.launches == {"rmsnorm": 2, "decode_attention": 1}
    outs = [prog() for _ in range(replays)]
    counts = kernels.launch_counts()
    assert counts["rmsnorm"] == 2 * replays
    assert counts["decode_attention"] == replays
    assert counts["ssd_extend"] == 5
    assert prog.graph.replays == replays and len(calls) == 1
    assert all(o is not prog.out and torch.equal(o, prog.out) for o in outs)
    kernels.reset_launch_counts()


def test_a_failed_capture_sets_the_counters_back_and_raises():
    wrappers = kernels._WRAPPERS

    def body():
        wrappers["rmsnorm"].launches += 1
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    kernels.reset_launch_counts()
    prog = _StandInProgram(body)
    with pytest.raises(RuntimeError, match="capturing"):
        prog.capture()
    assert prog.graph is None
    assert kernels.launch_counts()["rmsnorm"] == 0


def test_an_eager_program_runs_its_body_every_call():
    kernels.reset_launch_counts()
    seen = []
    prog = StepProgram(lambda: torch.tensor([len(seen)]))
    for i in range(3):
        seen.append(prog())
    assert [int(t) for t in seen] == [0, 1, 2]
    assert prog.graph is None and prog.launches == {}
