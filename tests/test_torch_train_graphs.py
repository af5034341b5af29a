"""The port's captured train step (``training/train_loop.py``'s
``TrainProgram``) against its functional eager step and the JAX
package's ``jax.jit(make_train_step(...))``, on the CPU.

On the CPU the step's body runs eagerly over its static buffers (the
parameters, moments and step counters written in place by
``AdamW.update_``, each batch copied into a static buffer); on the card
the same body is captured once as a CUDA graph and replayed
(``tests/test_torch_card.py`` holds that path). Compared, on reduced
llama3.2-1b, mamba2-780m, qwen2-moe-a2.7b and jamba-1.5-large-398b's
super-block (B 4, L 32):

* the static body against the functional step (``graphs=False``), bit
  for bit over 3 steps (every metric, parameter, moment and step
  counter), with and without ``microbatch=2``;
* the static body against JAX's jitted step on the same converted
  weights and batches: losses to 1e-5 relative, the parameters after a
  step to rtol 1e-4, atol 5e-5 (2 lr where the gradient is at rounding
  level, as ``tests/test_torch_training.py`` holds them; later steps'
  losses against JAX's are the five-loss tests of
  ``tests/test_torch_training*.py``, whose ``train`` runs this body);
* ``AdamW.update_`` against ``update`` bit for bit (f32 and bf16, clip
  on and off), and both schedules against JAX's;
* the MoE token route's expert counts by binary search against
  ``torch.bincount``, and the route's experts, outputs and load-balance
  loss against JAX's ``_route_tokens`` (a skewed router included);
* a train state written by the JAX package (bf16 leaves) loaded and
  copied into a running step, which then trains as the functional step
  does from it, bit for bit; the step's state saved and read back;
* the card path's control flow with a stand-in graph (a replay reruns
  the body): warm-up, one capture, replays equal to the functional
  step, and a capture that reads the host raising on every later call,
  naming the step, with no fall back to eager.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro.training import checkpoints as jax_ckpt  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training.train_loop import make_train_step as jax_step  # noqa: E402
from repro_torch import bridge, kernels  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.pytree import tree_leaves, tree_map  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.training import checkpoints  # noqa: E402
from repro_torch.training import optimizer as opt_mod  # noqa: E402
from repro_torch.training.train_loop import (TrainProgram,  # noqa: E402
                                             _grads_of, batch_to,
                                             init_train_state,
                                             make_train_step)

ARCHS = ("llama3.2-1b", "mamba2-780m", "qwen2-moe-a2.7b",
         "jamba-1.5-large-398b")
B, L = 4, 32
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 1e-4, 5e-5
METRICS = ("loss", "lm_loss", "aux_loss", "grad_norm", "lr")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _batches(cfg, n, seed=1):
    it = pipeline.batches_for(cfg, B, L, seed=seed)
    return [next(it) for _ in range(n)]


def _model(arch, **over):
    return build(get_arch(arch, variant="reduced").replace(**over),
                 device="cpu")


def _opt():
    return opt_mod.AdamW(lr=opt_mod.cosine_schedule(1e-3, 2, 10))


def _clone(state):
    return tree_map(lambda t: t.clone(), state)


def _same_state(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _same_metrics(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def _run(step, state, batches):
    """The metrics of each step and the state after the last, cloned (a
    static step's state is its own buffers)."""
    ms = []
    for batch in batches:
        state, m = step(state, batch)
        ms.append({k: v.clone() for k, v in m.items()})
    return _clone(state), ms


# --------------------------------------------------------------------- #
# the static body against the functional step
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("microbatch", [0, 2], ids=["full", "micro2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_static_body_equals_functional_step_bitwise(arch, microbatch):
    tm = _model(arch)
    to = _opt()
    state0 = init_train_state(tm, to, seed=0)
    keep = _clone(state0)
    batches = _batches(tm.cfg, 3)
    step = make_train_step(tm, to, microbatch=microbatch)
    assert isinstance(step, TrainProgram) and not step.graphs
    got_state, got = _run(step, state0, batches)
    assert _same_state(state0, keep)            # the caller's state kept
    want_state, want = _run(
        make_train_step(tm, to, microbatch=microbatch, graphs=False),
        state0, batches)
    assert all(_same_metrics(a, b) for a, b in zip(want, got))
    assert _same_state(want_state, got_state)
    assert int(got_state["step"]) == int(got_state["opt"]["step"]) == 3
    assert step.cache_size() == 0 and step.calls == 3


def test_the_step_returns_its_own_tensors_each_call():
    """The state a step returns is its buffers (no new allocation a
    step); the functional step returns new tensors."""
    tm = _model("llama3.2-1b")
    to = _opt()
    b1, b2 = _batches(tm.cfg, 2)
    step = make_train_step(tm, to)
    s1, _ = step(init_train_state(tm, to, seed=0), b1)
    ptrs = [t.data_ptr() for t in tree_leaves(s1)]
    s2, _ = step(s1, b2)
    assert [t.data_ptr() for t in tree_leaves(s2)] == ptrs
    assert s2 is not s1 and s2["params"] is not s1["params"]
    eager = make_train_step(tm, to, graphs=False)
    e1, _ = eager(s2, b1)
    assert all(a.data_ptr() != b.data_ptr() for a, b in
               zip(tree_leaves(e1["params"]), tree_leaves(s2["params"])))


def test_graphs_true_needs_a_card_and_layouts_are_fixed():
    tm = _model("llama3.2-1b")
    to = _opt()
    with pytest.raises(ValueError, match="CUDA"):
        make_train_step(tm, to, graphs=True)
    step = make_train_step(tm, to)
    state, _ = step(init_train_state(tm, to, seed=0), _batches(tm.cfg, 1)[0])
    short = {k: v[:2] for k, v in _batches(tm.cfg, 1)[0].items()}
    with pytest.raises(ValueError, match="one layout"):
        step(state, short)
    other = init_train_state(_model("llama3.2-1b", n_kv_heads=2), to, 0)
    with pytest.raises(ValueError, match="differ from the step's buffers"):
        step(other, _batches(tm.cfg, 1)[0])


# --------------------------------------------------------------------- #
# against JAX's jitted step
# --------------------------------------------------------------------- #
def _pair(arch):
    """Both packages' models of ``arch`` (reduced) and one set of weights:
    the port's seed-0 init, crossed to JAX as numpy arrays."""
    jm, tm = jax_build(jax_get_arch(arch, variant="reduced")), _model(arch)
    tp = tm.init(0)
    jp = jax.tree.map(jnp.asarray, bridge.params_to_numpy(tp))
    return jm, jp, tm, tp


def _leaves(jtree, ttree):
    flat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = tree_leaves(ttree)
    assert len(flat) == len(tl)
    return [(jax.tree_util.keystr(p), a, b) for (p, a), b in zip(flat, tl)]


def _assert_params_close(want, got, grads, lr):
    """rtol 1e-4, atol 5e-5 where the gradient (the port's, which equals
    JAX's to GRAD_TOL of each leaf's max) stands above GRAD_TOL of its
    leaf's max, 2 lr + 5e-5 where it does not (a first AdamW step moves
    an element by about lr sign(g))."""
    gs = [np.abs(_np(g)) for g in tree_leaves(grads)]
    for (name, a, b), g in zip(_leaves(want, got), gs):
        noise = g <= GRAD_TOL * g.max()
        a, b = _np(a), _np(b)
        np.testing.assert_allclose(b[~noise], a[~noise], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=name)
        assert np.abs(b[noise] - a[noise]).max(initial=0.0) \
            <= 2 * lr + PARAM_ATOL, name


@pytest.mark.parametrize("arch", ARCHS)
def test_static_body_matches_jax_jitted_step(arch):
    jm, jp, tm, tp = _pair(arch)
    b1, = _batches(tm.cfg, 1)
    jo = jax_opt.AdamW(lr=jax_opt.cosine_schedule(1e-3, 2, 10))
    to = _opt()
    js = {"params": jp, "opt": jo.init(jp), "step": jnp.zeros((), jnp.int32)}
    ts = {"params": tp, "opt": to.init(tp),
          "step": torch.zeros((), dtype=torch.int32)}
    jstep, tstep = jax.jit(jax_step(jm, jo)), make_train_step(tm, to)
    grads = _grads_of(tm, tp, batch_to(b1, "cpu"))[2]
    js, jmet = jstep(js, b1)
    ts, tmet = tstep(ts, b1)
    assert set(tmet) == set(jmet) == set(METRICS)
    for k in METRICS:
        assert abs(float(tmet[k]) - float(jmet[k])) \
            <= LOSS_RTOL * abs(float(jmet[k])) + 1e-12, k
    _assert_params_close(js["params"], ts["params"], grads,
                         float(tmet["lr"]))
    assert int(ts["step"]) == int(js["step"]) == 1


# --------------------------------------------------------------------- #
# the optimizer
# --------------------------------------------------------------------- #
def _tree(rng, dtype):
    def leaf(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dtype)
    return {"a": {"w": leaf(6, 5), "b": leaf(5)}, "z": leaf(3, 2, 4)}


@pytest.mark.parametrize("clip", [1.0, 1e3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_update_in_place_equals_update_bitwise(dtype, clip):
    """Three steps (clipping active at 1.0, not at 1e3): the parameters
    (in their dtype), f32 moments and step, the same bits; update_ writes
    the given tensors and returns nothing."""
    rng = np.random.default_rng(7)
    params = _tree(rng, dtype)
    grads = [_tree(rng, dtype) for _ in range(3)]
    opt = opt_mod.AdamW(lr=opt_mod.cosine_schedule(1e-2, 1, 10),
                        clip_norm=clip)
    fp, fs = params, opt.init(params)
    ip, ist = _clone(params), opt.init(params)
    ptrs = [t.data_ptr() for t in tree_leaves((ip, ist))]
    for g in grads:
        fp, fs = opt.update(g, fs, fp)
        assert opt.update_(g, ist, ip) is None
        assert _same_state(fp, ip) and _same_state(fs, ist)
    assert [t.data_ptr() for t in tree_leaves((ip, ist))] == ptrs
    assert int(ist["step"]) == 3 and ip["z"].dtype == dtype


@pytest.mark.parametrize("sched", ["cosine", "constant"])
def test_schedules_equal_jax(sched):
    """Both schedules, at the steps around warm-up and past the end: a
    0-d f32 tensor on the step's device, JAX's value (the constant one
    exactly: one f32 rounding of the same float)."""
    if sched == "cosine":
        j, t = jax_opt.cosine_schedule(3e-4, 100, 10_000), \
            opt_mod.cosine_schedule(3e-4, 100, 10_000)
        tol = 1e-6
    else:
        j, t = jax_opt.constant_schedule(2e-3), opt_mod.constant_schedule(2e-3)
        tol = 0.0
    for step in (0, 1, 50, 99, 100, 101, 5000, 10_000, 20_000):
        got = t(torch.tensor(step, dtype=torch.int32))
        want = float(j(jnp.int32(step)))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert got.device.type == "cpu"
        assert abs(float(got) - want) <= tol * abs(want), step


# --------------------------------------------------------------------- #
# the MoE token route
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("E, A, seed", [(4, 64, 0), (60, 512, 1),
                                        (8, 5, 2), (16, 256, 3)])
def test_sorted_counts_equal_bincount(E, A, seed):
    """Counts and offsets by binary search on the sorted ids = bincount
    and its exclusive cumsum, empty experts (E 60 over few ids, E 8
    over 5) and a skew to one expert included."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, E, A)
    if seed == 3:
        ids[: A // 2] = 5
    ids = torch.from_numpy(ids)
    counts, offsets = moe._sorted_counts(torch.sort(ids, stable=True).values,
                                         E)
    want = torch.bincount(ids, minlength=E)
    assert counts.dtype == want.dtype and torch.equal(counts, want)
    assert torch.equal(offsets, torch.cumsum(want, 0) - want)


@pytest.mark.parametrize("skew", [False, True], ids=["even", "skewed"])
def test_token_route_matches_jax(skew):
    """Reduced qwen2-moe's first MoE layer on 128 tokens: the experts
    each token picks equal JAX's top-k, the output within 1e-5 of
    max|JAX's| and the load-balance loss within 1e-5 relative; skewed,
    more tokens pick expert 0 than it has slots (assignments dropped)."""
    jc = jax_get_arch("qwen2-moe-a2.7b", variant="reduced")
    tm = _model("qwen2-moe-a2.7b")
    tl = tree_map(lambda a: a[0], tm.init(0)["blocks"]["sub0"]["moe"])
    jl = jax.tree.map(jnp.asarray, bridge.params_to_numpy(tl))
    x = np.random.default_rng(4).normal(
        size=(128, tm.cfg.d_model)).astype(np.float32)
    if skew:
        # every token's expert-0 logit raised by 3: most pick it
        w0 = np.asarray(jl["router"]["w"])[:, 0]
        x = x + (3.0 * np.sign(w0) / np.abs(w0).sum()).astype(np.float32)
    jy, jaux = jax.jit(lambda p, x: jax_moe._route_tokens(p, x, jc))(
        jl, jnp.asarray(x))
    ty, taux = moe._route_tokens(tl, torch.from_numpy(x), tm.cfg)
    k = tm.cfg.moe.top_k
    probs = jax.nn.softmax(jnp.asarray(x) @ jl["router"]["w"], axis=-1)
    jidx = np.asarray(lax.top_k(probs, k)[1])
    tidx = moe._gates(tl, torch.from_numpy(x), tm.cfg.moe)[2].numpy()
    assert np.array_equal(tidx, jidx)
    if skew:
        C = moe._capacity(128, tm.cfg.moe)
        assert int((tidx == 0).sum()) > C
    assert np.abs(_np(ty) - _np(jy)).max() <= 1e-5 * np.abs(_np(jy)).max()
    assert abs(float(taux) - float(jaux)) <= 1e-5 * abs(float(jaux))


# --------------------------------------------------------------------- #
# train states
# --------------------------------------------------------------------- #
def test_a_loaded_jax_state_trains_on_identically(tmp_path):
    """A bf16 train state written by the JAX package, loaded and passed
    to a step that already ran on another state: the step copies it into
    its buffers (the loaded tensors stay as they were) and then trains
    as the functional step does from the loaded state, bit for bit over
    2 steps; the step's state saved and read back is the same bits."""
    over = dict(dtype="bfloat16", param_dtype="bfloat16")
    tm = _model("llama3.2-1b", **over)
    jp = jax.tree.map(jnp.asarray, bridge.params_to_numpy(tm.init(3)))
    jo = jax_opt.AdamW(lr=jax_opt.cosine_schedule(1e-3, 2, 10))
    jax_ckpt.save_train_state(tmp_path / "jax", 5, jp, jo.init(jp))
    step_n, params, opt_state = checkpoints.load_train_state(
        tmp_path / "jax", device="cpu")
    assert step_n == 5
    assert {t.dtype for t in tree_leaves(params)} == {torch.bfloat16}
    loaded = {"params": params, "opt": opt_state,
              "step": torch.tensor(step_n, dtype=torch.int32)}
    keep = _clone(loaded)
    to = _opt()
    batches = _batches(tm.cfg, 3)
    step = make_train_step(tm, to)
    step(init_train_state(tm, to, seed=0), batches[0])
    got_state, got = _run(step, loaded, batches[1:])
    assert _same_state(loaded, keep)
    want_state, want = _run(make_train_step(tm, to, graphs=False), loaded,
                            batches[1:])
    assert all(_same_metrics(a, b) for a, b in zip(want, got))
    assert _same_state(want_state, got_state)
    assert int(got_state["step"]) == 7
    checkpoints.save_train_state(tmp_path / "port", 7, step.state["params"],
                                 step.state["opt"])
    _, p2, o2 = checkpoints.load_train_state(tmp_path / "port", device="cpu")
    assert _same_state(p2, got_state["params"])
    assert _same_state(o2, got_state["opt"])


# --------------------------------------------------------------------- #
# the card path, with a stand-in graph
# --------------------------------------------------------------------- #
_HOST_READS = ("__int__", "__index__", "__bool__", "__float__", "item",
               "tolist")


def _host_read(*_):
    raise RuntimeError("operation not permitted when stream is capturing")


class _StandInGraph:
    """Replays by running the step's body again and writing its metrics
    into the captured ones, as a graph writes its own buffers."""

    def __init__(self, prog):
        self.prog, self.replays = prog, 0

    def replay(self):
        self.replays += 1
        with kernels.recorded_launches():         # a replay counts none
            fresh = self.prog._body()
        for k, v in fresh.items():
            self.prog.out[k].copy_(v)


class _StandIn(TrainProgram):
    """A ``TrainProgram`` that takes the card path on the CPU: the
    capture runs the body with host reads raising, as inside a capture,
    and then puts the static state back, since a capture records the
    step and runs none of it."""

    def __init__(self, model, opt, **kw):
        super().__init__(model, opt, graphs=True, **kw)

    def _on_stream(self):
        return contextlib.nullcontext()

    def _new_graph(self):
        return _StandInGraph(self)

    @contextlib.contextmanager
    def _recording(self, graph):
        before = _clone(self.state)
        saved = {k: torch.Tensor.__dict__.get(k) for k in _HOST_READS}
        for k in _HOST_READS:
            setattr(torch.Tensor, k, _host_read)
        try:
            yield
        finally:
            for k, v in saved.items():
                if v is None:
                    delattr(torch.Tensor, k)
                else:
                    setattr(torch.Tensor, k, v)
            for a, b in zip(tree_leaves(self.state), tree_leaves(before)):
                a.copy_(b)

    def _reserved(self):
        return 0


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-moe-a2.7b"])
def test_captured_path_replays_the_functional_step(arch):
    """The first call warms up eagerly, the second captures once and
    replays, the third replays: metrics (fresh tensors each call) and
    the state after each step equal the functional step's, bit for
    bit; no capture after the first."""
    tm = _model(arch)
    to = _opt()
    state0 = init_train_state(tm, to, seed=0)
    batches = _batches(tm.cfg, 3)
    prog = _StandIn(tm, to)
    eager = make_train_step(tm, to, graphs=False)
    s, e = state0, state0
    seen = []
    for i, batch in enumerate(batches):
        s, m = prog(s, batch)
        e, me = eager(e, batch)
        assert prog.cache_size() == int(i >= 1)
        assert _same_metrics(me, m) and _same_state(e, s)
        seen.append(m["loss"].data_ptr())
    assert prog.graph.replays == 2
    assert len(set(seen)) == 3


def test_a_capture_that_reads_the_host_raises_and_does_not_fall_back():
    """A loss that reads the host runs eagerly in the warm-up, then its
    capture raises naming the step, on every later call; the state holds
    the warm-up's step."""
    tm = _model("llama3.2-1b")

    class _Reads:
        device, cfg = tm.device, tm.cfg

        @staticmethod
        def train_loss(params, batch):
            loss, metrics = tm.train_loss(params, batch)
            float(loss.detach())                       # a host read
            return loss, metrics

    to = _opt()
    prog = _StandIn(_Reads(), to)
    batches = _batches(tm.cfg, 3)
    s, _ = prog(init_train_state(tm, to, seed=0), batches[0])
    after = _clone(s)
    for batch in batches[1:]:
        with pytest.raises(RuntimeError,
                           match="the train step of llama3.2-1b.*capture"):
            prog(s, batch)
        assert prog.cache_size() == 0
    assert _same_state(prog.state, after) and prog.calls == 1
