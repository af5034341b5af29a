"""The port's compiled service call against the JAX package's, on the CPU.

JAX compiles a service's call with ``jax.jit`` in three places:
``Service.jitted()``, each endpoint group of a ``DeployedService`` and
each stage of ``profile_stages``. The port runs them as programs
(``repro_torch.core.program.ServiceProgram``): CUDA graphs on the card,
eager on the CPU. Here, on the same weights (JAX's, carried across with
``repro_torch.bridge``) and the same inputs (numpy, from a seed):

* ``Service.jitted()`` equals JAX's within 1e-5 (class ids equal) for
  the reduced pixtral-12b classifier ``>> label_decoder``, ``model.lm``
  on the reduced llama3.2-1b and on a 2-layer mamba2-780m, and every
  combinator; gradients through it equal JAX's;
* a deployed route on local, remote and split plans equals JAX's;
* ``profile_stages`` gives a ``compile_ms`` of at least 0.

A stand-in program (no card: its "graph" replays by running the
captured function again on the static buffers) holds what the card
path does: one capture a key (a new shape or a new params tree is one
more, equal calls none), inputs copied into the same static storage,
outputs returned as clones, a route run as segments with one host read a
call, a failed capture that sets the launch counters back and raises
naming the service, a route the program cannot split, and the refusal
of a call under grad mode. The engine's step programs on the same core
are held by ``test_torch_graphs.py``.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.zoo_builders as jzb  # noqa: E402
import repro_torch.core.zoo_builders as tzb  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.core import compose as jcompose  # noqa: E402
from repro.core import deploy as jdeploy  # noqa: E402
from repro.core import profile as jprofile  # noqa: E402
from repro.core.netmodel import NetworkModel as JNet  # noqa: E402
from repro.core.service import Service as JService  # noqa: E402
from repro.core.service import Signature as JSig  # noqa: E402
from repro.core.service import TensorSpec as JSpec  # noqa: E402
from repro.core.service import service_from_fn as jservice  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro_torch import bridge, kernels  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import compose, deploy, profile  # noqa: E402
from repro_torch.core.netmodel import NetworkModel  # noqa: E402
from repro_torch.core.program import ServiceProgram  # noqa: E402
from repro_torch.core.pytree import tree_leaves  # noqa: E402
from repro_torch.core.service import (Service, Signature,  # noqa: E402
                                      TensorSpec, service_from_fn)

TOL = 1e-5


# --------------------------------------------------------------------- #
# helpers: the same service in both packages
# --------------------------------------------------------------------- #
def _linear_pair(name, d_in, d_out, key=0, batch=4):
    w = jax.random.normal(jax.random.PRNGKey(key), (d_in, d_out)) * 0.1
    js = jservice(name, lambda p, x: x @ p["w"],
                  jax.ShapeDtypeStruct((batch, d_in), jnp.float32),
                  params={"w": w})
    ts = service_from_fn(name, lambda p, x: x @ p["w"],
                         torch.zeros(batch, d_in),
                         params={"w": torch.from_numpy(np.array(w))})
    return js, ts


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _close(port, jax_out, tol=TOL):
    if isinstance(port, dict):
        assert set(port) == set(jax_out)
        for k in port:
            _close(port[k], jax_out[k], tol)
        return
    got = port.detach().float().numpy()
    want = np.asarray(jax_out, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _route_pair(d_in=8, d_out=4):
    """route(sel, [small, big]): sel picks big where mean(x) > 0."""
    (js, ts), (jb, tb) = _linear_pair("small", d_in, d_out, 0), \
        _linear_pair("big", d_in, d_out, 1)
    tsel = Service(name="sel",
                   fn=lambda p, x: (x.mean() > 0).to(torch.int32),
                   signature=Signature(ts.signature.inputs,
                                       TensorSpec((), "int32")))
    jsel = JService(name="sel",
                    fn=lambda p, x: (jnp.mean(x) > 0).astype(jnp.int32),
                    signature=JSig(js.signature.inputs, JSpec((), "int32")))
    return jcompose.route(jsel, [js, jb]), compose.route(tsel, [ts, tb])


def _both_jitted(js, ts, jx, tx, params=None):
    """Both packages' ``jitted()`` on the services' own params."""
    return (ts.jitted()(ts.params if params is None else params[1], tx),
            js.jitted()(js.params if params is None else params[0], jx))


@pytest.fixture(scope="module")
def clf_pair():
    """The reduced pixtral-12b classifier (10 classes) and label decoder
    in both packages, on JAX's seed-0 weights."""
    jc = jzb.classifier_service("pixtral-12b", n_classes=10)
    jc = jc.with_params(jc.metadata["init_params"](jax.random.PRNGKey(0)))
    tc = tzb.classifier_service("pixtral-12b", n_classes=10)
    npt = jax.tree.map(np.asarray, jc.params)
    cfg = get_arch("pixtral-12b", variant="reduced")
    tc = tc.with_params(
        {"backbone": bridge.params_from_jax(npt["backbone"], cfg, "cpu"),
         "head": bridge.cache_from_jax(npt["head"], "cpu")})
    return (jc, jzb.label_decoder(10)), (tc, tzb.label_decoder(10))


# --------------------------------------------------------------------- #
# Service.jitted() against JAX's
# --------------------------------------------------------------------- #
def test_jitted_classifier_pipeline_matches_jax(clf_pair):
    (jc, jd), (tc, td) = clf_pair
    x = _x((2, 16, 64), 1)
    got, want = _both_jitted(jc >> jd, tc >> td,
                             {"embeddings": jnp.asarray(x)},
                             {"embeddings": torch.from_numpy(x)})
    np.testing.assert_array_equal(got["class_id"].numpy(),
                                  np.asarray(want["class_id"]))
    _close(got["confidence"], want["confidence"])
    _close(tc.jitted()(tc.params, {"embeddings": torch.from_numpy(x)}),
           jc.jitted()(jc.params, {"embeddings": jnp.asarray(x)}))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-780m"])
def test_jitted_lm_matches_jax(arch):
    """``model.lm`` at the reduced width (2 layers): mamba2-780m's
    cache-free forward runs the SSD dual form."""
    cfg = get_arch(arch, variant="reduced")
    assert cfg.n_layers == 2
    jlm = jzb.lm_service(arch, variant="reduced")
    tlm = tzb.lm_service(arch, variant="reduced")
    jp = jax_build(jax_get_arch(arch, variant="reduced")).init(
        jax.random.PRNGKey(0))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = np.random.default_rng(12).integers(0, cfg.vocab, (2, 24)).astype(
        np.int32)
    got, want = _both_jitted(jlm, tlm, {"tokens": jnp.asarray(toks)},
                             {"tokens": torch.from_numpy(toks)},
                             params=(jp, tp))
    _close(got, want)


def _combinator_pair(kind):
    """(JAX service, port service, numpy input tree) for one combinator."""
    if kind == "seq":
        (ja, ta), (jb, tb) = _linear_pair("a", 8, 16, 0), \
            _linear_pair("b", 16, 4, 1)
        return ja >> jb, ta >> tb, _x((4, 8), 2)
    if kind == "parallel":
        (ja, ta), (jb, tb) = _linear_pair("a", 8, 4, 0), \
            _linear_pair("b", 6, 2, 1)
        return (jcompose.parallel({"l": ja, "r": jb}),
                compose.parallel({"l": ta, "r": tb}),
                {"l": _x((4, 8), 3), "r": _x((4, 6), 4)})
    if kind.startswith("ensemble"):
        pairs = [_linear_pair(f"m{i}", 8, 4, i) for i in range(3)]
        combine = kind.split("_")[1]
        return (jcompose.ensemble([j for j, _ in pairs], combine=combine),
                compose.ensemble([t for _, t in pairs], combine=combine),
                _x((2, 8), 5))
    if kind.startswith("route"):
        jr, tr = _route_pair()
        sign = 1.0 if kind.endswith("pos") else -1.0
        return jr, tr, sign * np.abs(_x((4, 8), 6))
    per_t = service_from_fn("norm", lambda p, x: x / torch.linalg.norm(x),
                            torch.ones(8))
    per_j = jservice("norm", lambda p, x: x / jnp.linalg.norm(x),
                     jax.ShapeDtypeStruct((8,), jnp.float32))
    return (jcompose.map_batch(per_j), compose.map_batch(per_t),
            _x((5, 8), 7))


COMBINATORS = ["seq", "parallel", "ensemble_mean", "ensemble_sum",
               "ensemble_stack", "route_pos", "route_neg", "map_batch"]


@pytest.mark.parametrize("kind", COMBINATORS)
def test_jitted_combinator_matches_jax(kind):
    js, ts, x = _combinator_pair(kind)
    tx = {k: torch.from_numpy(v) for k, v in x.items()} \
        if isinstance(x, dict) else torch.from_numpy(x)
    jx = {k: jnp.asarray(v) for k, v in x.items()} \
        if isinstance(x, dict) else jnp.asarray(x)
    got, want = _both_jitted(js, ts, jx, tx)
    _close(got, want)
    _close(got, ts(tx))


def test_gradients_through_a_cpu_program_match_jax():
    """On the CPU the program runs the function eagerly, so autograd
    flows through it, as ``jax.grad`` flows through ``jax.jit``."""
    js, ts, x = _combinator_pair("seq")
    jg = jax.grad(lambda p: js.jitted()(p, jnp.asarray(x)).sum())(js.params)
    tp = {k: {"w": v["w"].clone().requires_grad_()}
          for k, v in ts.params.items()}
    ts.jitted()(tp, torch.from_numpy(x)).sum().backward()
    for k in tp:
        _close(tp[k]["w"].grad, jg[k]["w"])


# --------------------------------------------------------------------- #
# the deployed call and the profiled stages
# --------------------------------------------------------------------- #
def _quiet(pkg):
    return (JNet if pkg == "jax" else NetworkModel)(jitter_frac=0.0, seed=0)


def _routed_pipe_pair():
    """pre (8 -> 8) >> route(sel, [small, big]) (8 -> 4), both packages,
    with their stage lists."""
    (jp, tp) = _linear_pair("pre", 8, 8, 2)
    jr, tr = _route_pair()
    return (jp >> jr, [jp, jr]), (tp >> tr, [tp, tr])


@pytest.mark.parametrize("plan_kind", ["local", "remote", "split"])
def test_deployed_route_matches_jax(plan_kind):
    """A composition holding a route, deployed all local (one group: the
    program splits it around the route), all remote, and split after
    its first stage (the route alone on the cloud endpoint): both
    branches, twice each, equal JAX's deployed call and the undeployed
    service; the remote stages charge JAX's modelled network time."""
    deps = {}
    for pkg, ((svc, stages), mod) in zip(
            ("jax", "torch"), zip(_routed_pipe_pair(), (jdeploy, deploy))):
        plan = {"local": lambda: mod.DeploymentPlan.all_local(svc),
                "remote": lambda: mod.DeploymentPlan.all_remote(
                    svc, network=_quiet(pkg)),
                "split": lambda: mod.DeploymentPlan.split(
                    svc, 1, network=_quiet(pkg))}[plan_kind]()
        deps[pkg] = (svc, mod.deploy(svc, plan, stages=stages))
    (_, jdep), (tsvc, tdep) = deps["jax"], deps["torch"]
    for sign in (1.0, -1.0, 1.0, -1.0):
        x = sign * np.abs(_x((4, 8), 13))
        out, tel = tdep.call(torch.from_numpy(x))
        jout, jtel = jdep.call(jnp.asarray(x))
        _close(out, jout)
        _close(out, tsvc(torch.from_numpy(x)))
        assert [(s.stage, s.endpoint) for s in tel.stages] == \
            [(s.stage, s.endpoint) for s in jtel.stages]
        assert tel.transfer_total_s == jtel.transfer_total_s
        assert all(s.pool_bytes == 0 for s in tel.stages)   # no card


def test_profile_stages_matches_jax(clf_pair):
    (jc, jd), (tc, td) = clf_pair
    x = _x((2, 16, 64), 3)
    got = profile.profile_stages([tc, td], {"embeddings": torch.from_numpy(x)},
                                 iters=3)
    want = jprofile.profile_stages([jc, jd], {"embeddings": jnp.asarray(x)},
                                   iters=3)
    assert [(p.stage, p.output_bytes, p.n_params) for p in got] == \
        [(p.stage, p.output_bytes, p.n_params) for p in want]
    assert all(p.compile_ms >= 0 and p.compute_ms > 0 for p in got)


# --------------------------------------------------------------------- #
# the card path, with a stand-in graph
# --------------------------------------------------------------------- #
_CAPTURING = []
#: the tensor methods that read the device from the host
_HOST_READS = ("__int__", "__index__", "__bool__", "__float__", "item",
               "tolist")


def _host_read(*_):
    raise RuntimeError("operation not permitted when stream is capturing")


class _StandInGraph:
    """Replays by running the captured function again on the static
    buffers and writing its outputs into the captured ones, as a graph
    writes its own; counts its replays."""

    def __init__(self):
        self.replays, self.rerun, self.out = 0, None, None

    def replay(self):
        self.replays += 1
        with kernels.recorded_launches():       # a replay counts none
            fresh = self.rerun()
        for o, f in zip(tree_leaves(self.out), tree_leaves(fresh)):
            o.copy_(f)


class _StandIn(ServiceProgram):
    """A ``ServiceProgram`` that takes CPU tensors down the card path;
    the capture runs the function once with no recording, as a capture
    traces it, and raises on a host read, as a capture does; the route's
    index read is counted."""

    def __init__(self, service):
        super().__init__(service)
        self.reads = 0

    def _on_card(self, leaves):
        return True

    def _new_graph(self):
        return _StandInGraph()

    @contextlib.contextmanager
    def _recording(self, graph):
        """A host read raises inside it, as inside a capture."""
        saved = {k: torch.Tensor.__dict__.get(k) for k in _HOST_READS}
        for k in _HOST_READS:
            setattr(torch.Tensor, k, _host_read)
        _CAPTURING.append(1)
        try:
            yield
        finally:
            _CAPTURING.pop()
            for k, v in saved.items():
                if v is None:
                    delattr(torch.Tensor, k)
                else:
                    setattr(torch.Tensor, k, v)

    def _reserved(self):
        return 0

    def _capture(self, seg, params, x):
        graph, static, out, launches = super()._capture(seg, params, x)
        graph.rerun = lambda: seg.fn(params, static)
        graph.out = out
        return graph, static, out, launches

    def _read_index(self, idx):
        self.reads += 1
        return super()._read_index(idx)


def test_a_key_is_the_input_specs_and_the_params_storage():
    """The first call of a key captures, equal calls replay; a new
    batch size is one more capture, and so is a new params tree, whose
    output is the new weights'; the old key still replays."""
    _, ts = _linear_pair("a", 8, 4, 0)
    prog = _StandIn(ts)
    x4, x2 = torch.from_numpy(_x((4, 8), 1)), torch.from_numpy(_x((2, 8), 2))
    for _ in range(3):
        assert torch.equal(prog(ts.params, x4), x4 @ ts.params["w"])
    assert prog.cache_size() == 1
    prog(ts.params, x2)
    assert prog.cache_size() == 2
    other = {"w": ts.params["w"] * 2.0}
    for _ in range(2):
        assert torch.equal(prog(other, x4), x4 @ other["w"])
    assert prog.cache_size() == 3
    assert torch.equal(prog(ts.params, x4), x4 @ ts.params["w"])
    assert prog.cache_size() == 3
    (graph, *_), = [g for k, g in prog._plan[0].graphs.items()
                    if k[1][0][1][0] == (2, 8)]
    assert graph.replays == 0


def test_inputs_go_into_the_same_static_storage_and_outputs_are_clones():
    _, ts = _linear_pair("a", 8, 4, 0)
    prog = _StandIn(ts)
    seen, outs = [], []
    for seed in range(4):
        x = torch.from_numpy(_x((4, 8), seed))
        outs.append(prog(ts.params, x))
        (graph, static, out, _), = prog._plan[0].graphs.values()
        seen.append(static.data_ptr())
        assert torch.equal(static, x) and static.data_ptr() != x.data_ptr()
        assert torch.equal(outs[-1], x @ ts.params["w"])
        assert outs[-1].data_ptr() != out.data_ptr()
    assert len(set(seen)) == 1 and graph.replays == 3
    assert len({o.data_ptr() for o in outs}) == 4


@pytest.mark.parametrize("replays", [1, 3])
def test_replays_add_the_launches_their_capture_recorded(replays):
    def fn(p, x):
        kernels._WRAPPERS["rmsnorm"].launches += 2
        kernels._WRAPPERS["flash_attention"].launches += 1
        return x * 2

    svc = Service(name="twice", fn=fn, signature=Signature(
        TensorSpec((3,), "float32"), TensorSpec((3,), "float32")))
    kernels.reset_launch_counts()
    prog = _StandIn(svc)
    prog(None, torch.ones(3))                    # the warm-up counts
    assert kernels.launch_counts()["rmsnorm"] == 2
    (_, _, _, launches), = prog._plan[0].graphs.values()
    assert launches == {"rmsnorm": 2, "flash_attention": 1}
    for _ in range(replays):
        assert torch.equal(prog(None, torch.ones(3)), torch.full((3,), 2.))
    counts = kernels.launch_counts()
    assert counts["rmsnorm"] == 2 * (replays + 1)
    assert counts["flash_attention"] == replays + 1
    kernels.reset_launch_counts()


def test_a_route_runs_as_segments_with_one_host_read_a_call():
    """pre >> route(sel, [small, big]) >> post: the head (pre and the
    selector), the branch taken and post are three captures; the other
    branch is captured the first time it runs; every call reads the
    index once and equals JAX's call."""
    (jpre, tpre), (jpost, tpost) = _linear_pair("pre", 8, 8, 2), \
        _linear_pair("post", 4, 3, 3)
    jr, tr = _route_pair()
    tsvc, jsvc = tpre >> tr >> tpost, jpre >> jr >> jpost
    prog = _StandIn(tsvc)
    sizes = []
    for i, sign in enumerate((1.0, 1.0, -1.0, -1.0, 1.0)):
        x = sign * np.abs(_x((4, 8), 20 + i))
        _close(prog(tsvc.params, torch.from_numpy(x)),
               jsvc.jitted()(jsvc.params, jnp.asarray(x)))
        assert prog.reads == i + 1
        sizes.append(prog.cache_size())
    assert sizes == [3, 3, 4, 4, 4]
    head, = [s for s in prog._plan if hasattr(s, "head")]
    assert head.head.name == "pre+route_small_big.selector"
    assert len(prog._plan) == 2                  # the switch, then post


def test_a_route_the_program_cannot_split_raises_naming_it():
    _, tr = _route_pair()
    _, ta = _linear_pair("a", 8, 4, 5)
    par = compose.parallel({"r": tr, "a": ta}, name="par_with_route")
    x = {"r": torch.ones(4, 8), "a": torch.ones(4, 8)}
    par(x)                                       # eager: fine
    with pytest.raises(RuntimeError,
                       match="'par_with_route'.*reads the host.*capturing"):
        _StandIn(par)(par.params, x)


def test_a_failed_capture_sets_the_counters_back_and_raises():
    """A function that reads the host cannot be captured: the error names
    the service, the counters keep only the warm-up's launches, and
    nothing is cached."""
    def fn(p, x):
        kernels._WRAPPERS["rmsnorm"].launches += 1
        if _CAPTURING:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return x + 1

    svc = Service(name="reads_host", fn=fn, signature=Signature(
        TensorSpec((3,), "float32"), TensorSpec((3,), "float32")))
    kernels.reset_launch_counts()
    prog = _StandIn(svc)
    with pytest.raises(RuntimeError, match="'reads_host'.*capturing"):
        prog(None, torch.ones(3))
    assert kernels.launch_counts()["rmsnorm"] == 1
    assert prog.cache_size() == 0
    kernels.reset_launch_counts()


def test_a_call_on_the_card_under_grad_mode_raises():
    """A graph carries no autograd: with grad mode on and a param that
    requires grad, the card path raises naming the training item; under
    ``no_grad``, or with nothing requiring grad, it captures."""
    _, ts = _linear_pair("a", 8, 4, 0)
    p = {"w": ts.params["w"].clone().requires_grad_()}
    x = torch.ones(4, 8)
    prog = _StandIn(ts)
    with pytest.raises(RuntimeError, match="item 12"):
        prog(p, x)
    with pytest.raises(RuntimeError, match="item 12"):
        prog(ts.params, x.clone().requires_grad_())
    assert prog.cache_size() == 0
    with torch.no_grad():
        prog(p, x)
    prog(ts.params, x)
    assert prog.cache_size() == 2
