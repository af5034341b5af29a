"""The PyTorch port's Zoo compose layer against the JAX package.

One port counterpart for each case of ``tests/test_compose.py``,
``test_deploy_compose.py``, ``test_registry.py``, ``test_transport.py``
and ``test_serving.py::test_deployment_local_remote_same_result``. The
same weights (JAX's, carried across with ``repro_torch.bridge``) and the
same inputs (numpy, from a seed) go through both packages on the CPU:

* the reduced pixtral-12b classifier ``>> label_decoder``: class ids
  equal, confidences and logits within 1e-5, through every placement;
* ``model.lm`` logits within 1e-5;
* every combinator's outputs within 1e-5, signatures and composition
  errors (messages included) equal;
* modelled network times equal (the same seeded ``NetworkModel`` over
  the same payload bytes);
* a cross-package zoo: a service published by JAX is pulled by the port
  and the other way round, with equal ``tree_hash``;
* bf16 leaves round-trip in the port, and the port reads a JAX-written
  bf16 leaf with a matching hash.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.zoo_builders as jzb  # noqa: E402
import repro_torch.core.zoo_builders as tzb  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.core import compat as jcompat  # noqa: E402
from repro.core import compose as jcompose  # noqa: E402
from repro.core import deploy as jdeploy  # noqa: E402
from repro.core.netmodel import NetworkModel as JNet  # noqa: E402
from repro.core.netmodel import tree_nbytes as jnbytes  # noqa: E402
from repro.core.registry import Registry as JRegistry  # noqa: E402
from repro.core.service import Service as JService  # noqa: E402
from repro.core.service import Signature as JSig  # noqa: E402
from repro.core.service import TensorSpec as JSpec  # noqa: E402
from repro.core.service import service_from_fn as jservice  # noqa: E402
from repro.core.transport import RepoTransport as JRepoTransport  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro.training import checkpoints as jckpt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import compat, compose, deploy  # noqa: E402
from repro_torch.core.netmodel import NetworkModel, tree_nbytes  # noqa: E402
from repro_torch.core.registry import Registry, register_builder  # noqa: E402
from repro_torch.core.service import (Service, Signature, TensorSpec,  # noqa: E402
                                      service_from_fn)
from repro_torch.core.transport import (PeerTransport, RepoTransport,  # noqa: E402
                                        SyncedRegistry, TransportError)
from repro_torch.serving.faults import Faults  # noqa: E402
from repro_torch.training import checkpoints as ckpt  # noqa: E402

TOL = 1e-5


# --------------------------------------------------------------------- #
# helpers: the same service in both packages
# --------------------------------------------------------------------- #
def _linear_pair(name, d_in, d_out, key=0, batch=4):
    """A linear service in JAX (weights from ``PRNGKey(key)``, as the JAX
    tests make them) and its port twin on the same weights."""
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


def _port_params(jp, cfg):
    """The port's classifier params from JAX's: the backbone through the
    bridge (keys, shapes and dtypes checked), the head leaf for leaf."""
    npt = jax.tree.map(np.asarray, jp)
    return {"backbone": bridge.params_from_jax(npt["backbone"], cfg, "cpu"),
            "head": bridge.cache_from_jax(npt["head"], "cpu")}


@pytest.fixture(scope="module")
def clf_pair():
    """The reduced pixtral-12b classifier (10 classes) and label decoder
    in both packages, on JAX's seed-0 weights."""
    jc = jzb.classifier_service("pixtral-12b", n_classes=10)
    jc = jc.with_params(jc.metadata["init_params"](jax.random.PRNGKey(0)))
    tc = tzb.classifier_service("pixtral-12b", n_classes=10)
    tc = tc.with_params(_port_params(
        jc.params, get_arch("pixtral-12b", variant="reduced")))
    return (jc, jzb.label_decoder(10)), (tc, tzb.label_decoder(10))


def _emb(seed=0):
    return _x((2, 16, 64), seed)


# --------------------------------------------------------------------- #
# tests/test_compose.py counterparts
# --------------------------------------------------------------------- #
def test_seq_composes_and_matches_jax():
    (ja, ta), (jb, tb) = _linear_pair("a", 8, 16, 0), \
        _linear_pair("b", 16, 4, 1)
    x = _x((4, 8))
    out = (ta >> tb)(torch.from_numpy(x))
    _close(out, (ja >> jb)(jnp.asarray(x)))
    assert (ta >> tb).metadata["stages"] == ["a", "b"]
    assert (ta >> tb).signature.inputs == TensorSpec((4, 8), "float32")
    assert (ta >> tb).output_eval_shape(torch.from_numpy(x)) == \
        TensorSpec((4, 4), "float32") == (ta >> tb).signature.outputs


def test_seq_associativity():
    (ja, ta), (jb, tb), (jc, tc) = (_linear_pair("a", 4, 8, 0),
                                    _linear_pair("b", 8, 6, 1),
                                    _linear_pair("c", 6, 2, 2))
    x = torch.from_numpy(_x((3, 4)))
    left, right = ((ta >> tb) >> tc)(x), (ta >> (tb >> tc))(x)
    np.testing.assert_allclose(left.numpy(), right.numpy(), rtol=1e-5)
    _close(left, ((ja >> jb) >> jc)(jnp.asarray(x.numpy())))


def _error_cases(pkg):
    """Each composition error of the JAX tests, built in one package;
    returns the raised message (or the returned error list)."""
    if pkg == "jax":
        pair, cerr, spec, sig, svc, ens, conc, uni = (
            lambda *a: _linear_pair(*a)[0], jcompat.CompositionError, JSpec,
            JSig, JService, jcompose.ensemble, jcompat.check_concrete,
            jcompat.unify)
        zeros = jnp.zeros
    else:
        pair, cerr, spec, sig, svc, ens, conc, uni = (
            lambda *a: _linear_pair(*a)[1], compat.CompositionError,
            TensorSpec, Signature, Service, compose.ensemble,
            compat.check_concrete, compat.unify)
        zeros = torch.zeros

    def raised(fn):
        with pytest.raises(cerr) as ei:
            fn()
        return str(ei.value)

    int_only = svc(name="int_only", fn=lambda p, x: x,
                   signature=sig(spec((-1, 16), "int32"),
                                 spec((-1, 16), "int32")))
    return {
        "seq_shape": raised(lambda: pair("a", 8, 16) >> pair("c", 32, 4)),
        "seq_dtype": raised(lambda: pair("a", 8, 16) >> int_only),
        "ensemble_members": raised(lambda: ens([pair("a", 8, 4),
                                                pair("b", 8, 5)])),
        "check_concrete_path": raised(lambda: conc(
            {"tokens": spec((-1, 16), "int32")},
            {"tokens": zeros((2, 8), dtype=getattr(
                jnp if pkg == "jax" else torch, "int32"))}, where="svc")),
        "unify_missing": "; ".join(uni(
            {"a": spec((1,), "float32")},
            {"a": spec((1,), "float32"), "b": spec((1,), "float32")},
            where="x")),
    }


@pytest.mark.parametrize("case", ["seq_shape", "seq_dtype",
                                  "ensemble_members", "check_concrete_path",
                                  "unify_missing"])
def test_composition_errors_match_jax(case):
    """Each rejected composition raises (or reports) in both packages,
    with the same message."""
    got, want = _error_cases("torch")[case], _error_cases("jax")[case]
    assert got == want and got
    if case == "seq_shape":
        assert "16" in got and "32" in got
    if case == "check_concrete_path":
        assert "tokens" in got
    if case == "unify_missing":
        assert "missing" in got


def test_cast_adapter_repairs_a_dtype_mismatch():
    (ja, ta) = _linear_pair("a", 8, 16)
    tint = Service(name="int_only", fn=lambda p, x: x,
                   signature=Signature(TensorSpec((-1, 16), "int32"),
                                       TensorSpec((-1, 16), "int32")))
    jint = JService(name="int_only", fn=lambda p, x: x,
                    signature=JSig(JSpec((-1, 16), "int32"),
                                   JSpec((-1, 16), "int32")))
    fixed = ta >> compose.cast_adapter(ta.signature.outputs, "int32") >> tint
    jfixed = ja >> jcompose.cast_adapter(ja.signature.outputs, "int32") \
        >> jint
    x = _x((4, 8)) * 30
    got = fixed(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jfixed(jnp.asarray(x))))
    assert compose.cast_adapter(ta.signature.outputs, torch.int32).name \
        == "cast_int32"


def test_wildcard_batch_dims_match():
    spec1 = TensorSpec((-1, 16), "float32")
    spec2 = TensorSpec((4, 16), "float32")
    assert spec1.matches(spec2) and spec2.matches(spec1)
    assert not TensorSpec((3, 16), "float32").matches(spec2)
    assert not TensorSpec((4, 16), "bfloat16").matches(spec2)
    assert TensorSpec.of(torch.zeros(2, 3, dtype=torch.bfloat16)) == \
        TensorSpec((2, 3), "bfloat16")


def test_parallel_combinator_matches_jax():
    (ja, ta), (jb, tb) = _linear_pair("a", 8, 4, 0), \
        _linear_pair("b", 6, 2, 1)
    xs = {"l": _x((4, 8), 1), "r": _x((4, 6), 2)}
    got = compose.parallel({"l": ta, "r": tb})(
        {k: torch.from_numpy(v) for k, v in xs.items()})
    want = jcompose.parallel({"l": ja, "r": jb})(
        {k: jnp.asarray(v) for k, v in xs.items()})
    _close(got, want)


@pytest.mark.parametrize("combine", ["mean", "sum", "stack"])
def test_ensemble_matches_jax(combine):
    pairs = [_linear_pair(f"m{i}", 8, 4, i) for i in range(3)]
    x = _x((2, 8), 3)
    te = compose.ensemble([t for _, t in pairs], combine=combine)
    je = jcompose.ensemble([j for j, _ in pairs], combine=combine)
    _close(te(torch.from_numpy(x)), je(jnp.asarray(x)))
    assert te.signature.outputs == TensorSpec(je.signature.outputs.shape,
                                              "float32")


def _route_pair():
    (js, ts), (jb, tb) = _linear_pair("small", 8, 4, 0), \
        _linear_pair("big", 8, 4, 1)
    tsel = Service(name="sel",
                   fn=lambda p, x: (x.mean() > 0).to(torch.int32),
                   signature=Signature(ts.signature.inputs,
                                       TensorSpec((), "int32")))
    jsel = JService(name="sel",
                    fn=lambda p, x: (jnp.mean(x) > 0).astype(jnp.int32),
                    signature=JSig(js.signature.inputs, JSpec((), "int32")))
    return jcompose.route(jsel, [js, jb]), compose.route(tsel, [ts, tb])


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_route_takes_the_branch_jax_takes(sign):
    jr, tr = _route_pair()
    x = sign * np.abs(_x((4, 8), 4))
    _close(tr(torch.from_numpy(x)), jr(jnp.asarray(x)))


def test_route_clamps_its_index_as_lax_switch_does():
    (js, ts), (jb, tb) = _linear_pair("s", 8, 4, 0), \
        _linear_pair("b", 8, 4, 1)
    for idx in (-3, 7):
        tsel = Service(name="sel", fn=lambda p, x, i=idx: torch.tensor(i),
                       signature=Signature(ts.signature.inputs,
                                           TensorSpec((), "int32")))
        jsel = JService(name="sel",
                        fn=lambda p, x, i=idx: jnp.asarray(i, jnp.int32),
                        signature=JSig(js.signature.inputs,
                                       JSpec((), "int32")))
        x = _x((4, 8), 5)
        _close(compose.route(tsel, [ts, tb])(torch.from_numpy(x)),
               jcompose.route(jsel, [js, jb])(jnp.asarray(x)))


def test_map_batch_matches_vmap():
    per_t = service_from_fn("norm", lambda p, x: x / torch.linalg.norm(x),
                            torch.ones(8))
    per_j = jservice("norm", lambda p, x: x / jnp.linalg.norm(x),
                     jax.ShapeDtypeStruct((8,), jnp.float32))
    x = _x((5, 8), 6)
    lifted = compose.map_batch(per_t)
    _close(lifted(torch.from_numpy(x)),
           jcompose.map_batch(per_j)(jnp.asarray(x)))
    assert lifted.signature.inputs.shape == (-1, 8)


@pytest.mark.parametrize("decoder", ["label", "top3", "select"])
def test_decoders_and_select_adapter_match_jax(decoder):
    logits = _x((4, 10), 7) * 3
    if decoder == "label":
        t, j = tzb.label_decoder(10), jzb.label_decoder(10)
    elif decoder == "top3":
        t, j = tzb.topk_decoder(10, k=3), jzb.topk_decoder(10, k=3)
    else:
        spec = {"a": TensorSpec((4, 10), "float32"),
                "b": TensorSpec((4, 10), "float32")}
        jspec = {k: JSpec(v.shape, v.dtype) for k, v in spec.items()}
        t = compose.select_adapter(spec, "b")
        j = jcompose.select_adapter(jspec, "b")
        got = t({"a": torch.zeros(4, 10), "b": torch.from_numpy(logits)})
        _close(got, j({"a": jnp.zeros((4, 10)), "b": jnp.asarray(logits)}))
        assert t.signature.outputs == spec["b"]
        return
    got, want = t(torch.from_numpy(logits)), j(jnp.asarray(logits))
    for k in got:
        if got[k].dtype == torch.int32:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        else:
            _close(got[k], want[k])


# --------------------------------------------------------------------- #
# tests/test_deploy_compose.py counterparts
# --------------------------------------------------------------------- #
def _quiet(pkg):
    return (JNet if pkg == "jax" else NetworkModel)(jitter_frac=0.0, seed=0)


def _ens_pair(d_in=8, d_out=4, n=3):
    pairs = [_linear_pair(f"m{i}", d_in, d_out, i) for i in range(n)]
    return (jcompose.ensemble([j for j, _ in pairs], combine="mean"),
            compose.ensemble([t for _, t in pairs], combine="mean"))


@pytest.mark.parametrize("plan_kind", ["local", "remote"])
@pytest.mark.parametrize("combinator", ["ensemble", "route"])
def test_deployed_combinator_matches_jax(combinator, plan_kind):
    """A non-seq combinator deploys as one stage: the same outputs as
    undeployed and as JAX's, per-stage telemetry on the endpoint it ran
    on, and (remote) the same modelled network time as JAX's."""
    if combinator == "ensemble":
        js, ts = _ens_pair()
        xs = [_x((4, 8), 8)]
    else:
        js, ts = _route_pair()
        xs = [np.abs(_x((4, 8), 9)), -np.abs(_x((4, 8), 9))]
    plans = {}
    for pkg, s, mod in (("jax", js, jdeploy), ("torch", ts, deploy)):
        plans[pkg] = mod.deploy(s, mod.DeploymentPlan.all_local(s)) \
            if plan_kind == "local" else mod.deploy(
                s, mod.DeploymentPlan.all_remote(s, network=_quiet(pkg)))
    for x in xs:
        out, tel = plans["torch"].call(torch.from_numpy(x))
        jout, jtel = plans["jax"].call(jnp.asarray(x))
        _close(out, jout)
        _close(out, ts(torch.from_numpy(x)))
        assert len(tel.stages) == 1 and tel.total_s > 0
        st = tel.stages[0]
        assert st.endpoint == ("local" if plan_kind == "local" else "cloud")
        assert st.param_bytes == tree_nbytes(ts.params) \
            == jnbytes(js.params)
        if plan_kind == "remote":
            assert st.compute_s == 0.0
            assert st.transfer_s == jtel.stages[0].transfer_s > 0
        else:
            assert st.compute_s > 0 and st.transfer_s == 0.0


def test_deployed_seq_split_per_stage_telemetry():
    (ja, ta), (jb, tb) = _linear_pair("a", 8, 16, 0), \
        _linear_pair("b", 16, 4, 1)
    x = _x((4, 8), 10)
    tpipe, jpipe = ta >> tb, ja >> jb
    out, tel = deploy.deploy(tpipe, deploy.DeploymentPlan.split(
        tpipe, split_at=1, network=_quiet("torch")),
        stages=[ta, tb]).call(torch.from_numpy(x))
    jout, jtel = jdeploy.deploy(jpipe, jdeploy.DeploymentPlan.split(
        jpipe, split_at=1, network=_quiet("jax")),
        stages=[ja, jb]).call(jnp.asarray(x))
    _close(out, jout)
    assert [(s.stage, s.endpoint) for s in tel.stages] == \
        [("a", "local"), ("b", "cloud")]
    assert tel.transfer_total_s == jtel.transfer_total_s > 0


@pytest.mark.parametrize("bits", ["int4", "int8"])
def test_edge_split_quantizes_the_edge_stage_like_jax(bits):
    """The edge stage holds quantized params (the port's QTensors are
    bit-equal to JAX's), its output matches JAX's quantized one, and the
    remote stage stays full precision."""
    (ja, ta), (jb, tb) = _linear_pair("a", 64, 64, 0), \
        _linear_pair("b", 64, 8, 1)
    x = _x((4, 64), 11)
    tpipe, jpipe = ta >> tb, ja >> jb
    out, tel = deploy.deploy(tpipe, deploy.DeploymentPlan.edge_split(
        tpipe, split_at=1, quantize=bits, network=_quiet("torch")),
        stages=[ta, tb]).call(torch.from_numpy(x))
    jout, jtel = jdeploy.deploy(jpipe, jdeploy.DeploymentPlan.edge_split(
        jpipe, split_at=1, quantize=bits, network=_quiet("jax")),
        stages=[ja, jb]).call(jnp.asarray(x))
    _close(out, jout)
    assert [(s.stage, s.endpoint, s.precision) for s in tel.stages] == \
        [("a", "edge", bits), ("b", "cloud", "fp")]
    assert [s.param_bytes for s in tel.stages] == \
        [s.param_bytes for s in jtel.stages]
    assert tel.stages[0].param_bytes < tree_nbytes(ta.params) / 3
    rel = np.max(np.abs(out.numpy() - tpipe(torch.from_numpy(x)).numpy()))
    assert rel / np.max(np.abs(out.numpy())) < 0.25


@pytest.mark.parametrize("bits", ["int4", "int8"])
def test_quantized_endpoint_on_a_non_seq_combinator(bits):
    js, ts = _ens_pair(64, 16, 2)
    x = np.ones((4, 64), np.float32)
    if bits == "int4":
        tplan = deploy.DeploymentPlan.edge_split(
            ts, split_at=1, quantize="int4", network=_quiet("torch"))
        jplan = jdeploy.DeploymentPlan.edge_split(
            js, split_at=1, quantize="int4", network=_quiet("jax"))
    else:
        tplan = deploy.DeploymentPlan(
            endpoints={"edge": deploy.Endpoint("edge", quantize="int8")},
            assignments={ts.name: "edge"})
        jplan = jdeploy.DeploymentPlan(
            endpoints={"edge": jdeploy.Endpoint("edge", quantize="int8")},
            assignments={js.name: "edge"})
    out, tel = deploy.deploy(ts, tplan).call(torch.from_numpy(x))
    jout, _ = jdeploy.deploy(js, jplan).call(jnp.asarray(x))
    _close(out, jout)
    assert tel.stages[0].endpoint == "edge"
    assert tel.stages[0].precision == bits
    assert tel.stages[0].param_bytes < tree_nbytes(ts.params) / 3 \
        or bits == "int8"


@pytest.mark.parametrize("fault", ["missing_endpoint", "mesh"])
def test_deploy_plan_errors(fault):
    _, ta = _linear_pair("a", 8, 4, 0)
    if fault == "missing_endpoint":     # a typo'd endpoint, as in JAX
        plan = deploy.DeploymentPlan(
            endpoints={"cloud": deploy.Endpoint(
                "cloud", kind="remote", network=_quiet("torch")),
                "edge": deploy.Endpoint("edge")},
            assignments={"a": "cloudd"})
        with pytest.raises(KeyError):
            deploy.deploy(ta, plan)
    else:       # a mesh endpoint: local without a mesh, as JAX's; the
        # group under a one-rank gloo mesh gives the same result, and
        # so does an int8 mesh endpoint as an int8 local one
        import tempfile

        import torch.distributed as dist
        from repro_torch.launch.mesh import make_serving_mesh
        js, _ = _linear_pair("a", 8, 4, 0)
        x = _x((4, 8))
        jout, _ = jdeploy.deploy(js, jdeploy.DeploymentPlan(
            endpoints={"pod": jdeploy.Endpoint("pod", kind="mesh")},
            assignments={"a": "pod"})).call(jnp.asarray(x))
        local, _ = deploy.deploy(ta).call(torch.from_numpy(x))
        with tempfile.TemporaryDirectory() as tmp:
            dist.init_process_group("gloo", init_method=f"file://{tmp}/s",
                                    rank=0, world_size=1)
            try:
                for mesh in (None, make_serving_mesh("auto")):
                    plan = deploy.DeploymentPlan(
                        endpoints={"pod": deploy.Endpoint(
                            "pod", kind="mesh", mesh=mesh)},
                        assignments={"a": "pod"})
                    out, tel = deploy.deploy(ta, plan).call(
                        torch.from_numpy(x))
                    assert tel.stages[0].endpoint == "pod"
                    assert torch.equal(out, local)
                    _close(out, jout)
                q8 = [deploy.deploy(ta, deploy.DeploymentPlan(
                    endpoints={"pod": deploy.Endpoint(
                        "pod", kind=kind, mesh=mesh, quantize="int8")},
                    assignments={"a": "pod"})).call(torch.from_numpy(x))[0]
                    for kind, mesh in (("local", None),
                                       ("mesh", make_serving_mesh("auto")))]
                assert torch.equal(q8[1], q8[0])
            finally:
                dist.destroy_process_group()


# --------------------------------------------------------------------- #
# the paper's deployment example (test_serving.py counterpart)
# --------------------------------------------------------------------- #
def test_deployment_local_remote_same_result(clf_pair):
    (jc, jd), (tc, td) = clf_pair
    x = _emb()
    jsvc, tsvc = jc >> jd, tc >> td
    want = jsvc({"embeddings": jnp.asarray(x)})
    outs = []
    for plan in [deploy.DeploymentPlan.all_local(tsvc),
                 deploy.DeploymentPlan.all_remote(tsvc, NetworkModel(seed=1)),
                 deploy.DeploymentPlan.split(tsvc, 1, NetworkModel(seed=2))]:
        y, tel = deploy.deploy(tsvc, plan, stages=[tc, td]).call(
            {"embeddings": torch.from_numpy(x)})
        outs.append(y)
        assert tel.total_s > 0
        np.testing.assert_array_equal(y["class_id"].numpy(),
                                      np.asarray(want["class_id"]))
        _close(y["confidence"], want["confidence"])
    for y in outs[1:]:
        assert torch.equal(y["class_id"], outs[0]["class_id"])
        assert torch.equal(y["confidence"], outs[0]["confidence"])


def test_classifier_logits_match_jax(clf_pair):
    (jc, _), (tc, _) = clf_pair
    x = _emb(1)
    _close(tc({"embeddings": torch.from_numpy(x)}),
           jc({"embeddings": jnp.asarray(x)}))
    assert tc.n_params == sum(int(np.prod(a.shape))
                              for a in jax.tree.leaves(jc.params))
    assert tc.signature == Signature(
        {"embeddings": TensorSpec((-1, 16, 64), "float32")},
        TensorSpec((-1, 10), "float32"))


def test_lm_service_logits_match_jax():
    cfg = get_arch("llama3.2-1b", variant="reduced")
    jlm = jzb.lm_service("llama3.2-1b", variant="reduced")
    tlm = tzb.lm_service("llama3.2-1b", variant="reduced")
    jp = jax_build(jax_get_arch("llama3.2-1b", variant="reduced")).init(
        jax.random.PRNGKey(0))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = np.random.default_rng(12).integers(0, cfg.vocab, (2, 24)).astype(
        np.int32)
    _close(tlm({"tokens": torch.from_numpy(toks)}, params=tp),
           jlm({"tokens": jnp.asarray(toks)}, params=jp))
    assert tlm.signature.outputs == TensorSpec((-1, -1, cfg.vocab),
                                               "float32")


# --------------------------------------------------------------------- #
# tests/test_registry.py counterparts
# --------------------------------------------------------------------- #
def _publish_port(reg, tc, td, composed=True):
    reg.publish(tc, builder="model.classifier",
                config={"arch": "pixtral-12b", "n_classes": 10})
    reg.publish(td, builder="adapter.label_decoder",
                config={"n_classes": 10})
    if composed:
        reg.publish_composed(tc >> td, [tc, td])


def test_publish_pull_roundtrip(tmp_path, clf_pair):
    _, (tc, td) = clf_pair
    reg = Registry(tmp_path, device="cpu")
    _publish_port(reg, tc, td, composed=False)
    svc = reg.pull(tc.name)
    x = {"embeddings": torch.from_numpy(_emb(2))}
    assert torch.equal(tc(x), svc(x))
    assert ckpt.tree_hash(svc.params) == ckpt.tree_hash(tc.params)


@pytest.mark.parametrize("tamper", ["params", "signature"])
def test_pull_detects_tampering(tmp_path, clf_pair, tamper):
    _, (tc, td) = clf_pair
    reg = Registry(tmp_path, device="cpu")
    _publish_port(reg, tc, td, composed=False)
    pdir = tmp_path / tc.name / tc.version
    if tamper == "params":
        data = dict(np.load(pdir / "params.npz"))
        key0 = sorted(data)[0]
        data[key0] = data[key0] + 1.0
        np.savez(pdir / "params.npz", **data)
        with pytest.raises(IOError):
            reg.pull(tc.name)
    else:
        m = json.loads((pdir / "manifest.json").read_text())
        m["config"]["n_classes"] = 12     # drifted config
        (pdir / "manifest.json").write_text(json.dumps(m))
        with pytest.raises((compat.CompositionError, IOError)):
            reg.pull(tc.name)


def test_composed_by_reference_dedups_weights(tmp_path, clf_pair):
    _, (tc, td) = clf_pair
    reg = Registry(tmp_path, device="cpu")
    _publish_port(reg, tc, td)
    svc = tc >> td
    assert not (tmp_path / svc.name / svc.version / "params.npz").exists()
    pulled = reg.pull(svc.name)
    x = {"embeddings": torch.from_numpy(_emb(3))}
    a, b = svc(x), pulled(x)
    assert torch.equal(a["confidence"], b["confidence"])


def test_publish_composed_requires_stages_published(tmp_path, clf_pair):
    _, (tc, td) = clf_pair
    with pytest.raises(FileNotFoundError):
        Registry(tmp_path).publish_composed(tc >> td, [tc, td])


def test_versioning_and_list(tmp_path):
    reg = Registry(tmp_path, device="cpu")
    s1 = service_from_fn("s", lambda p, x: x * 2, torch.zeros(2))
    register_builder("test.double")(
        lambda: service_from_fn("s", lambda p, x: x * 2, torch.zeros(2)))
    reg.publish(s1, builder="test.double", config={})
    import dataclasses
    reg.publish(dataclasses.replace(s1, version="0.2.0"),
                builder="test.double", config={})
    assert reg.versions("s") == ["0.1.0", "0.2.0"]
    assert reg.pull("s").version == "0.2.0"
    assert len(reg.list()) == 2


# --------------------------------------------------------------------- #
# the cross-package zoo and the pytree file format
# --------------------------------------------------------------------- #
def test_jax_publishes_the_port_pulls(tmp_path, clf_pair):
    (jc, jd), _ = clf_pair
    jreg = JRegistry(tmp_path)
    jm = jreg.publish(jc, builder="model.classifier",
                      config={"arch": "pixtral-12b", "n_classes": 10})
    jreg.publish(jd, builder="adapter.label_decoder",
                 config={"n_classes": 10})
    jreg.publish_composed(jc >> jd, [jc, jd])
    pulled = Registry(tmp_path, device="cpu").pull((jc >> jd).name)
    assert ckpt.tree_hash(pulled.params["stage0"]) == jm["params_hash"] \
        == jckpt.tree_hash(jc.params)
    x = _emb(4)
    got = pulled({"embeddings": torch.from_numpy(x)})
    want = (jc >> jd)({"embeddings": jnp.asarray(x)})
    np.testing.assert_array_equal(got["class_id"].numpy(),
                                  np.asarray(want["class_id"]))
    _close(got["confidence"], want["confidence"])


def test_port_publishes_jax_pulls(tmp_path, clf_pair):
    (jc, jd), (tc, td) = clf_pair
    reg = Registry(tmp_path, device="cpu")
    _publish_port(reg, tc, td)
    m = json.loads((tmp_path / tc.name / tc.version
                    / "manifest.json").read_text())
    pulled = JRegistry(tmp_path).pull((tc >> td).name)   # JAX verifies
    assert m["params_hash"] == ckpt.tree_hash(tc.params) \
        == jckpt.tree_hash(pulled.params["stage0"])
    x = _emb(5)
    got = pulled({"embeddings": jnp.asarray(x)})
    want = (tc >> td)({"embeddings": torch.from_numpy(x)})
    np.testing.assert_array_equal(np.asarray(got["class_id"]),
                                  want["class_id"].numpy())
    _close(want["confidence"], got["confidence"])


def _bf16_tree():
    g = torch.Generator().manual_seed(0)
    return {"a": {"w": torch.randn(3, 5, generator=g).to(torch.bfloat16)},
            "b": torch.arange(4, dtype=torch.int32),
            "c": torch.randn(2, generator=g)}


def test_bf16_leaves_roundtrip_in_the_port(tmp_path):
    tree = _bf16_tree()
    digest = ckpt.save_pytree(tmp_path / "p", tree)
    man = json.loads((tmp_path / "p.json").read_text())
    assert man["leaves"]["a/w"] == {"shape": [3, 5], "dtype": "bfloat16"}
    back = ckpt.load_pytree(tmp_path / "p", device="cpu")
    assert back["a"]["w"].dtype == torch.bfloat16
    assert torch.equal(back["a"]["w"], tree["a"]["w"])
    assert torch.equal(back["b"], tree["b"]) and back["b"].dtype == \
        torch.int32
    assert ckpt.tree_hash(back) == digest == ckpt.tree_hash(tree)


def test_port_reads_a_jax_written_bf16_leaf(tmp_path):
    """JAX writes its bfloat16 leaves as ``|V2``; the port reads them as
    bfloat16, with the hash JAX computed for the tree in memory."""
    rng = np.random.default_rng(13)
    jtree = {"w": jnp.asarray(rng.normal(size=(4, 6)), jnp.bfloat16),
             "s": jnp.asarray(rng.normal(size=(6,)), jnp.float32)}
    digest = jckpt.save_pytree(tmp_path / "j", jtree)
    back = ckpt.load_pytree(tmp_path / "j", device="cpu")
    assert back["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["w"].float().numpy(),
                                  np.asarray(jtree["w"], np.float32))
    assert ckpt.tree_hash(back) == digest == jckpt.tree_hash(jtree)


def test_truncated_payload_fails_fast(tmp_path):
    from repro_torch.serving.faults import truncate_file
    ckpt.save_pytree(tmp_path / "p", _bf16_tree())
    truncate_file(tmp_path / "p.npz", 0.5)
    with pytest.raises(ckpt.CheckpointError, match="unreadable"):
        ckpt.load_pytree(tmp_path / "p", device="cpu")


# --------------------------------------------------------------------- #
# tests/test_transport.py counterparts
# --------------------------------------------------------------------- #
@pytest.fixture
def remote(tmp_path, clf_pair):
    """A remote repository populated by the port."""
    _, (tc, td) = clf_pair
    root = tmp_path / "remote"
    _publish_port(Registry(root, device="cpu"), tc, td)
    return root, (tc >> td).name


def test_pull_through_transport_charges_bytes(remote, tmp_path):
    root, _ = remote
    sreg = SyncedRegistry(tmp_path / "cache", [RepoTransport(root)],
                          device="cpu")
    _, report = sreg.pull("classify_pixtral-12b")
    assert report is not None and report.nbytes > 0
    assert report.seconds > 0 and report.source == "repo"
    _, report2 = sreg.pull("classify_pixtral-12b")
    assert report2 is None or report2.cached


def test_peer_preferred_over_repo(remote, tmp_path):
    root, _ = remote
    peer, repo = PeerTransport(root), RepoTransport(root)
    sreg = SyncedRegistry(tmp_path / "cache", [peer, repo], device="cpu")
    _, report = sreg.pull("label_decoder")
    assert report.source == "peer"
    assert peer.network.transfer_s(10_000_000) \
        < repo.network.transfer_s(10_000_000)


def test_composed_pull_fetches_stage_deps(remote, tmp_path, clf_pair):
    root, comp_name = remote
    sreg = SyncedRegistry(tmp_path / "cache", [RepoTransport(root)],
                          device="cpu")
    svc, _ = sreg.pull(comp_name)
    assert (tmp_path / "cache" / "classify_pixtral-12b").exists()
    assert (tmp_path / "cache" / "label_decoder").exists()
    (jc, jd), _ = clf_pair
    x = _emb(6)
    out = svc({"embeddings": torch.from_numpy(x)})
    np.testing.assert_array_equal(
        out["class_id"].numpy(),
        np.asarray((jc >> jd)({"embeddings": jnp.asarray(x)})["class_id"]))


def test_push_to_remote(remote, tmp_path):
    root, _ = remote
    other = tmp_path / "other_remote"
    sreg = SyncedRegistry(tmp_path / "cache", [RepoTransport(root)],
                          device="cpu")
    sreg.pull("label_decoder")
    report = RepoTransport(other).push("label_decoder", "0.1.0",
                                       tmp_path / "cache")
    assert (other / "label_decoder/0.1.0/manifest.json").exists()
    assert report.nbytes > 0


@pytest.mark.parametrize("case", ["drops_retried", "push_drop_retried",
                                  "latency_timeout"])
def test_transport_faults_are_retried(remote, tmp_path, case):
    root, _ = remote
    if case == "drops_retried":
        f = Faults(seed=0).on("transport_drop", op="fetch", times=2)
        t = RepoTransport(root, backoff_s=0.001, faults=f)
        report = t.fetch("label_decoder", "0.1.0", tmp_path / "cache")
        assert report.retries == 2 and report.nbytes > 0
    elif case == "push_drop_retried":
        RepoTransport(root).fetch("label_decoder", "0.1.0",
                                  tmp_path / "cache")
        f = Faults(seed=0).on("transport_drop", op="push", times=1)
        t = RepoTransport(tmp_path / "other", backoff_s=0.001, faults=f)
        report = t.push("label_decoder", "0.1.0", tmp_path / "cache")
        assert report.retries == 1
        assert (tmp_path / "other/label_decoder/0.1.0/manifest.json"
                ).exists()
    else:
        f = Faults(seed=0).on("transport_latency", op="fetch",
                              delay_s=0.2, times=1)
        t = RepoTransport(root, timeout_s=0.05, backoff_s=0.001, faults=f)
        report = t.fetch("label_decoder", "0.1.0", tmp_path / "cache")
        assert report.retries == 1


def test_fetch_exhausts_retries_and_leaves_no_partial(remote, tmp_path):
    root, _ = remote
    f = Faults(seed=0).on("transport_drop", op="fetch", times=-1)
    t = RepoTransport(root, backoff_s=0.001, max_retries=2, faults=f)
    with pytest.raises(TransportError, match="after 3 attempts"):
        t.fetch("label_decoder", "0.1.0", tmp_path / "cache")
    assert not (tmp_path / "cache/label_decoder/0.1.0").exists()
    report = RepoTransport(root).fetch("label_decoder", "0.1.0",
                                       tmp_path / "cache")
    assert not report.cached and report.retries == 0


def test_backoff_and_network_model_match_jax():
    """Seeded jitter replays, and equals the JAX package's draw for draw
    (both are numpy generators from the same seed)."""
    t1 = RepoTransport("/nonexistent", backoff_s=0.01, jitter_seed=3)
    t2 = RepoTransport("/nonexistent", backoff_s=0.01, jitter_seed=3)
    tj = JRepoTransport("/nonexistent", backoff_s=0.01, jitter_seed=3)
    seq1 = [t1._backoff(k) for k in range(4)]
    assert seq1 == [t2._backoff(k) for k in range(4)] \
        == [tj._backoff(k) for k in range(4)]
    for k, d in enumerate(seq1):
        assert 0.5 * 0.01 * 2 ** k <= d <= 0.01 * 2 ** k
    net, jnet = NetworkModel(seed=4), JNet(seed=4)
    assert [net.request_s(1000, 10, q) for q in range(3)] == \
        [jnet.request_s(1000, 10, q) for q in range(3)]


# --------------------------------------------------------------------- #
# the CLI (test_transport.py::test_cli_roundtrip counterpart)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cli_roundtrip(tmp_path, writer):
    """init-demo (by the port's CLI, or by the JAX package's) -> pull ->
    compose -> deploy local, split and remote, all with ``--device cpu``:
    the demo batch's class ids agree across placements."""
    from repro_torch.launch.zoo_cli import main
    peer, zoo = str(tmp_path / "peer"), str(tmp_path / "zoo")
    if writer == "port":
        main(["--zoo", peer, "--device", "cpu", "init-demo",
              "--n-classes", "10"])
    else:
        from repro.launch.zoo_cli import main as jax_main
        jax_main(["--zoo", peer, "init-demo", "--n-classes", "10"])
    main(["--zoo", zoo, "--peer", peer, "--device", "cpu", "pull",
          "--name", "classify_pixtral-12b"])
    main(["--zoo", zoo, "--peer", peer, "--device", "cpu", "compose",
          "--stages", "classify_pixtral-12b,label_decoder",
          "--name", "pipe"])
    outs = [main(["--zoo", zoo, "--device", "cpu", "deploy", "--name",
                  "pipe", "--placement", p, "--batch", "2"])
            for p in ("local", "split:1", "remote")]
    for out in outs:
        assert out["class_id"].shape == (2,)
        assert torch.equal(out["class_id"], outs[0]["class_id"])
