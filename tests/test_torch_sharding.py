"""The port's sharding rules and serving mesh against the JAX package's.

* ``param_shardings`` / ``spec_for_path`` for every leaf of every
  architecture's params, of its int8 and int4 quantized params, and
  ``cache_shardings`` for every leaf of its cache (and a paged cache),
  equal JAX's as tuples: reduced configs on 2 x 4 and 1 x 8 axis sizes,
  full configs on 16 x 16;
* ``local_shape`` and ``shard`` cut every leaf into blocks that cover it
  exactly as many times as the axes it is replicated over;
* ``make_serving_mesh``'s spec parsing and errors, and a one-rank gloo
  mesh's collectives;
* ``moe_block_shard_map`` on one rank against JAX's on a (1, 1) mesh and
  against the port's ``moe_block`` (rtol = atol = 2e-4, aux 1e-5, as
  ``tests/test_moe_shard_map.py``).
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.distribution import sharding as jax_sharding  # noqa: E402
from repro.launch import mesh as jax_mesh  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro.models.moe import init_moe, moe_block as jax_moe_block  # noqa: E402
from repro.models.moe_shard_map import \
    moe_block_shard_map as jax_moe_shard_map  # noqa: E402
from repro.quant import quantize_for_cfg  # noqa: E402
from repro_torch.configs import ARCHS, EXTRA_ARCHS, get_arch  # noqa: E402
from repro_torch.distribution import sharding  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models.model import build, param_shapes  # noqa: E402
from repro_torch.models.moe import moe_block  # noqa: E402
from repro_torch.models.moe_shard_map import moe_block_shard_map  # noqa: E402
from repro_torch.quant.params import quantized_shapes  # noqa: E402

ALL = sorted(ARCHS) + sorted(EXTRA_ARCHS)
REDUCED_SIZES = [(2, 4), (1, 8)]
FULL_SIZES = (16, 16)


def _sizes(shape):
    return {"data": shape[0], "model": shape[1]}


def _mesh(shape):
    return mesh_mod.Mesh(shape)


def _is_spec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


def _jax_specs(tree, shape, kind="params"):
    """JAX's specs leaf by leaf ('/'-joined path -> tuple) on a stand-in
    mesh of ``shape`` whose NamedSharding is the spec itself."""
    fake = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty(shape))
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_sharding, "NamedSharding", lambda mesh, spec: spec)
    try:
        specs = jax_sharding.cache_shardings(tree, fake) if kind == "cache" \
            else jax_sharding.param_shardings(tree, fake)
    finally:
        mp.undo()
    return {jax_sharding._path_str(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(specs, is_leaf=_is_spec)[0]}


def _jax_shapes(tree):
    return {jax_sharding._path_str(p): tuple(a.shape) for p, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield "/".join(path), tree


def _port_shapes(tree):
    """A tree of shapes, of QTensor (shape, dtype) pairs or of tensors ->
    {path: shape}."""
    out = {}
    for name, leaf in _flat(tree):
        if hasattr(leaf, "shape"):
            leaf = tuple(leaf.shape)
        elif len(leaf) == 2 and isinstance(leaf[1], torch.dtype):
            leaf = tuple(leaf[0])
        out[name] = tuple(leaf)
    return out


def _unflatten(flat):
    tree = {}
    for name, v in flat.items():
        node = tree
        *head, last = name.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _cfgs(arch, reduced):
    v = "reduced" if reduced else ""
    return jax_get_arch(arch, variant=v), get_arch(arch, variant=v)


@pytest.mark.parametrize("quant", ["", "int8", "int4"])
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ALL)
def test_param_specs_equal_jax(arch, reduced, quant):
    jc, tc = _cfgs(arch, reduced)
    jm = jax_build(jc)
    jshapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    if quant:
        jshapes = jax.eval_shape(
            lambda p: quantize_for_cfg(p, jc.replace(quant=quant)), jshapes)
        tc = tc.replace(quant=quant)
    port = _port_shapes(quantized_shapes(param_shapes(tc), tc))
    assert port == _jax_shapes(jshapes)
    tree = _unflatten(port)
    rules = sharding.default_param_rules()
    for shape in REDUCED_SIZES if reduced else [FULL_SIZES]:
        want = _jax_specs(jshapes, shape)
        got = dict(_flat(sharding.param_shardings(tree, _mesh(shape))))
        assert got == want, shape
        for name, s in port.items():
            assert sharding.spec_for_path(name, s, rules, _sizes(shape)) \
                == tuple(jax_sharding.spec_for_path(
                    name, s, jax_sharding.default_param_rules(),
                    _sizes(shape)))


def _port_cache(tc, paged=False):
    model = dataclasses.replace(build(tc, device="cpu"),
                                device=torch.device("meta"))
    if paged:
        return model.make_paged_cache(8, 64, page_size=16, num_pages=40)
    return model.make_cache(8, 64)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ALL)
def test_cache_specs_equal_jax(arch, reduced):
    jc, tc = _cfgs(arch, reduced)
    jm = jax_build(jc)
    caches = [(jax.eval_shape(lambda: jm.make_cache(8, 64)),
               _port_cache(tc))]
    if jc.family == "dense":
        caches.append((jax.eval_shape(lambda: jm.make_paged_cache(
            8, 64, page_size=16, num_pages=40)), _port_cache(tc, True)))
    for jcache, tcache in caches:
        port = _port_shapes(tcache)
        assert port == _jax_shapes(jcache)
        for shape in REDUCED_SIZES if reduced else [FULL_SIZES]:
            got = dict(_flat(sharding.cache_shardings(_unflatten(port),
                                                      _mesh(shape))))
            assert got == _jax_specs(jcache, shape, "cache"), shape


@pytest.mark.parametrize("arch,quant", [("llama3.2-1b", ""),
                                        ("llama3.2-1b", "int4"),
                                        ("qwen2-moe-a2.7b", ""),
                                        ("mamba2-780m", "int8")])
@pytest.mark.parametrize("shape", REDUCED_SIZES, ids=["2x4", "1x8"])
def test_blocks_reassemble_every_leaf(arch, quant, shape):
    """Every rank's block of every param and cache leaf has
    ``local_shape``, and the blocks of all ranks cover each element
    exactly as often as the axes the leaf is replicated over (and hold
    its values)."""
    from repro_torch.quant import quantize_for_cfg as port_quantize
    cfg = get_arch(arch, variant="reduced").replace(quant=quant)
    model = build(cfg, device="cpu")
    params = port_quantize(model.init(0), cfg)
    cache = model.make_cache(4, 32)
    abstract = mesh_mod.Mesh(shape)
    for tree, specs in ((params, sharding.param_shardings(params, abstract)),
                        (cache, sharding.cache_shardings(cache, abstract))):
        for (name, leaf), (_, spec) in zip(_flat(tree), _flat(specs)):
            idx = torch.arange(leaf.numel()).view(leaf.shape)
            seen = torch.zeros(leaf.numel(), dtype=torch.long)
            used = {a for ax in spec if ax is not None
                    for a in (ax if isinstance(ax, tuple) else (ax,))}
            rep = int(np.prod([n for a, n in _sizes(shape).items()
                               if a not in used]))
            for coords in np.ndindex(*shape):
                blk = sharding.shard(idx, spec, abstract, coords)
                assert tuple(blk.shape) == sharding.local_shape(
                    leaf.shape, spec, abstract), name
                seen[blk.reshape(-1)] += 1
                assert torch.equal(sharding.shard(leaf, spec, abstract,
                                                  coords).reshape(-1),
                                   leaf.reshape(-1)[blk.reshape(-1)])
            assert bool((seen == rep).all()), (name, spec)


@pytest.mark.parametrize("spec,want", [("auto", (1, 8)), ("", (1, 8)),
                                       ("2,4", (2, 4)), ("2x4", (2, 4)),
                                       ("8,1", (8, 1))])
def test_mesh_spec_parsing(spec, want):
    assert mesh_mod.parse_mesh_spec(spec, 8) == want


@pytest.mark.parametrize("spec", ["2,4,1", "0,8", "a,b", "4"])
def test_bad_mesh_specs_raise_as_jax(spec):
    with pytest.raises(ValueError):
        jax_mesh.make_serving_mesh(spec)
    with pytest.raises(ValueError):
        mesh_mod.parse_mesh_spec(spec, 8)


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo process group for the test, destroyed after."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torchrun"):
        mesh_mod.make_serving_mesh("auto")


def test_one_rank_mesh(one_rank):
    mesh = mesh_mod.make_serving_mesh("auto")
    assert mesh.axis_names == ("data", "model") and mesh.shape == (1, 1)
    assert mesh.coords == (0, 0) and mesh_mod.batch_axes(mesh) == ("data",)
    assert mesh_mod.make_serving_mesh("1,1") is mesh
    with pytest.raises(ValueError, match="needs 8 ranks"):
        mesh_mod.make_serving_mesh("2,4")
    mesh_mod.reset_collective_counts()
    x = torch.arange(6, dtype=torch.float32).view(2, 3)
    assert torch.equal(mesh.all_reduce(x.clone()), x)
    assert torch.equal(mesh.all_gather(x, "model", dim=-1), x)
    assert torch.equal(mesh.broadcast(x.clone(), "data", 0), x)
    assert mesh_mod.collective_counts() == {"all_reduce": 1,
                                            "all_gather": 1, "broadcast": 1}


def _moe_cfgs():
    jc = jax_get_arch("qwen2-moe-a2.7b", variant="reduced")
    jc = jc.replace(moe=dataclasses.replace(jc.moe, capacity_factor=8.0))
    tc = get_arch("qwen2-moe-a2.7b", variant="reduced")
    return jc, tc.replace(moe=dataclasses.replace(tc.moe,
                                                  capacity_factor=8.0))


def test_shard_map_moe_on_one_rank_matches_jax_and_moe_block(one_rank):
    jc, tc = _moe_cfgs()
    jp = init_moe(jax.random.PRNGKey(0), jc)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a).copy()), jp)
    xn = np.random.default_rng(0).normal(size=(2, 16, jc.d_model))
    x = jnp.asarray(xn, jnp.float32)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    with jmesh:
        jy, ja = jax.jit(lambda p, x: jax_moe_shard_map(p, x, jc, jmesh))(
            jp, x)
    jy0, ja0 = jax.jit(lambda p, x: jax_moe_block(p, x, jc))(jp, x)
    mesh = mesh_mod.make_serving_mesh("1,1")
    xt = torch.from_numpy(xn.astype(np.float32))
    with sharding.use_mesh(mesh):
        ty, ta = moe_block_shard_map(tp, xt, tc, mesh)
    ty0, ta0 = moe_block(tp, xt, tc)
    for want, aux in ((jy, ja), (jy0, ja0)):
        np.testing.assert_allclose(ty.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(float(ta), float(aux), rtol=1e-5)
    np.testing.assert_allclose(ty.numpy(), ty0.numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(float(ta), float(ta0), rtol=1e-5)


class _Sharding:
    """Stands in for NamedSharding: keeps the spec (``add_zero_sharding``
    reads ``.spec``)."""

    def __init__(self, mesh, spec):
        self.spec = spec


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-moe-a2.7b",
                                  "mamba2-780m"])
def test_zero_and_batch_specs_equal_jax(arch):
    jc, tc = _cfgs(arch, False)
    jm = jax_build(jc)
    jshapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    batch = {"tokens": jax.ShapeDtypeStruct((256, 4096), jnp.int32),
             "lengths": jax.ShapeDtypeStruct((256,), jnp.int32),
             "odd": jax.ShapeDtypeStruct((5, 3), jnp.int32)}
    fake = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty(FULL_SIZES))
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_sharding, "NamedSharding", _Sharding)
    try:
        jzero = jax_sharding.add_zero_sharding(
            jax_sharding.param_shardings(jshapes, fake), jshapes, fake)
        jbatch = jax_sharding.batch_shardings(batch, fake)
    finally:
        mp.undo()

    def flat(tree):
        return {jax_sharding._path_str(p): tuple(s.spec) for p, s in
                jax.tree_util.tree_flatten_with_path(
                    tree, is_leaf=lambda x: isinstance(x, _Sharding))[0]}

    tree = _unflatten(_port_shapes(param_shapes(tc)))
    mesh = _mesh(FULL_SIZES)
    zero = sharding.add_zero_sharding(sharding.param_shardings(tree, mesh),
                                      tree, mesh)
    assert dict(_flat(zero)) == flat(jzero)
    assert sharding.batch_shardings(
        {k: v.shape for k, v in batch.items()}, mesh) == {
        k.split("/")[-1]: v for k, v in flat(jbatch).items()}


@pytest.mark.parametrize("axes", [("data",), ("pod", "data")])
def test_activation_rules_equal_jax(axes):
    want = jax_sharding.default_activation_rules(batch_axes=axes,
                                                 seq_axis="model")
    got = sharding.default_activation_rules(batch_axes=axes,
                                            seq_axis="model")
    assert got == {k: tuple(v) for k, v in want.items()}
