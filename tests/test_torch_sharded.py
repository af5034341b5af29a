"""The port's serving mesh against the JAX package's single-device
engine, on the CPU: eight gloo processes under torchrun.

``tests/torch_sharded_check.py`` runs once for the module, on the JAX
package's reduced llama3.2-1b and qwen2-moe-a2.7b weights (through the
bridge) and the prompts of ``tests/sharded_check.py``; while it runs,
this process serves the same requests through the JAX ``Engine`` on one
device. The cases (JAX's ``test_sharded_serving.py`` and
``test_moe_shard_map.py``, for the port):

* greedy tokens on a 2 x 4 mesh equal JAX's in the modes plain,
  chunked, prefix, int8kv, spec and int8w, and int4w and reduced
  qwen2-moe (one expert a rank), on a first and a second stream;
* temperature-sampled streams on 2 x 4 (chunked, and speculative with
  a model draft) equal the port's single-device engine's, token for
  token: each data rank draws its slots' noise as one device does;
* the program counts stay flat over the second stream;
* plain on 1 x 8 (4 KV heads do not divide 8: gathered heads, a
  replicated cache);
* chunked admission's cache bits on the mesh: chunk 8 = chunk 16
  bitwise, the whole prompt within 1e-5;
* every rank's tokens agree;
* every rank's param and cache leaves have the local shape of JAX's
  spec for that leaf;
* the expert-parallel MoE block against the single-device block;
* the Zoo's ``mesh`` endpoint (reduced llama's logits, params cut to
  each rank's blocks, fp and int8) on 2 x 4 and 1 x 8 against the
  ``local`` endpoint;
* the serve CLI on a 1 x 2 mesh under torchrun gives the single-device
  CLI's tokens.
"""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.distribution import sharding as jax_sharding  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro.quant import quantize_for_cfg  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.distribution.sharding import local_shape  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CHECK = ROOT / "tests" / "torch_sharded_check.py"
MODES = ["plain", "chunked", "prefix", "int8kv", "spec", "int8w", "int4w",
         "moe"]
#: the JAX engine's arguments for each mode (tests/sharded_check.py's)
JAX_MODES = {
    "plain": {}, "chunked": {"prefill_chunk": 8},
    "prefix": {"prefill_chunk": 8, "prefix_cache_tokens": 256},
    "int8kv": {"kv_cache_dtype": "int8"},
    "spec": {"draft": "fp@1", "spec_gamma": 2},
    "int8w": {}, "int4w": {}, "moe": {},
}
_PARAMS = {"int8w": "llama_int8", "int4w": "llama_int4", "moe": "moe"}
#: the sampled modes of torch_sharded_check.py (its SAMPLER's knobs)
SAMPLED = {"sampled": {"prefill_chunk": 8},
           "spec_sampled": {"draft": "fp@1", "spec_gamma": 2}}

_STATE = {}


def _torchrun(n, args, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n)] + args, cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, **kw)


def _jax_params():
    out = {}
    for key, arch, quant in (("llama", "llama3.2-1b", ""),
                             ("llama_int8", "llama3.2-1b", "int8"),
                             ("llama_int4", "llama3.2-1b", "int4"),
                             ("moe", "qwen2-moe-a2.7b", "")):
        jc = jax_get_arch(arch, variant="reduced")
        jm = jax_build(jc)
        jp = jm.init(jax.random.PRNGKey(0))
        if quant:
            jp = quantize_for_cfg(jp, jc.replace(quant=quant))
        out[key] = (jm, jp, get_arch(arch, variant="reduced").replace(
            quant=quant))
    return out


def _prompts():
    rng = np.random.default_rng(21)
    head = list(rng.integers(0, 1024, 12))
    return [np.asarray(head + list(rng.integers(0, 1024, L)))
            for L in (3, 8, 11, 17)]


def _jax_tokens(jm, jp, **kw):
    eng = JaxEngine(jm, jp, max_batch=4, cache_len=64, **kw)
    for i, p in enumerate(_prompts()):
        eng.submit(JaxRequest(uid=i, prompt=p, max_new_tokens=8))
    return {str(u): list(map(int, r.tokens)) for u, r in eng.run().items()}


def _sampled_tokens(weights, **kw):
    """Two streams through the port's engine on one device, sampling as
    the mesh check does."""
    from repro_torch.models.model import build
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request
    from repro_torch.serving.sampler import Sampler
    eng = Engine(build(get_arch("llama3.2-1b", variant="reduced"),
                       device="cpu"), weights, max_batch=4, cache_len=64,
                 sampler=Sampler(temperature=0.8, top_k=32), **kw)
    out = {}
    for uid0 in (0, 100):
        for i, p in enumerate(_prompts()):
            eng.submit(Request(uid=uid0 + i, prompt=p, max_new_tokens=8))
        out[uid0] = {str(u): list(r.tokens) for u, r in eng.run().items()
                     if u >= uid0}
    return out


def _result(tmp_path_factory):
    if _STATE:
        return _STATE
    params = _jax_params()
    path = tmp_path_factory.mktemp("mesh") / "weights.pt"
    weights = {k: bridge.params_from_jax(jax.tree.map(np.asarray, jp), tc,
                                         "cpu")
               for k, (_, jp, tc) in params.items()}
    torch.save(weights, path)
    proc = _torchrun(8, [str(CHECK), str(path)])
    try:
        jax_tokens = {m: _jax_tokens(*params[_PARAMS.get(m, "llama")][:2],
                                     **JAX_MODES[m]) for m in MODES}
        one_device = {m: _sampled_tokens(weights["llama"], **kw)
                      for m, kw in SAMPLED.items()}
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    try:
        _STATE.update(json.loads(out.strip().splitlines()[-1]))
    except (json.JSONDecodeError, IndexError):
        raise AssertionError(f"torch_sharded_check printed no JSON "
                             f"(rc={proc.returncode}):\n{out}\n"
                             f"{err[-4000:]}") from None
    _STATE["jax"] = jax_tokens
    _STATE["one_device"] = one_device
    _STATE["params"] = params
    return _STATE


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    return _result(tmp_path_factory)


@pytest.mark.parametrize("mode", MODES)
def test_mesh_greedy_tokens_equal_jax(result, mode):
    m, want = result["modes"][mode], result["jax"][mode]
    assert m["tokens"] == want, (m["tokens"], want)
    assert m["tokens_second_stream"] == {
        str(int(u) + 100): t for u, t in want.items()}


@pytest.mark.parametrize("mode", list(SAMPLED))
def test_mesh_sampled_streams_equal_one_device(result, mode):
    m, want = result["sampled"][mode], result["one_device"][mode]
    assert m["tokens"] == want[0], (m["tokens"], want[0])
    assert m["tokens_second_stream"] == want[100]
    assert m["ranks_agree"] and m["programs_flat"]


@pytest.mark.parametrize("mode", MODES)
def test_mesh_programs_stay_flat(result, mode):
    m = result["modes"][mode]
    assert m["programs_flat"], m["program_sizes"]


@pytest.mark.parametrize("mode", MODES + ["plain_1x8"])
def test_every_rank_has_the_same_tokens(result, mode):
    m = result["plain_1x8"] if mode == "plain_1x8" \
        else result["modes"][mode]
    assert m["ranks_agree"]


def test_pure_tensor_parallel_mesh(result):
    """1 x 8: 4 KV heads do not divide 8, so the projections are gathered
    to whole heads and the cache is replicated; tokens still equal
    JAX's."""
    m = result["plain_1x8"]
    assert m["tokens"] == result["jax"]["plain"]
    assert m["programs_flat"]
    # every rank holds all 4 KV heads of the cache
    for shapes in m["rank_shapes"]:
        assert shapes["cache"]["sub0/k"] == [2, 4, 64, 4, 64]


def test_admission_cache_bits_on_mesh(result):
    assert result["cache_bits_equal"]
    assert result["cache_close_to_whole"]


def test_expert_parallel_moe_block_matches_single_device(result):
    """moe_block_shard_map on 2 x 4 (one expert a rank) against moe_block
    on one device: y within rtol = atol = 2e-4, the aux loss within
    rtol 1e-4 (JAX's multi-device tolerances), on every rank."""
    r = result["moe_block"]
    assert r["y_close"] and r["aux_close"], r
    assert r["aux"] > 0, r


@pytest.mark.parametrize("case", ["2,4", "2,4-int8", "1,8"])
def test_mesh_endpoint_matches_local_on_every_rank(result, case):
    """A ``mesh`` endpoint above one rank: every rank holds its blocks
    of the service's params (1 x 8: the projections gathered to whole
    heads) and its logits equal the ``local`` endpoint's within rtol =
    atol = 1e-5."""
    r = result["endpoint"][case]
    assert r["close"], r
    assert r["shape"] == [2, 16, get_arch("llama3.2-1b",
                                          variant="reduced").vocab]


def _jax_specs(tree, sizes, cache=False):
    """JAX's specs for a tree of shapes, leaf by leaf: its
    ``param_shardings`` / ``cache_shardings`` on a stand-in mesh of
    ``sizes`` whose NamedSharding is the spec itself."""
    fake = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty(sizes))
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_sharding, "NamedSharding", lambda mesh, spec: spec)
    try:
        specs = jax_sharding.cache_shardings(tree, fake) if cache \
            else jax_sharding.param_shardings(tree, fake)
    finally:
        mp.undo()
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(k.key) for k in path): tuple(spec)
            for path, spec in flat}


@pytest.mark.parametrize("mode,mesh", [("plain", (2, 4)),
                                       ("plain_1x8", (1, 8)),
                                       ("int8kv", (2, 4)),
                                       ("int4w", (2, 4)), ("moe", (2, 4))])
def test_every_rank_holds_the_local_shape_of_jax_spec(result, mode, mesh):
    m = result["plain_1x8"] if mode == "plain_1x8" \
        else result["modes"][mode]
    jm, jp, _ = result["params"][_PARAMS.get(mode, "llama")]
    kw = {"kv_cache_dtype": "int8"} if mode == "int8kv" else {}
    jcfg = jm.cfg.replace(kv_quant=True) if kw else jm.cfg
    cache = jax.eval_shape(lambda: jax_build(jcfg).make_cache(4, 64))
    shapes = {"params": jax.tree.map(lambda a: a.shape, jp),
              "cache": jax.tree.map(lambda a: a.shape, cache)}
    specs = {"params": _jax_specs(jp, mesh),
             "cache": _jax_specs(cache, mesh, cache=True)}
    full = {part: {"/".join(str(k.key) for k in path): tuple(s)
                   for path, s in jax.tree_util.tree_flatten_with_path(
                       shapes[part], is_leaf=lambda x: isinstance(x, tuple))
                   [0]} for part in shapes}
    assert len(m["rank_shapes"]) == mesh[0] * mesh[1]
    for rank, got in enumerate(m["rank_shapes"]):
        abstract = Mesh(mesh, rank)
        for part in ("params", "cache"):
            assert set(got[part]) == set(full[part])
            for name, shape in full[part].items():
                want = local_shape(shape, specs[part][name], abstract)
                assert tuple(got[part][name]) == want, (rank, part, name)


def test_serve_cli_on_a_two_rank_mesh_gives_the_single_device_tokens(
        tmp_path):
    args = ["--arch", "llama3.2-1b", "--variant", "reduced", "--device",
            "cpu", "--requests", "8", "--max-new", "12", "--max-batch", "4",
            "--cache-len", "64", "--prefill-chunk", "8", "--temperature",
            "0"]
    proc = _torchrun(2, ["-m", "repro_torch.launch.serve"] + args + [
        "--mesh", "1,2", "--json", str(tmp_path / "mesh.json")])
    from repro_torch.launch import serve
    serve.main(args + ["--json", str(tmp_path / "one.json")])
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-4000:]
    assert out.count("mesh: data=1 model=2 (2 devices)") == 1, out
    mesh = json.loads((tmp_path / "mesh.json").read_text())
    one = json.loads((tmp_path / "one.json").read_text())
    assert mesh["tokens"] == one["tokens"]
    assert mesh["n_finished"] == one["n_finished"] == 8
