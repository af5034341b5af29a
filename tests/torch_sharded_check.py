"""The port's serving mesh on the CPU, one gloo process a rank: the
counterpart of ``tests/sharded_check.py`` for ``repro_torch``.

Run under torchrun (``tests/test_torch_sharded.py`` does, once a
module), with a weights file that test wrote (the JAX package's reduced
llama3.2-1b and qwen2-moe-a2.7b weights, through the bridge)::

  python -m torch.distributed.run --standalone --nproc-per-node 8 \\
      tests/torch_sharded_check.py WEIGHTS.pt

Rank 0 prints one JSON object on its last line: for each mode of
``sharded_check.py`` (plain, chunked, prefix, int8kv, spec, int8w) and
``int4w`` on a 2 x 4 mesh, and ``plain`` on 1 x 8 (4 KV heads do not
divide 8: the heads are gathered and the cache replicated), the greedy
tokens of a first and a second request stream and the program counts
before and after the second; the same for temperature sampling on
2 x 4, chunked and speculative; every rank's tokens; the local shapes of
every param and cache leaf on every rank; chunked admission's cache
bits on the mesh (chunk 8 against 16 bitwise, against the whole prompt
within 1e-5); the expert-parallel MoE block against the single-device
block; reduced qwen2-moe served on 2 x 4 (one expert a rank); and the
Zoo's ``mesh`` endpoint (reduced llama's logits service, its params cut
to each rank's blocks, in fp and int8) on 2 x 4 and 1 x 8 against the
``local`` endpoint. The test holds the tokens against the JAX package's
single-device engine.
"""
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import deploy  # noqa: E402
from repro_torch.core.zoo_builders import lm_service_for  # noqa: E402
from repro_torch.core.pytree import tree_flatten_with_path  # noqa: E402
from repro_torch.distribution.sharding import (  # noqa: E402
    param_shardings, shard_tree, use_mesh)
from repro_torch.launch.mesh import make_serving_mesh  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.models.moe import moe_block  # noqa: E402
from repro_torch.models.moe_shard_map import moe_block_shard_map  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.serving.sampler import Sampler  # noqa: E402

CFG = get_arch("llama3.2-1b", variant="reduced")
MOE_CFG = get_arch("qwen2-moe-a2.7b", variant="reduced")
RNG = np.random.default_rng(21)
# the prompts of sharded_check.py: a shared 12-token head (prefix-cache
# hits) and tails straddling the chunk size
HEAD = list(RNG.integers(0, CFG.vocab, 12))
PROMPTS = [np.asarray(HEAD + list(RNG.integers(0, CFG.vocab, L)))
           for L in (3, 8, 11, 17)]

MODES = {
    "plain": {},
    "chunked": {"prefill_chunk": 8},
    "prefix": {"prefill_chunk": 8, "prefix_cache_tokens": 256},
    "int8kv": {"kv_cache_dtype": "int8"},
    "spec": {"draft": "fp@1", "spec_gamma": 2},
    "int8w": {"_params": "llama_int8"},
    "int4w": {"_params": "llama_int4"},
    "moe": {"_params": "moe"},
}
#: temperature sampling (the serve CLI's default knobs) on the mesh,
#: through mixed steps and through spec steps with idle admissions: each
#: stream must be the single-device port engine's
SAMPLER = Sampler(temperature=0.8, top_k=32)
SAMPLED = {
    "sampled": {"prefill_chunk": 8, "sampler": SAMPLER},
    "spec_sampled": {"draft": "fp@1", "spec_gamma": 2, "sampler": SAMPLER},
}


def _engine(weights, mesh, _params="llama", **kw):
    cfg = MOE_CFG if _params == "moe" else CFG
    return Engine(build(cfg, device="cpu"), weights[_params], max_batch=4,
                  cache_len=64, mesh=mesh, **kw)


def _serve(eng, max_new=8, uid0=0):
    for i, p in enumerate(PROMPTS):
        eng.submit(Request(uid=uid0 + i, prompt=p, max_new_tokens=max_new))
    resp = eng.run()
    return {u: list(r.tokens) for u, r in resp.items() if u >= uid0}


def _shapes(tree):
    return {"/".join(map(str, path)): list(t.shape)
            for path, t in tree_flatten_with_path(tree)}


def check_mode(weights, name, mesh="2,4"):
    eng = _engine(weights, mesh, **{**MODES, **SAMPLED}[name])
    first = _serve(eng)
    sizes0 = dict(eng.program_cache_sizes())
    second = _serve(eng, uid0=100)
    out = {"tokens": {str(u): t for u, t in first.items()},
           "tokens_second_stream": {str(u): t for u, t in second.items()},
           "programs_flat": sizes0 == dict(eng.program_cache_sizes()),
           "program_sizes": dict(eng.program_cache_sizes()),
           "shapes": {"params": _shapes(eng.params),
                      "cache": _shapes(eng.cache)}}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (out["tokens"],
                                   out["tokens_second_stream"],
                                   out["shapes"]))
    out["ranks_agree"] = all(t == out["tokens"] and t2 ==
                             out["tokens_second_stream"]
                             for t, t2, _ in every)
    out["rank_shapes"] = [s for _, _, s in every]
    del out["shapes"]
    return out


def check_admission_cache_bits(weights, mesh="2,4"):
    """On the mesh, slot 0's K/V/pos/step after chunked admission: 8- and
    16-token chunks bitwise equal, the whole prompt in one chunk within
    1e-5 (its extend is padded to the ring). The data rank that holds
    slot 0 compares its blocks; the verdicts are combined over ranks."""
    prompt = PROMPTS[2]
    L = len(prompt)
    caches = {}
    for tag, kw in (("chunk8", {"prefill_chunk": 8}),
                    ("chunk16", {"prefill_chunk": 16}),
                    ("whole", {})):
        eng = _engine(weights, mesh, **kw)
        eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=1))
        eng._fill_free_slots()
        while eng._admit is not None:
            eng.step()
        caches[tag] = eng.cache
        owner = eng._local_slot(0) is not None

    def compare(a, b, exact):
        ok = True
        for name in a:
            for key, la in a[name].items():
                lb = b[name][key]
                if key in ("k", "v", "k_scale", "v_scale"):
                    la, lb = la[:, 0, :L], lb[:, 0, :L]
                    ok &= torch.equal(la, lb) if exact else \
                        bool(torch.allclose(la, lb, rtol=1e-5, atol=1e-5))
                elif key in ("pos", "step"):
                    ok &= torch.equal(la[:, 0], lb[:, 0])
        return ok

    flags = torch.tensor([
        compare(caches["chunk8"], caches["chunk16"], True) if owner else 1,
        compare(caches["chunk8"], caches["whole"], False) if owner else 1],
        dtype=torch.int32)
    dist.all_reduce(flags, op=dist.ReduceOp.MIN)
    return {"cache_bits_equal": bool(flags[0]),
            "cache_close_to_whole": bool(flags[1])}


def check_moe_block(weights, mesh="2,4"):
    """moe_block_shard_map on the mesh (each data rank its 2 rows of 4,
    each model rank its block of the params: one expert of 4, a quarter
    of the shared expert's hidden units) against the single-device
    moe_block on all rows, capacity factor 8 (no drops on either)."""
    import dataclasses
    mesh = make_serving_mesh(mesh)
    cfg = MOE_CFG.replace(moe=dataclasses.replace(MOE_CFG.moe,
                                                  capacity_factor=8.0))
    block = weights["moe"]["blocks"]["sub0"]["moe"]
    p = {"router": {"w": block["router"]["w"][0]},
         "shared": {n: {"w": w["w"][0]} for n, w in block["shared"].items()},
         **{k: block[k][0] for k in ("wi", "wg", "wo")}}
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 16, cfg.d_model)).astype(np.float32))
    y0, a0 = moe_block(p, x, cfg)
    tree = {"moe": p}
    local = shard_tree(tree, param_shardings(tree, mesh), mesh)["moe"]
    d = mesh.axis_index("data")
    with use_mesh(mesh):
        y1, a1 = moe_block_shard_map(local, x[2 * d:2 * d + 2], cfg, mesh)
    want = y0[2 * d:2 * d + 2]
    close = torch.tensor([int(torch.allclose(y1, want, rtol=2e-4,
                                              atol=2e-4)),
                          int(abs(float(a1) - float(a0))
                              <= 1e-4 * abs(float(a0)))])
    err = torch.tensor([float((y1 - want).abs().max()),
                        abs(float(a1) - float(a0))])
    dist.all_reduce(close, op=dist.ReduceOp.MIN)
    dist.all_reduce(err, op=dist.ReduceOp.MAX)
    return {"y_close": bool(close[0]), "aux_close": bool(close[1]),
            "max_abs_err": float(err[0]), "aux_abs_err": float(err[1]),
            "aux": float(a0)}


def check_endpoint(weights, mesh, quantize=""):
    """Reduced llama's logits service on a ``mesh`` endpoint (each rank
    holds its blocks of the params; an int8 endpoint cuts the dequantized
    weights in its program) against the same service on a ``local``
    endpoint, on every rank: within rtol = atol = 1e-5 (the mesh sums
    the row-parallel blocks in another order)."""
    svc = lm_service_for(CFG, arch=CFG.name).with_params(weights["llama"])
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, CFG.vocab, (2, 16)).astype(np.int32))
    outs = []
    for kind, m in (("local", None), ("mesh", make_serving_mesh(mesh))):
        plan = deploy.DeploymentPlan(
            endpoints={"ep": deploy.Endpoint("ep", kind=kind, mesh=m,
                                             quantize=quantize)},
            assignments={svc.name: "ep"})
        outs.append(deploy.deploy(svc, plan).call({"tokens": tokens})[0])
    close = torch.tensor([int(torch.allclose(outs[1], outs[0], rtol=1e-5,
                                             atol=1e-5))])
    err = torch.tensor([float((outs[1] - outs[0]).abs().max())])
    dist.all_reduce(close, op=dist.ReduceOp.MIN)
    dist.all_reduce(err, op=dist.ReduceOp.MAX)
    return {"close": bool(close[0]), "max_abs_err": float(err[0]),
            "shape": list(outs[1].shape)}


def main():
    torch.set_num_threads(1)
    dist.init_process_group("gloo")
    weights = torch.load(sys.argv[1], weights_only=True)
    result = {"world": dist.get_world_size(), "modes": {}}
    for name in MODES:
        result["modes"][name] = check_mode(weights, name)
    result["sampled"] = {name: check_mode(weights, name)
                         for name in SAMPLED}
    result["plain_1x8"] = check_mode(weights, "plain", mesh="1,8")
    result.update(check_admission_cache_bits(weights))
    result["moe_block"] = check_moe_block(weights)
    result["endpoint"] = {f"{mesh}{'-' + q if q else ''}":
                          check_endpoint(weights, mesh, q)
                          for mesh, q in (("2,4", ""), ("2,4", "int8"),
                                          ("1,8", ""))}
    if dist.get_rank() == 0:
        print(json.dumps(result), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
