"""Quantized SSM stacks, the quantized leaf sets and the serve CLI of
the MoE and hybrid stacks, against the JAX package.

On the CPU in fp32, reduced width, the JAX package's weights (scaled by
8, JAX-quantized under ``cfg.quant``) crossed through
``repro_torch.bridge``:

* mamba2-780m ``reduced+edge`` (int4 weights, int8 KV) and int8 weights
  build and serve greedy tokens equal to the JAX engine's on the same
  JAX-quantized weights;
* the quantized leaf sets of mamba2, qwen2-moe and jamba are JAX's (the
  SSM projections and the shared expert quantized, the experts and the
  router not), at int8 and int4;
* the serve CLI on ``--device cpu`` for qwen2-moe and jamba.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import quant as jq  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro.serving.sampler import Sampler as JaxSampler  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import quant as tq  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.quant.qtensor import is_qtensor  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _models(arch, variant="reduced", quant=""):
    """(JAX model, JAX params, port model, port params) on one set of
    weights, scaled by 8 and JAX-quantized under ``quant``."""
    jc = jax_get_arch(arch, variant=variant)
    tc = get_arch(arch, variant=variant)
    if quant:
        jc, tc = jc.replace(quant=quant), tc.replace(quant=quant)
    jm, tm = jax_build(jc), build(tc, device="cpu")
    jp = jax.tree.map(lambda a: a * 8.0 if a.ndim >= 2 else a,
                      jm.init(jax.random.PRNGKey(0)))
    jp = jq.quantize_for_cfg(jp, jc)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jm, jp, tm, tp


def _serve(side, key, lengths=(3, 9, 14), max_new=8, seed=9, **kw):
    jm, jp, tm, tp = _models(*key)
    kw = dict(max_batch=2, cache_len=64, **kw)
    if side == "jax":
        e, R = JaxEngine(jm, jp, sampler=JaxSampler(), **kw), JaxRequest
    else:
        e, R = Engine(tm, tp, **kw), Request
    rng = np.random.default_rng(seed)
    for uid, L in enumerate(lengths):
        e.submit(R(uid=uid, prompt=rng.integers(0, tm.cfg.vocab, L),
                   max_new_tokens=max_new))
    resp = e.run()
    assert all(r.finished for r in resp.values())
    return {u: list(r.tokens) for u, r in resp.items()}, e.latency_stats()


@pytest.mark.parametrize("variant,quant", [("reduced+edge", ""),
                                           ("reduced", "int8")])
def test_quantized_ssm_engine_matches_jax(variant, quant):
    key = ("mamba2-780m", variant, quant)
    want, _ = _serve("jax", key, prefill_chunk=8)
    got, _ = _serve("torch", key, prefill_chunk=8)
    assert got == want
    tp = _models(*key)[3]
    assert is_qtensor(tp["blocks"]["sub0"]["ssm"]["in_proj"]["w"])


def _qpaths(tree, path=()):
    if is_qtensor(tree):
        return {path}
    if isinstance(tree, dict):
        return set().union(*(_qpaths(v, path + (k,)) for k, v in
                             tree.items())) if tree else set()
    return set()


@pytest.mark.parametrize("arch", ["mamba2-780m", "qwen2-moe-a2.7b",
                                  "jamba-1.5-large-398b"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_leaf_set_as_jax(arch, bits):
    jc = jax_get_arch(arch, variant="reduced")
    tc = get_arch(arch, variant="reduced")
    rng = np.random.default_rng(0)
    jp = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(a.dtype),
                      jax.eval_shape(jax_build(jc).init,
                                     jax.random.PRNGKey(0)))
    tp = bridge.params_from_jax(jp, tc, "cpu")
    want = _qpaths(jq.quantize_params(jp, bits=bits))
    assert _qpaths(tq.quantize_params(tp, bits=bits)) == want
    keys = {k for p in want for k in p}
    assert "router" not in keys
    assert not any(p[-1] in ("wi", "wg", "wo") and "moe" in p for p in want)
    if tc.moe is not None and tc.moe.n_shared:
        assert "shared" in keys
    if tc.ssm is not None:
        assert {"in_proj", "out_proj"} <= {p[-2] for p in want}


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-1.5-large-398b"])
def test_serve_cli_on_cpu(arch, capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--variant", "reduced", "--device", "cpu",
                "--requests", "3", "--max-new", "4", "--max-batch", "2",
                "--cache-len", "64", "--prefill-chunk", "8",
                "--temperature", "0"])
    out = capsys.readouterr().out
    assert f"arch={arch}-reduced" in out and "ok=3/3" in out
