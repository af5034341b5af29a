"""Speculation on the MoE and hybrid stacks against the JAX package.

On the CPU in fp32, reduced width, the JAX package's weights crossed
through ``repro_torch.bridge``:

* the n-gram drafter on qwen2-moe over a vocabulary of 8 (drafts match,
  so proposals are accepted: the accept path runs) and on jamba (its
  SSM sublayers commit by checkpoint restore and a replay of the
  accepted prefix, its attention sublayer by rewinding ``step``): spec
  tokens equal the plain engine's and the JAX spec engine's, with JAX's
  acceptance rate;
* the ``spec`` variant (an int8 self-draft of half the blocks at gamma
  4) on qwen2-moe: tokens equal plain and JAX's;
* jamba on a paged pool and jamba with a model draft raise
  ``ValueError``, as the JAX engine does, and it builds no prefix cache.

Quantized SSM stacks, the quantized leaf sets and the CLI are in
``tests/test_torch_families_quant.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro.serving.sampler import Sampler as JaxSampler  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _models(arch, variant="reduced", vocab=0):
    """(JAX model, JAX params, port model, port params) on one set of
    weights, the matrices scaled by 8 so greedy streams vary."""
    jc = jax_get_arch(arch, variant=variant)
    tc = get_arch(arch, variant=variant)
    if vocab:
        jc, tc = jc.replace(vocab=vocab), tc.replace(vocab=vocab)
    jm, tm = jax_build(jc), build(tc, device="cpu")
    jp = jax.tree.map(lambda a: a * 8.0 if a.ndim >= 2 else a,
                      jm.init(jax.random.PRNGKey(0)))
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


@pytest.mark.parametrize("key", [("qwen2-moe-a2.7b", "reduced", 8),
                                 ("jamba-1.5-large-398b", "reduced", 8)])
def test_ngram_spec_matches_plain_and_jax(key):
    kw = dict(lengths=(6, 13), max_new=16, seed=2)
    plain, _ = _serve("torch", key, **kw)
    want, jst = _serve("jax", key, draft="ngram", spec_gamma=3, **kw)
    got, st = _serve("torch", key, draft="ngram", spec_gamma=3, **kw)
    assert got == plain == want
    assert st["spec_acceptance_rate"] == jst["spec_acceptance_rate"]
    assert st["fallback_admissions"] == 0
    if key[0] == "qwen2-moe-a2.7b":
        assert st["spec_acceptance_rate"] > 0.0


def test_spec_variant_on_moe_matches_jax():
    key = ("qwen2-moe-a2.7b", "reduced+spec")
    assert _models(*key)[2].cfg.draft == "int8@1"
    plain, _ = _serve("torch", ("qwen2-moe-a2.7b",))
    want, jst = _serve("jax", key)
    got, st = _serve("torch", key)
    assert got == want == plain
    assert st["spec_gamma"] == jst["spec_gamma"] == 4
    assert st["spec_tokens_per_step"] == jst["spec_tokens_per_step"]


def test_hybrid_refuses_pool_and_model_draft():
    _, _, tm, tp = _models("jamba-1.5-large-398b")
    with pytest.raises(ValueError, match="paged"):
        Engine(tm, tp, max_batch=2, cache_len=64, paged=True)
    with pytest.raises(ValueError, match="model-draft"):
        Engine(tm, tp, max_batch=2, cache_len=64, draft="int8@1")
    e = Engine(tm, tp, max_batch=2, cache_len=64, prefix_cache_tokens=256)
    assert e.prefix_cache is None        # recurrent state: no prefix reuse
