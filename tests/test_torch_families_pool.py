"""The port's engine on a paged KV pool for the attention-only stacks of
the MoE and other dense families, and the prefix cache on qwen2-moe,
against the JAX engine: greedy tokens identical.

On the CPU in fp32, reduced width, the JAX package's weights scaled by 8
and crossed through ``repro_torch.bridge``; three prompts of 3, 11 and
17 tokens on two slots, chunks of 8, a 64-token cache, pages of 8. The
pool drains and every admission is chunked. The prefix cache serves
four prompts behind one 16-token header on rings and on the pool: the
hits and their tokens are the JAX engine's.
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

POOL = ["qwen2-moe-a2.7b", "granite-moe-3b-a800m", "mixtral-8x7b",
        "internlm2-20b", "qwen2.5-14b", "starcoder2-15b", "gemma2-9b-class"]


@functools.lru_cache(maxsize=None)
def _models(arch):
    jc = jax_get_arch(arch, variant="reduced")
    tc = get_arch(arch, variant="reduced")
    jm, tm = jax_build(jc), build(tc, device="cpu")
    jp = jax.tree.map(lambda a: a * 8.0 if a.ndim >= 2 else a,
                      jm.init(jax.random.PRNGKey(0)))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jm, jp, tm, tp


def _serve(side, arch, prompts, **kw):
    jm, jp, tm, tp = _models(arch)
    kw = dict(max_batch=2, cache_len=64, prefill_chunk=8, **kw)
    if side == "jax":
        e, R = JaxEngine(jm, jp, sampler=JaxSampler(), **kw), JaxRequest
    else:
        e, R = Engine(tm, tp, **kw), Request
    for uid, p in enumerate(prompts):
        e.submit(R(uid=uid, prompt=p, max_new_tokens=6))
    resp = e.run()
    return {u: list(r.tokens) for u, r in resp.items()}, e.latency_stats()


def _prompts(vocab):
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, L) for L in (3, 11, 17)]


@pytest.mark.parametrize("arch", POOL)
def test_engine_pool_matches_jax(arch):
    prompts = _prompts(_models(arch)[2].cfg.vocab)
    want, _ = _serve("jax", arch, prompts, paged=True, page_size=8)
    got, st = _serve("torch", arch, prompts, paged=True, page_size=8)
    assert got == want
    assert st["kv_pages_live"] == 0 and st["fallback_admissions"] == 0


@pytest.mark.parametrize("paged", [False, True])
def test_prefix_hits_on_moe_match_jax(paged):
    arch = "qwen2-moe-a2.7b"
    rng = np.random.default_rng(7)
    head = rng.integers(0, 1024, 16)
    prompts = [np.concatenate([head, rng.integers(0, 1024, n)])
               for n in (3, 5, 9, 2)]
    kw = dict(prefix_cache_tokens=256)
    if paged:
        kw.update(paged=True, page_size=8)
    want, jst = _serve("jax", arch, prompts, **kw)
    got, st = _serve("torch", arch, prompts, **kw)
    assert got == want
    assert st["prefix_hits"] == jst["prefix_hits"] > 0
    assert st["prefix_hit_tokens"] == jst["prefix_hit_tokens"]
