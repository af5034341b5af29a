"""The port's engine on the MoE, hybrid and other dense families against
the JAX engine on KV rings (and SSM state): greedy tokens identical.

On the CPU in fp32, reduced width, the JAX package's weights scaled by 8
(so the random models' greedy streams vary) and crossed through
``repro_torch.bridge``; three prompts of 3, 11 and 17 tokens on two
slots (the third reuses a slot: its reset covers KV rings and SSM state
alike), chunks of 8, a 64-token cache. gemma2-class runs with a
16-token window, so its ring wraps. The paged pool and the prefix
cache are in ``tests/test_torch_families_pool.py``, speculation in
``_serving.py``, quantized SSM stacks and the CLI in ``_quant.py``.
Every admission is chunked (``fallback_admissions == 0``). MoE stacks
route densely in the cached modes on both sides, so chunking and batch
composition cannot change a token's experts.
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

RINGS = ["qwen2-moe-a2.7b", "granite-moe-3b-a800m", "mixtral-8x7b",
         "jamba-1.5-large-398b", "internlm2-20b", "qwen2.5-14b",
         "starcoder2-15b", "gemma2-9b-class"]


@functools.lru_cache(maxsize=None)
def _models(arch):
    jc = jax_get_arch(arch, variant="reduced")
    tc = get_arch(arch, variant="reduced")
    if arch == "gemma2-9b-class":        # a window the 64-token ring wraps
        jc, tc = jc.replace(sliding_window=16), tc.replace(sliding_window=16)
    jm, tm = jax_build(jc), build(tc, device="cpu")
    jp = jax.tree.map(lambda a: a * 8.0 if a.ndim >= 2 else a,
                      jm.init(jax.random.PRNGKey(0)))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jm, jp, tm, tp


def _serve(side, arch, **kw):
    jm, jp, tm, tp = _models(arch)
    kw = dict(max_batch=2, cache_len=64, prefill_chunk=8, **kw)
    if side == "jax":
        e, R = JaxEngine(jm, jp, sampler=JaxSampler(), **kw), JaxRequest
    else:
        e, R = Engine(tm, tp, **kw), Request
    rng = np.random.default_rng(1)
    for uid, L in enumerate((3, 11, 17)):
        e.submit(R(uid=uid, prompt=rng.integers(0, tm.cfg.vocab, L),
                   max_new_tokens=6))
    resp = e.run()
    return {u: list(r.tokens) for u, r in resp.items()}, e


@pytest.mark.parametrize("arch", RINGS)
def test_engine_rings_match_jax(arch):
    want, _ = _serve("jax", arch)
    got, e = _serve("torch", arch)
    assert got == want
    assert len({t for ts in got.values() for t in ts}) > 3
    st = e.latency_stats()
    assert st["fallback_admissions"] == 0 and st["chunked_admissions"] == 3
