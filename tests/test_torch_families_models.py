"""Every mode of the port's MoE, hybrid and other dense models against
the JAX package's: ``forward_train`` (logits and the MoE aux loss),
``prefill`` of right-padded rows then two decodes, an ``extend`` with
per-row lengths and ``verify_step``, within 1e-4 (f32 sums in another
order), for qwen2-moe, granite-moe, mixtral, jamba (one super-block),
internlm2, qwen2.5 (its qkv bias, live in the logits), starcoder2 and
gemma2-class (head_dim 256, every layer windowed, tied embeddings). On
the CPU in fp32 at the ``reduced`` width, the JAX package's weights
crossed through ``repro_torch.bridge``, numpy inputs from a seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.model import build  # noqa: E402

torch.set_num_threads(1)

#: logits and losses of a whole model (f32 sums in another order), and
#: the aux loss (one route's)
LOGIT_TOL = 1e-4
ROUTE_TOL = 1e-5
NEW = ["qwen2-moe-a2.7b", "granite-moe-3b-a800m", "mixtral-8x7b",
       "jamba-1.5-large-398b", "internlm2-20b", "qwen2.5-14b",
       "starcoder2-15b", "gemma2-9b-class"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


_PAIRS = {}


def _pair(arch):
    if arch not in _PAIRS:
        jc = jax_get_arch(arch, variant="reduced")
        tc = get_arch(arch, variant="reduced")
        jm, tm = jax_build(jc), build(tc, device="cpu")
        jp = jm.init(jax.random.PRNGKey(0))
        tp = bridge.params_from_jax(_np(jp), tc, "cpu")
        _PAIRS[arch] = (jc, jm, jp, tc, tm, tp)
    return _PAIRS[arch]


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


@pytest.mark.parametrize("arch", NEW)
def test_model_modes_match_jax(arch):
    jc, jm, jp, tc, tm, tp = _pair(arch)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tc.vocab, (2, 12)).astype(np.int32)
    t = torch.from_numpy(toks).long()

    # the cache-free forward (MoE: capacity dispatch), logits and aux
    jl, ja = jax.jit(lambda p, x: JT.forward_train(p, jc, x))(jp, toks)
    tl, ta = TT.forward_train(tp, tc, t)
    _close(tl, jl)
    _close(ta, ja, ROUTE_TOL)
    if tc.moe is not None:
        assert float(ta) > 0

    # prefill of right-padded rows, then two decodes
    length = np.array([12, 7], np.int32)
    jcache = jm.make_cache(2, 32)
    jlo, jcache = jax.jit(jm.prefill)(jp, {"tokens": toks,
                                           "length": length}, jcache)
    tcache = tm.make_cache(2, 32)
    tlo, _ = tm.prefill(tp, {"tokens": t, "length": torch.from_numpy(
        length)}, tcache)
    _close(tlo, jlo)
    jdec = jax.jit(jm.decode_step)
    for i in range(2):
        nxt = rng.integers(0, tc.vocab, (2, 1)).astype(np.int32)
        jlo, jcache = jdec(jp, nxt, jcache)
        tlo, _ = tm.decode_step(tp, torch.from_numpy(nxt).long(), tcache)
        _close(tlo, jlo)

    # an extend with per-row lengths (a chunk and a short row), then the
    # verify window
    ext = rng.integers(0, tc.vocab, (2, 5)).astype(np.int32)
    lens = np.array([5, 2], np.int32)
    jlo, jcache = jax.jit(jm.extend_into_cache)(jp, ext, jcache, lens)
    tlo, _ = tm.extend_into_cache(tp, torch.from_numpy(ext).long(), tcache,
                                  torch.from_numpy(lens))
    for b, n in enumerate(lens):
        _close(tlo[b, :n], np.asarray(jlo)[b, :n])
    ver = rng.integers(0, tc.vocab, (2, 4)).astype(np.int32)
    jlo, jcache = jax.jit(jm.verify_step)(jp, ver, jcache)
    tlo, _ = tm.verify_step(tp, torch.from_numpy(ver).long(), tcache)
    _close(tlo, jlo)
    assert TT.cache_steps(tcache).tolist() == \
        np.asarray(jm.cache_steps(jcache)).tolist()


def test_qkv_bias_is_live():
    """qwen2.5's q/k/v biases reach the logits: zeroing them moves the
    output, in the port as in JAX."""
    jc, jm, jp, tc, tm, tp = _pair("qwen2.5-14b")
    assert "b" in tp["blocks"]["sub0"]["attn"]["wq"]
    toks = np.random.default_rng(4).integers(0, tc.vocab, (1, 6))
    t = torch.from_numpy(toks).long()
    bumped = jax.tree.map(lambda a: a, tp)
    for k in ("wq", "wk", "wv"):
        bumped["blocks"]["sub0"]["attn"][k] = dict(
            bumped["blocks"]["sub0"]["attn"][k],
            b=torch.full_like(tp["blocks"]["sub0"]["attn"][k]["b"], 0.5))
    a, _ = TT.forward_train(tp, tc, t)
    b, _ = TT.forward_train(bumped, tc, t)
    assert (a - b).abs().max() > 1e-3
