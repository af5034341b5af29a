"""The PyTorch port's serving engine against the JAX package's.

The same requests go through the JAX ``Engine`` and the port's
``Engine`` on the CPU (same weights through ``repro_torch.bridge``,
greedy sampling): the token streams and finish reasons are identical,
with chunked admission as the whole prompt (``prefill_chunk=0``) and in
chunks of 8, more requests than slots, an EOS finish and a one-token
request. Also: speculation's argument errors raise as JAX's, the paged
pool on a mesh (item 13b) raises, the NaN guard, the samplers' distributions, and the serve CLI. The engine
lifecycle (cancel, deadlines, priorities, faults, tracing) is held
against the JAX engine in ``tests/test_torch_lifecycle.py``.
"""
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
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving.engine import ERR_TOKEN, Engine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.serving.sampler import Sampler  # noqa: E402


def _models():
    jc = jax_get_arch("llama3.2-1b", variant="reduced").replace(n_kv_heads=2)
    tc = get_arch("llama3.2-1b", variant="reduced").replace(n_kv_heads=2)
    jm, tm = jax_build(jc), build(tc, device="cpu")
    # weights scaled up so greedy streams of the random model vary
    jp = jax.tree.map(lambda a: a * 8 if a.ndim >= 2 else a,
                      jm.init(jax.random.PRNGKey(0)))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jm, jp, tm, tp


_JM, _JP, _TM, _TP = _models()


def _greedy_continuation(prompt, n):
    """The port's own greedy continuation of one prompt (to pick an EOS
    id the stream really reaches)."""
    cache = _TM.make_cache(1, 48)
    logits, _ = _TM.extend_into_cache(_TP, torch.tensor(prompt)[None],
                                      cache)
    out = [int(logits[0, -1].argmax())]
    for _ in range(n - 1):
        logits, _ = _TM.decode_step(_TP, torch.tensor([[out[-1]]]), cache)
        out.append(int(logits[0, -1].argmax()))
    return out


def _requests():
    rng = np.random.default_rng(1)
    specs = [(5, 6), (17, 4), (9, 1), (30, 7), (3, 5), (12, 9)]
    reqs = [(uid, rng.integers(0, 1024, L), mx, None)
            for uid, (L, mx) in enumerate(specs)]
    # request 5 stops at its 4th greedy token
    uid, prompt, mx, _ = reqs[5]
    stream = _greedy_continuation(prompt, mx)
    eos = stream[3]
    assert eos not in stream[:3]
    reqs[5] = (uid, prompt, mx, eos)
    return reqs


@pytest.mark.parametrize("chunk", [0, 8])
def test_engine_matches_jax_engine(chunk):
    reqs = _requests()
    je = JaxEngine(_JM, _JP, max_batch=2, cache_len=48, sampler=JaxSampler(),
                   prefill_chunk=chunk)
    te = Engine(_TM, _TP, max_batch=2, cache_len=48, prefill_chunk=chunk)
    for uid, prompt, mx, eos in reqs:
        je.submit(JaxRequest(uid=uid, prompt=prompt, max_new_tokens=mx,
                             eos_id=eos))
        te.submit(Request(uid=uid, prompt=prompt, max_new_tokens=mx,
                          eos_id=eos))
    jr, tr = je.run(), te.run()
    assert sorted(tr) == sorted(jr)
    for uid in jr:
        assert tr[uid].tokens == jr[uid].tokens, uid
        assert tr[uid].finish_reason == jr[uid].finish_reason, uid
    assert tr[5].finish_reason == "eos" and tr[2].tokens and \
        len(tr[2].tokens) == 1
    assert len(set(tr[3].tokens)) > 1
    st = te.latency_stats()
    assert st["n_finished"] == len(reqs)
    assert st["chunked_admissions"] == len(reqs)
    assert st["prefill_chunk"] == (chunk or 48)
    assert {"plain", "mixed"} <= set(te.step_kinds)


def test_slot_reset_leaves_no_stale_keys():
    """A recycled slot's position row is rewritten to -1 and its depth to
    0 before the next admission writes it."""
    te = Engine(_TM, _TP, max_batch=1, cache_len=48, prefill_chunk=8)
    te.submit(Request(uid=0, prompt=np.arange(20), max_new_tokens=2))
    te.run()
    te._start_chunked(Request(uid=1, prompt=np.arange(3)), 0)
    for sub in te.cache.values():
        assert bool((sub["pos"][:, 0] == -1).all())
        assert bool((sub["step"][:, 0] == 0).all())


@pytest.mark.parametrize("arch,kw,exc,match", [
    ("llama3.2-1b", {"spec_gamma": 2}, ValueError, "no draft"),
    ("mamba2-780m", {"draft": "fp@1", "spec_gamma": 2}, ValueError,
     "ngram"),
    ("llama3.2-1b", {"mesh": "paged"}, NotImplementedError, "13b"),
], ids=["gamma_without_draft", "model_draft_on_ssm", "mesh"])
def test_out_of_slice_arguments_raise(arch, kw, exc, match):
    """Speculation's argument errors raise as the JAX engine's do (a
    gamma with no draft; a model draft on a stack that needs replay);
    the paged pool on a mesh, whose port waits for item 13b, raises
    naming it."""
    if kw.get("mesh") == "paged":
        from repro_torch.launch.mesh import Mesh
        kw = {"mesh": Mesh((1, 1)), "paged": True, "page_size": 8}
    if arch == "llama3.2-1b":
        tm, tp = _TM, _TP
    else:
        tm = build(get_arch(arch, variant="reduced"), device="cpu")
        tp = tm.init(0)
    if exc is ValueError:
        jm = jax_build(jax_get_arch(arch, variant="reduced"))
        with pytest.raises(exc, match=match):
            JaxEngine(jm, jm.init(jax.random.PRNGKey(0)), max_batch=2,
                      cache_len=48, **kw)
    with pytest.raises(exc, match=match):
        Engine(tm, tp, max_batch=2, cache_len=48, **kw)


@pytest.mark.parametrize("req,match", [
    (dict(prompt=np.array([], np.int64)), "non-empty"),
    (dict(prompt=np.array([1.5, 2.0])), "integer"),
    (dict(prompt=np.arange(3), max_new_tokens=0), "positive"),
    (dict(prompt=np.arange(60)), "KV capacity"),
])
def test_submit_validates(req, match):
    te = Engine(_TM, _TP, max_batch=2, cache_len=48)
    with pytest.raises(ValueError, match=match):
        te.submit(Request(uid=0, **req))


def test_nan_guard_contains_the_poisoned_row(monkeypatch):
    """A row with non-finite logits emits ERR_TOKEN and finishes with
    "error"; the other rows sample exactly as without the guard."""
    logits = torch.randn(3, 11, generator=torch.Generator().manual_seed(0))
    logits[1, 4] = float("nan")
    nxt, bad = engine_mod._guarded_sample(Sampler(), None, logits)
    assert bad.tolist() == [False, True, False]
    assert nxt[1].item() == ERR_TOKEN
    assert nxt[[0, 2]].tolist() == logits[[0, 2]].argmax(-1).tolist()

    real = engine_mod._guarded_sample

    def poisoned(sampler, gen, lg):
        lg = lg.clone()
        lg[0] = float("nan")
        return real(sampler, gen, lg)
    monkeypatch.setattr(engine_mod, "_guarded_sample", poisoned)
    te = Engine(_TM, _TP, max_batch=2, cache_len=48, prefill_chunk=8)
    te.submit(Request(uid=0, prompt=np.arange(5), max_new_tokens=4))
    out = te.run()
    assert out[0].finished and out[0].finish_reason == "error"
    assert out[0].tokens == []
    assert te.latency_stats()["slot_errors"] == 1


def _freqs(sampler, logits, n=20000, seed=0):
    gen = torch.Generator().manual_seed(seed)
    draws = sampler(gen, logits.expand(n, -1))
    return np.bincount(draws.numpy(), minlength=logits.shape[-1]) / n


def test_sampler_distributions():
    """Stochastic sampling cannot match jax.random's bits; it matches the
    distribution the JAX sampler draws from."""
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, -3.0]])
    p = torch.softmax(logits / 0.7, -1)[0].numpy()
    np.testing.assert_allclose(_freqs(Sampler(temperature=0.7), logits), p,
                               atol=0.015)
    top2 = _freqs(Sampler(temperature=1.0, top_k=2), logits)
    assert top2[2:].sum() == 0
    q = torch.softmax(logits[0, :2], -1).numpy()
    np.testing.assert_allclose(top2[:2], q, atol=0.015)
    nuc = _freqs(Sampler(temperature=1.0, top_p=0.6), logits)
    full = torch.softmax(logits, -1)[0].numpy()
    keep = (np.cumsum(full) - full) < 0.6
    assert nuc[~keep].sum() == 0
    np.testing.assert_allclose(nuc[keep], full[keep] / full[keep].sum(),
                               atol=0.015)
    greedy = Sampler()(None, logits.expand(3, -1))
    assert greedy.tolist() == [0, 0, 0]


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch import serve
    responses, stats = serve.main([
        "--arch", "llama3.2-1b", "--variant", "reduced", "--device", "cpu",
        "--requests", "8", "--max-new", "12", "--max-batch", "4",
        "--cache-len", "64", "--prefill-chunk", "8", "--temperature", "0"])
    out = capsys.readouterr().out
    assert "ttft ms" in out and "itl ms" in out and "tokens=96" in out
    assert stats["n_finished"] == 8
    assert all(r.finish_reason == "length" and len(r.tokens) == 12
               for r in responses.values())


def test_serve_cli_requires_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the default device works")
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="CUDA device is required"):
        serve.main(["--requests", "1"])
