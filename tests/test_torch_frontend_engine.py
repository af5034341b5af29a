"""The port's engine on the frontend families against the JAX engine:
pixtral-12b's embedding prefix and seamless-m4t-medium's encoded
memory, served on KV rings.

On the CPU in fp32 at the ``reduced`` width (16 frontend tokens of 64
dims), the JAX package's weights scaled by 8 (so the random models'
greedy streams vary) and crossed through ``repro_torch.bridge``; frames
(16, 64) and prompts from a numpy seed; 2 slots, a 64-token cache:

* greedy tokens equal JAX's, whole and in chunks of 8, with three
  requests on two slots (the third reuses a slot: its reset zeroes the
  memory rows or re-runs the prefix);
* slot 0's cache after one admission equals JAX's leaf for leaf (on the
  unscaled weights, whose caches are not chaotic: floats within 1e-5,
  positions and depths exact), compared with JAX directly (JAX's own
  chunked-against-whole cache test is red for seamless);
* every rejection of an embeddings request raises as JAX's does, with
  its error type and text: an encoder-decoder request without frames,
  frames on a frontend-less stack, frames of the wrong shape, frames on
  the paged pool, a VLM prompt past ``kv_len - n_tokens``, a model
  draft on an encoder-decoder;
* n-gram speculation on seamless (tokens = the plain engine's = JAX's),
  the ``spec`` variant on pixtral (its int8 self-draft takes the
  embedding chunk too: tokens = JAX's spec engine's);
* an embeddings request leaves the prefix cache's stats as JAX's leave
  them (the ``continuous`` variant: no lookup, no publication);
* a priority displacement preempts an embeddings request, which
  resumes (its frames re-encoded, its prefix re-run) with JAX's tokens;
* the serve CLI draws frames in the JAX CLI's order and passes them on,
  so its streams equal a JAX engine's fed the same draws.
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
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

torch.set_num_threads(1)

ARCHS = ["pixtral-12b", "seamless-m4t-medium"]
PIXTRAL, SEAMLESS = ARCHS
CACHE_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _models(arch, variant="reduced", scale=8.0):
    jc = jax_get_arch(arch, variant=variant)
    tc = get_arch(arch, variant=variant)
    jm, tm = jax_build(jc), build(tc, device="cpu")
    jp = jax.tree.map(lambda a: a * scale if a.ndim >= 2 else a,
                      jm.init(jax.random.PRNGKey(0)))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jm, jp, tm, tp


def _requests(cfg, lengths=(3, 11, 17), seed=1):
    rng = np.random.default_rng(seed)
    fe = cfg.frontend
    out = []
    for L in lengths:
        emb = rng.normal(0, 1, (fe.n_tokens, fe.d_embed)).astype(np.float32)
        out.append((rng.integers(0, cfg.vocab, L), emb))
    return out


def _engine(side, arch, variant="reduced", scale=8.0, **kw):
    jm, jp, tm, tp = _models(arch, variant, scale)
    kw = {"max_batch": 2, "cache_len": 64, **kw}
    if side == "jax":
        return JaxEngine(jm, jp, sampler=JaxSampler(), **kw), JaxRequest
    return Engine(tm, tp, **kw), Request


def _serve(side, arch, variant="reduced", max_new=6, **kw):
    e, R = _engine(side, arch, variant, **kw)
    for uid, (prompt, emb) in enumerate(_requests(e.model.cfg)):
        e.submit(R(uid=uid, prompt=prompt, max_new_tokens=max_new,
                   embeddings=emb))
    resp = e.run()
    return {u: list(r.tokens) for u, r in resp.items()}, e


@pytest.mark.parametrize("chunk", [None, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax(arch, chunk):
    want, _ = _serve("jax", arch, prefill_chunk=chunk)
    got, e = _serve("torch", arch, prefill_chunk=chunk)
    assert got == want
    assert len({t for ts in got.values() for t in ts}) > 3
    st = e.latency_stats()
    assert st["chunked_admissions"] == 3 and st["fallback_admissions"] == 0
    assert e.program_cache_sizes()["mixed"] <= 2


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_cache_after_one_admission_matches_jax(arch):
    caches = []
    for side in ("jax", "torch"):
        e, R = _engine(side, arch, scale=1.0, prefill_chunk=8)
        prompt, emb = _requests(e.model.cfg, lengths=(13,))[0]
        e.submit(R(uid=0, prompt=prompt, max_new_tokens=1, embeddings=emb))
        e.run()
        caches.append(e.cache)
    jcache, tcache = caches
    want = jax.tree.map(lambda a: np.asarray(a)[:, 0], jcache)
    got = jax.tree.map(lambda a: a[:, 0],
                       bridge.cache_to_numpy(tcache))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=CACHE_TOL, rtol=0)
    # the prompt (behind the prefix) is in; plain steps after the finish
    # advance the idle row until the poll, in both engines alike
    pos = want["self"]["pos"] if arch == SEAMLESS else want["sub0"]["pos"]
    assert (pos[0, :13 + (16 if arch == PIXTRAL else 0)] >= 0).all()


def _raises_as_jax(make, submit_kw, match=None):
    """``make(side)`` -> (engine, Request class); the request built from
    ``submit_kw`` must raise the same error type with the same text on
    both sides."""
    errs = []
    for side in ("jax", "torch"):
        e, R = make(side)
        with pytest.raises(ValueError) as info:
            e.submit(R(**submit_kw))
        errs.append(str(info.value))
    assert errs[0] == errs[1]
    if match:
        assert match in errs[1]


def test_encdec_request_without_frames_raises_as_jax():
    _raises_as_jax(lambda s: _engine(s, SEAMLESS),
                   dict(uid=0, prompt=np.arange(4), max_new_tokens=2),
                   "embeddings")


def test_frames_on_a_frontend_less_stack_raise_as_jax():
    def make(side):
        jc = jax_get_arch("llama3.2-1b", variant="reduced")
        if side == "jax":
            jm = jax_build(jc)
            return JaxEngine(jm, jm.init(jax.random.PRNGKey(0)),
                             max_batch=2, cache_len=32), JaxRequest
        tm = build(get_arch("llama3.2-1b", variant="reduced"), "cpu")
        return Engine(tm, tm.init(0), max_batch=2, cache_len=32), Request

    _raises_as_jax(make, dict(uid=0, prompt=np.arange(4), max_new_tokens=2,
                              embeddings=np.zeros((16, 64), np.float32)),
                   "no frontend")


@pytest.mark.parametrize("arch", ARCHS)
def test_frames_of_the_wrong_shape_raise_as_jax(arch):
    _raises_as_jax(lambda s: _engine(s, arch),
                   dict(uid=0, prompt=np.arange(4), max_new_tokens=2,
                        embeddings=np.zeros((15, 64), np.float32)),
                   "(16, 64)")


def test_frames_on_the_paged_pool_raise_as_jax():
    _raises_as_jax(
        lambda s: _engine(s, PIXTRAL, paged=True, page_size=8),
        dict(uid=0, prompt=np.arange(4), max_new_tokens=2,
             embeddings=np.zeros((16, 64), np.float32)),
        "token-only")


def test_vlm_prompt_past_the_prefix_capacity_raises_as_jax():
    """A VLM prompt may take ``kv_len - n_tokens`` tokens: 48 fit a
    64-token ring behind the 16-token prefix, 49 do not."""
    emb = np.zeros((16, 64), np.float32)
    _raises_as_jax(lambda s: _engine(s, PIXTRAL),
                   dict(uid=0, prompt=np.arange(49), max_new_tokens=2,
                        embeddings=emb), "16-token frontend prefix")
    e, R = _engine("torch", PIXTRAL)
    e.submit(R(uid=0, prompt=np.arange(48), max_new_tokens=2,
               embeddings=emb))


def test_model_draft_on_encdec_raises_as_jax():
    """A model draft on an encoder-decoder raises ``ValueError`` naming the
    n-gram drafter: given as a (model, params) pair, with JAX's text; as
    a self-draft spec both raise earlier, in their self-draft's
    ``block_spec`` ("unknown family encdec")."""
    jm, jp, tm, tp = _models(SEAMLESS)
    errs = []
    for side, pair in (("jax", (jm, jp)), ("torch", (tm, tp))):
        with pytest.raises(ValueError) as info:
            _engine(side, SEAMLESS, draft=pair, spec_gamma=2)
        errs.append(str(info.value))
    assert errs[0] == errs[1] and "ngram" in errs[1]
    for side in ("jax", "torch"):
        with pytest.raises(ValueError):
            _engine(side, SEAMLESS, draft="int8")


def test_ngram_speculation_on_encdec_matches_plain_and_jax():
    plain, _ = _serve("torch", SEAMLESS, max_new=8, prefill_chunk=8)
    want, _ = _serve("jax", SEAMLESS, max_new=8, prefill_chunk=8,
                     draft="ngram", spec_gamma=3)
    got, e = _serve("torch", SEAMLESS, max_new=8, prefill_chunk=8,
                    draft="ngram", spec_gamma=3)
    assert got == want == plain
    assert e.spec_gamma == 3 and "spec" in e.step_kinds


def test_spec_variant_on_vlm_matches_jax():
    """pixtral's ``spec`` variant: an int8 self-draft of half the blocks
    at gamma 4, whose cache also takes the embedding chunk."""
    want, je = _serve("jax", PIXTRAL, "reduced+spec", max_new=8,
                      prefill_chunk=8)
    got, e = _serve("torch", PIXTRAL, "reduced+spec", max_new=8,
                    prefill_chunk=8)
    assert e._draft_model is not None and e.spec_gamma == 4
    assert got == want
    st, jst = e.latency_stats(), je.latency_stats()
    assert st["spec_acceptance_rate"] == jst["spec_acceptance_rate"]


def test_embeddings_skip_the_prefix_cache_as_jax():
    """The ``continuous`` variant: two requests with one prompt and other
    frames, then the same prompt token-only twice. Neither embeddings
    request looks up or publishes (JAX: the token stream alone does not
    key a slot that holds a frontend prefix); the stats and tokens are
    JAX's."""
    outs, stats = [], []
    for side in ("jax", "torch"):
        e, R = _engine(side, PIXTRAL, "reduced+continuous", max_batch=2,
                       prefill_chunk=8)
        assert e.prefix_cache is not None
        (prompt, emb_a), (_, emb_b) = _requests(e.model.cfg,
                                                lengths=(20, 20))
        e.submit(R(uid=0, prompt=prompt, max_new_tokens=4,
                   embeddings=emb_a))
        e.submit(R(uid=1, prompt=prompt, max_new_tokens=4,
                   embeddings=emb_b))
        e.run()
        mid = {k: v for k, v in e.latency_stats().items()
               if k.startswith("prefix_")}
        e.submit(R(uid=2, prompt=prompt, max_new_tokens=4))
        e.run()
        e.submit(R(uid=3, prompt=prompt, max_new_tokens=4))
        resp = e.run()
        outs.append({u: list(r.tokens) for u, r in resp.items()})
        stats.append((mid, {k: v for k, v in e.latency_stats().items()
                            if k.startswith("prefix_")}))
    assert outs[1] == outs[0]
    assert stats[1] == stats[0]
    mid, end = stats[1]
    assert mid["prefix_hits"] == 0 and mid["prefix_entries"] == 0
    assert end["prefix_hits"] == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_priority_displacement_of_an_embeddings_request(arch):
    """Two priority-0 embeddings requests fill both slots; a priority-5
    one displaces the request with the most slack, which resumes by
    replay (its frames re-encoded, or its prefix re-run, on
    re-admission) with the tokens of JAX's run."""
    outs = []
    for side in ("jax", "torch"):
        e, R = _engine(side, arch, prefill_chunk=8)
        reqs = _requests(e.model.cfg, lengths=(5, 9, 4), seed=3)
        e.submit(R(uid=0, prompt=reqs[0][0], max_new_tokens=12,
                   embeddings=reqs[0][1], deadline_s=1e3))
        e.submit(R(uid=1, prompt=reqs[1][0], max_new_tokens=12,
                   embeddings=reqs[1][1]))
        for _ in range(3):
            e.tick(2)
        e.submit(R(uid=2, prompt=reqs[2][0], max_new_tokens=4,
                   embeddings=reqs[2][1], priority=5))
        resp = e.run()
        assert e.requests[1].preemptions == 1
        assert e.latency_stats()["preemptions"] == 1
        outs.append({u: (list(r.tokens), r.finish_reason)
                     for u, r in resp.items()})
    assert outs[1] == outs[0]
    assert all(r == "length" for _, r in outs[1].values())


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_draws_frames_as_jax(arch, capsys):
    """``--device cpu`` serve CLI: the seed's draws in the JAX CLI's
    order (length, frames, prompt), the frames passed on each request;
    its streams equal a JAX engine's fed the same draws on the same
    seed-0 weights (the port's own init, crossed to JAX)."""
    tm = build(get_arch(arch, variant="reduced"), "cpu")
    tp = tm.init(0)
    jm = jax_build(jax_get_arch(arch, variant="reduced"))
    jp = jax.tree.map(np.asarray, bridge.params_to_numpy(tp))
    args = ["--arch", arch, "--variant", "reduced", "--device", "cpu",
            "--requests", "3", "--max-new", "5", "--max-batch", "2",
            "--cache-len", "64", "--prefill-chunk", "8", "--temperature",
            "0"]
    orig = Engine.__init__

    def seeded(self, model, params, **kw):   # the CLI's model, tp's weights
        orig(self, model, tp, **kw)

    Engine.__init__ = seeded
    try:
        responses, _ = serve_cli.main(args)
    finally:
        Engine.__init__ = orig
    assert "ok=3/3" in capsys.readouterr().out
    got = {u: list(r.tokens) for u, r in responses.items()}
    je = JaxEngine(jm, jp, max_batch=2, cache_len=64, prefill_chunk=8,
                   sampler=JaxSampler())
    rng = np.random.default_rng(0)
    fe = jm.cfg.frontend
    for uid in range(3):
        L = int(rng.integers(max(2, 16 // 2), 16 + 1))
        emb = rng.normal(0, 1, (fe.n_tokens, fe.d_embed)).astype(np.float32)
        je.submit(JaxRequest(uid=uid, prompt=rng.integers(0, jm.cfg.vocab, L),
                             max_new_tokens=5, embeddings=emb))
    want = {u: list(r.tokens) for u, r in je.run().items()}
    assert got == want
