"""The PyTorch port's speculative decoding against the JAX package's.

On the CPU, at reduced width (llama3.2-1b with 2 KV heads and
mamba2-780m, two layers each), with the same weights on both sides
(``repro_torch.bridge``), greedy unless said:

* ``ngram_propose``: proposals and one-hot logits bitwise equal to JAX's
  on random histories and on the edges (an empty and a one-token
  history, a match at the end, the -1 fill);
* ``Sampler``: the greedy accept rule gives JAX's ``(block, n_acc)``;
  identical distributions accept every proposal; ``filtered_logits``
  equals JAX's within 1e-6, ties at the k-th value included (``_topk``
  keeps the lowest index, as ``lax.top_k`` does); the stochastic rule's
  first token is distributed as the target's p (seeded draws, within
  five standard errors);
* the model: ``verify_step`` equals sequential decodes (2e-5) and
  JAX's verify (1e-4), a rollback then a decode equals a clean cache
  (2e-5) and JAX's rolled-back one (1e-4; mamba2 by checkpoint restore
  and replay);
* ``parse_draft_spec`` raises as JAX's does; ``make_self_draft`` copies
  no float weight (``data_ptr`` equality);
* the engine, for the ``fp@1``, ``int8@1``, ``int8`` and ``ngram``
  drafts on rings and on the pool: spec tokens equal the port's plain
  tokens and JAX's spec tokens, with JAX's step kinds, tokens a step and
  acceptance rate; EOS inside the window, ``max_new_tokens`` inside it,
  int8 KV, the n-gram drafter on repetitive vocab-8 streams (mamba2's
  replay), the ``spec`` mode of chaos, cancel and ``nan_logits`` against
  the JAX engine; the serve CLI's ``--draft`` and ``--spec-gamma`` on
  ``--device cpu``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro.quant.self_draft import parse_draft_spec as jax_parse  # noqa: E402
from repro.serving import faults as jax_faults  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.ngram_draft import ngram_propose as jax_propose  # noqa: E402,E501
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro.serving.sampler import Sampler as JaxSampler  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.quant.self_draft import (make_self_draft,  # noqa: E402
                                          parse_draft_spec)
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.ngram_draft import ngram_propose  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.serving.sampler import Sampler  # noqa: E402

#: logits of one port forward path against another (the JAX spec tests'
#: tolerance), and against the JAX model's (tests/test_torch_model.py's
#: LOGIT_TOL: f32 sums in another order)
TOL = 2e-5
JAX_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _models(arch="llama3.2-1b", vocab=0, scale=8.0):
    """(JAX model, JAX params, port model, port params): the same
    weights, the matrices scaled by ``scale`` so greedy streams of the
    random model vary."""
    jc = jax_get_arch(arch, variant="reduced")
    tc = get_arch(arch, variant="reduced")
    if arch == "llama3.2-1b":
        jc, tc = jc.replace(n_kv_heads=2), tc.replace(n_kv_heads=2)
    if vocab:
        jc, tc = jc.replace(vocab=vocab), tc.replace(vocab=vocab)
    jm, tm = jax_build(jc), build(tc, device="cpu")
    jp = jax.tree.map(lambda a: a * scale if a.ndim >= 2 else a,
                      jm.init(jax.random.PRNGKey(0)))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jm, jp, tm, tp


_RNG = np.random.default_rng(11)
#: the JAX spec tests' prompt lengths: the 1-token prompt is the draft's
#: empty admission (d_len 0); max_new 10 at gamma 4 ends mid-window
_PROMPTS = [_RNG.integers(0, 1024, L) for L in (1, 3, 9, 17)]
#: the chaos schedule of the port's lifecycle tests
CHAOS = "nan_logits@6/1,page_alloc@9x2,slow_step@4+0.002"


def _engine(side, model_key=("llama3.2-1b",), **kw):
    jm, jp, tm, tp = _models(*model_key)
    kw.setdefault("max_batch", 2)
    kw.setdefault("cache_len", 64)
    if side == "jax":
        if isinstance(kw.get("faults"), str):
            kw["faults"] = jax_faults.Faults.parse(kw["faults"])
        return JaxEngine(jm, jp, sampler=JaxSampler(), **kw), JaxRequest
    return Engine(tm, tp, **kw), Request


def _serve(side, prompts=None, max_new=10, model_key=("llama3.2-1b",),
           eos=None, **kw):
    """Serve ``prompts`` on one side; returns ({uid: (tokens, finish
    reason)}, the engine)."""
    prompts = _PROMPTS if prompts is None else prompts
    e, R = _engine(side, model_key, **kw)
    for uid, p in enumerate(prompts):
        e.submit(R(uid=uid, prompt=p, max_new_tokens=max_new, eos_id=eos))
    resp = e.run()
    return {u: (list(r.tokens), r.finish_reason)
            for u, r in resp.items()}, e


@functools.lru_cache(maxsize=None)
def _plain(paged=False, max_new=10, model_key=("llama3.2-1b",)):
    kw = dict(paged=True, page_size=8) if paged else {}
    return _serve("torch", max_new=max_new, model_key=model_key, **kw)[0]


def _spec_stats(engine):
    st = engine.latency_stats()
    return {k: st[k] for k in ("spec_gamma", "spec_tokens_per_step",
                               "spec_acceptance_rate", "decode_steps")}


# --------------------------------------------------------------------- #
# the n-gram drafter
# --------------------------------------------------------------------- #
def _history(case):
    rng = np.random.default_rng(3)
    B, H = 4, 24
    hist = np.full((B, H), -1, np.int32)
    if case == "random":
        lens = np.array([24, 17, 9, 2])
        for b, n in enumerate(lens):
            hist[b, :n] = rng.integers(0, 4, n)   # a small vocab repeats
    elif case == "empty_and_one":
        lens = np.array([0, 1, 0, 1])
        hist[1, 0], hist[3, 0] = 5, 2
    elif case == "match_at_end":
        # the context's most recent earlier match has no continuation
        # left but the context itself: proposals clamp to the last token
        lens = np.array([6, 6, 5, 7])
        hist[0, :6] = [1, 2, 3, 9, 2, 3]
        hist[1, :6] = [7, 7, 7, 7, 7, 7]
        hist[2, :5] = [4, 5, 4, 5, 4]
        hist[3, :7] = [1, 2, 3, 1, 2, 3, 1]
    else:                                        # "fill": -1 in the window
        lens = np.array([3, 4, 2, 5])
        for b, n in enumerate(lens):
            hist[b, :n] = rng.integers(0, 3, n)
    return hist, lens.astype(np.int32)


@pytest.mark.parametrize("case", ["random", "empty_and_one",
                                  "match_at_end", "fill"])
@pytest.mark.parametrize("gamma", [1, 4])
def test_ngram_propose_matches_jax(case, gamma):
    hist, lens = _history(case)
    jt, jl = jax_propose(jnp.asarray(hist), jnp.asarray(lens), gamma=gamma,
                         vocab=11)
    tt, tl = ngram_propose(torch.from_numpy(hist), torch.from_numpy(lens),
                           gamma=gamma, vocab=11)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tl.dtype == torch.float32


def test_ngram_propose_examples():
    """The most recent match of the longest context wins; no match
    repeats the last token."""
    hist = torch.tensor([[1, 2, 3, 1, 2, 3, 4, 1, 2, -1],
                         [5, 6, 7, 8, -1, -1, -1, -1, -1, -1]])
    toks, _ = ngram_propose(hist, torch.tensor([9, 4]), gamma=3, vocab=9)
    # row 0: "1 2" last matched at 3 (then 3, 4, 1); row 1: no match
    assert toks.tolist() == [[3, 4, 1], [8, 8, 8]]


# --------------------------------------------------------------------- #
# the accept rule and the filtered distribution
# --------------------------------------------------------------------- #
def test_speculative_greedy_matches_jax():
    rng = np.random.default_rng(5)
    B, G, V = 6, 4, 13
    tgt = rng.normal(size=(B, G + 1, V)).astype(np.float32)
    draft = tgt[:, :G].argmax(-1).astype(np.int32)
    # row r diverges from the target's argmax at position r (none for
    # rows past G)
    for r in range(min(B, G)):
        draft[r, r] = (draft[r, r] + 1) % V
    dl = rng.normal(size=(B, G, V)).astype(np.float32)
    jb, jn = JaxSampler().speculative(jax.random.PRNGKey(0),
                                      jnp.asarray(draft), jnp.asarray(dl),
                                      jnp.asarray(tgt))
    tb, tn = Sampler().speculative(None, torch.from_numpy(draft),
                                   torch.from_numpy(dl),
                                   torch.from_numpy(tgt))
    assert tb.tolist() == np.asarray(jb).tolist()
    assert tn.tolist() == np.asarray(jn).tolist() == [0, 1, 2, 3, 4, 4]


def test_identical_distributions_accept_everything():
    """Stochastic rule: q == p, so p/q = 1 and every proposal is
    accepted, the bonus token appended."""
    logits = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (2, 4, 16)).astype(np.float32))
    gen = torch.Generator().manual_seed(1)
    for sampler in (Sampler(temperature=1.0),
                    Sampler(temperature=0.7, top_k=5)):
        draft = logits[:, :3].argmax(-1)
        block, n_acc = sampler.speculative(gen, draft, logits[:, :3],
                                           logits)
        assert n_acc.tolist() == [3, 3]
        assert torch.equal(block[:, :3], draft)


SAMPLERS = {
    "temperature": dict(temperature=0.7),
    "top_k_ties": dict(temperature=1.3, top_k=3),
    "top_p": dict(temperature=0.9, top_p=0.8),
    "top_p_top_k": dict(temperature=1.1, top_k=4, top_p=0.9),
}


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_filtered_logits_match_jax(name):
    """Within 1e-6 of JAX's (f32 division and softmax), ties at the
    k-th value included: the same k entries survive."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 2, 10)).astype(np.float32)
    x[0, 0, [1, 4, 7, 8]] = 5.0           # four-way tie around k = 3, 4
    x[1, 1, :] = 0.25                     # every entry tied
    want = np.asarray(JaxSampler(**SAMPLERS[name]).filtered_logits(
        jnp.asarray(x)))
    got = Sampler(**SAMPLERS[name]).filtered_logits(
        torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_topk_keeps_the_lowest_index_at_ties():
    s = Sampler(temperature=1.0, top_k=2)
    logits = torch.tensor([[0.0, 3.0, 1.0, 3.0, 3.0],
                           [2.0, 2.0, 2.0, 2.0, 2.0]])
    vals, idx = s._topk(logits)
    assert idx.tolist() == [[1, 3], [0, 1]]
    assert vals.tolist() == [[3.0, 3.0], [2.0, 2.0]]
    _, jidx = JaxSampler(temperature=1.0, top_k=2)._topk(
        jnp.asarray(logits.numpy()))
    assert np.asarray(jidx).tolist() == idx.tolist()
    # __call__ samples only among those k
    gen = torch.Generator().manual_seed(0)
    drawn = {int(t) for _ in range(50)
             for t in s(gen, logits.repeat(4, 1))[::2]}
    assert drawn <= {1, 3}


@pytest.mark.parametrize("name", ["temperature", "top_k_ties"])
def test_stochastic_first_token_is_distributed_as_p(name):
    """Every emitted token of the stochastic rule is a sample of the
    target's filtered distribution: the first one's frequencies over
    40000 seeded rows match p within five standard errors."""
    V, G, N = 6, 3, 40_000
    rng = np.random.default_rng(7)
    tgt = torch.from_numpy(rng.normal(size=(1, G + 1, V)).astype(
        np.float32)).expand(N, -1, -1)
    dl = torch.from_numpy(rng.normal(size=(1, G, V)).astype(
        np.float32)).expand(N, -1, -1)
    sampler = Sampler(**SAMPLERS[name])
    gen = torch.Generator().manual_seed(3)
    draft = sampler(gen, dl.reshape(-1, V)).reshape(N, G)
    block, _ = sampler.speculative(gen, draft, dl, tgt)
    p = torch.softmax(sampler.filtered_logits(tgt[0, 0]), -1).numpy()
    freq = np.bincount(block[:, 0].numpy(), minlength=V) / N
    se = np.sqrt(p * (1 - p) / N)
    assert np.all(np.abs(freq - p) <= 5 * se + 1e-12), (freq, p)


# --------------------------------------------------------------------- #
# the model: verify and rollback
# --------------------------------------------------------------------- #
def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def test_verify_step_matches_sequential_decode():
    jm, jp, tm, tp = _models()
    rng = np.random.default_rng(13)
    toks = rng.integers(0, 1024, (1, 8))
    seq = rng.integers(0, 1024, (1, 4))
    cache_a = tm.make_cache(1, 32)
    tm.prefill(tp, {"tokens": _t(toks)}, cache_a)
    lo_v, _ = tm.verify_step(tp, _t(seq), cache_a)
    cache_b = tm.make_cache(1, 32)
    tm.prefill(tp, {"tokens": _t(toks)}, cache_b)
    for i in range(4):
        lo_i, _ = tm.decode_step(tp, _t(seq[:, i:i + 1]), cache_b)
        np.testing.assert_allclose(lo_v[:, i].numpy(), lo_i[:, 0].numpy(),
                                   rtol=TOL, atol=TOL)
    assert tm.cache_steps(cache_a).tolist() == [12]
    jc = jm.make_cache(1, 32)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jc)
    jlo, _ = jm.verify_step(jp, jnp.asarray(seq, jnp.int32), jc)
    np.testing.assert_allclose(lo_v.numpy(), np.asarray(jlo), rtol=0,
                               atol=JAX_TOL)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-780m"])
def test_rollback_then_decode_matches_clean_cache_and_jax(arch):
    """Verify five speculated tokens, accept three: roll back (an
    attention stack to the accepted depth; an SSM stack to the
    pre-verify checkpoint, then replay the three), and a decode gives
    the clean cache's logits and JAX's, within 2e-5."""
    jm, jp, tm, tp = _models(arch)
    assert tm.supports_speculative
    assert tm.rollback_needs_replay == jm.rollback_needs_replay \
        == (arch == "mamba2-780m")
    rng = np.random.default_rng(17)
    toks = rng.integers(0, tm.cfg.vocab, (1, 8))
    junk = rng.integers(0, tm.cfg.vocab, (1, 5))
    nxt = np.asarray([[3]])

    def port(speculate):
        cache = tm.make_cache(1, 32)
        tm.prefill(tp, {"tokens": _t(toks)}, cache)
        if speculate:
            tm.verify_step(tp, _t(junk), cache)
            if tm.rollback_needs_replay:
                tm.rollback(cache, torch.tensor([8]))
                tm.extend_into_cache(tp, _t(junk[:, :3]), cache,
                                     torch.tensor([3], dtype=torch.int32),
                                     last_only=True)
            else:
                tm.rollback(cache, torch.tensor([11]))
        else:
            tm.extend_into_cache(tp, _t(junk[:, :3]), cache,
                                 torch.tensor([3], dtype=torch.int32),
                                 last_only=True)
        assert tm.cache_steps(cache).tolist() == [11]
        return tm.decode_step(tp, _t(nxt), cache)[0].numpy()

    jc = jm.make_cache(1, 32)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jc)
    _, jc = jm.verify_step(jp, jnp.asarray(junk, jnp.int32), jc)
    if jm.rollback_needs_replay:
        jc = jm.rollback(jc, jnp.asarray([8], jnp.int32))
        _, jc = jm.extend_into_cache(jp, jnp.asarray(junk[:, :3], jnp.int32),
                                     jc, jnp.asarray([3], jnp.int32),
                                     last_only=True)
    else:
        jc = jm.rollback(jc, jnp.asarray([11], jnp.int32))
    want, _ = jm.decode_step(jp, jnp.asarray(nxt, jnp.int32), jc)
    got, clean = port(True), port(False)
    np.testing.assert_allclose(got, clean, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=JAX_TOL)


# --------------------------------------------------------------------- #
# the self-draft
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("spec", ["int4@2", "fp", "int8@1", "int2@1",
                                  "ngram", "int8@0", "fp@x", ""])
def test_parse_draft_spec_matches_jax(spec):
    try:
        want = jax_parse(spec)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            parse_draft_spec(spec)
        assert str(got.value) == str(err)
    else:
        assert parse_draft_spec(spec) == want


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("spec", ["fp@1", "int8@1", "int4", "fp"])
def test_self_draft_copies_no_float_weight(spec):
    _, _, tm, tp = _models()
    dm, dp = make_self_draft(tm, tp, spec)
    target = dict(_leaves(tp))
    nb = 1 if "@" in spec else 2
    assert dm.cfg.n_layers == nb and dm.cfg.draft == ""
    for path, leaf in _leaves(dp):
        if len(path) >= 2 and path[-2] == "w":   # a QTensor leaf
            assert spec.startswith("int"), path
            continue
        base = target[path]
        assert leaf.data_ptr() == base.data_ptr(), path
        if path[0] == "blocks":
            assert leaf.shape[0] == nb and base.shape[0] == 2
    assert dp["embed"]["table"] is tp["embed"]["table"]


def test_spec_variant_matches_jax():
    for arch, variant in (("llama3.2-1b", "reduced+spec"),
                          ("llama3.2-1b", "spec"),
                          ("mamba2-780m", "spec")):
        got = get_arch(arch, variant=variant)
        want = jax_get_arch(arch, variant=variant)
        assert (got.name, got.draft, got.spec_gamma) \
            == (want.name, want.draft, want.spec_gamma)
    assert get_arch("llama3.2-1b", variant="spec").draft == "int8@8"


# --------------------------------------------------------------------- #
# the engine, against the port's plain engine and the JAX engine
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("paged", [False, True], ids=["rings", "pool"])
@pytest.mark.parametrize("draft", ["fp@1", "int8@1", "int8", "ngram"])
def test_greedy_spec_tokens_equal_plain_and_jax(draft, paged):
    kw = dict(draft=draft, spec_gamma=4)
    if paged:
        kw.update(paged=True, page_size=8)
    got, te = _serve("torch", **kw)
    want, je = _serve("jax", **kw)
    assert got == want
    assert got == _plain(paged)
    assert te.step_kinds == je.step_kinds
    assert set(te.step_kinds) == {"admit", "spec"}
    assert _spec_stats(te) == _spec_stats(je)
    assert te.program_cache_sizes()["step"] == 1
    assert set(te.program_cache_sizes()) == {"step", "admit_chunk"}
    if paged:
        assert te.latency_stats()["kv_pages_live"] == 0
        te._paged.check_invariants()


def test_rejections_are_exercised():
    """The one-block draft disagrees with the target on these streams:
    both the accept and the reject-resample paths run, and the tokens
    are still the plain engine's."""
    got, te = _serve("torch", max_new=24, draft="fp@1", spec_gamma=4)
    want, je = _serve("jax", max_new=24, draft="fp@1", spec_gamma=4)
    assert got == want == _plain(max_new=24)
    acc = te.latency_stats()["spec_acceptance_rate"]
    assert 0.0 < acc < 1.0
    assert _spec_stats(te) == _spec_stats(je)


@pytest.mark.parametrize("draft", ["int8@1", "ngram"])
def test_eos_inside_the_window(draft):
    first = _plain(max_new=12)[3][0]
    idx = next(i for i, t in enumerate(first) if i >= 2 and t not in first[:i])
    eos = int(first[idx])
    outs = []
    for side, kw in (("torch", {}), ("torch", dict(draft=draft)),
                     ("jax", dict(draft=draft))):
        out, _ = _serve(side, prompts=_PROMPTS[3:], max_new=12, eos=eos,
                        spec_gamma=4 if kw else 0, **kw)
        outs.append(out)
    assert outs[0] == outs[1] == outs[2]
    assert outs[1][0] == (first[:idx + 1], "eos")


@pytest.mark.parametrize("max_new", [2, 3, 6, 7])
def test_max_new_tokens_inside_the_window(max_new):
    got, _ = _serve("torch", prompts=_PROMPTS[:2], max_new=max_new,
                    draft="int8@1", spec_gamma=4)
    base, _ = _serve("torch", prompts=_PROMPTS[:2], max_new=max_new)
    assert got == base
    assert all(len(t) == max_new and r == "length"
               for t, r in got.values())
    if max_new == 7:
        want, _ = _serve("jax", prompts=_PROMPTS[:2], max_new=max_new,
                         draft="int8@1", spec_gamma=4)
        assert got == want


@pytest.mark.parametrize("draft", ["int8@1", "ngram"])
def test_spec_with_int8_kv_cache(draft):
    kw = dict(kv_cache_dtype="int8")
    got, te = _serve("torch", draft=draft, spec_gamma=4, **kw)
    want, je = _serve("jax", draft=draft, spec_gamma=4, **kw)
    base, _ = _serve("torch", **kw)
    assert got == want == base
    assert _spec_stats(te) == _spec_stats(je)


@pytest.mark.parametrize("arch,paged", [("mamba2-780m", False),
                                        ("llama3.2-1b", True)],
                         ids=["mamba2_replay", "llama_pool"])
def test_ngram_accepts_on_repetitive_streams(arch, paged):
    """A vocabulary of 8 makes the streams repeat, so the drafter's
    proposals are accepted: on mamba2 every spec step restores the
    pre-verify checkpoint and replays the accepted prefix. Tokens equal
    the plain engine's and JAX's, with fewer spec steps than tokens."""
    key = (arch, 8, 1.0)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 8, L) for L in (6, 13)]
    kw = dict(paged=True, page_size=8) if paged else {}
    base, _ = _serve("torch", prompts, 16, key, **kw)
    got, te = _serve("torch", prompts, 16, key, draft="ngram",
                     spec_gamma=3, **kw)
    want, je = _serve("jax", prompts, 16, key, draft="ngram",
                      spec_gamma=3, **kw)
    assert got == want == base
    st = _spec_stats(te)
    assert st == _spec_stats(je)
    assert st["spec_acceptance_rate"] > 0.0
    assert st["decode_steps"] < sum(len(t) - 1 for t, _ in base.values())


def test_model_draft_on_an_ssm_stack_raises_and_ngram_builds():
    _, _, tm, tp = _models("mamba2-780m")
    with pytest.raises(ValueError, match="ngram"):
        Engine(tm, tp, max_batch=1, cache_len=32, draft="fp@1",
               spec_gamma=2)
    e = Engine(tm, tp, max_batch=1, cache_len=32, draft="ngram",
               spec_gamma=2)
    assert e.spec_gamma == 2 and e.draft_cache is None
    assert e.prefix_cache is None
    with pytest.raises(ValueError, match="verify window"):
        Engine(tm, tp, max_batch=1, cache_len=4, draft="ngram",
               spec_gamma=4)


def test_spec_engine_builds_no_prefix_cache_and_polls_less():
    _, _, tm, tp = _models()
    e = Engine(tm, tp, max_batch=2, cache_len=64, draft="int8@1",
               prefix_cache_tokens=256, sync_every=8)
    assert e.spec_gamma == 4 and e.prefix_cache is None
    assert e.sync_every == 1
    assert "spec_gamma" not in Engine(tm, tp, max_batch=2,
                                      cache_len=64).latency_stats()


def test_stochastic_spec_completes():
    """Sampled speculation: full-length finished streams, and the same
    seed gives the same streams."""
    outs = []
    for _ in range(2):
        out, _ = _serve("torch", draft="int8@1", spec_gamma=3,
                        sampler=Sampler(temperature=0.9, top_k=16), seed=4)
        outs.append(out)
        assert all(len(t) == 10 and r == "length" for t, r in out.values())
    assert outs[0] == outs[1]


# --------------------------------------------------------------------- #
# the lifecycle in spec mode, against the JAX engine
# --------------------------------------------------------------------- #
SPEC_MODES = {"draft": dict(draft="fp@1", spec_gamma=4),
              "ngram_pool": dict(draft="ngram", spec_gamma=4, paged=True,
                                 page_size=8)}


@pytest.mark.parametrize("mode", list(SPEC_MODES))
def test_chaos_schedule_in_spec_mode_matches_jax(mode):
    kw = dict(SPEC_MODES[mode], prefill_chunk=8)
    outs, stats = [], []
    for side in ("jax", "torch"):
        out, e = _serve(side, faults=CHAOS, **kw)
        outs.append(out)
        st = e.latency_stats()
        stats.append({k: st[k] for k in ("slot_errors", "faults_injected",
                                         "preemptions", "decode_steps",
                                         "spec_tokens_per_step")})
    assert outs[1] == outs[0]
    assert stats[1] == stats[0]
    assert stats[1]["slot_errors"] == 1
    clean, _ = _serve("torch", prefill_chunk=8, faults=False)
    for uid, (toks, reason) in outs[1].items():
        if reason != "error":
            assert (toks, reason) == clean[uid], uid


@pytest.mark.parametrize("mode", list(SPEC_MODES))
def test_nan_logits_in_spec_mode_matches_jax(mode):
    outs = []
    for side in ("jax", "torch"):
        out, e = _serve(side, prompts=_PROMPTS[:2],
                        faults="nan_logits@1/0", **SPEC_MODES[mode])
        outs.append(out)
        assert e.latency_stats()["slot_errors"] == 1
    assert outs[1] == outs[0]
    assert sum(r == "error" for _, r in outs[1].values()) == 1


def _cancel_script(side, **kw):
    """Five requests on two slots, chunks of 8: cancel the queued one,
    then a decoding one after two ticks, then the admitting one."""
    e, R = _engine(side, prefill_chunk=8, **kw)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 1024, L) for L in (5, 9, 30, 7, 12)]
    for uid, p in enumerate(prompts):
        e.submit(R(uid=uid, prompt=p,
                   max_new_tokens={0: 20, 1: 20, 2: 4}.get(uid, 6)))

    def state(uid):
        if any(r.uid == uid for r in e.queue):
            return "queued"
        if e._admit is not None and e._admit.req.uid == uid:
            return "admitting"
        return "active" if any(r is not None and r.uid == uid
                               for r in e.slots) else "done"

    trail = []
    for ticks, uid in ((0, 4), (3, 0), (1, 2)):
        for _ in range(ticks):
            e.tick(1)
        trail.append((uid, state(uid), e.cancel(uid)))
    e.run()
    out = {u: (list(r.tokens), r.finish_reason)
           for u, r in e.responses.items()}
    return trail, out, e.latency_stats()["cancellations"]


@pytest.mark.parametrize("mode", list(SPEC_MODES))
def test_cancel_in_spec_mode_matches_jax(mode):
    want = _cancel_script("jax", **SPEC_MODES[mode])
    got = _cancel_script("torch", **SPEC_MODES[mode])
    assert got == want
    trail, out, n = got
    assert n == 3 and [s for _, s, _ in trail] == ["queued", "active",
                                                   "admitting"]
    assert [out[u][1] for u in (4, 0, 2)] == ["cancelled"] * 3


# --------------------------------------------------------------------- #
# the serve CLI
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("args,line", [
    (["--variant", "reduced+spec"], "speculative: gamma=4"),
    (["--draft", "ngram", "--spec-gamma", "3"], "speculative: gamma=3"),
    (["--variant", "reduced+spec", "--draft", "none"], None),
])
def test_serve_cli_draft_flags(args, line, capsys):
    from repro_torch.launch import serve
    responses, stats = serve.main(
        ["--arch", "llama3.2-1b", "--device", "cpu", "--requests", "3",
         "--max-new", "6", "--max-batch", "2", "--cache-len", "64",
         "--prefill-chunk", "8", "--temperature", "0"]
        + (args if "--variant" in args else ["--variant", "reduced"] + args))
    out = capsys.readouterr().out
    assert all(r.ok and len(r.tokens) == 6 for r in responses.values())
    if line is None:
        assert "speculative:" not in out and "spec_gamma" not in stats
    else:
        assert line in out and stats["spec_gamma"] == int(line[-1])
