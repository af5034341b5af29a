"""The PyTorch port's training against the JAX package's, on the CPU.

The same inputs go through both packages: parameter trees made by JAX
and crossed with ``repro_torch.bridge``, gradients and trees made with
numpy from a seed, batches from ``data/pipeline.py`` (each package's own
copy, which must yield the same numbers). Compared:

* the schedules and ``AdamW.update`` leaf for leaf on f32 and bf16
  trees, clipping and ``global_norm`` (f32 to 1e-6 relative; bf16
  parameters to one bf16 rounding, 2^-7 relative, where an f32 update
  lands at a rounding boundary);
* one ``make_train_step`` on reduced llama3.2-1b (G 1, and G 2 with two
  KV heads): the loss to 1e-5 relative, the gradients (``jax.grad``
  against ``torch.autograd.grad``) to 1e-4 of each leaf's max, the
  parameters after the step to JAX's own microbatch tolerance (rtol
  1e-4, atol 5e-5: Adam's m / sqrt(v) turns a difference in the last
  bits of a near-zero gradient into one of up to lr in the update, and
  atol 5e-5 holds that at lr 1e-3 after the warm-up's scaling);
* microbatch 2 against the full batch and against JAX's microbatch, the
  first five ``train`` losses against JAX's, remat on against off bit
  for bit;
* the plain backward formulas (``attention_backward_reference``,
  ``fused_rmsnorm_backward_reference``) against torch autograd of the
  plain forwards and ``jax.grad`` of the JAX package's
  ``flash_attention/ref.py`` and ``rmsnorm/ref.py`` (fp32, 1e-5 of each
  gradient's max). The kernel wrappers' autograd nodes are held in
  ``tests/test_torch_flash.py`` and ``tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.kernels.flash_attention.ref import \
    attention_reference as jax_attention_ref  # noqa: E402
from repro.kernels.rmsnorm.ref import \
    fused_rmsnorm_reference as jax_rmsnorm_ref  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training.train_loop import make_train_step as jax_step  # noqa: E402
from repro.training.train_loop import train as jax_train  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.pytree import tree_leaves  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as norm_ref  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.training import optimizer as opt_mod  # noqa: E402
from repro_torch.training.train_loop import (_unflatten_like, batch_to,  # noqa: E402
                                             init_train_state,
                                             make_train_step, train)

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 1e-4, 5e-5
BF16_REL = 2.0 ** -7


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(n_kv=None):
    jc = jax_get_arch("llama3.2-1b", variant="reduced")
    tc = get_arch("llama3.2-1b", variant="reduced")
    if n_kv:
        jc, tc = jc.replace(n_kv_heads=n_kv), tc.replace(n_kv_heads=n_kv)
    jm, tm = jax_build(jc), build(tc, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jm, jp, tm, tp


def _leaves(jtree, ttree):
    """[(path, jax leaf, port leaf)] in the one leaf order both keep."""
    flat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = tree_leaves(ttree)
    assert len(flat) == len(tl)
    return [(jax.tree_util.keystr(p), a, b) for (p, a), b in zip(flat, tl)]


def _assert_params_close(want, got, grads, lr):
    """Parameters after one step, leaf for leaf: within JAX's microbatch
    tolerance (rtol 1e-4, atol 5e-5) where the gradient stands above
    GRAD_TOL of its leaf's max, and within 2 lr + 5e-5 where it does not.
    A first AdamW step moves an element by lr g / (|g| + eps), about lr
    sign(g) whatever |g| is, so a gradient at the level of the two
    packages' rounding (it agrees only to GRAD_TOL of its leaf's max)
    may move its parameter by up to lr either way."""
    gs = {name: np.abs(_np(g)) for name, g, _ in _leaves(grads, got)}
    for name, a, b in _leaves(want, got):
        noise = gs[name] <= GRAD_TOL * gs[name].max()
        a, b = _np(a), _np(b)
        np.testing.assert_allclose(b[~noise], a[~noise], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=name)
        assert np.abs(b[noise] - a[noise]).max(initial=0.0) \
            <= 2 * lr + PARAM_ATOL, name


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


# --------------------------------------------------------------------- #
# optimizer
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("sched", ["cosine", "constant"])
def test_schedules_match_jax(sched):
    if sched == "cosine":
        j, t = jax_opt.cosine_schedule(3e-4, 100, 10_000), \
            opt_mod.cosine_schedule(3e-4, 100, 10_000)
    else:
        j, t = jax_opt.constant_schedule(2e-3), opt_mod.constant_schedule(2e-3)
    for step in (0, 1, 50, 99, 100, 101, 5000, 10_000, 20_000):
        got = t(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - float(j(jnp.int32(step)))) \
            <= 1e-6 * abs(float(j(jnp.int32(step)))) + 1e-12, step


def _tree(rng):
    """A small nested-dict tree of f32 numpy leaves."""
    return {"a": {"w": rng.normal(size=(6, 5)).astype(np.float32),
                  "b": rng.normal(size=5).astype(np.float32)},
            "z": rng.normal(size=(3, 2, 4)).astype(np.float32)}


def _to_jax(tree, dtype):
    return jax.tree.map(lambda x: jnp.asarray(x, getattr(jnp, dtype)), tree)


def _to_torch(tree, dtype):
    return jax.tree.map(lambda x: torch.from_numpy(x).to(
        getattr(torch, dtype)), tree,
        is_leaf=lambda x: isinstance(x, np.ndarray))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_adamw_update_matches_jax(dtype, clip):
    """Three updates of a tree (clipping active at clip 1.0, inactive at
    1e3): parameters, moments and step leaf for leaf."""
    rng = np.random.default_rng(3)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    jo = jax_opt.AdamW(lr=jax_opt.cosine_schedule(1e-2, 1, 10),
                       clip_norm=clip)
    to = opt_mod.AdamW(lr=opt_mod.cosine_schedule(1e-2, 1, 10),
                       clip_norm=clip)
    jp, tp = _to_jax(params, dtype), _to_torch(params, dtype)
    js, ts = jo.init(jp), to.init(tp)
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    for g in grads:
        jp, js = jo.update(_to_jax(g, dtype), js, jp)
        tp, ts = to.update(_to_torch(g, dtype), ts, tp)
        assert int(ts["step"]) == int(js["step"])
        for name, a, b in _leaves(js["m"], ts["m"]) + \
                _leaves(js["v"], ts["v"]):
            assert b.dtype == torch.float32
            assert _rel(a, b) <= 1e-6, name
        for name, a, b in _leaves(jp, tp):
            assert str(b.dtype) == f"torch.{dtype}"
            tol = 1e-6 if dtype == "float32" else BF16_REL
            np.testing.assert_allclose(_np(b), _np(a), rtol=tol, atol=1e-7,
                                       err_msg=name)


def test_adamw_minimizes_quadratic():
    opt = opt_mod.AdamW(lr=opt_mod.constant_schedule(0.1), weight_decay=0.0)
    params = {"x": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(200):
        params, state = opt.update({"x": 2 * params["x"]}, state, params)
    assert float(params["x"].abs().max()) < 1e-2


def test_grad_clipping_bounds_update():
    opt = opt_mod.AdamW(lr=opt_mod.constant_schedule(1.0), clip_norm=1.0,
                        weight_decay=0.0)
    params = {"x": torch.zeros(4)}
    new, _ = opt.update({"x": torch.full((4,), 1e9)}, opt.init(params),
                        params)
    assert torch.isfinite(new["x"]).all()


def test_global_norm_matches_jax():
    rng = np.random.default_rng(5)
    tree = _tree(rng)
    assert float(opt_mod.global_norm({"a": torch.tensor([3.0]),
                                      "b": torch.tensor([4.0])})) == 5.0
    got = float(opt_mod.global_norm(_to_torch(tree, "bfloat16")))
    want = float(jax_opt.global_norm(_to_jax(tree, "bfloat16")))
    assert abs(got - want) <= 1e-6 * want


# --------------------------------------------------------------------- #
# the train step
# --------------------------------------------------------------------- #
def _batch(cfg, B=4, L=32, seed=0):
    return next(pipeline.batches_for(cfg, B, L, seed=seed))


@pytest.mark.parametrize("n_kv", [None, 2], ids=["G1", "G2"])
def test_train_step_matches_jax(n_kv):
    jm, jp, tm, tp = _pair(n_kv)
    batch = _batch(tm.cfg)
    jo = jax_opt.AdamW(lr=jax_opt.cosine_schedule(1e-3, 2, 10))
    to = opt_mod.AdamW(lr=opt_mod.cosine_schedule(1e-3, 2, 10))
    # the gradients
    jg = jax.grad(lambda p: jm.train_loss(p, batch)[0])(jp)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(tp)]
    loss, _ = tm.train_loss(_unflatten_like(tp, leaves),
                            batch_to(batch, "cpu"))
    tg = torch.autograd.grad(loss, leaves)
    for name, a, b in _leaves(jg, _unflatten_like(tp, tg)):
        assert _rel(a, b) <= GRAD_TOL, name
    # one step
    js = {"params": jp, "opt": jo.init(jp), "step": jnp.zeros((), jnp.int32)}
    ts = {"params": tp, "opt": to.init(tp),
          "step": torch.zeros((), dtype=torch.int32)}
    js, jmet = jax.jit(jax_step(jm, jo))(js, batch)
    ts, tmet = make_train_step(tm, to)(ts, batch)
    assert set(tmet) == set(jmet)
    assert all(v.dim() == 0 for v in tmet.values())
    for k in ("loss", "lm_loss", "grad_norm", "lr"):
        assert abs(float(tmet[k]) - float(jmet[k])) \
            <= LOSS_RTOL * abs(float(jmet[k])), k
    assert int(ts["step"]) == 1 and int(ts["opt"]["step"]) == 1
    _assert_params_close(js["params"], ts["params"], jg, float(tmet["lr"]))


def test_microbatch_matches_full_batch_and_jax():
    jm, jp, tm, tp = _pair()
    batch = _batch(tm.cfg)
    to = opt_mod.AdamW(lr=opt_mod.constant_schedule(1e-3))
    jo = jax_opt.AdamW(lr=jax_opt.constant_schedule(1e-3))

    def tstate():
        return {"params": tp, "opt": to.init(tp),
                "step": torch.zeros((), dtype=torch.int32)}
    full, fm = make_train_step(tm, to)(tstate(), batch)
    micro, mm = make_train_step(tm, to, microbatch=2)(tstate(), batch)
    js = {"params": jp, "opt": jo.init(jp), "step": jnp.zeros((), jnp.int32)}
    jmicro, jmm = jax.jit(jax_step(jm, jo, microbatch=2))(js, batch)
    assert abs(float(mm["loss"]) - float(fm["loss"])) <= 1e-5
    assert abs(float(mm["loss"]) - float(jmm["loss"])) \
        <= LOSS_RTOL * float(jmm["loss"])
    jg = jax.grad(lambda p: jm.train_loss(p, batch)[0])(jp)
    _assert_params_close(full["params"], micro["params"], jg, 1e-3)
    _assert_params_close(jmicro["params"], micro["params"], jg, 1e-3)


def test_five_train_losses_match_jax():
    jm, jp, tm, tp = _pair()
    jo = jax_opt.AdamW(lr=jax_opt.cosine_schedule(3e-3, 2, 5))
    to = opt_mod.AdamW(lr=opt_mod.cosine_schedule(3e-3, 2, 5))
    jstate = {"params": jp, "opt": jo.init(jp),
              "step": jnp.zeros((), jnp.int32)}
    tstate = {"params": tp, "opt": to.init(tp),
              "step": torch.zeros((), dtype=torch.int32)}
    _, jh = jax_train(jm, jo, jax_pipeline.batches_for(jm.cfg, 4, 32, 1),
                      steps=5, log_every=1, state=jstate)
    _, th = train(tm, to, pipeline.batches_for(tm.cfg, 4, 32, 1), steps=5,
                  log_every=1, state=tstate)
    assert [h["step"] for h in th] == [0, 1, 2, 3, 4]
    assert set(th[0]) == set(jh[0])
    for a, b in zip(jh, th):
        assert abs(a["loss"] - b["loss"]) <= LOSS_RTOL * a["loss"]


def test_remat_on_equals_off_bitwise():
    """``cfg.remat`` recomputes each block in the backward
    (``torch.utils.checkpoint``): the same loss, gradients and step, bit
    for bit."""
    _, _, tm, tp = _pair(2)
    batch = _batch(tm.cfg)
    to = opt_mod.AdamW(lr=opt_mod.constant_schedule(1e-3))
    out = []
    for remat in (False, True):
        m = build(tm.cfg.replace(remat=remat), device="cpu")
        st = {"params": tp, "opt": to.init(tp),
              "step": torch.zeros((), dtype=torch.int32)}
        out.append(make_train_step(m, to)(st, batch))
    (s0, m0), (s1, m1) = out
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(s0), tree_leaves(s1)))


def test_init_train_state_layout():
    tm = build(get_arch("llama3.2-1b", variant="reduced"), device="cpu")
    to = opt_mod.AdamW(lr=opt_mod.constant_schedule(1e-3))
    st = init_train_state(tm, to, seed=3)
    assert set(st) == {"params", "opt", "step"}
    assert set(st["opt"]) == {"m", "v", "step"}
    assert st["step"].dtype == torch.int32 and st["step"].dim() == 0
    for p, m in zip(tree_leaves(st["params"]), tree_leaves(st["opt"]["m"])):
        assert m.shape == p.shape and m.dtype == torch.float32
        assert not m.any()


# --------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["llama3.2-1b", "pixtral-12b",
                                  "seamless-m4t-medium"])
def test_batches_match_jax(arch):
    """Tokens (and a frontend's embeddings) equal to JAX's, batch after
    batch; a VLM's prefix takes its positions out of the sequence."""
    tc = get_arch(arch, variant="reduced")
    jc = jax_get_arch(arch, variant="reduced")
    ti, ji = pipeline.batches_for(tc, 3, 40, seed=2), \
        jax_pipeline.batches_for(jc, 3, 40, seed=2)
    for _ in range(2):
        a, b = next(ji), next(ti)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])


def test_markov_lm_and_packing_match_jax():
    for vocab, br in ((64, 8), (1024, 4)):
        a, b = jax_pipeline.MarkovLM(vocab, br, 7), pipeline.MarkovLM(
            vocab, br, 7)
        assert a.entropy_bound() == b.entropy_bound()
        np.testing.assert_array_equal(
            a.sample(np.random.default_rng(1), 50),
            b.sample(np.random.default_rng(1), 50))
    docs = [np.arange(n) for n in (5, 9, 12)]
    np.testing.assert_array_equal(jax_pipeline.pack_documents(docs, 4),
                                  pipeline.pack_documents(docs, 4))


# --------------------------------------------------------------------- #
# the plain backward formulas
# --------------------------------------------------------------------- #
ATTN_CASES = [(2, 12, 12, 4, 2, 8, True, 0), (1, 16, 16, 2, 2, 16, True, 5),
              (2, 6, 20, 4, 1, 8, False, 0)]


@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=lambda c: "B{}_Lq{}_Lk{}_Hq{}_Hkv{}_hd{}_c{}_w{}"
                         .format(*c))
def test_attention_backward_reference_matches_autograd_and_jax(case):
    B, Lq, Lk, Hq, Hkv, hd, causal, window = case
    rng = np.random.default_rng(Lq + Lk)
    q, do = (rng.normal(size=(B, Hq, Lq, hd)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(B, Hkv, Lk, hd)).astype(np.float32)
            for _ in range(2))
    G = Hq // Hkv
    dq, dk, dv = flash_ref.attention_backward_reference(
        *(torch.from_numpy(a) for a in (q, k, v, do)), causal=causal,
        window=window)
    # torch autograd of the plain forward
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_ref.attention_reference(
        tq, tk.repeat_interleave(G, 1), tv.repeat_interleave(G, 1),
        causal=causal, window=window)
    out.backward(torch.from_numpy(do))
    # jax.grad of the JAX package's reference (per-head, heads expanded)
    def f(q_, k_, v_):
        o = jax_attention_ref(q_, jnp.repeat(k_, G, 1), jnp.repeat(v_, G, 1),
                              causal=causal, window=window)
        return jnp.sum(o * do)
    jq, jk, jv = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    for got, auto, jx in ((dq, tq.grad, jq), (dk, tk.grad, jk),
                          (dv, tv.grad, jv)):
        assert _rel(auto, got) <= 1e-5 and _rel(jx, got) <= 1e-5


@pytest.mark.parametrize("route", ["add", "norm"])
def test_rmsnorm_backward_reference_matches_autograd_and_jax(route):
    rng = np.random.default_rng(11)
    x, r, dy, dt = (rng.normal(size=(6, 48)).astype(np.float32)
                    for _ in range(4))
    s = (1 + 0.1 * rng.normal(size=48)).astype(np.float32)
    res = r if route == "add" else np.zeros_like(r)
    dtt = dt if route == "add" else None
    dx, ds = norm_ref.fused_rmsnorm_backward_reference(
        torch.from_numpy(x), None if route == "norm" else torch.from_numpy(r),
        torch.from_numpy(s), torch.from_numpy(dy),
        None if dtt is None else torch.from_numpy(dtt))
    tx, tr, ts_ = (torch.from_numpy(a).requires_grad_() for a in (x, r, s))
    y, t = norm_ref.fused_rmsnorm_reference(
        tx, tr if route == "add" else None, ts_)
    outs = [(y, dy)] + ([(t, dt)] if route == "add" else [])
    torch.autograd.backward([o for o, _ in outs],
                            [torch.from_numpy(g) for _, g in outs])

    def f(x_, r_, s_):
        y_, t_ = jax_rmsnorm_ref(x_, r_, s_)
        return jnp.sum(y_ * dy) + (jnp.sum(t_ * dt) if route == "add"
                                   else 0.0)
    jx, jr, js = jax.grad(f, argnums=(0, 1, 2))(x, res, s)
    assert _rel(tx.grad, dx) <= 1e-5 and _rel(jx, dx) <= 1e-5
    assert _rel(ts_.grad, ds) <= 1e-5 and _rel(js, ds) <= 1e-5
    if route == "add":
        assert _rel(tr.grad, dx) <= 1e-5 and _rel(jr, dx) <= 1e-5
