"""The PyTorch port's training of the SSM, MoE and hybrid stacks against
the JAX package's, on the CPU.

The same inputs go through both packages, as in
``tests/test_torch_training.py``: parameter trees made by JAX and
crossed with ``repro_torch.bridge``, batches from ``data/pipeline.py``,
kernel inputs made with numpy from a seed. Compared, on reduced
mamba2-780m, qwen2-moe-a2.7b and jamba-1.5-large-398b:

* one ``make_train_step``: the loss and the MoE auxiliary loss to 1e-5
  relative, the gradients (``jax.grad`` against ``torch.autograd.grad``)
  to 1e-4 of each leaf's max, the parameters after the step to JAX's
  microbatch tolerance (``_assert_params_close``);
* the first five ``train`` losses against JAX's;
* microbatch 2 against JAX's microbatch 2, and, on mamba2, against the
  full batch (a MoE layer's capacity and load-balance loss are taken
  over the tokens of a microbatch, so there the two differ by design);
* remat on against off, bit for bit;
* the train CLI's lines and records against JAX's CLI's;
* the plain backward formulas of the two ops that gained backward
  kernels, ``ssd_backward_reference`` and
  ``gated_rmsnorm_backward_reference``, against torch autograd of the
  plain forwards and ``jax.vjp`` of the JAX package's ``ssd_reference``
  and ``rms_norm(p, y * silu(z))`` (fp32 to 1e-5 of each gradient's
  max; the gated norm in bf16 to the bf16 gate, 2e-2, where autograd
  and JAX round each intermediate gradient to bf16 and the formula does
  not).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.kernels.ssd_scan.ref import \
    ssd_reference as jax_ssd_ref  # noqa: E402
from repro.launch import train as jax_train_cli  # noqa: E402
from repro.models.layers import rms_norm as jax_rms_norm  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training.train_loop import make_train_step as jax_step  # noqa: E402
from repro.training.train_loop import train as jax_train  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.pytree import tree_leaves  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as norm_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as ssd_ref  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.training import optimizer as opt_mod  # noqa: E402
from repro_torch.training.train_loop import (_unflatten_like, batch_to,  # noqa: E402
                                             make_train_step, train)

ARCHS = ("mamba2-780m", "qwen2-moe-a2.7b", "jamba-1.5-large-398b")
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 1e-4, 5e-5
REF_TOL = 1e-5
BF16_TOL = 2e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _pair(arch):
    jc = jax_get_arch(arch, variant="reduced")
    tc = get_arch(arch, variant="reduced")
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
    """Parameters after one step, leaf for leaf, as
    ``tests/test_torch_training.py`` holds them: rtol 1e-4, atol 5e-5
    where the gradient stands above GRAD_TOL of its leaf's max, 2 lr +
    5e-5 where it does not (a first AdamW step moves an element by about
    lr sign(g), so a rounding-level gradient may move it by lr either
    way)."""
    gs = {name: np.abs(_np(g)) for name, g, _ in _leaves(grads, got)}
    for name, a, b in _leaves(want, got):
        noise = gs[name] <= GRAD_TOL * gs[name].max()
        a, b = _np(a), _np(b)
        np.testing.assert_allclose(b[~noise], a[~noise], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=name)
        assert np.abs(b[noise] - a[noise]).max(initial=0.0) \
            <= 2 * lr + PARAM_ATOL, name


def _batch(cfg, B=4, L=64, seed=0):
    return next(pipeline.batches_for(cfg, B, L, seed=seed))


def _states(jp, tp, jo, to):
    return ({"params": jp, "opt": jo.init(jp),
             "step": jnp.zeros((), jnp.int32)},
            {"params": tp, "opt": to.init(tp),
             "step": torch.zeros((), dtype=torch.int32)})


# --------------------------------------------------------------------- #
# the train step
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    jm, jp, tm, tp = _pair(arch)
    batch = _batch(tm.cfg)
    jo = jax_opt.AdamW(lr=jax_opt.cosine_schedule(1e-3, 2, 10))
    to = opt_mod.AdamW(lr=opt_mod.cosine_schedule(1e-3, 2, 10))
    # the gradients and both losses
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jm.train_loss(p, batch), has_aux=True)(jp)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(tp)]
    loss, tmet = tm.train_loss(_unflatten_like(tp, leaves),
                               batch_to(batch, "cpu"))
    tg = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert abs(tmet["aux_loss"].item() - float(jmet["aux_loss"])) \
        <= LOSS_RTOL * abs(float(jmet["aux_loss"])) + 1e-12
    if tm.cfg.moe is not None:
        assert tmet["aux_loss"].item() > 0
    for name, a, b in _leaves(jg, _unflatten_like(tp, tg)):
        assert _rel(a, b) <= GRAD_TOL, name
    # one step
    js, ts = _states(jp, tp, jo, to)
    js, jmet = jax.jit(jax_step(jm, jo))(js, batch)
    ts, tmet = make_train_step(tm, to)(ts, batch)
    assert set(tmet) == set(jmet)
    for k in ("loss", "lm_loss", "aux_loss", "grad_norm", "lr"):
        assert abs(float(tmet[k]) - float(jmet[k])) \
            <= LOSS_RTOL * abs(float(jmet[k])) + 1e-12, k
    assert int(ts["step"]) == 1
    _assert_params_close(js["params"], ts["params"], jg, float(tmet["lr"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_five_train_losses_match_jax(arch):
    jm, jp, tm, tp = _pair(arch)
    jo = jax_opt.AdamW(lr=jax_opt.cosine_schedule(3e-3, 2, 5))
    to = opt_mod.AdamW(lr=opt_mod.cosine_schedule(3e-3, 2, 5))
    jstate, tstate = _states(jp, tp, jo, to)
    _, jh = jax_train(jm, jo, jax_pipeline.batches_for(jm.cfg, 4, 64, 1),
                      steps=5, log_every=1, state=jstate)
    _, th = train(tm, to, pipeline.batches_for(tm.cfg, 4, 64, 1), steps=5,
                  log_every=1, state=tstate)
    assert [h["step"] for h in th] == [0, 1, 2, 3, 4]
    assert set(th[0]) == set(jh[0])
    for a, b in zip(jh, th):
        assert abs(a["loss"] - b["loss"]) <= LOSS_RTOL * a["loss"]


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatch_matches_jax(arch):
    jm, jp, tm, tp = _pair(arch)
    batch = _batch(tm.cfg)
    to = opt_mod.AdamW(lr=opt_mod.constant_schedule(1e-3))
    jo = jax_opt.AdamW(lr=jax_opt.constant_schedule(1e-3))
    js, ts = _states(jp, tp, jo, to)
    micro, mm = make_train_step(tm, to, microbatch=2)(ts, batch)
    jmicro, jmm = jax.jit(jax_step(jm, jo, microbatch=2))(js, batch)
    for k in ("loss", "aux_loss"):
        assert abs(float(mm[k]) - float(jmm[k])) \
            <= LOSS_RTOL * float(jmm[k]) + 1e-12, k
    # the step's gradient: the sum over the microbatches of 2 rows
    parts = [jax.grad(lambda p: jm.train_loss(p, mb)[0])(jp) for mb in
             ({k: v[i:i + 2] for k, v in batch.items()} for i in (0, 2))]
    jg = jax.tree.map(jnp.add, *parts)
    _assert_params_close(jmicro["params"], micro["params"], jg, 1e-3)
    if tm.cfg.moe is None:
        _, ts = _states(jp, tp, jo, to)
        full, fm = make_train_step(tm, to)(ts, batch)
        assert abs(float(mm["loss"]) - float(fm["loss"])) <= 1e-5
        _assert_params_close(full["params"], micro["params"], jg, 1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_equals_off_bitwise(arch):
    """``cfg.remat`` recomputes each block in the backward: the same
    loss, auxiliary loss, gradients and step, bit for bit."""
    _, _, tm, tp = _pair(arch)
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


@pytest.mark.parametrize("arch", ["mamba2-780m", "qwen2-moe-a2.7b"])
def test_train_cli_matches_jax_lines_and_records(arch, tmp_path, capsys):
    args = ["--arch", arch, "--variant", "reduced", "--steps", "2",
            "--batch", "2", "--seq", "32", "--log-every", "1"]
    hist = train_cli.main(args + ["--device", "cpu", "--metrics",
                                  str(tmp_path / "port.jsonl")])
    port_out = capsys.readouterr().out.splitlines()
    jhist = jax_train_cli.main(args + ["--metrics",
                                       str(tmp_path / "jax.jsonl")])
    jax_out = capsys.readouterr().out.splitlines()
    assert [h["step"] for h in hist] == [0, 1]
    assert set(hist[0]) == set(jhist[0])
    assert len(port_out) == len(jax_out) == 3
    assert port_out[0].split()[:2] == jax_out[0].split()[:2]
    for a, b in zip(port_out, jax_out):
        assert [w.split("=")[0] for w in a.split()] == \
            [w.split("=")[0] for w in b.split()]
    recs = [json.loads(ln) for ln in
            (tmp_path / "port.jsonl").read_text().splitlines()]
    jrecs = [json.loads(ln) for ln in
             (tmp_path / "jax.jsonl").read_text().splitlines()]
    assert [set(r) for r in recs] == [set(r) for r in jrecs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_leaves_its_inputs_alone(dtype):
    """``AdamW.update`` is functional, as JAX's: the parameters, the
    gradients (read again for the step's ``grad_norm``) and the moments
    it is given keep their values, also where an f32 leaf's ``.float()``
    is the leaf itself and the update runs in place on its temporaries;
    with clipping active, the step's ``grad_norm`` is the unclipped
    norm."""
    g = torch.Generator().manual_seed(2)
    tdt = getattr(torch, dtype)

    def tree():
        return {"a": torch.randn(6, 4, generator=g).to(tdt),
                "b": {"c": torch.randn(5, generator=g)}}
    params, grads = tree(), tree()
    grads = opt_mod.tree_map(lambda t: 10 * t, grads)
    opt = opt_mod.AdamW(lr=opt_mod.constant_schedule(1e-2), clip_norm=1.0)
    state = opt.init(params)
    state["m"] = opt_mod.tree_map(lambda t: t + 0.5, state["m"])
    before = [t.clone() for t in tree_leaves((params, grads, state))]
    norm = opt_mod.global_norm(grads)
    new_params, new_state = opt.update(grads, state, params)
    assert float(norm) > 1.0
    for a, b in zip(tree_leaves((params, grads, state)), before):
        assert torch.equal(a, b)
    assert torch.equal(opt_mod.global_norm(grads), norm)
    assert all(not torch.equal(a, b) for a, b in
               zip(tree_leaves(new_params), tree_leaves(params)))


# --------------------------------------------------------------------- #
# the plain backward formulas
# --------------------------------------------------------------------- #
#: (b, l, h, p, g, n, chunk, initial state, final-state gradient, D)
SSD_CASES = [(2, 64, 4, 8, 1, 16, 16, False, False, True),
             (1, 96, 6, 4, 3, 8, 32, True, True, True),
             (2, 128, 4, 8, 2, 8, 64, True, False, False),
             (1, 128, 2, 8, 1, 16, 32, False, True, False)]


@pytest.mark.parametrize(
    "case", SSD_CASES,
    ids=lambda c: "b{}_l{}_h{}_p{}_g{}_n{}_chunk{}_init{:d}_dfinal{:d}_D{:d}"
    .format(*c))
def test_ssd_backward_reference_matches_autograd_and_jax(case):
    b, l, h, p, g, n, chunk, init, dfin, use_d = case
    rng = np.random.default_rng(l + h + chunk)
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = (0.02 + 0.1 * rng.random(size=(b, l, h))).astype(np.float32)
    A = (-0.5 - rng.random(size=h)).astype(np.float32)
    B, C = (rng.normal(size=(b, l, g, n)).astype(np.float32)
            for _ in range(2))
    D = rng.normal(size=h).astype(np.float32) if use_d else None
    s0 = rng.normal(size=(b, h, p, n)).astype(np.float32) if init else None
    dy = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dfinal = rng.normal(size=(b, h, p, n)).astype(np.float32) \
        if dfin else None
    t = (lambda a: None if a is None else torch.from_numpy(a))
    got = ssd_ref.ssd_backward_reference(
        t(x), t(dt), t(A), t(B), t(C), t(D), t(dy), t(dfinal), chunk=chunk,
        initial_state=t(s0))
    names = ["x", "dt", "A", "B", "C", "D", "initial_state"]
    keep = [True] * 5 + [use_d, init]
    assert [g_ is not None for g_ in got] == keep
    # torch autograd of the plain forward
    leaves = [t(a).requires_grad_() if a is not None else None
              for a in (x, dt, A, B, C, D, s0)]
    y, fin = ssd_ref.ssd_reference(*leaves[:6], chunk=chunk,
                                   initial_state=leaves[6])
    outs = [(y, dy)] + ([(fin, dfinal)] if dfin else [])
    auto = torch.autograd.grad(
        [o for o, _ in outs], [a for a in leaves if a is not None],
        [torch.from_numpy(g_) for _, g_ in outs])
    # jax.vjp of the JAX package's reference
    jargs = [a for a in (x, dt, A, B, C, D, s0) if a is not None]

    def f(*a):
        it = iter(a)
        xs = [next(it) if k else None for k in keep]
        return jax_ssd_ref(*xs[:6], chunk=chunk, initial_state=xs[6])
    (jy, jfin), vjp = jax.vjp(f, *jargs)
    jgrads = vjp((dy, dfinal if dfin else np.zeros(jfin.shape, np.float32)))
    np.testing.assert_allclose(_np(y), np.asarray(jy), rtol=1e-5, atol=1e-4)
    mine = [g_ for g_ in got if g_ is not None]
    for name, m, a, j in zip([nm for nm, k in zip(names, keep) if k], mine,
                             auto, jgrads):
        assert _rel(a, m) <= REF_TOL, (name, _rel(a, m))
        assert _rel(j, m) <= REF_TOL, (name, _rel(j, m))


#: (b, l, h, p, g, n, initial state, final-state gradient): the
#: backward's own sub-chunks 128 and 64 against the caller's chunk 256
BWD_SUB_CASES = [(1, 512, 2, 16, 1, 16, False, False),
                 (2, 256, 3, 8, 3, 8, True, True)]


@pytest.mark.parametrize("sub", [128, 64])
@pytest.mark.parametrize(
    "case", BWD_SUB_CASES,
    ids=lambda c: "b{}_l{}_h{}_p{}_g{}_n{}_init{:d}_dfinal{:d}".format(*c))
def test_ssd_backward_reference_at_the_plans_sub_chunks(case, sub):
    """What lets the backward choose its own chunk (``bwd_plan``'s
    sub-chunks): the plain backward at sub-chunk 128 or 64 agrees with
    itself at chunk 256 and with ``jax.grad`` of the JAX package's
    ``ssd_reference`` at chunk 256, in f32, within ``REF_TOL`` of each
    gradient's max (the same function; the chunk only regroups the
    sums). The inputs decay as the mixer's do (dt a softplus around
    0.05, A over -1..-8), over more than one chunk of 256."""
    b, l, h, p, g, n, init, dfin = case
    rng = np.random.default_rng(l + sub + h)
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, l, h)) - 3.0)).astype(
        np.float32)
    A = -np.linspace(1.0, 8.0, h).astype(np.float32)
    B, C = (rng.normal(size=(b, l, g, n)).astype(np.float32)
            for _ in range(2))
    D = rng.normal(size=h).astype(np.float32)
    s0 = rng.normal(size=(b, h, p, n)).astype(np.float32) if init else None
    dy = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dfinal = rng.normal(size=(b, h, p, n)).astype(np.float32) \
        if dfin else None
    t = (lambda a: None if a is None else torch.from_numpy(a))
    args = [t(a) for a in (x, dt, A, B, C, D, dy, dfinal)]
    at_sub = ssd_ref.ssd_backward_reference(*args, chunk=sub,
                                            initial_state=t(s0))
    at_256 = ssd_ref.ssd_backward_reference(*args, chunk=256,
                                            initial_state=t(s0))
    jargs = [a for a in (x, dt, A, B, C, D, s0) if a is not None]

    def loss(*a):
        y, fin = jax_ssd_ref(*a[:6], chunk=256,
                             initial_state=a[6] if init else None)
        out = jnp.sum(y * dy)
        return out + jnp.sum(fin * dfinal) if dfin else out
    jgrads = jax.grad(loss, argnums=tuple(range(len(jargs))))(*jargs)
    mine = [a for a in at_sub if a is not None]
    assert len(mine) == len(jgrads) == 6 + init
    for m, c, j in zip(mine, [a for a in at_256 if a is not None], jgrads):
        assert _rel(c, m) <= REF_TOL, _rel(c, m)
        assert _rel(j, m) <= REF_TOL, _rel(j, m)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_rmsnorm_backward_reference_matches_autograd_and_jax(dtype):
    """The SSD output y in f32, z, the scale and dout in ``dtype`` (the
    train step's activation and parameter dtype)."""
    rng = np.random.default_rng(13)
    N, d = 12, 96
    y, z, dout = (rng.normal(size=(N, d)).astype(np.float32)
                  for _ in range(3))
    s = (1 + 0.1 * rng.normal(size=d)).astype(np.float32)
    tdt = getattr(torch, dtype)
    ty = torch.from_numpy(y)
    tz, ts_, tdo = (torch.from_numpy(a).to(tdt) for a in (z, s, dout))
    dy, dz, ds = norm_ref.gated_rmsnorm_backward_reference(ty, tz, ts_, tdo)
    assert (dy.dtype, dz.dtype, ds.dtype) == (torch.float32, tdt, tdt)
    leaves = [a.clone().requires_grad_() for a in (ty, tz, ts_)]
    norm_ref.gated_rmsnorm_reference(*leaves).backward(tdo)
    jdt = getattr(jnp, dtype)

    def f(y_, z_, s_):
        v = y_.astype(jdt) * jax.nn.silu(z_.astype(jnp.float32)).astype(jdt)
        return jax_rms_norm({"scale": s_}, v)
    out, vjp = jax.vjp(f, jnp.asarray(y), jnp.asarray(z, jdt),
                       jnp.asarray(s, jdt))
    jgrads = vjp(jnp.asarray(dout, jdt))
    tol = REF_TOL if dtype == "float32" else BF16_TOL
    for name, m, a, j in zip(("y", "z", "scale"), (dy, dz, ds),
                             [a.grad for a in leaves], jgrads):
        assert _rel(a, m) <= tol, (name, _rel(a, m))
        assert _rel(j, m) <= tol, (name, _rel(j, m))
