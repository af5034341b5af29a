"""The port's MoE, hybrid and other dense families against the JAX
package's, model by model.

On the CPU in fp32, at the ``reduced`` width (MoE: 4 experts top-2 of
128 hidden units and one shared expert of 128; the hybrid: one full
Jamba super-block of 8 sublayers), with the JAX package's weights
crossed through ``repro_torch.bridge`` and numpy inputs from a seed:

* every id and variant resolves to the JAX config field for field (the
  fields the port carries), the registry is JAX's, and the ``spec``
  variant on the encoder-decoder raises ``ValueError`` in both;
* at full width, ``param_shapes`` is JAX's ``jax.eval_shape(init)`` tree
  leaf for leaf, and its count is JAX's ``param_count`` plus what that
  analytic count leaves out (``ln_f``'s scale and the SSM conv biases);
  the MoE router is the one f32 leaf named ``w`` and the bridge holds it
  (and every bf16 leaf) to its dtype;
* the three MoE routes (``_route_dense``, ``_route_tokens``,
  ``_route_grouped``) and their load-balance losses equal JAX's within
  1e-5, on plain routers, on a skewed router that overflows an expert's
  capacity (tokens dropped), and on a router with two identical columns
  (every token ties; the lowest index wins, as ``lax.top_k``);
* ``block_spec``, ``supports_paged`` and ``rollback_needs_replay`` of
  every family, and the fused-norm count of each stack; gemma2-class's
  windowed ring and the decode-attention plan at head_dim 256.

Every mode of every model is held against JAX's in
``tests/test_torch_families_models.py``, the engines in
``tests/test_torch_families_engine.py``, ``_pool.py``, ``_serving.py``
and ``_quant.py`` (one file a worker, each well under a minute).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import EXTRA_ARCHS as JAX_EXTRA  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import param_count  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHS, EXTRA_ARCHS, get_arch  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.model import build  # noqa: E402

torch.set_num_threads(1)

#: one MoE route's outputs and loss (f32 sums in another order)
ROUTE_TOL = 1e-5
#: the families this slice ports
NEW = ["qwen2-moe-a2.7b", "granite-moe-3b-a800m", "mixtral-8x7b",
       "jamba-1.5-large-398b", "internlm2-20b", "qwen2.5-14b",
       "starcoder2-15b", "gemma2-9b-class"]
PORTED = sorted(ARCHS) + sorted(EXTRA_ARCHS)
VARIANTS = ["", "reduced", "edge", "swa", "spec", "continuous",
            "reduced+edge", "reduced+swa", "reduced+spec",
            "reduced+continuous", "edge+continuous"]


# --------------------------------------------------------------------- #
# configs and parameter trees
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", PORTED)
def test_configs_resolve_as_jax(arch):
    for variant in VARIANTS:
        try:
            jc = jax_get_arch(arch, variant=variant)
        except ValueError:
            # the spec variant on the encoder-decoder: raised in both
            with pytest.raises(ValueError):
                get_arch(arch, variant=variant)
            continue
        tc = get_arch(arch, variant=variant)
        for f in dataclasses.fields(tc):
            got, want = getattr(tc, f.name), getattr(jc, f.name)
            if dataclasses.is_dataclass(got):
                got, want = dataclasses.asdict(got), dataclasses.asdict(want)
            assert got == want, (arch, variant, f.name)


def test_registry_as_jax():
    from repro.configs import ARCHS as JAX_ARCHS
    assert set(ARCHS) == set(JAX_ARCHS)
    assert set(EXTRA_ARCHS) == set(JAX_EXTRA)


@pytest.mark.parametrize("arch", NEW)
def test_param_shapes_full_width_as_jax(arch):
    tc, jc = get_arch(arch), jax_get_arch(arch)
    want = jax.eval_shape(jax_build(jc).init, jax.random.PRNGKey(0))
    got = TT.param_shapes(tc)

    def same(g, w, path):
        if isinstance(w, dict):
            assert set(g) == set(w), path
            for k in w:
                same(g[k], w[k], path + (k,))
            return
        assert tuple(g) == tuple(w.shape), path
        f32 = w.dtype == jnp.float32
        assert TT.is_f32_leaf(path) == f32, path

    same(got, want, ())
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(
        got, is_leaf=lambda x: isinstance(x, tuple)))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(want))
    # JAX's analytic count leaves out ln_f's scale and each SSM mixer's
    # conv bias
    n_ssm = sum(m == "ssm" for m, _ in TT.block_spec(tc)) * TT.n_blocks(tc)
    conv = 0
    if tc.ssm is not None:
        s = tc.ssm
        conv = s.d_inner(tc.d_model) + 2 * s.n_groups * s.d_state
    assert n == param_count(jc) + tc.d_model + n_ssm * conv


def test_bridge_router_f32_and_bf16_strict():
    arch = "qwen2-moe-a2.7b"
    jc = jax_get_arch(arch, variant="reduced").replace(
        param_dtype="bfloat16", dtype="bfloat16")
    tc = get_arch(arch, variant="reduced").replace(param_dtype="bfloat16",
                                                   dtype="bfloat16")
    # the JAX tree's leaves as they are (shapes and dtypes), made as zeros
    tree = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), jax.eval_shape(
        jax_build(jc).init, jax.random.PRNGKey(0)))
    tp = bridge.params_from_jax(tree, tc, "cpu")
    moe = tp["blocks"]["sub0"]["moe"]
    assert moe["router"]["w"].dtype == torch.float32
    assert moe["wi"].dtype == torch.bfloat16
    assert moe["shared"]["wi"]["w"].dtype == torch.bfloat16
    for leaf in ("router", "expert"):
        bad = jax.tree.map(lambda a: a, tree)
        sub = bad["blocks"]["sub0"]["moe"]
        if leaf == "router":      # a bf16 router
            sub["router"]["w"] = sub["router"]["w"].astype(
                sub["wi"].dtype)
        else:                     # an f32 expert
            sub["wi"] = sub["wi"].astype(np.float32)
        with pytest.raises(ValueError, match="dtype"):
            bridge.params_from_jax(bad, tc, "cpu")


@pytest.mark.parametrize("arch,paged,replay,norms", [
    ("qwen2-moe-a2.7b", True, False, 2 * 2 + 1),
    ("mixtral-8x7b", True, False, 2 * 2 + 1),
    ("jamba-1.5-large-398b", False, True, 23 + 1),
    ("gemma2-9b-class", True, False, 2 * 2 + 1),
    ("mamba2-780m", False, True, 2 * 2 + 1),
])
def test_family_properties_and_norm_count(arch, paged, replay, norms):
    """The facade's flags follow the block spec; one cache-free forward
    makes the stated number of fused-norm calls (the ops count their
    CPU calls like launches)."""
    tc = get_arch(arch, variant="reduced")
    m = build(tc, "cpu")
    assert m.supports_paged is paged
    assert m.rollback_needs_replay is replay
    if tc.family == "hybrid":
        spec = TT.block_spec(tc)
        assert [mx for mx, _ in spec] == ["attn"] + ["ssm"] * 7
        assert [f for _, f in spec] == ["moe", "mlp"] * 4
        cache = m.make_cache(1, 16)
        assert "pos" in cache["sub0"] and all(
            "ssm" in cache[f"sub{i}"] for i in range(1, 8))
    calls = []
    real_norm, real_gated = TL.rms_norm, TS.gated_rmsnorm

    def count(fn):
        def wrapped(*a, **k):
            calls.append(1)
            return fn(*a, **k)
        return wrapped

    TL.rms_norm, TS.gated_rmsnorm = count(real_norm), count(real_gated)
    try:
        TT.forward_train(m.init(0), tc, torch.zeros((1, 4),
                                                    dtype=torch.long))
    finally:
        TL.rms_norm, TS.gated_rmsnorm = real_norm, real_gated
    assert len(calls) == norms


# --------------------------------------------------------------------- #
# the MoE routes
# --------------------------------------------------------------------- #
def _moe_case(case, T=48, seed=0):
    """A reduced MoE config, expert params and tokens (numpy): ``plain``
    routers; ``skewed``: expert 0 wins every token, so its capacity
    overflows; ``ties``: experts 2 and 3 have one column, so every
    token's probabilities tie there."""
    cfg = get_arch("qwen2-moe-a2.7b", variant="reduced")
    jcfg = jax_get_arch("qwen2-moe-a2.7b", variant="reduced")
    m, d = cfg.moe, cfg.d_model
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, d)).astype(np.float32)
    w = (rng.normal(size=(d, m.n_experts)) * 0.2).astype(np.float32)
    if case == "skewed":
        x += 0.3
        w[:, 0] = 2.0
    elif case == "ties":
        w[:, 3] = w[:, 2]
        w[:, 2:] += 0.3 * np.sign(x.mean(0))[:, None]
    f = m.d_expert
    p = {"router": {"w": w},
         "wi": (rng.normal(size=(m.n_experts, d, f)) * 0.1).astype(
             np.float32),
         "wg": (rng.normal(size=(m.n_experts, d, f)) * 0.1).astype(
             np.float32),
         "wo": (rng.normal(size=(m.n_experts, f, d)) * 0.1).astype(
             np.float32)}
    return cfg, jcfg, p, x


def _tp(p):
    return jax.tree.map(torch.from_numpy, p)


@pytest.mark.parametrize("case", ["plain", "skewed", "ties"])
@pytest.mark.parametrize("route", ["dense", "tokens", "grouped"])
def test_moe_routes_match_jax(route, case):
    cfg, jcfg, p, x = _moe_case(case)
    if route == "grouped":
        x = x.reshape(3, -1, x.shape[-1])
        want = JM._route_grouped(p, jnp.asarray(x), jcfg)
        got = TM._route_grouped(_tp(p), torch.from_numpy(x), cfg)
    else:
        fn = "_route_dense" if route == "dense" else "_route_tokens"
        want = getattr(JM, fn)(p, jnp.asarray(x), jcfg)
        got = getattr(TM, fn)(_tp(p), torch.from_numpy(x), cfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ROUTE_TOL,
                                   rtol=0)
    if case == "skewed" and route == "tokens":
        # the overflow was real: expert 0 kept C of its assignments
        T, k = x.shape[0], cfg.moe.top_k
        assert TM._capacity(T, cfg.moe) < T
        assert TM._capacity(T, cfg.moe) == JM._capacity(T, jcfg.moe)
    if case == "ties":
        _, gi = TL.top_k(torch.softmax(torch.from_numpy(x @ p["router"]["w"]),
                                       -1), cfg.moe.top_k)
        _, jgi = jax.lax.top_k(jax.nn.softmax(
            jnp.asarray(x) @ p["router"]["w"]), cfg.moe.top_k)
        assert (gi.numpy() == np.asarray(jgi)).all()
        assert ((gi == 2) | (gi == 3)).any()


def test_capacity_rounds_as_jax():
    cfg = get_arch("qwen2-moe-a2.7b")
    jcfg = jax_get_arch("qwen2-moe-a2.7b")
    for n in (1, 7, 8, 100, 128, 1024, 4096):
        assert TM._capacity(n, cfg.moe) == JM._capacity(n, jcfg.moe)
        assert TM._capacity(n, cfg.moe) % 8 == 0


def test_gemma2_windowed_ring_and_head_dim():
    tc = get_arch("gemma2-9b-class")
    assert tc.hd == 256 and tc.d_model != tc.n_heads * tc.hd
    assert tc.sliding_window == 4096 and tc.tie_embeddings
    cache = build(get_arch("gemma2-9b-class", variant="reduced").replace(
        sliding_window=16), "cpu").make_cache(2, 64)
    assert cache["sub0"]["k"].shape[2] == 16


def test_decode_plan_at_head_dim_256():
    """gemma2-class's head_dim 256 on the card's decode-attention plan:
    the chunk takes 32-row blocks (each row group's warps split the head
    dim), the decode step one 16-row tile; fp32 stays on simt; the
    wrapper's head dims include 256."""
    from repro_torch.kernels.decode_attention import kernel as K
    assert 256 in K._HEAD_DIMS
    chunk = K.plan(1, 128, 16, 8, 1024, 256, torch.bfloat16)
    assert chunk.path == "mma_rows" and chunk.rows == K.MMA_ROWS_HD256
    assert chunk.row_blocks == -(-128 * 2 // K.MMA_ROWS_HD256)
    dec = K.plan(8, 1, 16, 8, 1024, 256, torch.bfloat16)
    assert dec.path == "mma_keys" and dec.rows == 16
    assert K.plan(8, 1, 16, 8, 1024, 256, torch.float32).path == "simt"
    assert K.plan(1, 128, 32, 8, 1024, 128, torch.bfloat16).rows == 64
