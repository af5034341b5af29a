"""The PyTorch port's SSM family (Mamba-2, ``mamba2-780m``) against the JAX
package's.

Inputs are made with numpy from a seed; weights are JAX's, crossed over
with ``repro_torch.bridge`` (the f32 ``A_log``/``D``/``dt_bias`` and the
conv bias perturbed from their constant init so every leaf matters). On
the CPU every SSD op runs its plain version, which is held against JAX's
``ref.py`` oracle and against the Pallas kernels in interpret mode; the
mixer, the reduced model in every mode (every cache leaf, checkpoints
included), rollback and the ``Engine`` are held against the JAX
package's, which runs its default route and its Pallas route
(``REPRO_FORCE_PALLAS=1``). Tolerances: 1e-4 absolute between the port
and JAX's oracle (the same f32 algorithm, sums in another order), 1e-3
against the Pallas kernels (the tolerance of JAX's own kernel test),
exact for depths, for bitwise compositionality and for untouched rows.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import param_count  # noqa: E402
from repro.kernels.ssd_scan import kernel as jkernel  # noqa: E402
from repro.kernels.ssd_scan import ref as jref  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models.layers import rms_norm as jax_rms_norm  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro.serving.sampler import Sampler as JaxSampler  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as norm_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as tkernel  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

TOL = 1e-4                 # port vs JAX's oracle (same f32 algorithm)
PALLAS_TOL = 1e-3          # vs the Pallas kernels (JAX's own tolerance)
ARCH = "mamba2-780m"
SSD_CASES = [(2, 128, 4, 32, 1, 32, 32), (1, 256, 8, 64, 2, 128, 64),
             (2, 64, 2, 16, 2, 16, 16), (1, 128, 6, 32, 3, 64, 64)]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ssd_inputs(b, l, h, p, g, n, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, l, h, p)).astype(f),
            rng.uniform(1e-3, 0.1, (b, l, h)).astype(f),
            -rng.uniform(0.5, 2.0, (h,)).astype(f),
            rng.standard_normal((b, l, g, n)).astype(f),
            rng.standard_normal((b, l, g, n)).astype(f),
            rng.standard_normal((h,)).astype(f))


# --------------------------------------------------------------------- #
# the SSD ops: plain versions against JAX's oracle and Pallas kernels
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_plain_matches_jax(case):
    *dims, chunk = case
    args = _ssd_inputs(*dims, seed=sum(dims))
    y, s = ops.ssd(*map(_t, args), chunk=chunk)
    yr, sr = jref.ssd_reference(*map(jnp.asarray, args), chunk=chunk)
    yp, sp = jkernel.ssd_pallas(*map(jnp.asarray, args), chunk=chunk,
                                interpret=True)
    assert y.dtype == s.dtype == torch.float32
    _close(y, yr)
    _close(s, sr)
    _close(y, yp, PALLAS_TOL)
    _close(s, sp, PALLAS_TOL)


def test_ssd_initial_state_matches_jax():
    b, l, h, p, g, n = 2, 64, 4, 32, 2, 32
    args = _ssd_inputs(b, l, h, p, g, n, seed=3)
    s0 = np.random.default_rng(4).standard_normal((b, h, p, n)).astype(
        np.float32)
    y, s = ops.ssd(*map(_t, args), chunk=16, initial_state=_t(s0))
    yr, sr = jref.ssd_reference(*map(jnp.asarray, args), chunk=16,
                                initial_state=jnp.asarray(s0))
    _close(y, yr)
    _close(s, sr)
    # chunking changes only the rounding
    y2, s2 = ops.ssd(*map(_t, args), chunk=64, initial_state=_t(s0))
    _close(y2, y)
    _close(s2, s)


@pytest.mark.parametrize("T,g", [(1, 1), (5, 1), (1, 2), (5, 2)])
def test_ssd_extend_plain_matches_jax(T, g):
    b, h, p, n = 2, 4, 32, 32
    x, dt, A, B, C, D = _ssd_inputs(b, T, h, p, g, n, seed=T + 10 * g)
    s0 = np.random.default_rng(T).standard_normal((b, h, p, n)).astype(
        np.float32)
    y, s = ops.ssd_extend(_t(s0), *map(_t, (x, dt, A, B, C, D)))
    yr, sr = jref.ssd_extend_reference(*map(jnp.asarray,
                                            (s0, x, dt, A, B, C, D)))
    yp, sp = jkernel.ssd_extend_pallas(
        *map(jnp.asarray, (s0, x, dt, A, B, C, D)), interpret=True)
    _close(y, yr)
    _close(s, sr)
    _close(y, yp, PALLAS_TOL)
    _close(s, sp, PALLAS_TOL)
    # the single step, through the op the decode path calls
    y1, s1 = ops.ssd_step(_t(s0), *map(_t, (x[:, 0], dt[:, 0], A, B[:, 0],
                                            C[:, 0], D)))
    yr1, sr1 = jref.ssd_decode_step(*map(jnp.asarray, (
        s0, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], D)))
    _close(y1, yr1)
    _close(s1, sr1)


def test_ssd_extend_is_bitwise_compositional():
    """[t1] + [t2] == [t1 + t2] == T single steps, bit for bit; a row
    whose dt is 0 comes out with its state unchanged; ``out`` may be the
    state itself and ``ckpt`` receives the incoming state."""
    tile = tkernel.EXT_TILE
    b, T, h, p, g, n = 3, 2 * tile + 3, 4, 32, 2, 32
    x, dt, A, B, C, D = map(_t, _ssd_inputs(b, T, h, p, g, n, seed=5))
    s0 = _t(np.random.default_rng(6).standard_normal((b, h, p, n)).astype(
        np.float32))
    y, s = ops.ssd_extend(s0, x, dt, A, B, C, D)
    # 1 (the decode route's one token, then the chunk route), 4, and the
    # edges of the kernel's tiles
    for t1 in (1, 4, tile - 1, tile, tile + 1, 2 * tile, 2 * tile + 1):
        ya, sa = ops.ssd_extend(s0, x[:, :t1], dt[:, :t1], A, B[:, :t1],
                                C[:, :t1], D)
        yb, sb = ops.ssd_extend(sa, x[:, t1:], dt[:, t1:], A, B[:, t1:],
                                C[:, t1:], D)
        assert torch.equal(torch.cat([ya, yb], 1), y)
        assert torch.equal(sb, s)
    st, ys = s0, []
    for t in range(T):
        yt, st = ops.ssd_step(st, x[:, t], dt[:, t], A, B[:, t], C[:, t], D)
        ys.append(yt)
    assert torch.equal(torch.stack(ys, 1), y) and torch.equal(st, s)
    dt0 = dt.clone()
    dt0[1] = 0
    state, ckpt = s0.clone(), torch.zeros_like(s0)
    _, out = ops.ssd_extend(state, x, dt0, A, B, C, D, out=state, ckpt=ckpt)
    assert out is state
    assert torch.equal(ckpt, s0)
    assert torch.equal(state[1], s0[1])
    assert not torch.equal(state[0], s0[0])


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("T", [1, 128])
@pytest.mark.parametrize("p,n", [(p, n) for p in tkernel.HEAD_DIMS
                                 for n in tkernel.STATE_DIMS])
@pytest.mark.parametrize("h,g", [(48, 1), (16, 2)])
def test_extend_plan_is_a_legal_launch_covering_every_row(b, T, p, n, h, g):
    """The recurrence kernel's plan: the decode route (a tile of 1 token)
    at T = 1, else tiles of ``EXT_TILE``; a block of 1 to 16 warps, its
    dynamic shared memory (the kernel's ``ExtSmem``) within the 227 KB a
    block may use; every state row (batch row, head, row) owned by exactly
    one warp of one block, a warp's rows in one head, a block's rows in
    one group; no more blocks than SMs unless 32 rows a block (the most)
    still give more; at mamba2-780m's dims, 24 rows (128 blocks) at b 1
    and 32 (768) at decode's b 8."""
    pl = tkernel.extend_plan(b, T, h, p, g, n)
    assert pl.tt == (1 if T == 1 else tkernel.EXT_TILE)
    assert pl.rows % tkernel.EXT_RPW == 0
    assert tkernel.EXT_RPW <= pl.rows <= tkernel.EXT_MAX_ROWS
    assert pl.threads == pl.rows // tkernel.EXT_RPW * 32 <= 512
    assert pl.smem <= 227 * 1024
    assert pl.batch == b and pl.blocks * pl.rows == h * p
    assert pl.blocks * b <= tkernel.SMS or pl.rows == tkernel.EXT_MAX_ROWS
    owned = np.zeros((b, h, p), dtype=np.int64)
    for by in range(pl.batch):
        for bx in range(pl.blocks):
            groups = set()
            for w in range(pl.threads // 32):
                fr = bx * pl.rows + tkernel.EXT_RPW * w + np.arange(
                    tkernel.EXT_RPW)
                heads = set((fr // p).tolist())
                assert len(heads) == 1
                groups.add(heads.pop() // (h // g))
                np.add.at(owned, (by, fr // p, fr % p), 1)
            assert len(groups) == 1
    assert (owned == 1).all()
    if (h, p, g, n) == (48, 64, 1, 128):
        assert (pl.rows, pl.blocks * b) == {1: (24, 128), 8: (32, 768)}[b]


# (b, l, h, g): mamba2-780m's heads and the reduced dims with 2 groups,
# at lengths every chunk below divides
CHUNK_PLAN_DIMS = [(1, 1536, 48, 1), (2, 768, 16, 2)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("chunk", [16, 24, 32, 48, 64, 128, 256])
@pytest.mark.parametrize("p,n", tkernel.CHUNK_DIMS)
@pytest.mark.parametrize("b,l,h,g", CHUNK_PLAN_DIMS)
def test_chunk_plan_is_a_legal_launch_covering_every_row(b, l, h, g, p, n,
                                                         chunk, dtype):
    """The dual form's plan: bf16 with a chunk that is a multiple of 16
    takes the mma route, in sub-chunks that divide the chunk (multiples
    of 16 up to ``MMA_MAX_SUB``), everything else the simt route at the
    caller's chunk; each kernel's dynamic shared memory within the 227
    KB a block may use; the chunk states' grid of (sub-chunk, head,
    batch row) blocks and the outputs' grid of (row block, head, batch
    row) blocks, a warp per 16 rows, each cover every token of every
    (batch row, head) exactly once, and the state pass's threads every 4
    state elements; the workspace is b h chunks (2 p n + 1) f32
    words (the chunk states, the incoming states as bf16 pairs, the
    decays). Every (p, n) pair the kernels are instantiated for
    (``CHUNK_DIMS``: Jamba's p 128 at n 128 beside p 32 and 64)."""
    pl = tkernel.chunk_plan(b, l, h, p, n, chunk, dtype)
    mma = dtype == torch.bfloat16 and chunk % 16 == 0
    assert pl.route == ("mma" if mma else "simt")
    assert chunk % pl.sub == 0 and pl.chunks * pl.sub == l
    assert pl.smem <= 227 * 1024 and pl.states_smem <= 227 * 1024
    assert pl.threads <= 1024
    if mma:
        assert pl.sub % 16 == 0 and pl.sub <= tkernel.MMA_MAX_SUB
        assert pl.sub == next(s for s in tkernel.MMA_SUBS if chunk % s == 0)
        assert pl.rows == min(pl.sub, tkernel.OUT_ROWS)
        assert pl.sub % pl.rows == 0 and pl.threads == pl.rows // 16 * 32
        # 4 warps, or a warp a 16-row m-tile of the state above p 64
        assert pl.states_threads == max(tkernel.STATES_THREADS, p // 16 * 32)
        assert pl.states_blocks == pl.chunks * h * b
        parts = pl.sub // pl.rows
        assert pl.blocks == pl.chunks * parts * h * b
        states = np.zeros((b, h, l), dtype=np.int64)
        outs = np.zeros((b, h, l), dtype=np.int64)
        for bz in range(b):
            for hy in range(h):
                for cx in range(pl.chunks):
                    states[bz, hy, cx * pl.sub:(cx + 1) * pl.sub] += 1
                for bx in range(pl.chunks * parts):
                    r0 = bx // parts * pl.sub + bx % parts * pl.rows
                    outs[bz, hy, r0:r0 + pl.rows] += 1
        assert (states == 1).all() and (outs == 1).all()
        total4 = b * h * p * n // 4
        assert (pl.pass_blocks - 1) * tkernel.PASS_THREADS < total4 \
            <= pl.pass_blocks * tkernel.PASS_THREADS
        assert pl.workspace == 4 * b * h * pl.chunks * (2 * p * n + 1)
    else:
        assert pl.sub == chunk and pl.blocks == h * b and pl.rows == l
        assert pl.threads == tkernel.SIMT_THREADS and pl.workspace == 0


def test_chunk_plan_at_mamba2_and_sub_override():
    """At mamba2-780m's b 1, l 1024, chunk 256 in bf16: sub-chunks of
    128, 384 chunk-state blocks, 768 output blocks of 64 rows (4 warps, 70
    KB of shared memory), 12.6 MB of chunk states. ``sub`` picks another
    sub-chunk for a timing run; one that is no multiple of 16, above
    ``MMA_MAX_SUB`` or not dividing l raises."""
    pl = tkernel.chunk_plan(1, 1024, 48, 64, 128, 256, torch.bfloat16)
    assert (pl.route, pl.sub, pl.rows, pl.blocks, pl.threads, pl.smem,
            pl.states_blocks) == ("mma", 128, 64, 768, 128, 71680, 384)
    assert 4 * 48 * pl.chunks * 64 * 128 == 12582912
    pl = tkernel.chunk_plan(1, 1024, 48, 64, 128, 256, torch.bfloat16, 64)
    assert (pl.sub, pl.blocks, pl.states_blocks) == (64, 768, 768)
    for bad in (24, 256, 96):
        with pytest.raises(ValueError, match="sub-chunk"):
            tkernel.chunk_plan(1, 1024, 48, 64, 128, 256, torch.bfloat16,
                               bad)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("chunk", [16, 40, 48, 64, 128, 256])
@pytest.mark.parametrize("p,n", tkernel.CHUNK_DIMS)
@pytest.mark.parametrize("b,l,h,g", [(4, 3840, 48, 1), (2, 3840, 16, 2)])
def test_bwd_plan_is_a_legal_launch(b, l, h, g, p, n, chunk, dtype):
    """The SSD backward's plan: bf16 with a chunk that is a multiple of 16
    takes the mma route, in sub-chunks of the first of ``BWD_SUBS`` that
    divides the chunk and whose main kernel fits a block's shared memory
    (64 at p 128); f32, or a chunk that is no multiple of 16 (40), the
    simt route at the caller's chunk. The sub-chunk divides the chunk and
    l; every kernel's shared memory stays within the 232,448 bytes a
    block may use; the grids cover every (sub-chunk, head, batch row)
    once (the chunk states both sides), a warp per 16 rows, and the
    state pass a thread per 4 state elements; at every (p, n) the
    kernels are instantiated for (``CHUNK_DIMS``); l 3840 is a multiple
    of every chunk."""
    pl = tkernel.bwd_plan(b, l, h, p, n, chunk, dtype)
    mma = dtype == torch.bfloat16 and chunk % 16 == 0
    assert pl.route == ("mma" if mma else "simt")
    assert chunk % pl.sub == 0 and l % pl.sub == 0
    assert pl.chunks * pl.sub == l
    assert max(pl.smem, pl.states_smem) <= tkernel.SMEM_LIMIT == 232448
    assert min(pl.blocks, pl.threads, pl.states_blocks, pl.states_threads,
               pl.pass_blocks, pl.workspace) > 0
    if mma:
        fits = [q for q in tkernel.BWD_SUBS
                if tkernel.bwd_main_smem(q, p, n) <= tkernel.SMEM_LIMIT]
        assert pl.sub == next(q for q in fits if chunk % q == 0)
        assert pl.sub == (64 if p == 128 and chunk % 64 == 0 else pl.sub)
        assert pl.threads == pl.sub // 16 * 32
        assert pl.blocks == pl.chunks * h * b
        assert pl.states_blocks == 2 * pl.chunks * h * b
        assert pl.smem == tkernel.bwd_main_smem(pl.sub, p, n)
        total4 = b * h * p * n // 4
        assert (pl.pass_blocks - 1) * tkernel.BWD_PASS_THREADS < total4 \
            <= pl.pass_blocks * tkernel.BWD_PASS_THREADS
    else:
        assert pl.sub == chunk and pl.threads == tkernel.SIMT_THREADS


def test_bwd_plan_at_mamba2_and_sub_override():
    """At mamba2-780m's train shape (b 4, l 1024, h 48, p 64, n 128,
    chunk 256) in bf16: sub-chunks of 128 (measured faster than 64 on the
    card), 1536 main blocks of 8 warps (163,328 bytes of shared memory);
    at jamba's p 128, 64. ``sub`` picks another sub-chunk; one that does
    not fit, is no multiple of 16 or does not divide l raises."""
    pl = tkernel.bwd_plan(4, 1024, 48, 64, 128, 256, torch.bfloat16)
    assert (pl.route, pl.sub, pl.blocks, pl.threads, pl.smem) == \
        ("mma", 128, 1536, 256, 163328)
    assert tkernel.bwd_plan(1, 1024, 128, 128, 128, 256,
                            torch.bfloat16).sub == 64
    pl = tkernel.bwd_plan(4, 1024, 48, 64, 128, 256, torch.bfloat16, 64)
    assert (pl.sub, pl.blocks, pl.threads) == (64, 3072, 128)
    for bad in (24, 256):
        with pytest.raises(ValueError, match="sub-chunk"):
            tkernel.bwd_plan(4, 1024, 48, 64, 128, 256, torch.bfloat16, bad)
    with pytest.raises(ValueError, match="sub-chunk"):
        tkernel.bwd_plan(1, 1024, 128, 128, 128, 256, torch.bfloat16, 128)
    with pytest.raises(ValueError, match="sub-chunk"):
        tkernel.bwd_plan(1, 96, 8, 64, 128, 32, torch.bfloat16, 64)


def _bf16_exact(args):
    """x, B and C rounded to bf16 values (kept in f32): the inputs of
    the mma route."""
    x, dt, A, B, C, D = args
    r = lambda a: np.asarray(  # noqa: E731
        torch.from_numpy(a).bfloat16().float())
    return r(x), dt, A, r(B), r(C), D


# (b, l, h, p, g, n, chunk): the plan's sub-chunk is 128, 64, 16, 32
SUB_CHUNK_CASES = [(1, 512, 8, 64, 1, 128, 256), (2, 256, 4, 32, 2, 64, 64),
                   (1, 96, 6, 32, 3, 32, 48), (2, 128, 4, 64, 1, 32, 32)]


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("case", SUB_CHUNK_CASES)
def test_ssd_plain_at_the_plans_sub_chunk_matches(case, init):
    """What justifies the mma route's sub-chunks: the plain dual form at
    the plan's sub-chunk agrees with itself at the caller's chunk and
    with the JAX oracle there, within 1e-5 of max|plain| over y and the
    final state (the same f32 algorithm; the chunk length only regroups
    the sums), from zero and from a given state."""
    *dims, chunk = case
    b, l, h, p, g, n = dims
    args = _bf16_exact(_ssd_inputs(*dims, seed=sum(dims) + init))
    s0 = np.random.default_rng(l).standard_normal((b, h, p, n)).astype(
        np.float32) if init else None
    sub = tkernel.chunk_plan(b, l, h, p, n, chunk, torch.bfloat16).sub
    assert sub < chunk or chunk in (32, 64)
    ts0 = None if s0 is None else _t(s0)
    ys, ss = ops.ssd(*map(_t, args), chunk=sub, initial_state=ts0)
    yc, sc = ops.ssd(*map(_t, args), chunk=chunk, initial_state=ts0)
    yj, sj = jref.ssd_reference(
        *map(jnp.asarray, args), chunk=chunk,
        initial_state=None if s0 is None else jnp.asarray(s0))
    for got, want in ((ys, yc), (ss, sc), (ys, yj), (ss, sj)):
        want = np.asarray(want)
        err = np.abs(np.asarray(got) - want).max()
        assert err <= 1e-5 * np.abs(want).max(), err


def _mma_route_model(x, dt, A, B, C, D, sub, s0=None, *, split=True):
    """The mma route's arithmetic in plain torch (the card kernels' three
    steps at sub-chunk ``sub``): every product with an f32 operand (x w
    in the chunk states, the weights W and the carried state in the
    outputs) takes that operand as bf16 hi + lo against an exact bf16
    partner (x, B, C rounded to bf16 beforehand), sums in f32. With
    ``split=False`` the f32 operand is rounded to bf16 once."""
    def pair(v):
        hi = v.bfloat16().float()
        return hi, ((v - hi).bfloat16().float() if split
                    else torch.zeros_like(v))

    b, l, h, p = x.shape
    g, n = B.shape[2:]
    nc = l // sub
    Bh = B.repeat_interleave(h // g, 2).reshape(b, nc, sub, h, n)
    Ch = C.repeat_interleave(h // g, 2).reshape(b, nc, sub, h, n)
    xr = x.reshape(b, nc, sub, h, p)
    dtr = dt.reshape(b, nc, sub, h)
    cum = torch.cumsum(dtr * A, dim=2)                   # (b, nc, sub, h)
    cend = cum[:, :, -1]                                 # (b, nc, h)
    w = torch.exp(cend[:, :, None] - cum) * dtr
    hi, lo = pair(xr * w[..., None])
    states = sum(torch.einsum("bcshp,bcshn->bchpn", t, Bh) for t in (hi, lo))
    s = torch.zeros((b, h, p, n)) if s0 is None else s0
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = torch.exp(cend[:, c])[..., None, None] * s + states[:, c]
    shi, slo = pair(torch.stack(s_in, 1))                # (b, nc, h, p, n)
    y = sum(torch.einsum("bcihn,bchpn->bcihp", Ch, t) for t in (shi, slo))
    y = y * torch.exp(cum)[..., None]
    scores = torch.einsum("bcihn,bcjhn->bchij", Ch, Bh)
    ci = cum.permute(0, 1, 3, 2)                         # (b, nc, h, sub)
    mask = torch.tril(torch.ones(sub, sub, dtype=torch.bool))
    W = torch.where(mask, scores * torch.exp(
        (ci[..., :, None] - ci[..., None, :]).clamp(max=0)), 0.0) \
        * dtr.permute(0, 1, 3, 2)[..., None, :]
    whi, wlo = pair(W)
    y = y + sum(torch.einsum("bchij,bcjhp->bcihp", t, xr)
                for t in (whi, wlo))
    return y.reshape(b, l, h, p) + x * D[:, None], s


@pytest.mark.parametrize("init", [False, True])
def test_mma_route_model_meets_the_gate(init):
    """The split-bf16 products hold the card's gate: the mma route's
    arithmetic, modelled in plain torch at mamba2-780m's head (p 64, n
    128) in the plan's sub-chunks (128 at chunk 256), is within
    ``SSD_TOL_REL`` = 1e-4 of max|plain| of the plain dual form over y
    and the final state; one bf16 rounding of each f32 operand instead
    misses it."""
    b, l, h, p, g, n = 1, 256, 4, 64, 1, 128
    args = [_t(a) for a in _bf16_exact(_ssd_inputs(b, l, h, p, g, n, 9))]
    s0 = _t(np.random.default_rng(10).standard_normal((b, h, p, n)).astype(
        np.float32)) if init else None
    y0, s1 = ops.ssd(*args, chunk=256, initial_state=s0)
    scale = max(y0.abs().max().item(), s1.abs().max().item())

    def rel(y, s):
        return max((y - y0).abs().max().item(),
                   (s - s1).abs().max().item()) / scale

    sub = tkernel.chunk_plan(b, l, h, p, n, 256, torch.bfloat16).sub
    assert rel(*_mma_route_model(*args, sub, s0)) <= 1e-4
    assert rel(*_mma_route_model(*args, sub, s0, split=False)) > 1e-4


@pytest.mark.parametrize("y_f32", [True, False])
@pytest.mark.parametrize("d", [1536, 3072])
@pytest.mark.parametrize("N", [1, 8, 128])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_gated_norm_plain_matches_jax(dtype, tol, N, d, y_f32):
    """The mixer's gated norm op (plain version) against the JAX model's
    expression, ``rms_norm(p, y * silu(z.astype(f32)).astype(dtype))``
    with y already in the activation dtype; z a strided slice of a
    wider in-projection row (row stride 2 d + 2 * 128 + 48, as
    mamba2-780m's 6448 at d 3072), y the SSD output in f32 or in the
    activation dtype. fp32 within 1e-5; bf16 within 2e-2 absolute plus
    2e-2 relative (one step of a bf16 output past 4 is 2^-5, and XLA
    may keep the gate's product in f32 where the port rounds it)."""
    rng = np.random.default_rng(N + d)
    y = rng.normal(size=(N, d)).astype(np.float32)
    zx = rng.normal(size=(N, 2 * d + 2 * 128 + 48)).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    z = torch.from_numpy(zx).to(tdt)[:, :d]
    got = norm_ops.gated_rmsnorm(
        torch.from_numpy(y) if y_f32 else torch.from_numpy(y).to(tdt), z,
        torch.from_numpy(scale).to(tdt), eps=1e-5)
    jz = jnp.asarray(zx, jdt)[:, :d]
    want = jax_rms_norm({"scale": jnp.asarray(scale, jdt)},
                        jnp.asarray(y).astype(jdt) * jax.nn.silu(
                            jz.astype(jnp.float32)).astype(jdt), 1e-5)
    assert got.dtype == tdt and got.shape == (N, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0 if dtype == "float32" else tol)


def test_ssd_cpu_tensors_take_the_plain_version():
    """The ops route CPU tensors to the plain versions (no launch
    counted); the kernel wrappers refuse them."""
    before = launch_counts()
    args = [_t(a) for a in _ssd_inputs(1, 16, 2, 32, 1, 32, seed=7)]
    y, s = ops.ssd(*args, chunk=16)
    assert y.device.type == "cpu" and launch_counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.ssd_cuda(*args, chunk=16)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.ssd_extend_cuda(s, *args)
    assert launch_counts() == before


# --------------------------------------------------------------------- #
# the mixer block in every mode
# --------------------------------------------------------------------- #
def _perturbed(tree, seed):
    """JAX params as numpy with the constant-init SSM leaves made random
    (D around 1, dt_bias and conv_b around 0), so each one is tested."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            v = np.asarray(v)
            if k in ("D", "dt_bias", "conv_b"):
                v = (v + 0.5 * rng.standard_normal(v.shape)).astype(v.dtype)
            out[k] = v
        return out
    return walk(tree)


def _cfgs():
    return (jax_get_arch(ARCH, variant="reduced"),
            get_arch(ARCH, variant="reduced"))


def _block_pair():
    jc, tc = _cfgs()
    jp = _perturbed(JS.init_ssm(jax.random.PRNGKey(1), jc), seed=1)
    tp = jax.tree.map(_t, jp)
    return jc, tc, jax.tree.map(jnp.asarray, jp), tp


def _same_ssm_cache(tc_, jc_, tol=TOL):
    """Every leaf of an SSM (sub-)cache: floats within tol, depths
    exactly, dtypes equal."""
    t_np = bridge.cache_to_numpy(tc_)
    j_np = jax.tree.map(np.asarray, jc_)
    assert set(t_np) == set(j_np) == set(TS.CACHE_KEYS)
    for k in TS.CACHE_KEYS:
        assert t_np[k].dtype == j_np[k].dtype, k
        assert t_np[k].shape == j_np[k].shape, k
        if k.startswith("step"):
            np.testing.assert_array_equal(t_np[k], j_np[k])
        else:
            _close(t_np[k], j_np[k], tol)


def test_ssm_block_matches_jax_in_every_mode():
    jc, tc, jp, tp = _block_pair()
    rng = np.random.default_rng(2)
    B, L, d = 3, 12, tc.d_model
    u = rng.standard_normal((B, L, d)).astype(np.float32)
    # cache-free, whole rows
    yj, _ = JS.ssm_block(jp, jnp.asarray(u), jc)
    yt, nc = TS.ssm_block(tp, _t(u), tc)
    assert nc is None
    _close(yt, yj)
    # cache-free, right-padded rows with return_cache
    length = np.array([12, 5, 2], np.int32)
    yj, cj = JS.ssm_block(jp, jnp.asarray(u), jc, return_cache=True,
                          length=jnp.asarray(length))
    yt, ct = TS.ssm_block(tp, _t(u), tc, return_cache=True,
                          length=_t(length))
    for b, n in enumerate(length):
        _close(yt[b, :n], yj[b, :n])
    _same_ssm_cache(ct, cj)
    # one decode step from that cache, in place
    u1 = rng.standard_normal((B, 1, d)).astype(np.float32)
    yj, cj = JS.ssm_block(jp, jnp.asarray(u1), jc, cache=cj)
    yt, ct2 = TS.ssm_block(tp, _t(u1), tc, cache=ct)
    assert ct2 is ct
    _close(yt, yj)
    _same_ssm_cache(ct, cj)
    # extend at per-row lengths, one of them 0
    u5 = rng.standard_normal((B, 5, d)).astype(np.float32)
    lens = np.array([5, 0, 3], np.int32)
    before = {k: v.clone() for k, v in ct.items()}
    yj, cj = JS.ssm_block(jp, jnp.asarray(u5), jc, cache=cj,
                          length=jnp.asarray(lens), mode="extend")
    yt, _ = TS.ssm_block(tp, _t(u5), tc, cache=ct, length=_t(lens),
                         mode="extend")
    for b, n in enumerate(lens):
        _close(yt[b, :n], yj[b, :n])
    _same_ssm_cache(ct, cj)
    for k in ("conv", "ssm", "step"):
        assert torch.equal(ct[k][1], before[k][1]), k
        assert torch.equal(ct[k + "_ckpt"], before[k]), k
    assert int(ct["step"][0]) == int(before["step"][0]) + 5


@pytest.mark.parametrize("L", [1, 40])
def test_ssm_block_cache_free_pads_to_a_chunk(L):
    """Lengths that are not a chunk multiple (chunk 16 at L 1, 32 at
    L 40 with 24 padded positions) give JAX's outputs and states."""
    jc, tc, jp, tp = _block_pair()
    u = np.random.default_rng(L).standard_normal((2, L, tc.d_model)).astype(
        np.float32)
    yj, cj = JS.ssm_block(jp, jnp.asarray(u), jc, return_cache=True)
    yt, ct = TS.ssm_block(tp, _t(u), tc, return_cache=True)
    _close(yt, yj)
    _same_ssm_cache(ct, cj)


# --------------------------------------------------------------------- #
# the reduced model in every mode
# --------------------------------------------------------------------- #
def _model_pair():
    jc, tc = _cfgs()
    jm, tm = jax_build(jc), build(tc, device="cpu")
    jp_np = _perturbed(jax.tree.map(np.asarray,
                                    jm.init(jax.random.PRNGKey(0))), seed=0)
    tp = bridge.params_from_jax(jp_np, tc, "cpu")
    return jm, jax.tree.map(jnp.asarray, jp_np), tm, tp


_PAIR = []


def _models():
    if not _PAIR:
        _PAIR.append(_model_pair())
    return _PAIR[0]


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 1024, shape).astype(
        np.int32)


def _same_cache(tcache, jcache, tol=TOL):
    assert set(tcache) == set(jcache)
    for sub in jcache:
        _same_ssm_cache(tcache[sub], jcache[sub], tol)


def _jitted(jm):
    """Fresh jitted step functions: a new function object each call, so
    an environment set before the call decides the route they trace."""
    return (jax.jit(lambda p, b, c: jm.prefill(p, b, c)),
            jax.jit(lambda p, t, c: jm.decode_step(p, t, c)),
            jax.jit(lambda p, t, c, n: jm.extend_into_cache(p, t, c, n)),
            jax.jit(lambda p, t: JT.forward_train(p, jm.cfg, t)[0]))


@pytest.mark.parametrize("route", ["default", "pallas"])
def test_model_matches_jax_in_every_mode(route, monkeypatch):
    traced = []
    if route == "pallas":
        monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")
        for name in ("ssd_pallas", "ssd_extend_pallas"):
            fn = getattr(jkernel, name)
            monkeypatch.setattr(jkernel, name, lambda *a, _f=fn, _n=name,
                                **k: traced.append(_n) or _f(*a, **k))
    jm, jp, tm, tp = _models()
    j_prefill, j_decode, j_extend, j_train = _jitted(jm)
    tol = TOL if route == "default" else PALLAS_TOL
    # forward_train
    toks = _tokens((2, 12), seed=0)
    lj = j_train(jp, jnp.asarray(toks))
    lt, _ = TT.forward_train(tp, tm.cfg, _t(toks).long())
    _close(lt, lj, tol)
    # prefill (right-padded rows) then decode
    length = np.array([12, 7], np.int32)
    jcache = jm.make_cache(2, 32)
    lj, jcache = j_prefill(jp, {"tokens": jnp.asarray(toks),
                                "length": jnp.asarray(length)}, jcache)
    tcache = tm.make_cache(2, 32)
    lt, _ = tm.prefill(tp, {"tokens": _t(toks).long(),
                            "length": _t(length)}, tcache)
    _close(lt, lj, tol)
    _same_cache(tcache, jcache, tol)
    nxt = _tokens((2, 1), seed=1)
    lj, jcache = j_decode(jp, jnp.asarray(nxt), jcache)
    lt, _ = tm.decode_step(tp, _t(nxt).long(), tcache)
    _close(lt, lj, tol)
    _same_cache(tcache, jcache, tol)
    # extend at per-row lengths (one 0) on that cache
    ext = _tokens((2, 6), seed=2)
    lens = np.array([6, 0], np.int32)
    lj, jcache = j_extend(jp, jnp.asarray(ext), jcache, jnp.asarray(lens))
    lt, _ = tm.extend_into_cache(tp, _t(ext).long(), tcache, _t(lens))
    _close(lt[0], lj[0], tol)
    _same_cache(tcache, jcache, tol)
    if route == "pallas":        # JAX's traces went through both kernels
        assert {"ssd_pallas", "ssd_extend_pallas"} <= set(traced)


def test_extend_from_a_jax_cache_and_rollback_match_jax():
    """A JAX cache crosses the bridge leaf for leaf; after an extend the
    rollback of ``set_cache_steps`` restores the checkpoints on the rows
    it moves back and leaves the others, as JAX's does."""
    jm, jp, tm, tp = _models()
    toks = _tokens((2, 9), seed=3)
    _, jcache = jm.extend_into_cache(jp, jnp.asarray(toks),
                                     jm.make_cache(2, 32))
    tcache = bridge.cache_from_jax(jax.tree.map(np.asarray, jcache), "cpu")
    _same_cache(tcache, jcache, 0.0)
    ext = _tokens((2, 4), seed=4)
    lens = np.array([4, 2], np.int32)
    _, jcache = jm.extend_into_cache(jp, jnp.asarray(ext), jcache,
                                     jnp.asarray(lens))
    tm.extend_into_cache(tp, _t(ext).long(), tcache, _t(lens))
    _same_cache(tcache, jcache)
    steps = np.array([9, 11], np.int32)          # row 0 back, row 1 stays
    jback = JT.set_cache_steps(jcache, jnp.asarray(steps))
    kept = bridge.cache_to_numpy(tcache)
    TT.set_cache_steps(tcache, _t(steps))
    _same_cache(tcache, jback)
    assert TT.cache_steps(tcache).tolist() == [9, 11]
    got = bridge.cache_to_numpy(tcache)
    for k in ("conv", "ssm"):
        np.testing.assert_array_equal(got["sub0"][k][:, 0],
                                      kept["sub0"][k + "_ckpt"][:, 0])
        np.testing.assert_array_equal(got["sub0"][k][:, 1],
                                      kept["sub0"][k][:, 1])


def test_param_tree_and_init():
    """The full-width tree counts JAX's ``param_count`` plus what its
    analytic count leaves out (the conv bias of each layer and the final
    norm), equals JAX's tree in shapes, and the port's own init keeps
    ``A_log``/``D``/``dt_bias`` in f32 with A = -exp(A_log) < 0."""
    cfg, jcfg = get_arch(ARCH), jax_get_arch(ARCH)
    shapes = TT.param_shapes(cfg)
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(
        shapes, is_leaf=lambda x: isinstance(x, tuple)))
    assert param_count(jcfg) == 857_217_792
    assert n == param_count(jcfg) + 48 * 3328 + 1536
    jshapes = jax.eval_shape(lambda: JT.init_transformer(
        jax.random.PRNGKey(0), jcfg))
    want = jax.tree.map(lambda a: tuple(a.shape), jshapes)
    assert jax.tree.map(tuple, shapes, is_leaf=lambda x: isinstance(
        x, tuple)) == want
    tc = get_arch(ARCH, variant="reduced").replace(param_dtype="bfloat16",
                                                   dtype="bfloat16")
    p = build(tc, "cpu").init(0)
    blk = p["blocks"]["sub0"]["ssm"]
    for k in TS.F32_LEAVES:
        assert blk[k].dtype == torch.float32, k
    assert blk["in_proj"]["w"].dtype == torch.bfloat16
    assert (-torch.exp(blk["A_log"]) < 0).all()
    assert set(p["blocks"]["sub0"]) == {"ln1", "ssm"}


def test_bridge_checks_ssm_dtypes():
    jc = jax_get_arch(ARCH, variant="reduced").replace(
        param_dtype="bfloat16", dtype="bfloat16")
    tc = get_arch(ARCH, variant="reduced").replace(param_dtype="bfloat16",
                                                   dtype="bfloat16")
    tree = jax.tree.map(np.asarray,
                        jax_build(jc).init(jax.random.PRNGKey(0)))
    tp = bridge.params_from_jax(tree, tc, "cpu")
    assert tp["blocks"]["sub0"]["ssm"]["A_log"].dtype == torch.float32
    tree["blocks"]["sub0"]["ssm"]["D"] = \
        tree["blocks"]["sub0"]["ssm"]["D"].astype(tree["ln_f"]["scale"].dtype)
    with pytest.raises(ValueError, match="dtype"):
        bridge.params_from_jax(tree, tc, "cpu")


def test_unported_ssm_options_raise():
    """The edge profile and weight quantization on an SSM stack build and
    serve on the CPU: the mixer's projections are QTensors and every
    request finishes (their tokens against the JAX engine's:
    tests/test_torch_families_quant.py)."""
    from repro_torch.quant import quantize_for_cfg
    from repro_torch.quant.qtensor import is_qtensor
    for cfg in (get_arch(ARCH, variant="reduced+edge"),
                get_arch(ARCH, variant="reduced").replace(quant="int8")):
        model = build(cfg, "cpu")
        params = quantize_for_cfg(model.init(0), cfg)
        assert is_qtensor(params["blocks"]["sub0"]["ssm"]["out_proj"]["w"])
        engine = Engine(model, params, max_batch=2, cache_len=32,
                        prefill_chunk=8)
        for uid in range(3):
            engine.submit(Request(uid=uid, prompt=np.arange(5 + uid),
                                  max_new_tokens=4))
        out = engine.run()
        assert all(r.finished and len(r.tokens) == 4 for r in out.values())


# --------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------- #
def _requests():
    rng = np.random.default_rng(1)
    return [(uid, rng.integers(0, 1024, L)) for uid, L in
            enumerate((3, 11, 17))]


@pytest.mark.parametrize("chunk", [0, 8])
def test_engine_matches_jax_engine(chunk):
    """Three requests on two slots (the third reuses a slot, so the reset
    of its SSM state is exercised), greedy tokens identical."""
    jm, jp, tm, tp = _models()
    je = JaxEngine(jm, jp, max_batch=2, cache_len=64, sampler=JaxSampler(),
                   prefill_chunk=chunk)
    te = Engine(tm, tp, max_batch=2, cache_len=64, prefill_chunk=chunk)
    for uid, prompt in _requests():
        je.submit(JaxRequest(uid=uid, prompt=prompt, max_new_tokens=6))
        te.submit(Request(uid=uid, prompt=prompt, max_new_tokens=6))
    jr, tr = je.run(), te.run()
    assert sorted(tr) == sorted(jr) == [0, 1, 2]
    for uid in jr:
        assert tr[uid].tokens == jr[uid].tokens, uid
        assert tr[uid].finish_reason == jr[uid].finish_reason == "length"
    assert len({t for r in tr.values() for t in r.tokens}) > 1
    assert {"plain", "mixed"} <= set(te.step_kinds)


def test_engine_slot_reset_zeroes_ssm_state():
    _, _, tm, tp = _models()
    te = Engine(tm, tp, max_batch=2, cache_len=64, prefill_chunk=8)
    te.submit(Request(uid=0, prompt=np.arange(5), max_new_tokens=3))
    te.run()
    sub = te.cache["sub0"]
    assert int(sub["step"][0, 0]) > 0 and sub["ssm"][:, 0].abs().sum() > 0
    te._reset_slot(0)
    for k, leaf in sub.items():
        assert not leaf[:, 0].any(), k


def test_engine_paged_and_long_prompts_raise_as_jax():
    jm, jp, tm, tp = _models()
    with pytest.raises(ValueError, match="paged"):
        JaxEngine(jm, jp, max_batch=2, cache_len=64, paged=True)
    with pytest.raises(ValueError, match="paged"):
        Engine(tm, tp, max_batch=2, cache_len=64, paged=True)
    je = JaxEngine(jm, jp, max_batch=2, cache_len=16)
    te = Engine(tm, tp, max_batch=2, cache_len=16)
    with pytest.raises(ValueError, match="exceeds"):
        je.submit(JaxRequest(uid=0, prompt=np.arange(17), max_new_tokens=2))
    with pytest.raises(ValueError, match="exceeds"):
        te.submit(Request(uid=0, prompt=np.arange(17), max_new_tokens=2))
    with pytest.raises(NotImplementedError, match="attention-only"):
        TT.make_paged_cache(tm.cfg, 2, 16, page_size=8, num_pages=4)


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch import serve
    responses, stats = serve.main([
        "--arch", ARCH, "--variant", "reduced", "--device", "cpu",
        "--requests", "6", "--max-new", "8", "--max-batch", "2",
        "--cache-len", "64", "--prefill-chunk", "8", "--temperature", "0"])
    out = capsys.readouterr().out
    assert "arch=mamba2-780m-reduced" in out and "tokens=48" in out
    assert stats["n_finished"] == 6
    assert all(r.finish_reason == "length" and len(r.tokens) == 8
               for r in responses.values())


def test_reduced_rule_and_ssm_config_match_jax():
    """The port's SSMConfig and the attention-free ``reduced`` rule give
    the JAX package's fields."""
    jc, tc = _cfgs()
    assert dataclasses.asdict(tc.ssm) == dataclasses.asdict(jc.ssm)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab", "head_dim", "dtype", "param_dtype"):
        assert getattr(tc, f) == getattr(jc, f), f
    full = get_arch(ARCH)
    assert dataclasses.asdict(full.ssm) == dataclasses.asdict(
        jax_get_arch(ARCH).ssm)
