"""ctypes bindings of the CUDA SSD kernels (``csrc/ssd_scan.cu``):
``ssd_extend_cuda``, the sequential recurrence from an explicit state (it
replaces the JAX package's ``ssd_extend_pallas``), and ``ssd_cuda``, the
chunked dual form (``ssd_pallas``), in one library; and
``ssd_bwd_cuda``, the dual form's backward (``csrc/ssd_scan_bwd.cu``,
which shares ``csrc/ssd_common.cuh`` with the forward), in another. Both
are built with ``nvcc`` on first use (``kernels/_build.py``).

The wrappers check devices, dtypes, shapes and strides and raise on what
the kernels do not take; they pass strides, so the x/B/C slices of the
model's conv output go to the kernels uncopied (an input whose last
dimension is not contiguous is copied first). States are never copied:
a state output must have contiguous (h, p, n) dimensions. Outputs are allocated
here; the extend kernel writes its new state into ``out`` when given (the
cache's own leaf, in place) and the incoming state into ``ckpt``.

The extend kernel's launch comes from ``extend_plan``, a pure function of
the shapes: ``tt`` tokens a tile (1, the decode route, at T = 1; else 16,
the chunk route, which advances the state through a tile before it
reduces the tile's readouts together) and ``rows`` state rows a block (2
a warp), the fewest that keep the grid within one block per SM, else 32.
Both routes run one arithmetic per token, so a token's bits depend
neither on T nor on the route.

The dual form's launch comes from ``chunk_plan``: bf16 x, B, C with a
chunk that is a multiple of 16 take the ``mma`` route (three launches
parallel over sub-chunks of ``sub`` tokens: the chunk states, the state
pass, the outputs; tensor-core products), everything else the ``simt``
route (one block per (head, batch row) walking the chunks). The ``mma``
route's workspace of chunk states is allocated here with the outputs.

The dual form runs through ``_autograd.differentiable``: with no
gradient to ask for, the plain launch; where a gradient could be asked
for, inside a node whose backward is ``ssd_bwd_cuda``
(``csrc/ssd_scan_bwd.cu``; it replaces no TPU kernel: the JAX package
differentiates its plain scan) on the route ``bwd_plan`` picks: bf16
with a chunk that is a multiple of 16 the ``mma`` route (five launches
in the backward's own sub-chunks, tensor-core products, one block a
sub-chunk of a head for all its gradients), else the ``simt`` route
(seven launches at the caller's chunk). The forward keeps nothing for
it: the backward recomputes each chunk's incoming state, so serving
launches are those of before. Its plain version is
``ref.ssd_backward_reference``; it counts one launch a call in
``ssd_bwd_cuda.launches``. The extend kernel (and ``ssd_step``, that
kernel at T = 1) runs through ``_autograd.launch``: it is for inference
only (no training path differentiates the recurrence: the train forward
runs the dual form), and a backward pass through it raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _autograd, _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)         # p the kernels take
STATE_DIMS = (32, 64, 128)        # n
#: the (p, n) pairs the dual form is instantiated for: every n at p 32
#: and 64, and Jamba's p 128 at n 128 (the recurrence takes any pair)
CHUNK_DIMS = tuple((p, n) for p in (32, 64) for n in STATE_DIMS) \
    + ((128, 128),)
MAX_CHUNK = 256
#: the dual form's mma route: sub-chunks it may work in (largest first;
#: ``chunk_plan`` takes the first that divides the chunk), the largest
#: the kernels hold, threads of the chunk-states and state-pass kernels,
#: the sub-steps (1: chunk states, 2: state pass, 4: outputs)
MMA_SUBS = (128, 64, 32, 16)
MMA_MAX_SUB = 128
STATES_THREADS = 128              # 4 warps; a warp a 16-row m-tile above
PASS_THREADS = 256
STEPS_ALL = 7
#: the most query rows a block of the outputs kernel takes (4 warps)
OUT_ROWS = 64
#: the simt route's tiles (``ssd_chunk_kernel``)
SIMT_THREADS = 256
SIMT_TILE = 64
#: the backward's mma route: the sub-chunks it may work in, in order of
#: preference (``bwd_plan`` takes the first that divides the chunk and
#: whose main kernel fits a block's shared memory, ``SMEM_LIMIT``), and
#: the threads of its kernels: chunk states as the forward's, the state
#: pass a thread per 4 elements, the main kernel a warp per 16 rows
BWD_SUBS = (128, 64, 32, 16)
BWD_PASS_THREADS = 256
SMEM_LIMIT = 232448
#: the simt backward's tiles (PR 32's kernels, csrc ``TILE``)
BWD_SIMT_TILE = 64
#: the extend kernel: state rows a warp, the most rows a block (16
#: warps), tokens a tile on the chunk route, the staging ring's depth, the
#: SMs a grid aims to fill at most once
EXT_RPW = 2
EXT_MAX_ROWS = 32
EXT_TILE = 16
EXT_STAGES = 3
SMS = 132
_FNS = {}


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the C signatures of ``csrc/ssd_scan.cu``'s entry points
ARGTYPES = {"ssd_extend_launch": [_P] * 10 + [_I] * 8 + [_LL] * 14 + [_P],
            "ssd_chunk_launch": [_P] * 9 + [_I] * 8 + [_LL] * 11 + [_P],
            "ssd_chunk_mma_launch": [_P] * 12 + [_I] * 8 + [_LL] * 11
            + [_P],
            "ssd_bwd_launch": [_P] * 23 + [_I] * 8 + [_LL] * 11 + [_P],
            "ssd_bwd_mma_launch": [_P] * 25 + [_I] * 7 + [_LL] * 11
            + [_P]}
#: the library of each entry point (the backward has its own source)
_STEMS = {"ssd_bwd_launch": "ssd_scan_bwd",
          "ssd_bwd_mma_launch": "ssd_scan_bwd"}


def _launcher(name):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load(_STEMS.get(name, "ssd_scan")), name)
        fn.argtypes = ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _rows(*ts):
    """The inputs with their last dimension made contiguous (copied only
    where it is not)."""
    return [t if t.stride(-1) == 1 else t.contiguous() for t in ts]


def _check_dims(name, x, dt, A, B, C, D):
    """The checks both wrappers share; returns (b, T, h, p, g, n)."""
    b, T, h, p = x.shape
    if B.dim() != 4 or C.shape != B.shape or B.shape[:2] != (b, T):
        raise ValueError(f"{name}: want B, C (b, T, g, n) matching x "
                         f"{tuple(x.shape)}; got {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    g, n = B.shape[2], B.shape[3]
    if dt.shape != (b, T, h) or A.shape != (h,) or D.shape != (h,):
        raise ValueError(f"{name}: want dt (b, T, h), A and D (h,); got "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(D.shape)}")
    if h % g:
        raise ValueError(f"{name}: {h} heads do not split into {g} groups")
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"{name}: head dim {p} / state dim {n} not "
                         f"supported (want p in {HEAD_DIMS}, n in "
                         f"{STATE_DIMS})")
    if dt.dtype != torch.float32 or A.dtype != torch.float32 \
            or D.dtype != torch.float32:
        raise TypeError(f"{name}: dt, A and D must be float32")
    if not A.is_contiguous() or not D.is_contiguous():
        raise ValueError(f"{name}: A and D must be contiguous")
    return b, T, h, p, g, n


def _check_state(name, t, b, h, p, n):
    if t.shape != (b, h, p, n) or t.dtype != torch.float32:
        raise ValueError(f"{name}: want a (b, h, p, n) = {(b, h, p, n)} "
                         f"float32 state; got {tuple(t.shape)} {t.dtype}")
    if t.stride()[1:] != (p * n, n, 1):
        raise ValueError(f"{name}: a state's (h, p, n) dimensions must be "
                         f"contiguous (any batch stride); strides "
                         f"{t.stride()}")


class ExtendPlan(NamedTuple):
    """How one extend call runs: ``tt`` tokens a tile, ``rows`` state
    rows a block (``rows // 2`` warps, ``threads`` threads), a grid of
    ``blocks`` (the (h * p) // rows blocks of a batch row, by ``batch``)
    and ``smem`` bytes of dynamic shared memory a block."""
    tt: int
    rows: int
    blocks: int
    batch: int
    threads: int
    smem: int


def extend_smem_bytes(tt: int, n: int) -> int:
    """The kernel's ``ExtSmem<tt, n>``: the staging ring of B, C (tt x n
    each), x (16 warps x tt x 2) and dt (16 x tt), and a warp's x*dt and
    decay."""
    w = EXT_MAX_ROWS // EXT_RPW
    ring = 2 * tt * n + w * tt * EXT_RPW + w * tt
    return 4 * (EXT_STAGES * ring + w * tt * EXT_RPW + w * tt)


def extend_plan(b: int, T: int, h: int, p: int, g: int,
                n: int) -> ExtendPlan:
    """The extend launch for state (b, h, p, n) over T tokens with g
    groups: the chunk route (tiles of ``EXT_TILE`` tokens) for T > 1, the
    decode route (tt 1) at T = 1; ``rows`` the smallest even number up
    to 32 that divides a group's (h / g) * p rows and gives at most
    ``SMS`` blocks (b 1 at mamba2's dims: 24 rows, 128 blocks), else 32
    (decode at b 8: 768 blocks, one per 32 rows)."""
    per_group, total = h // g * p, b * h * p
    rows = next((r for r in range(EXT_RPW, EXT_MAX_ROWS + 1, EXT_RPW)
                 if per_group % r == 0 and total // r <= SMS),
                EXT_MAX_ROWS)
    tt = 1 if T == 1 else EXT_TILE
    return ExtendPlan(tt, rows, h * p // rows, b, rows // EXT_RPW * 32,
                      extend_smem_bytes(tt, n))


def ssd_extend_cuda(state, x, dt, A, B, C, D=None, *, out=None, ckpt=None):
    """T recurrence steps from ``state`` (b, h, p, n) f32: x (b, T, h, p),
    dt (b, T, h), B/C (b, T, g, n), all f32; A, D (h,) f32. Returns (y (b,
    T, h, p) f32, new state). The new state is written into ``out`` when
    given (it may be ``state`` itself), else into a new tensor; ``ckpt``,
    when given, receives the incoming state. Raises on any input the
    kernel does not take, when the launch is refused, and in a backward
    pass."""
    if D is None:
        D = torch.zeros_like(A)
    return _autograd.launch("ssd_extend", _launch_extend, state, x, dt, A,
                            B, C, D, out, ckpt)


def _launch_extend(state, x, dt, A, B, C, D, out, ckpt):
    ts = [t for t in (state, x, dt, A, B, C, D, out, ckpt) if t is not None]
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("ssd_extend_cuda takes CUDA tensors on one device")
    if x.dim() != 4 or any(t.dtype != torch.float32 for t in (x, B, C)):
        raise TypeError(f"ssd_extend_cuda: want 4-D float32 x, B, C; got "
                        f"{tuple(x.shape)} {x.dtype}, {B.dtype}, {C.dtype}")
    x, dt, B, C = _rows(x, dt, B, C)
    b, T, h, p, g, n = _check_dims("ssd_extend_cuda", x, dt, A, B, C, D)
    if out is None:
        out = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    for t in (state, out) + (() if ckpt is None else (ckpt,)):
        _check_state("ssd_extend_cuda", t, b, h, p, n)
    y = torch.empty((b, T, h, p), dtype=torch.float32, device=x.device)
    pl = extend_plan(b, T, h, p, g, n)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _launcher("ssd_extend_launch")(
        state.data_ptr(), out.data_ptr(),
        None if ckpt is None else ckpt.data_ptr(), x.data_ptr(),
        dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        D.data_ptr(), y.data_ptr(), b, T, h, g, p, n, pl.rows, pl.tt,
        state.stride(0), out.stride(0),
        0 if ckpt is None else ckpt.stride(0),
        x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1),
        B.stride(0), B.stride(1), B.stride(2),
        C.stride(0), C.stride(1), C.stride(2), stream)
    ssd_extend_cuda.launches += 1
    if err != 0:
        raise RuntimeError(f"ssd_extend kernel launch failed: CUDA error "
                           f"{err}")
    return y, out


ssd_extend_cuda.launches = 0


class ChunkPlan(NamedTuple):
    """How one dual-form call runs: the ``route`` ("mma" or "simt"),
    ``sub`` tokens a sub-chunk (on simt the caller's chunk) and the
    ``chunks`` of them in l; the outputs kernel's grid of ``blocks``
    (``chunks`` x ``sub // rows`` x h x b on mma, h x b on simt) that take
    ``rows`` query rows each (simt: a whole sequence), of ``threads``
    threads and ``smem`` bytes of dynamic shared memory; on mma also the
    chunk-states kernel's ``states_blocks`` (``chunks`` x h x b) of
    ``states_threads`` threads and ``states_smem`` bytes, the state
    pass's ``pass_blocks`` of ``PASS_THREADS`` (a thread per 4 state
    elements) and the ``workspace`` bytes: the chunk states (b h chunks p
    n f32, written by the first kernel and read by the state pass), the
    incoming states as split bf16 pairs (the same bytes, written by the
    pass and read by the outputs kernel) and the decays (b h chunks f32);
    all 0 on simt."""
    route: str
    sub: int
    chunks: int
    rows: int
    blocks: int
    threads: int
    smem: int
    states_blocks: int
    states_threads: int
    states_smem: int
    pass_blocks: int
    workspace: int


def _out_region(q: int, p: int, n: int) -> int:
    """The outputs kernel's shared region in bf16 elements: the split
    state (2 x p x (n + 8)), later B and x (q x (n + 8 + p + 8))."""
    return max(2 * p * (n + 8), q * (n + p + 16))


def chunk_plan(b: int, l: int, h: int, p: int, n: int, chunk: int,
               dtype, sub: int = 0) -> ChunkPlan:
    """The dual form's launch for x (b, l, h, p), B/C (b, l, g, n) in
    ``dtype`` at ``chunk``. bf16 with a chunk that is a multiple of 16:
    the ``mma`` route, in sub-chunks of the first of ``MMA_SUBS`` that
    divides the chunk (``sub`` overrides it: any multiple of 16 up to
    ``MMA_MAX_SUB`` dividing l); the outputs kernel takes ``OUT_ROWS``
    query rows a block at most. 128 at mamba2's chunk 256: at b 1, l
    1024, h 48, 384 chunk-state blocks (3 an SM: one wave) and 768
    output blocks of 4 warps (70 KB of shared memory, 3 an SM), with
    12.6 MB of chunk states; 64 doubles the chunk-state bytes and
    measured slower on the card (``PERF.md`` §6, row 8). f32, or a chunk
    that is no multiple of 16: the ``simt`` route, one block per (head,
    batch row) at the caller's chunk."""
    if dtype == torch.bfloat16 and chunk % 16 == 0:
        q = sub or next(s for s in MMA_SUBS if chunk % s == 0)
        if q % 16 or not 16 <= q <= MMA_MAX_SUB or l % q:
            raise ValueError(f"ssd_cuda: sub-chunk {q} must be a multiple "
                             f"of 16 up to {MMA_MAX_SUB} dividing l = {l}")
        nc, rows = l // q, min(q, OUT_ROWS)
        states_smem = 2 * q * (n + 8) + 4 * q * (p + 8) + 8 * MMA_MAX_SUB
        states_threads = max(STATES_THREADS, p // 16 * 32)
        smem = 2 * (rows * (n + 8) + _out_region(q, p, n)) \
            + 8 * MMA_MAX_SUB
        total4 = b * h * p * n // 4
        return ChunkPlan("mma", q, nc, rows, nc * (q // rows) * h * b,
                         rows // 16 * 32, smem, nc * h * b, states_threads,
                         states_smem, -(-total4 // PASS_THREADS),
                         4 * b * h * nc * (2 * p * n + 1))
    t = SIMT_TILE
    smem = 4 * (p * (n + 1) + 2 * t * (n + 1) + t * (p + 1) + t * (t + 1)
                + 2 * MAX_CHUNK + t + 32)
    return ChunkPlan("simt", chunk, l // chunk, l, h * b, SIMT_THREADS, smem,
                     0, 0, 0, 0, 0)


def ssd_cuda(x, dt, A, B, C, D=None, *, chunk=64, initial_state=None):
    """The chunked scan: x, B, C (b, l, h, p) / (b, l, g, n) in one of
    float32 or bfloat16, dt (b, l, h), A and D (h,) f32; l % chunk == 0,
    chunk <= 256. ``initial_state`` (b, h, p, n) f32 seeds the carried
    state (zero when None). Returns (y (b, l, h, p) f32, final state (b,
    h, p, n) f32), on the route ``chunk_plan`` picks; where a gradient
    can be asked for, through a node whose backward runs
    ``ssd_bwd_cuda``. Raises on any input the kernels do not take and
    when a launch is refused."""
    if D is None:
        D = torch.zeros_like(A)
    return _autograd.differentiable(_launch_chunk, _ssd_fwd, _ssd_bwd, x, dt,
                                    A, B, C, D, chunk, initial_state)


def _ssd_fwd(x, dt, A, B, C, D, chunk, initial_state):
    return (_launch_chunk(x, dt, A, B, C, D, chunk, initial_state),
            (x, dt, A, B, C, D, initial_state), chunk)


def _ssd_bwd(chunk, saved, dy, dfinal):
    x, dt, A, B, C, D, s0 = saved
    if dy is None and dfinal is None:
        return (None,) * 8
    if dy is None:           # only the final state took part
        dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    dx, ddt, dA, dB, dC, dD, dinit = ssd_bwd_cuda(
        x, dt, A, B, C, D, dy, dfinal, chunk=chunk, initial_state=s0)
    return dx, ddt, dA, dB, dC, dD, None, dinit


class BwdPlan(NamedTuple):
    """How one backward call runs: the ``route`` ("mma" or "simt"),
    ``sub`` tokens a sub-chunk (on simt the caller's chunk) and the
    ``chunks`` of them in l. On mma, the main kernel's grid of
    ``blocks`` (``chunks`` x h x b, one a sub-chunk of a head and batch
    row) of ``threads`` (a warp per 16 rows) and ``smem`` bytes, the
    chunk-states kernel's ``states_blocks`` (both sides: ``chunks`` x h x
    2 b) of ``states_threads`` and ``states_smem`` bytes, and the state
    pass's ``pass_blocks``; on simt the query and key kernels' grid,
    threads and shared memory (the key kernel's, the larger), and the
    chunk-states kernel's. ``workspace``: the bytes the call allocates
    beside its outputs."""
    route: str
    sub: int
    chunks: int
    blocks: int
    threads: int
    smem: int
    states_blocks: int
    states_threads: int
    states_smem: int
    pass_blocks: int
    workspace: int


def bwd_main_smem(q: int, p: int, n: int) -> int:
    """The mma backward's main kernel (csrc ``bwd_main_smem``): C and B
    [q][n + 8], x and dy's hi and lo [q][p + 8] bf16, the state region
    (S_in's hi and lo, then G's: 2 [p][n + 8] bf16) and seven f32 rows of
    ``MMA_MAX_SUB``."""
    return 2 * (2 * q * (n + 8) + 3 * q * (p + 8) + 2 * p * (n + 8)) \
        + 28 * MMA_MAX_SUB


def bwd_plan(b: int, l: int, h: int, p: int, n: int, chunk: int, dtype,
             sub: int = 0) -> BwdPlan:
    """The backward's launch for x (b, l, h, p), B/C (b, l, g, n) in
    ``dtype`` at ``chunk`` (the dual form's gradient does not depend on
    the chunk, so the backward works in its own). bf16 with a chunk that
    is a multiple of 16: the ``mma`` route, in sub-chunks of the first of
    ``BWD_SUBS`` that divides the chunk and whose main kernel fits
    ``SMEM_LIMIT`` (64 at p 128); ``sub`` overrides it (a multiple of 16
    up to ``MMA_MAX_SUB`` dividing l that fits). f32, or a chunk that is
    no multiple of 16: the ``simt`` route at the caller's chunk."""
    if dtype == torch.bfloat16 and chunk % 16 == 0:
        fits = [q for q in BWD_SUBS if bwd_main_smem(q, p, n) <= SMEM_LIMIT]
        q = sub or next(q for q in fits if chunk % q == 0)
        if q not in fits or l % q:
            raise ValueError(f"ssd_bwd_cuda: sub-chunk {q} must be one of "
                             f"{fits} dividing l = {l}")
        nc = l // q
        pn = p * n
        workspace = 4 * (2 * b * h * nc * pn + 2 * b * l * h * n
                         + b * h * nc * (1 + pn // 128) + 2 * b * nc * h) \
            + 2 * 4 * b * h * nc * pn
        total4 = b * h * pn // 4
        return BwdPlan("mma", q, nc, nc * h * b, q // 16 * 32,
                       bwd_main_smem(q, p, n), 2 * nc * h * b,
                       max(STATES_THREADS, p // 16 * 32),
                       2 * q * (n + 8) + 4 * q * (p + 8) + 12 * MMA_MAX_SUB,
                       -(-total4 // BWD_PASS_THREADS), workspace)
    t, nc = BWD_SIMT_TILE, l // chunk
    key = 2 * t * (n + 1) + 2 * t * (p + 1) + 2 * t * (t + 1) \
        + 2 * MAX_CHUNK + 32
    states = t * (p + 1) + t * (n + 1) + t + 2 * MAX_CHUNK + 32
    workspace = 4 * (2 * b * h * nc * p * n + b * h * nc + 5 * b * h * l
                     + 2 * b * l * h * n + 2 * b * nc * h)
    return BwdPlan("simt", chunk, nc, nc * -(-chunk // t) * h * b,
                   SIMT_THREADS, 4 * key, 2 * nc * h * b, SIMT_THREADS,
                   4 * states, -(-b * h * p * n // SIMT_THREADS), workspace)


def bwd_workspace(b: int, l: int, h: int, p: int, g: int, n: int,
                  chunk: int, device):
    """The backward's f32 workspace, one allocation cut into (s_in, g_out,
    decay, pos, wdB, wdC, part): the chunks' incoming states and outgoing
    state gradients (b, h, l / chunk, p, n) each, their decays (b, h, l /
    chunk), five per-token planes (5, b, h, l), dB and dC a head (b, l,
    h, n) each, and the partial sums of dA and dD (2, b, l / chunk, h);
    54 MB + 2 x 101 MB at mamba2-780m's train shape (b 4, l 1024)."""
    nc = l // chunk
    sizes = (b * h * nc * p * n, b * h * nc * p * n, b * h * nc,
             5 * b * h * l, b * l * h * n, b * l * h * n, 2 * b * nc * h)
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    return torch.split(flat, sizes)


def bwd_mma_workspace(b: int, l: int, h: int, p: int, n: int, sub: int,
                      device):
    """The mma backward's workspace: one f32 allocation cut into (own,
    into, wdB, wdC, decay, gdot, part) -- the sub-chunks' own states
    (then their incoming states) and the sums sum_i e^{c_i} dy_i C_i^T
    (b, h, l / sub, p, n) each, dB and dC a head (b, l, h, n) each, the
    decays (b, h, l / sub), the pass's warp partials of <G, S_in> (b, h,
    l / sub, p n / 128) and the partial sums of dA and dD (2, b, l / sub,
    h), every piece that the kernels read by 8 or 16 bytes first; and one
    bf16 allocation cut into the incoming states and their gradients as
    split pairs (b, h, l / sub, 2, p, n) each."""
    nc = l // sub
    sizes = (b * h * nc * p * n, b * h * nc * p * n, b * l * h * n,
             b * l * h * n, b * h * nc, b * h * nc * (p * n // 128),
             2 * b * nc * h)
    f32 = torch.split(torch.empty(sum(sizes), dtype=torch.float32,
                                  device=device), sizes)
    pairs = torch.empty(2 * b * h * nc * 2 * p * n, dtype=torch.bfloat16,
                        device=device).chunk(2)
    return f32 + pairs


def _aligned(t):
    """``t`` contiguous on a 16-byte boundary (the kernels' float4s)."""
    if t is None:
        return None
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ssd_bwd_cuda(x, dt, A, B, C, D, dy, dfinal=None, *, chunk=64,
                 initial_state=None):
    """The backward kernels on the current stream, on the route
    ``bwd_plan`` picks: x, dt, A, B, C, D and ``initial_state`` as the
    forward took them (the dual form's function does not depend on its
    route or on the forward's chunk; ``chunk`` here sets the backward's
    own), ``dy`` the gradient of y (b, l, h, p) f32 and ``dfinal`` that
    of the final state (b, h, p, n) f32 or None, any strides (made
    contiguous once here). Returns (dx, ddt, dA, dB, dC, dD, dinit): new
    contiguous tensors, dx, dB and dC in the dtypes of x, B and C, ddt
    (b, l, h), dA, dD (h,) and dinit (b, h, p, n; None without an initial
    state) f32. Raises on any input the kernels do not take and when a
    launch is refused."""
    return _bwd_at_sub(x, dt, A, B, C, D, dy, dfinal, chunk,
                       initial_state, 0)


def _bwd_at_sub(x, dt, A, B, C, D, dy, dfinal, chunk, initial_state, sub):
    """``ssd_bwd_cuda`` on ``bwd_plan``'s route with its ``sub`` override
    (0: the plan's sub-chunk), for a timing or test run at another
    sub-chunk."""
    ts = [t for t in (x, dt, A, B, C, D, dy, dfinal, initial_state)
          if t is not None]
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("ssd_bwd_cuda takes CUDA tensors on one device")
    if x.dim() != 4 or x.dtype not in _DTYPES or B.dtype != x.dtype \
            or C.dtype != x.dtype:
        raise TypeError(f"ssd_bwd_cuda: want 4-D x, B, C of one dtype of "
                        f"{list(_DTYPES)}; got {tuple(x.shape)} {x.dtype}, "
                        f"{B.dtype}, {C.dtype}")
    x, dt, B, C = _rows(x, dt, B, C)
    b, l, h, p, g, n = _check_dims("ssd_bwd_cuda", x, dt, A, B, C, D)
    if (p, n) not in CHUNK_DIMS:
        raise ValueError(f"ssd_bwd_cuda: head dim {p} with state dim {n} "
                         f"is not instantiated (want one of {CHUNK_DIMS})")
    if not 1 <= chunk <= MAX_CHUNK or l % chunk:
        raise ValueError(f"ssd_bwd_cuda: want 1 <= chunk <= {MAX_CHUNK} "
                         f"dividing l = {l}; got chunk {chunk}")
    if dy.shape != x.shape or dy.dtype != torch.float32:
        raise ValueError(f"ssd_bwd_cuda: want a float32 dy of x's shape "
                         f"{tuple(x.shape)}; got {tuple(dy.shape)} "
                         f"{dy.dtype}")
    dy = _aligned(dy)
    states = []
    for t in (initial_state, dfinal):
        if t is not None:
            t = _aligned(t)
            _check_state("ssd_bwd_cuda", t, b, h, p, n)
        states.append(t)
    s0, dfinal = states
    pl = bwd_plan(b, l, h, p, n, chunk, x.dtype, sub)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((b, l, h, p), dtype=x.dtype, device=dev)
    dB = torch.empty((b, l, g, n), dtype=B.dtype, device=dev)
    dC = torch.empty_like(dB)
    ddt = torch.empty((b, l, h), **f32)
    dA, dD = torch.empty((h,), **f32), torch.empty((h,), **f32)
    dinit = None if s0 is None else torch.empty((b, h, p, n), **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()
    ptrs = [ptr(t) for t in (x, dt, A, B, C, D, s0, dy, dfinal, dx, ddt, dB,
                             dC, dA, dD, dinit)]
    strides = (x.stride(0), x.stride(1), x.stride(2), dt.stride(0),
               dt.stride(1), B.stride(0), B.stride(1), B.stride(2),
               C.stride(0), C.stride(1), C.stride(2),
               torch.cuda.current_stream(dev).cuda_stream)
    if pl.route == "mma":
        ws = bwd_mma_workspace(b, l, h, p, n, pl.sub, dev)
        err = _launcher("ssd_bwd_mma_launch")(
            *ptrs, *(t.data_ptr() for t in ws), b, l, pl.sub, h, g, p, n,
            *strides)
    else:
        ws = bwd_workspace(b, l, h, p, g, n, chunk, dev)
        err = _launcher("ssd_bwd_launch")(
            *ptrs, *(t.data_ptr() for t in ws), b, l, chunk, h, g, p, n,
            _DTYPES[x.dtype], *strides)
    ssd_bwd_cuda.launches += 1
    if err != 0:
        raise RuntimeError(f"ssd backward launch failed ({pl.route} route):"
                           f" CUDA error {err}")
    return dx, ddt, dA, dB, dC, dD, dinit


def chunk_buffers(pl: ChunkPlan, b: int, l: int, h: int, p: int, n: int,
                  device):
    """The outputs and the workspace of a call on plan ``pl``: y (b, l,
    h, p) and the final state (b, h, p, n) f32; the chunk states (b, h,
    chunks, p, n) and their decays (b, h, chunks) f32, and the incoming
    states' hi and lo planes (b, h, chunks, 2, p, n) bf16 (the last three
    empty on simt)."""
    f32 = dict(dtype=torch.float32, device=device)
    c = pl.chunks if pl.route == "mma" else 0
    return (torch.empty((b, l, h, p), **f32),
            torch.empty((b, h, p, n), **f32),
            torch.empty((b, h, c, p, n), **f32),
            torch.empty((b, h, c), **f32),
            torch.empty((b, h, c, 2, p, n), dtype=torch.bfloat16,
                        device=device))


def _launch_chunk(x, dt, A, B, C, D, chunk, initial_state, *, sub=0,
                  steps=STEPS_ALL, bufs=None):
    """One call of the dual form; ``sub``, ``steps`` (a mask of the mma
    route's sub-steps) and ``bufs`` (``chunk_buffers``' tuple, reused)
    let a timing run launch one sub-step at a time on one set of
    buffers."""
    ts = [t for t in (x, dt, A, B, C, D, initial_state) if t is not None]
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("ssd_cuda takes CUDA tensors on one device")
    if x.dim() != 4 or x.dtype not in _DTYPES or B.dtype != x.dtype \
            or C.dtype != x.dtype:
        raise TypeError(f"ssd_cuda: want 4-D x, B, C of one dtype of "
                        f"{list(_DTYPES)}; got {tuple(x.shape)} {x.dtype}, "
                        f"{B.dtype}, {C.dtype}")
    x, dt, B, C = _rows(x, dt, B, C)
    b, l, h, p, g, n = _check_dims("ssd_cuda", x, dt, A, B, C, D)
    if (p, n) not in CHUNK_DIMS:
        raise ValueError(f"ssd_cuda: head dim {p} with state dim {n} is "
                         f"not instantiated (want one of {CHUNK_DIMS})")
    if not 1 <= chunk <= MAX_CHUNK or l % chunk:
        raise ValueError(f"ssd_cuda: want 1 <= chunk <= {MAX_CHUNK} "
                         f"dividing l = {l}; got chunk {chunk}")
    if initial_state is not None:
        _check_state("ssd_cuda", initial_state, b, h, p, n)
        initial_state = initial_state.contiguous()
    pl = chunk_plan(b, l, h, p, n, chunk, x.dtype, sub)
    if pl.route == "mma" and initial_state is not None \
            and initial_state.data_ptr() % 16:
        initial_state = initial_state.clone()    # the state pass's float4s
    y, final, ws, decay, s_in = bufs or chunk_buffers(pl, b, l, h, p, n,
                                                      x.device)
    s0 = None if initial_state is None else initial_state.data_ptr()
    strides = (x.stride(0), x.stride(1), x.stride(2), dt.stride(0),
               dt.stride(1), B.stride(0), B.stride(1), B.stride(2),
               C.stride(0), C.stride(1), C.stride(2))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), s0, y.data_ptr(), final.data_ptr())
    if pl.route == "mma":
        err = _launcher("ssd_chunk_mma_launch")(
            *ptrs, ws.data_ptr(), decay.data_ptr(), s_in.data_ptr(), b, l,
            pl.sub, h, g, p, n, steps, *strides, stream)
    else:
        err = _launcher("ssd_chunk_launch")(
            *ptrs, b, l, chunk, h, g, p, n, _DTYPES[x.dtype], *strides,
            stream)
    ssd_cuda.launches += 1
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed ({pl.route} route): "
                           f"CUDA error {err}")
    return y, final


ssd_cuda.launches = 0
ssd_bwd_cuda.launches = 0
