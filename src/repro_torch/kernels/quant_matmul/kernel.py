"""ctypes bindings of the CUDA dequantize-matmul kernels
(``csrc/quant_matmul.cu``): ``quant_matmul_int8_cuda`` (it replaces the
JAX package's ``quant_matmul_int8_pallas``) and ``quant_matmul_int4_cuda``
(``quant_matmul_int4_pallas``). One library, built with ``nvcc`` on first
use (``kernels/_build.py``), with two entry points: one per route.

Routes, from ``mma_plan``. ``simt``: f32 products on the CUDA cores, 8
rows of x by 128 columns a block, K split until about ``TARGET_BLOCKS``
blocks run (``plan``); it takes fp32 x, int4 under a group that is not a
multiple of 16, an N that is not a multiple of 4 and int8 under a K that
is not a multiple of 8. When it splits K, the wrapper allocates an f32
workspace of partial sums and the library launches, after the main
kernel, a second kernel that adds the splits in a fixed order. ``mma``:
bf16 x on the tensor cores (mma.sync bf16 with f32 accumulators over
the exact weight values): int8, whose one running sum is scaled per
column in f32 at the end, and int4 with a group of a multiple of 16, one
fresh accumulator a group, scaled in f32 as the plain version does; 8
rows of x (M <= 8) or 32 by 128 columns a block, K tiles of 64 rows,
and K split only where the column and row tiles give fewer than 132
blocks. Its splits of a tile run as one thread-block cluster that adds
their sums through distributed shared memory: one launch, no
workspace. Both plans are pure functions of the shapes and the dtype,
and both routes are bitwise deterministic run to run.

The wrapper picks the plan and allocates the output (and the simt
workspace); one call counts once in ``launches``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BM, BN = 8, 128          # the simt tile of x rows and y columns
SIMT_BK = {8: 128, 4: 256}   # unpacked rows of the simt K tile, by bits
TARGET_BLOCKS = 528      # two waves of 2 blocks on each of 132 SMs
MAX_SPLITS = 16
SPLIT_ALIGN = 64         # a split covers a multiple of this many rows
#: the mma route: columns a block, rows of a K tile, the fewest blocks
#: that run unsplit (one per SM), the blocks a split aims at by the rows
#: of x a block (decode's small blocks wait on their loads: four an SM;
#: the chunk's: two), the fewest K tiles a split walks
MMA_BN, MMA_BK = 128, 64
MMA_MIN_BLOCKS = 132
MMA_TARGET_BLOCKS = {8: 528, 32: 264}
MMA_MIN_TILES = 3
MMA_MAX_SPLITS = 16      # the splits of a tile are one cluster
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the C signatures of csrc/quant_matmul.cu's entry points
ARGTYPES = {"quant_matmul_launch": [_P, _LL, _P, _P, _P, _P] + [_I] * 8
            + [_P],
            "quant_matmul_mma_launch": [_P, _LL, _P, _P, _P] + [_I] * 8
            + [_P]}
_FNS = {}


def _launcher(name="quant_matmul_launch"):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load("quant_matmul"), name)
        fn.argtypes = ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


class Plan(NamedTuple):
    """How one call runs: ``route`` ("mma" or "simt"), rows of x
    (``bm``) and columns of y (``bn``) a block, unpacked rows of a K
    tile (``bk``), the K ``splits`` of ``kper`` rows each, and the
    ``blocks`` of the main kernel's grid."""
    route: str
    bm: int
    bn: int
    bk: int
    splits: int
    kper: int
    blocks: int


def plan(M: int, N: int, K: int) -> Tuple[int, int, int]:
    """(blocks, splits, rows per split) for an (M, K) x (K, N) product:
    split K until about ``TARGET_BLOCKS`` blocks run, at most
    ``MAX_SPLITS`` splits of a multiple of ``SPLIT_ALIGN`` rows."""
    base = -(-N // BN) * -(-M // BM)
    want = min(MAX_SPLITS, max(1, -(-TARGET_BLOCKS // base)))
    kper = -(-K // want)
    kper = -(-kper // SPLIT_ALIGN) * SPLIT_ALIGN
    splits = -(-K // kper)
    return base * splits, splits, kper


def mma_plan(bits: int, M: int, N: int, K: int, gs: int,
             dtype: torch.dtype) -> Plan:
    """The route and tiles of an int8 (``bits`` 8) or int4 (4, group
    ``gs``; int8 ignores it) (M, K) x (K, N) product: ``mma`` for bf16
    x, N a multiple of 4 and, int4, gs a multiple of 16 or, int8, K a
    multiple of 8 (x's rows go 16 bytes a copy), else ``simt``
    (``plan``'s split). On ``mma`` a block owns 8 rows of x (M <= 8,
    decode) or 32 (the admitting chunk), and 128 columns; K is split only
    when those tiles give fewer than ``MMA_MIN_BLOCKS`` blocks, towards
    ``MMA_TARGET_BLOCKS[bm]``, each split walking at least
    ``MMA_MIN_TILES`` K tiles of 64 rows (at most ``MMA_MAX_SPLITS``
    splits)."""
    fits = gs % 16 == 0 if bits == 4 else K % 8 == 0
    if dtype != torch.bfloat16 or N % 4 or not fits:
        blocks, splits, kper = plan(M, N, K)
        return Plan("simt", BM, BN, SIMT_BK[bits], splits, kper, blocks)
    bm = 8 if M <= 8 else 32
    base = -(-N // MMA_BN) * -(-M // bm)
    tiles = -(-K // MMA_BK)
    want = 1
    if base < MMA_MIN_BLOCKS:
        want = min(MMA_MAX_SPLITS, max(1, tiles // MMA_MIN_TILES),
                   -(-MMA_TARGET_BLOCKS[bm] // base))
    per = -(-tiles // want)
    splits = -(-tiles // per)
    return Plan("mma", bm, MMA_BN, MMA_BK, splits, per * MMA_BK,
                base * splits)


def _launch(name, x, q, scale, *, int4):
    if not all(t.is_cuda and t.device == x.device for t in (x, q, scale)):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be one of {list(_DTYPES)}, got {x.dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"want int8 weights and f32 scales; got {q.dtype}, "
                        f"{scale.dtype}")
    if x.dim() != 2 or q.dim() != 2:
        raise ValueError(f"want 2-D x and weights; got {tuple(x.shape)}, "
                         f"{tuple(q.shape)}")
    M, K = x.shape
    N = q.shape[1]
    if int4:
        ng = scale.shape[0] if scale.dim() == 2 else 0
        if K % 2 or q.shape[0] != K // 2 or scale.dim() != 2 \
                or scale.shape[1] != N or ng < 1 or K % ng:
            raise ValueError(f"shape mismatch: x {tuple(x.shape)}, q4 "
                             f"{tuple(q.shape)}, scale {tuple(scale.shape)}")
        gs = K // ng
    else:
        if q.shape[0] != K or scale.shape != (N,):
            raise ValueError(f"shape mismatch: x {tuple(x.shape)}, q "
                             f"{tuple(q.shape)}, scale {tuple(scale.shape)}")
        gs = 0
    if M < 1 or N < 1:
        raise ValueError(f"empty product: x {tuple(x.shape)}, weights "
                         f"{tuple(q.shape)}")
    if x.stride(1) != 1 or not q.is_contiguous() \
            or not scale.is_contiguous():
        raise ValueError("x's last dimension, the weights and the scales "
                         "must be contiguous")
    if x.dtype == torch.bfloat16 and (K % 2 or x.data_ptr() % 4
                                      or (M > 1 and x.stride(0) % 2)):
        raise ValueError("bfloat16 x needs an even K and its rows on "
                         "4-byte boundaries")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    bits = 4 if int4 else 8
    pl = mma_plan(bits, M, N, K, gs, x.dtype)
    if pl.route == "mma":
        if x.data_ptr() % 16 or (M > 1 and x.stride(0) % 8) \
                or q.data_ptr() % 16 or scale.data_ptr() % 16:
            raise ValueError("the mma route needs x's rows, the weights "
                             "and the scales on 16-byte boundaries")
        err = _launcher("quant_matmul_mma_launch")(
            x.data_ptr(), x.stride(0), q.data_ptr(), scale.data_ptr(),
            out.data_ptr(), M, N, K, gs, bits, pl.bm // 8, pl.kper,
            pl.splits, stream)
    else:
        ws = torch.empty((pl.splits, M, N), dtype=torch.float32,
                         device=x.device) if pl.splits > 1 else None
        err = _launcher()(
            x.data_ptr(), x.stride(0), q.data_ptr(), scale.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(), M, N, K,
            gs, pl.kper, pl.splits, int(int4), _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def quant_matmul_int8_cuda(x, q, scale):
    """x: (M, K) f32 or bf16, last dimension contiguous; q: (K, N) int8;
    scale: (N,) f32 -> a new (M, N) tensor in x's dtype. Raises on any
    input the kernel does not take, and when the launch is refused."""
    out = _launch("quant_matmul_int8_cuda", x, q, scale, int4=False)
    quant_matmul_int8_cuda.launches += 1
    return out


def quant_matmul_int4_cuda(x, q4, scale):
    """x: (M, K) f32 or bf16, last dimension contiguous; q4: (K//2, N)
    packed int8; scale: (K//gs, N) f32 -> a new (M, N) tensor in x's
    dtype. Raises on any input the kernel does not take, and when the
    launch is refused."""
    out = _launch("quant_matmul_int4_cuda", x, q4, scale, int4=True)
    quant_matmul_int4_cuda.launches += 1
    return out


quant_matmul_int8_cuda.launches = 0
quant_matmul_int4_cuda.launches = 0
