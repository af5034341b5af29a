"""ctypes bindings of the CUDA decode-attention kernels
(``csrc/decode_attention.cu``): ``decode_attention_cuda`` over a
contiguous KV ring (it replaces the JAX package's
``decode_attention_pallas``) and ``paged_decode_attention_cuda`` over a
paged KV pool (``paged_decode_attention_pallas``). Both entry points live
in one library, built with ``nvcc`` on first use (``kernels/_build.py``).

``plan`` picks the route from the shapes and the dtype alone: bf16
takes the tensor cores (``mma_rows`` for R = T * G > 16 rows a sequence,
every admitted chunk: operation-bound; ``mma_keys`` for R <= 16, every
decode step: bound by the K/V bytes), fp32 the CUDA cores (``simt``,
f32 products and f32 p, which the fp32 gates need). On the bf16 routes
p is rounded to bf16 before the P V product, as the JAX model's plain
route rounds it. When the (sequence, KV head, row tile) grid alone
would leave the card's SMs short, the plan splits S over blocks; the
wrapper then allocates the f32 scratch of the splits' partials and the
library launches the main kernel and the kernel that combines the
splits, in a fixed order. Both belong to one wrapper call: ``launches``
counts calls.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _autograd, _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_ROUTES = {"simt": 0, "mma_rows": 1, "mma_keys": 2}
BK = 64                  # slots a staged K/V tile holds (csrc BK)
SIMT_ROWS = 16           # rows a block of the f32 route
MMA_ROWS = 64            # rows a block of the mma_rows route (4 warps)
KEYS_MAX_ROWS = 16       # R at most this: one 16-row tile, mma_keys
TARGET_BLOCKS = 264      # two blocks on each of the H100's 132 SMs
MAX_SPLITS = 16
_FNS = {}


class Plan(NamedTuple):
    """How one call runs: ``path`` ("mma_rows", "mma_keys" or "simt"),
    ``rows`` a block, ``row_blocks`` a (sequence, KV head), ``splits``
    of S, ``per`` slots a split (a multiple of ``BK`` when split) and
    the ``blocks`` of the main kernel."""
    path: str
    rows: int
    row_blocks: int
    splits: int
    per: int
    blocks: int


def plan(B: int, T: int, Hq: int, Hkv: int, S: int, hd: int,
         dtype: torch.dtype) -> Plan:
    """The route for q (B, T, Hq, hd) over S slots of Hkv heads: fp32
    takes ``simt`` unsplit; bf16 takes ``mma_keys`` for R = T * Hq / Hkv
    <= 16 rows a sequence and ``mma_rows`` above, and S is split until
    about ``TARGET_BLOCKS`` blocks run (at most ``MAX_SPLITS`` splits of
    whole ``BK``-slot tiles, every split non-empty, the last one ragged
    where S is not a multiple of its share). ``hd`` does not change the
    plan; it is named so that the plan reads as the call's shape."""
    del hd
    R = T * (Hq // Hkv)
    if dtype == torch.float32:
        rb = -(-R // SIMT_ROWS)
        return Plan("simt", SIMT_ROWS, rb, 1, S, B * Hkv * rb)
    path, rows = (("mma_keys", KEYS_MAX_ROWS) if R <= KEYS_MAX_ROWS
                  else ("mma_rows", MMA_ROWS))
    rb = -(-R // rows)
    base = B * Hkv * rb
    tiles = -(-S // BK)
    want = min(MAX_SPLITS, tiles, max(1, -(-TARGET_BLOCKS // base)))
    per_tiles = -(-tiles // want)
    splits = -(-tiles // per_tiles)
    per = per_tiles * BK if splits > 1 else S
    return Plan(path, rows, rb, splits, per, base * splits)


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the C signatures of csrc/decode_attention.cu's entry points
ARGTYPES = {
    "decode_attention_launch":
        [_P] * 8 + [_I] * 9 + [_LL] * 10 + [_I, _I, _P],
    "paged_decode_attention_launch":
        [_P] * 9 + [_I] * 10 + [_LL] * 10 + [_I, _I, _P],
}


def _launcher(name="decode_attention_launch"):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load("decode_attention"), name)
        fn.argtypes = ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _scratch(pl, q):
    """The f32 partials of a split call (None, None when unsplit)."""
    if pl.splits == 1:
        return None, None
    B, T, Hq, hd = q.shape
    acc = torch.empty((pl.splits, B * T * Hq, hd), dtype=torch.float32,
                      device=q.device)
    ml = torch.empty((pl.splits, B * T * Hq, 2), dtype=torch.float32,
                     device=q.device)
    return acc, ml


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_common(name, q, k, v, tensors):
    """The checks both wrappers share: one CUDA device, one dtype, 4-D
    q/k/v with matching head dims, contiguous last dimensions and q, K
    and V rows on 16-byte boundaries (the kernels copy them in 16-byte
    pieces)."""
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of "
                        f"{list(_DTYPES)}; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want 4-D q and equal-shaped 4-D k, v; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    hd, Hkv = q.shape[3], k.shape[2]
    if k.shape[3] != hd or q.shape[2] % Hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported (want one of "
                         f"{_HEAD_DIMS})")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the last dimension of q, k and v must be "
                         "contiguous")
    vec = 16 // k.element_size()
    for t in (q, k, v):
        if t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3]):
            raise ValueError("q, K and V rows must start on 16-byte "
                             f"boundaries (strides in multiples of {vec} "
                             "elements)")


def _check_positions(pos, q_pos, B, S, T, window):
    if pos.shape != (B, S) or q_pos.shape != (B, T) \
            or pos.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise ValueError(f"want pos (B, S) and q_pos (B, T) int32; got "
                         f"{tuple(pos.shape)} {pos.dtype}, "
                         f"{tuple(q_pos.shape)} {q_pos.dtype}")
    if pos.stride(1) != 1 or not q_pos.is_contiguous():
        raise ValueError("the last dimension of pos, and all of q_pos, "
                         "must be contiguous")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def decode_attention_cuda(q, k, v, pos, q_pos, *, window=0):
    """Launch the kernel on the current stream. q: (B, T, Hq, hd); k, v:
    (B, S, Hkv, hd) in the model's cache layout, any strides with the
    last dimension contiguous; pos: (B, S) int32; q_pos: (B, T) int32.
    Returns a new (B, T, Hq, hd) tensor in q's dtype, by the route and
    splits of ``plan``. Raises on any input the kernel does not take,
    when the launch is refused, and in a backward pass."""
    _check_common("decode_attention_cuda", q, k, v, (q, k, v, pos, q_pos))
    B, T = q.shape[:2]
    if k.shape[0] != B:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    _check_positions(pos, q_pos, B, k.shape[1], T, window)
    return _autograd.launch("decode attention", _launch, q, k, v, pos,
                            q_pos, int(window))


def _launch(q, k, v, pos, q_pos, window):
    B, T, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    pl = plan(B, T, Hq, Hkv, S, hd, q.dtype)
    out = torch.empty((B, T, Hq, hd), dtype=q.dtype, device=q.device)
    ws_acc, ws_ml = _scratch(pl, q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        q_pos.data_ptr(), out.data_ptr(), _ptr(ws_acc), _ptr(ws_ml),
        B, T, Hq, Hkv, S, hd, _ROUTES[pl.path], pl.splits, pl.per,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        pos.stride(0), int(window), _DTYPES[q.dtype], stream)
    decode_attention_cuda.launches += 1
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out


decode_attention_cuda.launches = 0


def paged_decode_attention_cuda(q, k_pool, v_pool, block_table, pos, q_pos,
                                *, window=0):
    """Launch the paged kernel on the current stream. q: (B, T, Hq, hd);
    k_pool, v_pool: (P + 1, ps, Hkv, hd) with the trash page last, any
    strides with the last dimension contiguous; block_table: (B, NB)
    int32 contiguous, entries in [0, P]; pos: (B, NB * ps) int32; q_pos:
    (B, T) int32. Returns a new (B, T, Hq, hd) tensor in q's dtype, by
    the plan of the logical shape (S = NB * ps), so exactly the
    contiguous kernel's output on the gathered view. Raises on any input
    the kernel does not take, when the launch is refused, and in a
    backward pass. Block-table entries are not range-checked here (that
    would read them back to the host): the engine's allocator keeps them
    in the pool."""
    _check_common("paged_decode_attention_cuda", q, k_pool, v_pool,
                  (q, k_pool, v_pool, block_table, pos, q_pos))
    B, T = q.shape[:2]
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or block_table.dtype != torch.int32 \
            or not block_table.is_contiguous():
        raise ValueError(f"want block_table (B, NB) int32 contiguous; got "
                         f"{tuple(block_table.shape)} {block_table.dtype}")
    _check_positions(pos, q_pos, B, block_table.shape[1] * k_pool.shape[1],
                     T, window)
    return _autograd.launch("paged decode attention", _launch_paged, q,
                            k_pool, v_pool, block_table, pos, q_pos,
                            int(window))


def _launch_paged(q, k_pool, v_pool, block_table, pos, q_pos, window):
    B, T, Hq, hd = q.shape
    ps, Hkv = k_pool.shape[1], k_pool.shape[2]
    NB = block_table.shape[1]
    pl = plan(B, T, Hq, Hkv, NB * ps, hd, q.dtype)
    out = torch.empty((B, T, Hq, hd), dtype=q.dtype, device=q.device)
    ws_acc, ws_ml = _scratch(pl, q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher("paged_decode_attention_launch")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), pos.data_ptr(), q_pos.data_ptr(),
        out.data_ptr(), _ptr(ws_acc), _ptr(ws_ml), B, T, Hq, Hkv, NB, ps,
        hd, _ROUTES[pl.path], pl.splits, pl.per,
        q.stride(0), q.stride(1), q.stride(2),
        k_pool.stride(0), k_pool.stride(1), k_pool.stride(2),
        v_pool.stride(0), v_pool.stride(1), v_pool.stride(2),
        pos.stride(0), int(window), _DTYPES[q.dtype], stream)
    paged_decode_attention_cuda.launches += 1
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"CUDA error {err}")
    return out


paged_decode_attention_cuda.launches = 0
