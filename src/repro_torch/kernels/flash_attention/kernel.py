"""ctypes binding of the CUDA flash-attention kernel
(``csrc/flash_attention.cu``), built with ``nvcc`` on first use
(``kernels/_build.py``). It replaces both of the JAX package's flash
entry points: ``flash_attention_pallas`` (G = 1) and
``flash_attention_gqa_pallas`` (G > 1).

``plan`` picks the route from the dtype alone: bf16 runs on the tensor
cores (``mma``: mma.sync bf16 products with f32 accumulators, p rounded
to bf16 before the P V product, as the JAX model's plain route rounds
it), fp32 on the CUDA cores (``simt``: f32 products and f32 p, which the
fp32 gates need). Both group the G query heads of a KV head into a
block of 64 rows, so a K/V tile is read once for the group, and run on
the smallest head-dim tile that holds hd. What bounds them at the
model's shapes: the operations, 4 B Hq hd per live query-key pair.

The launch runs through ``_autograd.differentiable``: with no gradient
to ask for, the plain launch (the serve path and the Zoo pass a null LSE
pointer, so their launches are those of before); where a gradient could
be asked for, the forward also writes each row's base-2 log-sum-exp of
its scaled scores (f32, (B, Hq, Lq)) and runs inside an autograd node
whose backward is ``flash_attention_bwd_cuda``: the three launches of
``csrc/flash_attention_bwd.cu`` (D = rowsum(dO O), then dK/dV by key
tile, then dQ by query tile, each recomputing P from the LSE; no
atomics). ``plan_bwd`` names its route by the dtype alone, as ``plan``
does: bf16 on the tensor cores (``mma``: mma.sync products, p and dS
rounded to bf16 as the products' operands), fp32 on the CUDA cores
(``simt``). That backward replaces no TPU kernel: the JAX package
differentiates its plain attention. Its plain version is
``ref.attention_backward_reference``. ``flash_attention_bwd_cuda``
counts one launch a call, in ``flash_attention_bwd_cuda.launches``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _autograd, _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_GROUP = 64                     # query rows of a block (csrc ROWS)
HD_TILES = (32, 64, 128, 160, 256)  # the head-dim tiles csrc instantiates
_FNS = {}


class Plan(NamedTuple):
    """How one call runs: ``path`` ("mma" or "simt"), the head-dim tile
    ``hd_tile`` the launch instantiates, query positions a block
    (``bq``) and the ``blocks`` of the grid."""
    path: str
    hd_tile: int
    bq: int
    blocks: int


def plan(B: int, Lq: int, Hq: int, Hkv: int, hd: int,
         dtype: torch.dtype) -> Plan:
    """bf16 -> ``mma``, fp32 -> ``simt``; the smallest head-dim tile that
    holds hd; one block per (batch, KV head, 64 / G query positions)."""
    hd_tile = next(t for t in HD_TILES if hd <= t)
    path = "mma" if dtype == torch.bfloat16 else "simt"
    bq = MAX_GROUP // (Hq // Hkv)
    return Plan(path, hd_tile, bq, B * Hkv * -(-Lq // bq))


class BwdPlan(NamedTuple):
    """How one backward call runs: its ``route`` ("mma" or "simt"), the
    head-dim tile, query positions a tile of 64 grouped rows (``bq``),
    the keys of a dK/dV block (``key_tile``) and of a dQ step
    (``dq_key_tile``), the threads of a dK/dV block, and the grid of
    each launch: D (``dot_blocks``, ``dot_lanes`` lanes a row), dK/dV,
    dQ."""
    route: str
    hd_tile: int
    bq: int
    key_tile: int
    dq_key_tile: int
    dkdv_threads: int
    dot_lanes: int
    dot_blocks: int
    dkdv_blocks: int
    dq_blocks: int


def plan_bwd(B: int, Lq: int, Lk: int, Hq: int, Hkv: int, hd: int,
             dtype: torch.dtype) -> BwdPlan:
    """The backward's launches (csrc/flash_attention_bwd.cu's templates):
    bf16 -> ``mma``, 64 keys a dK/dV block (8 warps at head-dim tiles 160
    and 256, two a 16-key slice, else 4), dQ key tiles of 64 (32 at tiles
    64 and 256); fp32 -> ``simt``, 256 threads and 64 keys a tile up to a
    head-dim tile of 128, 32 above. D takes a row's 16-byte units on the
    fewest lanes, a power of two, that hold them (at most a warp), 8
    warps a block."""
    fwd = plan(B, Lq, Hq, Hkv, hd, dtype)
    if fwd.path == "mma":
        key_tile, threads = 64, 256 if fwd.hd_tile >= 160 else 128
        dq_tile = 32 if fwd.hd_tile in (64, 256) else 64
    else:
        key_tile = dq_tile = 64 if fwd.hd_tile <= 128 else 32
        threads = 256
    units = hd * dtype.itemsize // 16
    lanes = 1
    while lanes < min(units, 32):
        lanes *= 2
    rows = B * Lq * Hq
    return BwdPlan(fwd.path, fwd.hd_tile, fwd.bq, key_tile, dq_tile,
                   threads, lanes, -(-rows // (8 * (32 // lanes))),
                   B * Hkv * -(-Lk // key_tile), fwd.blocks)


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the C signatures of csrc/flash_attention.cu's and
#: csrc/flash_attention_bwd.cu's entry points
ARGTYPES = {"flash_attention_launch":
            [_P] * 5 + [_I] * 7 + [_LL] * 9 + [_I] * 3 + [_P],
            "flash_attention_bwd_launch":
            [_P] * 10 + [_I] * 8 + [_LL] * 9 + [_I] * 3 + [_P]}


def _launcher(stem="flash_attention"):
    fn = _FNS.get(stem)
    if fn is None:
        fn = getattr(_build.load(stem), f"{stem}_launch")
        fn.argtypes = ARGTYPES[f"{stem}_launch"]
        fn.restype = ctypes.c_int
        _FNS[stem] = fn
    return fn


def _check(q, k, v, window):
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_attention_cuda takes CUDA tensors on one "
                         "device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of {list(_DTYPES)}; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"want q (B, Lq, Hq, hd) and k, v (B, Lk, Hkv, "
                         f"hd); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Lq, Hq, hd = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    if min(B, Lq, Lk, Hkv) < 1 or Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"want Hq a multiple of Hkv with at most "
                         f"{MAX_GROUP} query heads a KV head, and non-empty "
                         f"shapes; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} not supported (want a multiple "
                         f"of 8 up to {MAX_HEAD_DIM})")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the last dimension of q, k and v must be "
                         "contiguous")
    vec = 16 // k.element_size()
    for t in (q, k, v):
        if t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3]):
            raise ValueError("q, K and V rows must start on 16-byte "
                             f"boundaries (strides in multiples of {vec} "
                             "elements)")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def _strides(*ts):
    return [st for t in ts for st in t.stride()[:3]]


def _launch(q, k, v, causal, window, with_lse=False):
    """The forward launch: the output, or (output, LSE) with
    ``with_lse``."""
    B, Lq, Hq, hd = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    pl = plan(B, Lq, Hq, Hkv, hd, q.dtype)
    out = torch.empty((B, Lq, Hq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Lq), dtype=torch.float32,
                      device=q.device) if with_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, Lq, Lk, Hq, Hkv, hd, pl.hd_tile, *_strides(q, k, v),
        int(bool(causal)), int(window), _DTYPES[q.dtype], stream)
    flash_attention_cuda.launches += 1
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out if lse is None else (out, lse)


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, *, causal=True,
                             window=0):
    """The backward kernels on the current stream: q, k, v as the forward
    took them, ``out`` and ``lse`` from ``flash_attention_lse_cuda`` (or
    the autograd node's forward), ``dout`` the output's gradient (B, Lq,
    Hq, hd), any strides (made contiguous once here). Returns (dq, dk,
    dv), new contiguous tensors of q's, k's and v's shapes and dtype."""
    _check(q, k, v, window)
    B, Lq, Hq, hd = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape \
            or out.dtype != q.dtype or dout.dtype != q.dtype \
            or not out.is_contiguous() or dout.device != q.device:
        raise ValueError(f"out and dout must be ({B}, {Lq}, {Hq}, {hd}) "
                         f"{q.dtype} on {q.device}, out contiguous")
    if lse.shape != (B, Hq, Lq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be a contiguous float32 ({B}, {Hq}, "
                         f"{Lq}) tensor on {q.device}")
    # the D launch reads o and dout in 16-byte units
    dout = dout.contiguous()
    if dout.data_ptr() % 16:
        dout = dout.clone()
    if out.data_ptr() % 16:
        out = out.clone()
    pl = plan_bwd(B, Lq, Lk, Hq, Hkv, hd, q.dtype)
    dq = torch.empty((B, Lq, Hq, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Lk, Hkv, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    dsum = torch.empty((B, Hq, Lq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher("flash_attention_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Lq, Lk, Hq, Hkv, hd, pl.hd_tile,
        pl.key_tile, *_strides(q, k, v), int(bool(causal)), int(window),
        _DTYPES[q.dtype], stream)
    flash_attention_bwd_cuda.launches += 1
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {err}")
    return dq, dk, dv


def flash_attention_lse_cuda(q, k, v, *, causal=True, window=0):
    """The forward with its LSE, no autograd node: (out, lse (B, Hq, Lq)
    f32). For callers that run the backward kernels themselves."""
    _check(q, k, v, window)
    return _launch(q, k, v, causal, int(window), True)


def _fwd(q, k, v, causal, window):
    out, lse = _launch(q, k, v, causal, window, True)
    return out, (q, k, v, out, lse), (causal, window)


def _bwd(meta, saved, dout):
    if dout is None:
        return None, None, None, None, None
    q, k, v, out, lse = saved
    dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                          causal=meta[0], window=meta[1])
    return dq, dk, dv, None, None


def flash_attention_cuda(q, k, v, *, causal=True, window=0):
    """Launch the kernel on the current stream. q: (B, Lq, Hq, hd); k, v:
    (B, Lk, Hkv, hd), the model's layout, any strides with the last
    dimension contiguous. Returns a new contiguous (B, Lq, Hq, hd) tensor
    in q's dtype; where a gradient can be asked for, through a node whose
    backward runs the backward kernels. Raises on any input the kernel
    does not take, and when a launch is refused."""
    _check(q, k, v, window)
    return _autograd.differentiable(_launch, _fwd, _bwd, q, k, v, causal,
                                    int(window))


flash_attention_cuda.launches = 0
flash_attention_bwd_cuda.launches = 0
