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

The launch runs through ``_autograd.launch``: where a gradient could be
asked for, inside an autograd node whose backward raises (a tensor made
by a ctypes launch has no ``grad_fn`` of its own, so a ``backward()``
through the kernel would silently give q, k and v no gradient). The
flash backward kernel is ROADMAP section 1, item 12 (training).
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


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the C signature of csrc/flash_attention.cu's entry point
ARGTYPES = {"flash_attention_launch":
            [_P] * 4 + [_I] * 7 + [_LL] * 9 + [_I] * 3 + [_P]}


def _launcher():
    fn = _FNS.get("flash")
    if fn is None:
        fn = _build.load("flash_attention").flash_attention_launch
        fn.argtypes = ARGTYPES["flash_attention_launch"]
        fn.restype = ctypes.c_int
        _FNS["flash"] = fn
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


def _launch(q, k, v, causal, window):
    B, Lq, Hq, hd = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    pl = plan(B, Lq, Hq, Hkv, hd, q.dtype)
    out = torch.empty((B, Lq, Hq, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Lq, Lk, Hq, Hkv, hd, pl.hd_tile,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(bool(causal)), int(window), _DTYPES[q.dtype], stream)
    flash_attention_cuda.launches += 1
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out


def flash_attention_cuda(q, k, v, *, causal=True, window=0):
    """Launch the kernel on the current stream. q: (B, Lq, Hq, hd); k, v:
    (B, Lk, Hkv, hd), the model's layout, any strides with the last
    dimension contiguous. Returns a new contiguous (B, Lq, Hq, hd) tensor
    in q's dtype. Raises on any input the kernel does not take, when the
    launch is refused, and in a backward pass."""
    _check(q, k, v, window)
    return _autograd.launch("flash attention", _launch, q, k, v, causal,
                            int(window))


flash_attention_cuda.launches = 0
