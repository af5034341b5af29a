"""ctypes binding of the CUDA decode-attention kernel
(``csrc/decode_attention.cu``; it replaces the JAX package's
``decode_attention_pallas``). The library is built with ``nvcc`` on first
use (``kernels/_build.py``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_FN = None


def _launcher():
    global _FN
    if _FN is None:
        fn = _build.load("decode_attention").decode_attention_launch
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p] + [i] * 6 + [ll] * 10 + [i, i, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def decode_attention_cuda(q, k, v, pos, q_pos, *, window=0):
    """Launch the kernel on the current stream. q: (B, T, Hq, hd); k, v:
    (B, S, Hkv, hd) in the model's cache layout, any strides with the
    last dimension contiguous; pos: (B, S) int32; q_pos: (B, T) int32.
    Returns a new (B, T, Hq, hd) tensor in q's dtype. Raises on any input
    the kernel does not take, and when the launch is refused."""
    tensors = (q, k, v, pos, q_pos)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("decode_attention_cuda takes CUDA tensors on one "
                         "device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of "
                        f"{list(_DTYPES)}; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, T, Hq, hd) and k, v (B, S, Hkv, hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, T, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or Hq % Hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported (want one of "
                         f"{_HEAD_DIMS})")
    if pos.shape != (B, S) or q_pos.shape != (B, T) \
            or pos.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise ValueError(f"want pos (B, S) and q_pos (B, T) int32; got "
                         f"{tuple(pos.shape)} {pos.dtype}, "
                         f"{tuple(q_pos.shape)} {q_pos.dtype}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1 \
            or pos.stride(1) != 1 or not q_pos.is_contiguous():
        raise ValueError("the last dimension of q, k, v and pos, and all "
                         "of q_pos, must be contiguous")
    vec = 16 // k.element_size()
    for t in (k, v):
        if t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3]):
            raise ValueError("K/V rows must start on 16-byte boundaries "
                             f"(strides in multiples of {vec} elements)")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    out = torch.empty((B, T, Hq, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        q_pos.data_ptr(), out.data_ptr(), B, T, Hq, Hkv, S, hd,
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
