"""ctypes bindings of the CUDA decode-attention kernels
(``csrc/decode_attention.cu``): ``decode_attention_cuda`` over a
contiguous KV ring (it replaces the JAX package's
``decode_attention_pallas``) and ``paged_decode_attention_cuda`` over a
paged KV pool (``paged_decode_attention_pallas``). Both entry points live
in one library, built with ``nvcc`` on first use (``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_FNS = {}


def _launcher(name="decode_attention_launch"):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load("decode_attention"), name)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "decode_attention_launch":
            fn.argtypes = [p] * 6 + [i] * 6 + [ll] * 10 + [i, i, p]
        else:
            fn.argtypes = [p] * 7 + [i] * 7 + [ll] * 10 + [i, i, p]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _check_common(name, q, k, v, tensors):
    """The checks both wrappers share: one CUDA device, one dtype, 4-D
    q/k/v with matching head dims, contiguous last dimensions and K/V
    rows on 16-byte boundaries."""
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
    for t in (k, v):
        if t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3]):
            raise ValueError("K/V rows must start on 16-byte boundaries "
                             f"(strides in multiples of {vec} elements)")


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
    Returns a new (B, T, Hq, hd) tensor in q's dtype. Raises on any input
    the kernel does not take, and when the launch is refused."""
    _check_common("decode_attention_cuda", q, k, v, (q, k, v, pos, q_pos))
    B, T, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    _check_positions(pos, q_pos, B, S, T, window)
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


def paged_decode_attention_cuda(q, k_pool, v_pool, block_table, pos, q_pos,
                                *, window=0):
    """Launch the paged kernel on the current stream. q: (B, T, Hq, hd);
    k_pool, v_pool: (P + 1, ps, Hkv, hd) with the trash page last, any
    strides with the last dimension contiguous; block_table: (B, NB)
    int32 contiguous, entries in [0, P]; pos: (B, NB * ps) int32; q_pos:
    (B, T) int32. Returns a new (B, T, Hq, hd) tensor in q's dtype.
    Raises on any input the kernel does not take, and when the launch is
    refused. Block-table entries are not range-checked here (that would
    read them back to the host): the engine's allocator keeps them in
    the pool."""
    _check_common("paged_decode_attention_cuda", q, k_pool, v_pool,
                  (q, k_pool, v_pool, block_table, pos, q_pos))
    B, T, Hq, hd = q.shape
    ps, Hkv = k_pool.shape[1], k_pool.shape[2]
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or block_table.dtype != torch.int32 \
            or not block_table.is_contiguous():
        raise ValueError(f"want block_table (B, NB) int32 contiguous; got "
                         f"{tuple(block_table.shape)} {block_table.dtype}")
    NB = block_table.shape[1]
    _check_positions(pos, q_pos, B, NB * ps, T, window)
    out = torch.empty((B, T, Hq, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher("paged_decode_attention_launch")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), pos.data_ptr(), q_pos.data_ptr(),
        out.data_ptr(), B, T, Hq, Hkv, NB, ps, hd,
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
