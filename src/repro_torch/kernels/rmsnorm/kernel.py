"""ctypes binding of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``),
built with ``nvcc`` on first use (``kernels/_build.py``). It replaces the
JAX package's ``fused_rmsnorm_pallas`` and fuses Mamba-2's gate into the
same launch.

One kernel, three routes, from ``plan``: ``add`` (residual given: y and
t = x + residual), ``norm`` (no residual: y alone) and ``gated`` (y =
rmsnorm(T(T(y) * T(silu(f32 z)))) * scale, the mixer's norm(y *
silu(z)) with the JAX model's roundings). ``plan`` also maps rows to
threads by d: a thread owns ``nv`` 16-byte units of its row (one on the
serve path's short launches, two for ``WIDE_ROWS`` wide rows or more),
a row ``tpr`` threads (its units over ``nv``, rounded up to a warp: no
power-of-two padding), a block ``rows`` rows (up to 128 threads of short
rows, else one row). What bounds it: bytes, each operand read once and
each output written once; at the serve path's N 8 and 128 a launch is
one memory round trip and one reduction. The wrapper is written for a
low host cost a call (97 calls a mamba2 forward): each operand checked
once, the raw stream handle in place of a Python stream object.

``fused_rmsnorm_cuda`` (add, norm) and ``gated_rmsnorm_cuda`` (gated)
count in one counter, ``fused_rmsnorm_cuda.launches``: one kernel. Each
runs its launch through ``_autograd.launch``, whose backward raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _autograd, _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"norm": 0, "add": 1, "gated": 2}
MAX_D = 16384
MAX_THREADS = 1024       # threads a row at most (csrc MAX_THREADS)
ROW_THREADS = 128        # a block of rows shorter than this many threads
#: 16-byte units a thread, by row dtype (the csrc templates)
NVS = {torch.bfloat16: (1, 2), torch.float32: (1, 2, 4)}
#: rows from which a wide row (at least WIDE_UNITS units) takes two units
#: a thread: twice the bytes in flight a thread, where occupancy, not one
#: launch's latency, sets the time (the Zoo's N 2048, model.lm's)
WIDE_ROWS = 1024
WIDE_UNITS = 256
# csrc flags: the vector path of each operand (V_OUT: both outputs), and
# y and the scale in f32
V_A, V_B, V_S, V_OUT, A_F32, S_F32 = 1, 2, 4, 8, 16, 32
_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
#: the C signature of csrc/rmsnorm.cu's entry point
ARGTYPES = {"rmsnorm_launch": [_P] * 5 + [_I] * 7 + [_LL] * 2
            + [_I, _F, _P]}
_FNS = {}


class Plan(NamedTuple):
    """How one call runs: the ``route`` ("add", "norm" or "gated"),
    ``nv`` 16-byte units a thread, ``tpr`` threads a row, ``rows`` rows
    a block of ``threads`` threads, and the ``blocks`` of the grid."""
    route: str
    nv: int
    tpr: int
    rows: int
    threads: int
    blocks: int


@functools.lru_cache(maxsize=1024)
def plan(N: int, d: int, dtype: torch.dtype, route: str = "add") -> Plan:
    """Rows of d elements of ``dtype`` (16-byte units of 16 / element
    size): the fewest units a thread in ``NVS`` that keep a row within
    ``MAX_THREADS`` threads (at least 2 for ``WIDE_ROWS`` rows or more of
    ``WIDE_UNITS`` units or more), the row's threads rounded up to a
    warp, and ``ROW_THREADS // tpr`` rows a block where that is more
    than one."""
    units = -(-d // (16 // dtype.itemsize))
    nv = next((v for v in NVS[dtype] if -(-units // v) <= MAX_THREADS),
              None)
    if nv is None:
        raise ValueError(f"d={d} exceeds the kernel's row limit")
    if N >= WIDE_ROWS and units >= WIDE_UNITS:
        nv = max(nv, 2)
    tpr = (-(-units // nv) + 31) // 32 * 32
    rows = max(1, ROW_THREADS // tpr)
    return Plan(route, nv, tpr, rows, tpr * rows, -(-N // rows))


def _launcher():
    fn = _FNS.get("rmsnorm")
    if fn is None:
        fn = _build.load("rmsnorm").rmsnorm_launch
        fn.argtypes = ARGTYPES["rmsnorm_launch"]
        fn.restype = ctypes.c_int
        _FNS["rmsnorm"] = fn
    return fn


def _rows(name, t, shape, dtypes, dev):
    """The row stride of operand ``t``, after checking that it is an (N,
    d) tensor of ``shape`` on ``dev``, its last dimension contiguous and
    its dtype one of ``dtypes``."""
    st = t.stride()
    if t.shape != shape or st[-1] != 1 or t.device != dev:
        raise ValueError(f"{name} must be an (N, d) = {tuple(shape)} CUDA "
                         f"tensor on {dev} with its last dimension "
                         f"contiguous, got {tuple(t.shape)} strides {st} "
                         f"on {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {list(dtypes)}, got "
                        f"{t.dtype}")
    return st[0]


def _launch(route, a, b, scale, eps):
    """Check, plan and launch one call of any route: a = x (or y), b =
    the residual (or z, or None). Returns y, or (y, t) on the add
    route."""
    lead = b if route == "gated" else a
    dtype, shape, dev = lead.dtype, lead.shape, lead.device
    if dev.type != "cuda" or len(shape) != 2 or dtype not in _DTYPES:
        raise ValueError(f"rmsnorm takes (N, d) float32 or bfloat16 CUDA "
                         f"tensors, got {tuple(shape)} {dtype} on {dev}")
    N, d = shape
    if d > MAX_D:
        raise ValueError(f"d={d} exceeds the kernel's limit {MAX_D}")
    sa = _rows("x" if route != "gated" else "y", a, shape,
               (torch.float32, dtype) if route == "gated" else (dtype,), dev)
    sb = 0 if b is None else _rows("residual" if route == "add" else "z",
                                   b, shape, (dtype,), dev)
    if scale.shape != (d,) or scale.stride(0) != 1 \
            or scale.dtype not in _DTYPES or scale.device != dev:
        raise ValueError(f"scale must be a contiguous ({d},) float32 or "
                         f"bfloat16 tensor on {dev}, got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    pl = plan(N, d, dtype, route)
    out = torch.empty_like(lead, memory_format=torch.contiguous_format)
    t = torch.empty_like(out) if route == "add" else None
    # the vector path of an operand: its pointer and row stride on the
    # alignment of a unit (16 bytes; 8 for four bf16 of an f32 row);
    # fresh outputs start aligned, and their rows do when d fills units
    unit = 16 // dtype.itemsize
    pa, pb, ps = a.data_ptr(), 0 if b is None else b.data_ptr(), \
        scale.data_ptr()
    ea, es = a.dtype.itemsize, scale.dtype.itemsize
    flags = (V_OUT * (d % unit == 0)
             | V_A * ((pa | sa * ea) % min(16, unit * ea) == 0)
             | V_S * (ps % min(16, unit * es) == 0)
             | A_F32 * (ea == 4) | S_F32 * (es == 4))
    if b is not None:
        flags |= V_B * ((pb | sb * dtype.itemsize) % 16 == 0)
    if N:
        err = _launcher()(
            pa, pb or None, ps, out.data_ptr(),
            None if t is None else t.data_ptr(), N, d, _MODES[route],
            _DTYPES[dtype], pl.nv, pl.tpr, pl.rows, sa, sb, flags,
            float(eps), torch._C._cuda_getCurrentRawStream(dev.index))
        fused_rmsnorm_cuda.launches += 1
        if err != 0:
            raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error "
                               f"{err}")
    return out if t is None else (out, t)


def fused_rmsnorm_cuda(x, residual, scale, eps=1e-5):
    """x, residual: (N, d) CUDA tensors of one dtype, float32 or
    bfloat16, any row stride with the last dimension contiguous
    (residual may be None); scale: (d,), float32 or bfloat16. Returns
    (y, t), new contiguous tensors in x's dtype, t = x itself when there
    is no residual. Raises on any input the kernel does not take, when
    the launch is refused, and in a backward pass."""
    if residual is None:
        return _autograd.launch("rmsnorm", _launch, "norm", x, None, scale,
                                eps), x
    return _autograd.launch("rmsnorm", _launch, "add", x, residual, scale,
                            eps)


def gated_rmsnorm_cuda(y, z, scale, eps=1e-5):
    """Mamba-2's gated norm: rmsnorm(T(T(y) * T(silu(f32 z)))) * scale in
    z's dtype T (float32 or bfloat16). y: (N, d) float32 or T; z: (N, d);
    both any row stride with the last dimension contiguous (z is read in
    place out of the in-projection's output); scale: (d,). Returns a new
    contiguous (N, d) tensor in T. Counts in
    ``fused_rmsnorm_cuda.launches``. Raises on any input the kernel does
    not take, when the launch is refused, and in a backward pass."""
    return _autograd.launch("gated rmsnorm", _launch, "gated", y, z, scale,
                            eps)


fused_rmsnorm_cuda.launches = 0
