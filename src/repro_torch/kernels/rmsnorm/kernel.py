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
count in one counter, ``fused_rmsnorm_cuda.launches``: one kernel. The
add and norm routes run through ``_autograd.differentiable``: where a
gradient can be asked for, inside a node whose backward is
``fused_rmsnorm_bwd_cuda`` (``rmsnorm_bwd_launch`` of the same ``.cu``:
rows mapped to threads by ``plan_bwd``, up to 4 units a lane, each row
read once in 16-byte units and held in registers through its reduction
(two rows in flight a row slot), each thread's dscale sums in registers
over its rows; then the dscale reduction over the blocks' partial sums,
no atomics; rstd recomputed from x; it replaces no TPU kernel, the JAX
package differentiates its plain norm), counted in
``fused_rmsnorm_bwd_cuda.launches``, one a call. The gated route runs
through ``_autograd.differentiable`` too: its node's backward is
``gated_rmsnorm_bwd_cuda`` (``rmsnorm_gated_bwd_launch``: the same
register route from ``plan_bwd(..., "gated")``, one pass over y, z and
dout in 16-byte units, sig(z) and the gate once an element, z read in
place; jamba's d 16384 on the wide-row route; it replaces no TPU kernel
either), counted in ``gated_rmsnorm_bwd_cuda.launches``.
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
#: the C signatures of csrc/rmsnorm.cu's entry points
ARGTYPES = {"rmsnorm_launch": [_P] * 5 + [_I] * 7 + [_LL] * 2
            + [_I, _F, _P],
            "rmsnorm_bwd_launch": [_P] * 8 + [_I] * 6 + [_LL] * 2
            + [_I, _I, _F, _P],
            "rmsnorm_gated_bwd_launch": [_P] * 8 + [_I] * 6 + [_LL] * 2
            + [_I, _I, _F, _P]}
#: 16-byte units a thread of the backward's register route (csrc
#: templates), at most BWD_HOLD_THREADS threads a block; a row on at most
#: BWD_ROW_THREADS threads where the units allow (more rows in flight an
#: SM than one warp a row at 4 units a lane: measured on the card at d
#: 2048, N 4096); a gated row on up to BWD_HOLD_THREADS (its unit holds
#: an f32 y: the fewer units a lane, the fewer registers)
NVS_BWD = (1, 2, 4)
#: a gated bf16 row's units a lane on the register route (4 of an f32 y
#: spill: wider rows, past d 4096, take the wide-row route)
NVS_BWD_GATED_BF16 = (1, 2)
BWD_HOLD_THREADS = 256
BWD_ROW_THREADS = 128
#: units a thread of its wide-row route (a row past 1024 units, d 8192
#: bf16, 4096 f32: one a block, re-reading its units)
BWD_WIDE_UNITS = 8
#: blocks of the add / norm backward's row pass at most: one an SM, so
#: the second launch sums as few partial rows as fill the card
BWD_GRID = 132
# csrc flags of the backward: the residual and dt present, the scale f32,
# the gated route's y f32; the add / norm route's 16-byte paths
B_RES, B_DT, B_SF32, B_YF32 = 1, 2, 4, 8
BV_X, BV_R, BV_DY, BV_DT, BV_S, BV_DX = 16, 32, 64, 128, 256, 512
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


def bwd_hold_threads(nv: int) -> int:
    """Threads a block of the backward's register route at ``nv`` units
    a lane (csrc ``bwd_hold_threads``): twice ``BWD_HOLD_THREADS`` at one
    unit, whose templates stay within 128 registers."""
    return 2 * BWD_HOLD_THREADS if nv == 1 else BWD_HOLD_THREADS


@functools.lru_cache(maxsize=1024)
def plan_bwd(N: int, d: int, dtype: torch.dtype,
             route: str = "add") -> Plan:
    """The backward's launch for rows of d elements of ``dtype`` (x, or
    z on the gated route). Add / norm: the fewest units a thread in
    ``NVS_BWD`` that fit a row on ``BWD_ROW_THREADS`` threads (4 where
    none does), ``BWD_HOLD_THREADS // tpr`` rows a block. Gated: the
    fewest units a thread (``NVS_BWD_GATED_BF16`` for bf16 rows) whose
    row fits a block of ``bwd_hold_threads(nv)`` threads (one unit a lane
    up to 512 threads: d 4096 bf16 in 12 warps at d 3072), as many rows a
    block as fit it. A row's threads are rounded up to a warp. A row past
    the register route (past d 8192 bf16 or 4096 f32; gated bf16 past d
    4096) runs alone in its block on the wide-row route, 8 units a
    thread. At most ``BWD_GRID`` blocks walk the rows (each block's
    partial dscale row is summed in the second launch)."""
    if d > MAX_D:
        raise ValueError(f"d={d} exceeds the backward's row limit")
    units = -(-d // (16 // dtype.itemsize))

    def warps(v):                         # a row's threads at v units
        return (-(-units // v) + 31) // 32 * 32
    if route == "gated":
        nvs = NVS_BWD_GATED_BF16 if dtype == torch.bfloat16 else NVS_BWD
        nv = next((v for v in nvs if warps(v) <= bwd_hold_threads(v)),
                  None)
    else:
        nv = None if units > BWD_HOLD_THREADS * NVS_BWD[-1] else next(
            (v for v in NVS_BWD if units <= BWD_ROW_THREADS * v),
            NVS_BWD[-1])
    if nv is None:
        nv, rows = BWD_WIDE_UNITS, 1
        tpr = warps(nv)
    else:
        tpr = warps(nv)
        rows = max(1, (bwd_hold_threads(nv) if route == "gated"
                       else BWD_HOLD_THREADS) // tpr)
    return Plan(route, nv, tpr, rows, tpr * rows,
                min(-(-N // rows), BWD_GRID))


def _launcher(entry="rmsnorm_launch"):
    fn = _FNS.get(entry)
    if fn is None:
        fn = getattr(_build.load("rmsnorm"), entry)
        fn.argtypes = ARGTYPES[entry]
        fn.restype = ctypes.c_int
        _FNS[entry] = fn
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


def fused_rmsnorm_bwd_cuda(x, residual, scale, dy, dt=None, eps=1e-5):
    """The backward of the add route (``residual`` given) or the norm
    route (None) on the current stream: x, residual as the forward took
    them; dy the gradient of y, dt that of the sum t (None where t took
    no part; always None on the norm route), each (N, d) in x's dtype,
    any strides (made contiguous once here). Returns (dx, dscale): dx a
    new contiguous (N, d) tensor in x's dtype, also the residual's
    gradient; dscale (d,) in the scale's dtype, summed in f32."""
    dtype, shape, dev = x.dtype, x.shape, x.device
    if dev.type != "cuda" or len(shape) != 2 or dtype not in _DTYPES:
        raise ValueError(f"rmsnorm backward takes (N, d) float32 or "
                         f"bfloat16 CUDA tensors, got {tuple(shape)} "
                         f"{dtype} on {dev}")
    N, d = shape
    if d > MAX_D:
        raise ValueError(f"d={d} exceeds the kernel's limit {MAX_D}")
    sx = _rows("x", x, shape, (dtype,), dev)
    sr = 0 if residual is None else _rows("residual", residual, shape,
                                          (dtype,), dev)
    if scale.shape != (d,) or scale.stride(0) != 1 \
            or scale.dtype not in _DTYPES or scale.device != dev:
        raise ValueError(f"scale must be a contiguous ({d},) float32 or "
                         f"bfloat16 tensor on {dev}, got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    for name, g in (("dy", dy), ("dt", dt)):
        if g is not None and (g.shape != shape or g.dtype != dtype
                              or g.device != dev):
            raise ValueError(f"{name} must be a {tuple(shape)} {dtype} "
                             f"tensor on {dev}")
    dy = dy.contiguous()
    dt = None if dt is None else dt.contiguous()
    dx = torch.empty((N, d), dtype=dtype, device=dev)
    dscale = torch.empty((d,), dtype=scale.dtype, device=dev)
    if N == 0:
        return dx, dscale.zero_()
    pl = plan_bwd(N, d, dtype, "norm" if residual is None else "add")
    partial = torch.empty((pl.blocks, d), dtype=torch.float32, device=dev)
    # the 16-byte path of an operand: its pointer and row stride on the
    # alignment of a unit (8 bytes for four bf16 of an f32 row's scale)
    es = dtype.itemsize
    unit = 16 // es
    px = x.data_ptr()
    pr = 0 if residual is None else residual.data_ptr()
    pdy = dy.data_ptr()
    pdt = 0 if dt is None else dt.data_ptr()
    ps = scale.data_ptr()
    flags = (B_RES * (residual is not None) | B_DT * (dt is not None)
             | B_SF32 * (scale.dtype == torch.float32)
             | BV_X * ((px | sx * es) % 16 == 0)
             | BV_R * ((pr | sr * es) % 16 == 0)
             | BV_DY * ((pdy | d * es) % 16 == 0)
             | BV_DT * ((pdt | d * es) % 16 == 0)
             | BV_S * (ps % min(16, unit * scale.dtype.itemsize) == 0)
             | BV_DX * (d % unit == 0))
    err = _launcher("rmsnorm_bwd_launch")(
        px, pr or None, ps, pdy, pdt or None, dx.data_ptr(),
        partial.data_ptr(), dscale.data_ptr(), N, d, _DTYPES[dtype], pl.nv,
        pl.tpr, pl.rows, sx, sr, flags, pl.blocks, float(eps),
        torch._C._cuda_getCurrentRawStream(dev.index))
    fused_rmsnorm_bwd_cuda.launches += 1
    if err != 0:
        raise RuntimeError(f"rmsnorm backward launch failed: CUDA error "
                           f"{err}")
    return dx, dscale


def gated_rmsnorm_bwd_cuda(y, z, scale, dout, eps=1e-5):
    """The backward of the gated route on the current stream: y and z as
    the forward took them ((N, d), any row stride with the last dimension
    contiguous; y f32 or z's dtype), ``dout`` the output's gradient (N,
    d) in z's dtype, any strides (made contiguous once here). Returns
    (dy, dz, dscale): new contiguous (N, d) tensors in y's and z's
    dtypes and dscale (d,) in the scale's dtype, summed in f32 over the
    blocks' partial rows in order (no atomics)."""
    dtype, shape, dev = z.dtype, z.shape, z.device
    if dev.type != "cuda" or len(shape) != 2 or dtype not in _DTYPES:
        raise ValueError(f"gated rmsnorm backward takes (N, d) float32 or "
                         f"bfloat16 CUDA tensors, got {tuple(shape)} "
                         f"{dtype} on {dev}")
    N, d = shape
    if d > MAX_D:
        raise ValueError(f"d={d} exceeds the kernel's limit {MAX_D}")
    sy = _rows("y", y, shape, (torch.float32, dtype), dev)
    sz = _rows("z", z, shape, (dtype,), dev)
    if scale.shape != (d,) or scale.stride(0) != 1 \
            or scale.dtype not in _DTYPES or scale.device != dev:
        raise ValueError(f"scale must be a contiguous ({d},) float32 or "
                         f"bfloat16 tensor on {dev}, got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    if dout.shape != shape or dout.dtype != dtype or dout.device != dev:
        raise ValueError(f"dout must be a {tuple(shape)} {dtype} tensor on "
                         f"{dev}")
    dout = dout.contiguous()
    dy = torch.empty((N, d), dtype=y.dtype, device=dev)
    dz = torch.empty((N, d), dtype=dtype, device=dev)
    dscale = torch.empty((d,), dtype=scale.dtype, device=dev)
    if N == 0:
        return dy, dz, dscale.zero_()
    pl = plan_bwd(N, d, dtype, "gated")
    partial = torch.empty((pl.blocks, d), dtype=torch.float32, device=dev)
    # the 16-byte path of an operand: its pointer and row stride on 16
    # bytes (8 for four bf16 of an f32 row's scale); the outputs' where d
    # fills units
    es, ey = dtype.itemsize, y.dtype.itemsize
    py, pz, pd, ps = (y.data_ptr(), z.data_ptr(), dout.data_ptr(),
                      scale.data_ptr())
    flags = (B_SF32 * (scale.dtype == torch.float32)
             | B_YF32 * (y.dtype == torch.float32)
             | BV_X * ((py | sy * ey) % 16 == 0)
             | BV_R * ((pz | sz * es) % 16 == 0)
             | BV_DY * ((pd | d * es) % 16 == 0)
             | BV_S * (ps % min(16, 16 // es * scale.dtype.itemsize) == 0)
             | BV_DX * (d % (16 // es) == 0))
    err = _launcher("rmsnorm_gated_bwd_launch")(
        py, pz, ps, pd, dy.data_ptr(), dz.data_ptr(), partial.data_ptr(),
        dscale.data_ptr(), N, d, _DTYPES[dtype], pl.nv, pl.tpr, pl.rows, sy,
        sz, flags, pl.blocks, float(eps),
        torch._C._cuda_getCurrentRawStream(dev.index))
    gated_rmsnorm_bwd_cuda.launches += 1
    if err != 0:
        raise RuntimeError(f"gated rmsnorm backward launch failed: CUDA "
                           f"error {err}")
    return dy, dz, dscale


def _fast(x, residual, scale, eps):
    return _launch("norm" if residual is None else "add", x, residual,
                   scale, eps)


def _fwd(x, residual, scale, eps):
    return _fast(x, residual, scale, eps), (x, residual, scale), eps


def _bwd(eps, saved, dy, dt=None):
    """The node's backward: y's gradient dy and, on the add route, the
    sum's dt (None where an output took no part)."""
    x, residual, scale = saved
    if dy is None:          # y took no part: the sum's gradient passes
        return dt, dt, None, None
    dx, dscale = fused_rmsnorm_bwd_cuda(x, residual, scale, dy, dt, eps)
    return dx, None if residual is None else dx, dscale, None


def fused_rmsnorm_cuda(x, residual, scale, eps=1e-5):
    """x, residual: (N, d) CUDA tensors of one dtype, float32 or
    bfloat16, any row stride with the last dimension contiguous
    (residual may be None); scale: (d,), float32 or bfloat16. Returns
    (y, t), new contiguous tensors in x's dtype, t = x itself when there
    is no residual; where a gradient can be asked for, through a node
    whose backward runs ``fused_rmsnorm_bwd_cuda``. Raises on any input
    the kernel does not take and when a launch is refused."""
    out = _autograd.differentiable(_fast, _fwd, _bwd, x, residual, scale,
                                   eps)
    return (out, x) if residual is None else out


def _gated_fast(y, z, scale, eps):
    return _launch("gated", y, z, scale, eps)


def _gated_fwd(y, z, scale, eps):
    return _gated_fast(y, z, scale, eps), (y, z, scale), eps


def _gated_bwd(eps, saved, dout):
    if dout is None:
        return None, None, None, None
    return gated_rmsnorm_bwd_cuda(*saved, dout, eps) + (None,)


def gated_rmsnorm_cuda(y, z, scale, eps=1e-5):
    """Mamba-2's gated norm: rmsnorm(T(T(y) * T(silu(f32 z)))) * scale in
    z's dtype T (float32 or bfloat16). y: (N, d) float32 or T; z: (N, d);
    both any row stride with the last dimension contiguous (z is read in
    place out of the in-projection's output); scale: (d,). Returns a new
    contiguous (N, d) tensor in T; where a gradient can be asked for,
    through a node whose backward runs ``gated_rmsnorm_bwd_cuda``. Counts
    in ``fused_rmsnorm_cuda.launches``. Raises on any input the kernel
    does not take and when a launch is refused."""
    return _autograd.differentiable(_gated_fast, _gated_fwd, _gated_bwd, y,
                                    z, scale, eps)


fused_rmsnorm_cuda.launches = 0
fused_rmsnorm_bwd_cuda.launches = 0
gated_rmsnorm_bwd_cuda.launches = 0
