"""The SSD scan ops the Mamba-2 mixer calls, with the contracts of the JAX
package's ``kernels/ssd_scan/ops.py``: the CUDA kernels for CUDA tensors,
the plain versions for CPU tensors.

``ssd_extend`` and ``ssd_step`` also take ``out`` (where the new state
goes; it may be ``state`` itself, so a cache leaf is advanced in place)
and ``ckpt`` (which receives the incoming state: the cache's ``ssm_ckpt``
leaf). On the card ``ssd_step`` is the ``ssd_extend`` kernel at T = 1, so
every state update there has one arithmetic: a slot's state does not
depend on whether its token came in a plain step or in a mixed step's
T = 1 extend, and extending by T tokens is bitwise T steps. On the CPU
the plain extend is a loop of the plain step, bitwise too.
"""
from __future__ import annotations

from repro_torch.kernels import dispatch
from repro_torch.kernels.ssd_scan import kernel as _kernel
from repro_torch.kernels.ssd_scan import ref as _ref


def ssd(x, dt, A, B, C, D=None, *, chunk=64, initial_state=None):
    """The chunked dual form: x (b, l, h, p), dt (b, l, h), A (h,), B/C
    (b, l, g, n), D (h,) or None, l % chunk == 0; ``initial_state`` (b,
    h, p, n) seeds the state (zero when None). Returns (y (b, l, h, p)
    f32, final state (b, h, p, n) f32)."""
    ts = [t for t in (x, dt, A, B, C, D, initial_state) if t is not None]
    if dispatch.use_kernel(*ts):
        return _kernel.ssd_cuda(x, dt, A, B, C, D, chunk=chunk,
                                initial_state=initial_state)
    return _ref.ssd_reference(x, dt, A, B, C, D, chunk=chunk,
                              initial_state=initial_state)


def _plain_into(y, s, state, out, ckpt):
    if ckpt is not None:
        ckpt.copy_(state)
    if out is not None:
        s = out.copy_(s)
    return y, s


def ssd_extend(state, x, dt, A, B, C, D=None, *, out=None, ckpt=None):
    """Multi-token sequential recurrence from an explicit state: state
    (b, h, p, n) f32, x (b, T, h, p), dt (b, T, h), B/C (b, T, g, n).
    Returns (y (b, T, h, p) f32, new state). Bitwise equal to T
    applications of ``ssd_step`` on both paths."""
    ts = [t for t in (state, x, dt, A, B, C, D, out, ckpt) if t is not None]
    if dispatch.use_kernel(*ts):
        return _kernel.ssd_extend_cuda(state, x, dt, A, B, C, D, out=out,
                                       ckpt=ckpt)
    y, s = _ref.ssd_extend_reference(state, x, dt, A, B, C, D)
    return _plain_into(y, s, state, out, ckpt)


def ssd_step(state, x, dt, A, B, C, D=None, *, out=None, ckpt=None):
    """One recurrence step: state (b, h, p, n) f32, x (b, h, p), dt (b,
    h), B/C (b, g, n). Returns (y (b, h, p) f32, new state). On CUDA
    tensors this is the ``ssd_extend`` kernel at T = 1."""
    ts = [t for t in (state, x, dt, A, B, C, D, out, ckpt) if t is not None]
    if dispatch.use_kernel(*ts):
        y, s = _kernel.ssd_extend_cuda(state, x[:, None], dt[:, None], A,
                                       B[:, None], C[:, None], D, out=out,
                                       ckpt=ckpt)
        return y[:, 0], s
    y, s = _ref.ssd_decode_step(state, x, dt, A, B, C, D)
    return _plain_into(y, s, state, out, ckpt)
