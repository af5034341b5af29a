"""Fused residual add + RMSNorm over the last axis of any shape: the op
every norm of the decoder path calls."""
from __future__ import annotations

from repro_torch.kernels import dispatch
from repro_torch.kernels.rmsnorm import kernel as _kernel
from repro_torch.kernels.rmsnorm import ref as _ref


def fused_rmsnorm(x, residual, scale, *, eps=1e-5):
    """(y, t): t = x + residual (x itself when ``residual`` is None) and
    y = rmsnorm(t) * scale, both in x's dtype. The Triton kernel for CUDA
    tensors, the plain version for CPU tensors."""
    ts = (x, scale) if residual is None else (x, residual, scale)
    if not dispatch.use_kernel(*ts):
        return _ref.fused_rmsnorm_reference(x, residual, scale, eps=eps)
    d = x.shape[-1]
    y, t = _kernel.fused_rmsnorm_triton(
        x.reshape(-1, d), None if residual is None else
        residual.reshape(-1, d), scale, eps=eps)
    return y.view(x.shape), (x if residual is None else t.view(x.shape))
