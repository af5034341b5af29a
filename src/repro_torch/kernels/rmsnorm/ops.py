"""RMSNorm ops over the last axis of any shape: the fused residual add +
RMSNorm every norm of the decoder path calls, and Mamba-2's gated norm.
The CUDA kernel for CUDA tensors, the plain versions for CPU tensors."""
from __future__ import annotations

from repro_torch.kernels import dispatch
from repro_torch.kernels.rmsnorm import kernel as _kernel
from repro_torch.kernels.rmsnorm import ref as _ref


def fused_rmsnorm(x, residual, scale, *, eps=1e-5):
    """(y, t): t = x + residual (x itself when ``residual`` is None) and
    y = rmsnorm(t) * scale, both in x's dtype."""
    ts = (x, scale) if residual is None else (x, residual, scale)
    if not dispatch.use_kernel(*ts):
        return _ref.fused_rmsnorm_reference(x, residual, scale, eps=eps)
    d = x.shape[-1]
    y, t = _kernel.fused_rmsnorm_cuda(
        x.reshape(-1, d), None if residual is None else
        residual.reshape(-1, d), scale, eps=eps)
    return y.view(x.shape), (x if residual is None else t.view(x.shape))


def gated_rmsnorm(y, z, scale, *, eps=1e-5):
    """rmsnorm(v) * scale with v = y * silu(z) in z's dtype, rounded as
    the JAX model rounds it: y (the SSD output, f32 or z's dtype) and
    silu(f32 z) each cast to z's dtype, their product in it. y and z
    (..., d) of one shape; z may be a strided slice of the in-projection
    (its rows are read in place on the card)."""
    if not dispatch.use_kernel(y, z, scale):
        return _ref.gated_rmsnorm_reference(y, z, scale, eps=eps)
    d = z.shape[-1]
    out = _kernel.gated_rmsnorm_cuda(y.reshape(-1, d), z.reshape(-1, d),
                                     scale, eps=eps)
    return out.view(z.shape)
