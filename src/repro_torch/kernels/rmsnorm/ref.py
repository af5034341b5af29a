"""Plain PyTorch versions of the RMSNorm kernel's routes.

``fused_rmsnorm_reference``: t = x + residual and y = t * rsqrt(mean(t^2)
+ eps) * scale, all in f32; both outputs in x's dtype. ``residual=None``
is the norm alone (t = x). The same function as the JAX package's
``fused_rmsnorm_reference``. In bf16 the norm reads the f32 sum, not the
sum rounded to bf16 that an unfused ``x + y`` followed by ``rms_norm``
would read.

``gated_rmsnorm_reference``: Mamba-2's gated norm, the JAX model's
``rms_norm(p, y * silu(z.astype(f32)).astype(dtype))`` with y already
cast to the activation dtype (``src/repro/models/ssm.py``), here with
that dtype taken from z and the cast of y done inside.

``fused_rmsnorm_backward_reference``: the backward of the add and norm
routes by the formulas the backward kernel computes, in f32 (t, rstd and
t^ = t rstd from x and the residual): dx = rstd (s dy - t^ mean(t^ s
dy)) + dt, the residual's gradient the same, dscale = the sum over rows
of dy t^. The plain version the kernel (``csrc/rmsnorm.cu``'s
``rmsnorm_bwd_launch``) is held against.

``gated_rmsnorm_backward_reference``: the backward of the gated norm by
the formulas its kernel (``rmsnorm_gated_bwd_launch``) computes, in f32
from the forward's rounded values (y^ = T(y), the gate T(silu(z)) and v
= T(y^ gate)): dv by the norm's formula, dy = dv gate, dz = dv y^
sig(z) (1 + z (1 - sig(z))), dscale = the sum over rows of dout v^.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def fused_rmsnorm_reference(x, residual, scale, eps=1e-5):
    t = x.float() if residual is None else x.float() + residual.float()
    var = torch.mean(t * t, dim=-1, keepdim=True)
    y = t * torch.rsqrt(var + eps) * scale.float()
    return y.to(x.dtype), (x if residual is None else t.to(x.dtype))


def gated_rmsnorm_reference(y, z, scale, eps=1e-5):
    v = y.to(z.dtype) * F.silu(z.float()).to(z.dtype)
    return fused_rmsnorm_reference(v, None, scale, eps=eps)[0]


def fused_rmsnorm_backward_reference(x, residual, scale, dy, dt=None,
                                     eps=1e-5):
    """(dx, dscale) of ``fused_rmsnorm_reference`` over the last axis:
    dx in x's dtype (also the residual's gradient), dscale in the scale's
    dtype; dt the sum output's gradient, or None."""
    d = x.shape[-1]
    t = x.float() if residual is None else x.float() + residual.float()
    rstd = torch.rsqrt(torch.mean(t * t, dim=-1, keepdim=True) + eps)
    th = t * rstd
    g = dy.float() * scale.float()
    dx = rstd * (g - th * torch.mean(th * g, dim=-1, keepdim=True))
    if dt is not None:
        dx = dx + dt.float()
    dscale = (dy.float() * th).reshape(-1, d).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def gated_rmsnorm_backward_reference(y, z, scale, dout, eps=1e-5):
    """(dy, dz, dscale) of ``gated_rmsnorm_reference`` over the last axis
    for the output gradient ``dout``: dy in y's dtype, dz in z's, dscale
    in the scale's, each computed in f32 (v, rstd and v^ = v rstd from y
    and z as the forward rounds them)."""
    d = z.shape[-1]
    zf = z.float()
    yh = y.to(z.dtype).float()
    gate = F.silu(zf).to(z.dtype).float()
    v = (yh * gate).to(z.dtype).float()
    rstd = torch.rsqrt(torch.mean(v * v, dim=-1, keepdim=True) + eps)
    vh = v * rstd
    g = dout.float() * scale.float()
    dv = rstd * (g - vh * torch.mean(vh * g, dim=-1, keepdim=True))
    sig = torch.sigmoid(zf)
    dz = dv * yh * sig * (1 + zf * (1 - sig))
    dscale = (dout.float() * vh).reshape(-1, d).sum(0)
    return (dv * gate).to(y.dtype), dz.to(z.dtype), dscale.to(scale.dtype)
