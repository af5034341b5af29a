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
