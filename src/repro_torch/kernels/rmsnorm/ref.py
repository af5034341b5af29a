"""Plain PyTorch version of the fused residual add + RMSNorm.

t = x + residual and y = t * rsqrt(mean(t^2) + eps) * scale, all in f32;
both outputs in x's dtype. ``residual=None`` is the norm alone (t = x).
The same function as the JAX package's ``fused_rmsnorm_reference``. In
bf16 the norm reads the f32 sum, not the sum rounded to bf16 that an
unfused ``x + y`` followed by ``rms_norm`` would read.
"""
from __future__ import annotations

import torch


def fused_rmsnorm_reference(x, residual, scale, eps=1e-5):
    t = x.float() if residual is None else x.float() + residual.float()
    var = torch.mean(t * t, dim=-1, keepdim=True)
    y = t * torch.rsqrt(var + eps) * scale.float()
    return y.to(x.dtype), (x if residual is None else t.to(x.dtype))
