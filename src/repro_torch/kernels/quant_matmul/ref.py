"""Plain PyTorch versions of the fused dequantize-matmul (the JAX
package's ``kernels/quant_matmul/ref.py``).

int8 per-channel uses the scale algebra ``x @ (q * s) == (x @ q) * s``:
the scale is an epilogue on the f32 accumulator. int4 group-wise needs
the per-group contraction first: ``y = sum_g (x_g @ q_g) * s_g``. Both
accumulate in f32 and return ``x.dtype``.
"""
from __future__ import annotations

import torch

from repro_torch.quant.qtensor import unpack_int4


def quant_matmul_int8_reference(x, q, scale):
    """x: (M, K) float; q: (K, N) int8; scale: (N,) f32 -> (M, N)."""
    acc = x.to(torch.float32) @ q.to(torch.float32)
    return (acc * scale[None, :].to(torch.float32)).to(x.dtype)


def quant_matmul_int4_reference(x, q4, scale):
    """x: (M, K) float; q4: (K//2, N) packed int8; scale: (ng, N) f32."""
    qf = unpack_int4(q4).to(torch.float32)               # (K, N)
    K, N = qf.shape
    ng = scale.shape[0]
    gs = K // ng
    xg = x.to(torch.float32).reshape(-1, ng, gs)
    qg = qf.reshape(ng, gs, N)
    partial = torch.einsum("mgk,gkn->mgn", xg, qg)
    y = (partial * scale[None].to(torch.float32)).sum(dim=1)
    return y.to(x.dtype)
