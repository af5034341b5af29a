"""QTensor: the quantized-weight leaf format (the port's copy of the JAX
package's ``quant/qtensor.py``).

A QTensor is a plain dict, so the stacked block axis of the parameters
slices through it unchanged (``transformer._at``):

* int8, symmetric per output channel::

      {"q":  int8 (..., K, N),        # round(w / scale)
       "scale": f32 (..., N)}         # max|w| over K / 127

* int4, symmetric group-wise along K, two values packed per byte::

      {"q4": int8 (..., K//2, N),     # row 2i in the low nibble of
                                      # byte i, row 2i+1 in the high
       "scale": f32 (..., n_groups, N)}

The precision is encoded by the key (``q`` or ``q4``), never by a
tensor. Quantization is always over the last two dims ``(K, N) = (d_in,
d_out)``. int4 uses the symmetric range [-7, 7], so dequantization is
``q * scale`` with no zero point. The leaves are bit-equal to the JAX
package's for the same float weights: the same f32 arithmetic, and
``torch.round`` rounds half to even as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

QTENSOR_KEYS = ("q", "q4")
_EPS = 1e-8


def is_qtensor(x) -> bool:
    return isinstance(x, dict) and "scale" in x \
        and any(k in x for k in QTENSOR_KEYS)


def qtensor_bits(qt) -> int:
    return 4 if "q4" in qt else 8


def int4_group_size(K: int, group_size: int) -> int:
    """The group size ``quantize_tensor`` uses for d_in ``K``: the largest
    divisor of K that is <= ``group_size`` (it may be odd: 17 for K 34)."""
    gs = group_size
    while K % gs:
        gs -= 1
    return gs


def qtensor_shapes(shape: Tuple[int, ...], bits: int, group_size: int
                   ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{leaf: (shape, dtype)} of the QTensor that ``quantize_tensor`` makes
    from a float weight of ``shape`` (..., K, N)."""
    *lead, K, N = shape
    lead = tuple(lead)
    if bits == 8:
        return {"q": (lead + (K, N), torch.int8),
                "scale": (lead + (N,), torch.float32)}
    ng = K // int4_group_size(K, group_size)
    return {"q4": (lead + (K // 2, N), torch.int8),
            "scale": (lead + (ng, N), torch.float32)}


# --------------------------------------------------------------------- #
# int4 packing: two signed nibbles per int8 byte, paired along K
# --------------------------------------------------------------------- #
def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """q: int (..., K, N) with values in [-8, 7], K even -> int8 (...,
    K//2, N); row 2i in the low nibble, row 2i+1 in the high."""
    K = q.shape[-2]
    if K % 2:
        raise ValueError(f"int4 packing needs even K, got {K}")
    pairs = q.to(torch.int32).reshape(q.shape[:-2] + (K // 2, 2,
                                                      q.shape[-1]))
    lo, hi = pairs[..., 0, :], pairs[..., 1, :]
    byte = ((hi & 0xF) << 4) | (lo & 0xF)                 # 0..255
    return torch.where(byte >= 128, byte - 256, byte).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """int8 (..., K//2, N) -> int32 (..., K, N), sign-extended nibbles:
    ``(n ^ 8) - 8`` of each 4-bit field, the value JAX's ``(p << 28) >>
    28`` and ``(p << 24) >> 28`` give."""
    p32 = packed.to(torch.int32)
    lo = ((p32 & 0xF) ^ 8) - 8
    hi = (((p32 >> 4) & 0xF) ^ 8) - 8
    Kp, N = packed.shape[-2], packed.shape[-1]
    both = torch.stack([lo, hi], dim=-2)                   # (..., Kp, 2, N)
    return both.reshape(packed.shape[:-2] + (2 * Kp, N))


# --------------------------------------------------------------------- #
# quantize / dequantize one weight
# --------------------------------------------------------------------- #
def quantize_tensor(w: torch.Tensor, bits: int = 8, group_size: int = 32):
    """w: float (..., K, N) -> QTensor dict on w's device.

    int8: per-(output-)channel scale over the full K axis. int4:
    group-wise scale over ``int4_group_size(K, group_size)`` rows of K.
    """
    wf = w.to(torch.float32)
    K = wf.shape[-2]
    if bits == 8:
        scale = torch.clamp(wf.abs().amax(dim=-2) / 127.0, min=_EPS)
        q = torch.clamp(torch.round(wf / scale[..., None, :]), -127, 127)
        return {"q": q.to(torch.int8), "scale": scale}
    if bits == 4:
        if K % 2:
            raise ValueError(f"int4 needs even d_in, got {K}")
        gs = int4_group_size(K, group_size)
        ng = K // gs
        wg = wf.reshape(wf.shape[:-2] + (ng, gs, wf.shape[-1]))
        scale = torch.clamp(wg.abs().amax(dim=-2) / 7.0, min=_EPS)
        q = torch.clamp(torch.round(wg / scale[..., None, :]), -7, 7)
        q = q.reshape(wf.shape).to(torch.int32)
        return {"q4": pack_int4(q), "scale": scale}
    raise ValueError(f"unsupported bits={bits}")


def dequantize_tensor(qt, dtype=torch.float32) -> torch.Tensor:
    """QTensor dict -> dense float tensor (..., K, N)."""
    scale = qt["scale"].to(torch.float32)
    if "q" in qt:
        return (qt["q"].to(torch.float32) * scale[..., None, :]).to(dtype)
    q = unpack_int4(qt["q4"]).to(torch.float32)
    ng, gs = scale.shape[-2], q.shape[-2] // scale.shape[-2]
    wg = q.reshape(q.shape[:-2] + (ng, gs, q.shape[-1]))
    return (wg * scale[..., None, :]).reshape(q.shape).to(dtype)


def qtensor_nbytes(qt) -> int:
    """Stored bytes (values + scales)."""
    return sum(v.numel() * v.element_size() for v in qt.values())
