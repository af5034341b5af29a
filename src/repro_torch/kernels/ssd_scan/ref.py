"""Plain PyTorch versions of the Mamba-2 SSD (state-space dual) scan.

The same functions as the JAX package's ``kernels/ssd_scan/ref.py``,
with its shapes (Mamba-2 paper, arXiv:2405.21060):

  x  : (b, l, h, p)   inputs split into h heads of dim p
  dt : (b, l, h)      positive step sizes (softplus already applied)
  A  : (h,)           negative per-head decay rates
  B,C: (b, l, g, n)   input/output projections, g groups (h % g == 0)

``ssd_reference`` is the chunked dual form (the cache-free forward);
``ssd_extend_reference`` is exactly T applications of
``ssd_decode_step``, so on the CPU extending by [t1, t2] tokens gives the
bits of extending by [t1 + t2] and of t1 + t2 single steps. All
arithmetic is f32; y and the states come back in f32.
"""
from __future__ import annotations

import torch


def segsum(x):
    """x: (..., T) -> (..., T, T) with out[..., i, j] = sum_{j<s<=i} x[s]
    (lower-triangular; -inf above the diagonal so exp() masks it)."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                 device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_reference(x, dt, A, B, C, D=None, *, chunk=64, initial_state=None):
    """Returns y (b, l, h, p) and the final state (b, h, p, n), both f32;
    ``initial_state`` (b, h, p, n) seeds the carried state (zero when
    None)."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if l % chunk:
        raise ValueError(f"seq {l} not divisible by chunk {chunk}")
    nc = l // chunk
    rep = h // g

    x, dt = x.float(), dt.float()
    A, B, C = A.float(), B.float(), C.float()
    Bh = B.repeat_interleave(rep, dim=2)                 # (b, l, h, n)
    Ch = C.repeat_interleave(rep, dim=2)

    xr = x.reshape(b, nc, chunk, h, p)
    dtr = dt.reshape(b, nc, chunk, h)
    Br = Bh.reshape(b, nc, chunk, h, n)
    Cr = Ch.reshape(b, nc, chunk, h, n)

    dA = torch.einsum("bcsh,h->bchs", dtr, A)            # (b, nc, h, chunk)
    dA_cum = torch.cumsum(dA, dim=-1)
    Lm = torch.exp(segsum(dA))                           # (b, nc, h, c, c)
    xdt = xr * dtr[..., None]                            # (b, nc, c, h, p)

    # intra-chunk (dual / quadratic form)
    Y_diag = torch.einsum("bclhn,bcshn,bchls,bcshp->bclhp", Cr, Br, Lm, xdt)

    # per-chunk end states
    decay_states = torch.exp(dA_cum[..., -1:] - dA_cum)  # (b, nc, h, c)
    states = torch.einsum("bcshn,bchs,bcshp->bchpn", Br, decay_states, xdt)

    # inter-chunk recurrence, emitting each chunk's incoming state
    chunk_decay = torch.exp(dA_cum[..., -1])             # (b, nc, h)
    s = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) \
        if initial_state is None else initial_state.float()
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)                      # (b, nc, h, p, n)

    # inter-chunk contribution to outputs
    state_decay_out = torch.exp(dA_cum)                  # (b, nc, h, c)
    Y_off = torch.einsum("bclhn,bchpn,bchl->bclhp", Cr, prev,
                         state_decay_out)

    y = (Y_diag + Y_off).reshape(b, l, h, p)
    if D is not None:
        y = y + x * D.float()[None, None, :, None]
    return y, s


def ssd_extend_reference(state, x, dt, A, B, C, D=None):
    """Multi-token sequential recurrence from an explicit state.

    state: (b, h, p, n); x: (b, T, h, p); dt: (b, T, h); B, C: (b, T, g,
    n). Returns (y (b, T, h, p), final state (b, h, p, n)): exactly T
    applications of ``ssd_decode_step``."""
    s = state.float()
    ys = []
    for t in range(x.shape[1]):
        y, s = ssd_decode_step(s, x[:, t], dt[:, t], A, B[:, t], C[:, t], D)
        ys.append(y)
    return torch.stack(ys, dim=1), s


def ssd_decode_step(state, x, dt, A, B, C, D=None):
    """Single-token recurrence: s' = exp(dt·A)·s + (dt·x) Bᵀ, y = C s'ᵀ
    (+ D·x). state: (b, h, p, n); x: (b, h, p); dt: (b, h); B, C: (b, g,
    n)."""
    h = x.shape[1]
    rep = h // B.shape[1]
    x, dt = x.float(), dt.float()
    Bh = B.float().repeat_interleave(rep, dim=1)         # (b, h, n)
    Ch = C.float().repeat_interleave(rep, dim=1)
    dA = torch.exp(dt * A.float()[None])                 # (b, h)
    new_state = state.float() * dA[..., None, None] + \
        (x * dt[..., None])[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    if D is not None:
        y = y + x * D.float()[None, :, None]
    return y, new_state
