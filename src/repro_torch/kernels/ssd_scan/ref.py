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

``ssd_backward_reference`` is the backward of ``ssd_reference`` written
out by its formulas (not by autograd), the plain version the backward
kernel (``csrc/ssd_scan_bwd.cu``) is held against. Per (b, h) and chunk
of length Q, with c_i = sum_{t<=i} dt_t A_h within the chunk and x^ =
dt x:

  y_i   = sum_{j<=i} (C_i.B_j) e^{c_i-c_j} x^_j + e^{c_i} S_in C_i + D x_i
  S_out = e^{c_Q} S_in + sum_j e^{c_Q-c_j} x^_j B_j^T

so, with G = dS_out (the next chunk's dS_in; the final state's gradient
for the last chunk), M_ij = (C_i.B_j)(dy_i.x^_j) e^{c_i-c_j} (j <= i):

  dS_in  = sum_i e^{c_i} dy_i C_i^T + e^{c_Q} G
  dx^_j  = sum_{i>=j} (C_i.B_j) e^{c_i-c_j} dy_i + e^{c_Q-c_j} G B_j
  dC_i   = sum_{j<=i} e^{c_i-c_j} (dy_i.x^_j) B_j + e^{c_i} S_in^T dy_i
  dB_j   = sum_{i>=j} e^{c_i-c_j} (dy_i.x^_j) C_i + e^{c_Q-c_j} G^T x^_j
  dc_i   = sum_j M_ij - sum_k M_ki + e^{c_i} dy_i.(S_in C_i)
           - e^{c_Q-c_i} x^_i.(G B_i) (+ at i = Q: sum_j e^{c_Q-c_j}
           x^_j.(G B_j) + e^{c_Q} <G, S_in>)

then d(dt A)_t = sum_{i>=t} dc_i (a reverse cumsum within the chunk),
dx = dt dx^ + D dy, ddt = x.dx^ + A d(dt A), dA = sum dt d(dt A), dD =
sum dy.x; dB and dC summed over the heads of a group.
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


def ssd_backward_reference(x, dt, A, B, C, D, dy, dfinal=None, *,
                           chunk=64, initial_state=None):
    """The gradients of ``ssd_reference(x, dt, A, B, C, D, chunk=chunk,
    initial_state=initial_state)`` for the output gradients dy (b, l, h,
    p) and ``dfinal`` (b, h, p, n) or None (the final state took no
    part), by the formulas of the module docstring. Returns (dx, ddt, dA,
    dB, dC, dD, dinit): dx, dB, dC in the dtypes of x, B, C; ddt, dA, dD
    and dinit f32; dD None when D is None, dinit None when
    ``initial_state`` is None."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if l % chunk:
        raise ValueError(f"seq {l} not divisible by chunk {chunk}")
    nc, Q, rep = l // chunk, chunk, h // g
    f32 = dict(dtype=torch.float32, device=x.device)
    Af = A.float()
    xr = x.float().reshape(b, nc, Q, h, p)
    dtr = dt.float().reshape(b, nc, Q, h)
    Br = B.float().repeat_interleave(rep, dim=2).reshape(b, nc, Q, h, n)
    Cr = C.float().repeat_interleave(rep, dim=2).reshape(b, nc, Q, h, n)
    dyr = dy.float().reshape(b, nc, Q, h, p)
    xb = xr * dtr[..., None]                              # x^
    cum = torch.cumsum(dtr * Af, dim=2)                   # (b, nc, Q, h)
    cq = cum[:, :, -1]                                    # (b, nc, h)
    eC = torch.exp(cum)                                   # e^{c_i}
    eS = torch.exp(cq[:, :, None] - cum)                  # e^{c_Q - c_j}
    ch = cum.transpose(2, 3)                              # (b, nc, h, Q)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    Lm = torch.exp((ch[..., :, None] - ch[..., None, :]).masked_fill(
        ~tri, 0.0)) * tri                                 # (b, nc, h, i, j)

    # the incoming states, then the reverse pass
    loc = torch.einsum("bcjh,bcjhp,bcjhn->bchpn", eS, xb, Br)
    s = torch.zeros((b, h, p, n), **f32) if initial_state is None \
        else initial_state.float()
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = s * torch.exp(cq[:, c])[..., None, None] + loc[:, c]
    s_in = torch.stack(s_in, dim=1)                       # (b, nc, h, p, n)
    into = torch.einsum("bcih,bcihp,bcihn->bchpn", eC, dyr, Cr)
    gs = torch.zeros((b, h, p, n), **f32) if dfinal is None \
        else dfinal.float()
    g_out = [None] * nc
    for c in reversed(range(nc)):
        g_out[c] = gs
        gs = into[:, c] + torch.exp(cq[:, c])[..., None, None] * gs
    g_out = torch.stack(g_out, dim=1)                     # dS_out

    # the intra-chunk terms
    sij = torch.einsum("bcihn,bcjhn->bchij", Cr, Br)
    dyx = torch.einsum("bcihp,bcjhp->bchij", dyr, xb)
    W = Lm * dyx
    M = sij * W
    dxb = torch.einsum("bchij,bcihp->bcjhp", Lm * sij, dyr)
    dC = torch.einsum("bchij,bcjhn->bcihn", W, Br)
    dB = torch.einsum("bchij,bcihn->bcjhn", W, Cr)
    dc = (M.sum(-1) - M.sum(-2)).transpose(2, 3)          # (b, nc, Q, h)
    # the incoming state's terms
    u = torch.einsum("bchpn,bcihn->bcihp", s_in, Cr)
    dC = dC + eC[..., None] * torch.einsum("bchpn,bcihp->bcihn", s_in, dyr)
    dc = dc + eC * (dyr * u).sum(-1)
    # the outgoing state's terms
    w = torch.einsum("bchpn,bcjhn->bcjhp", g_out, Br)
    dxb = dxb + eS[..., None] * w
    dB = dB + eS[..., None] * torch.einsum("bchpn,bcjhp->bcjhn", g_out, xb)
    m = eS * (xb * w).sum(-1)
    dc = dc - m
    dc[:, :, -1] += m.sum(2) + torch.exp(cq) * (g_out * s_in).sum((-1, -2))

    da = torch.flip(torch.cumsum(torch.flip(dc, (2,)), 2), (2,))
    dx = dxb * dtr[..., None]
    if D is not None:
        dx = dx + dyr * D.float()[:, None]
    ddt = (xr * dxb).sum(-1) + Af * da
    dA = (dtr * da).sum((0, 1, 2))
    dD = None if D is None else (dyr * xr).sum((0, 1, 2, 4))
    dB = dB.reshape(b, l, g, rep, n).sum(3)
    dC = dC.reshape(b, l, g, rep, n).sum(3)
    return (dx.reshape(b, l, h, p).to(x.dtype), ddt.reshape(b, l, h), dA,
            dB.to(B.dtype), dC.to(C.dtype), dD,
            None if initial_state is None else gs)
