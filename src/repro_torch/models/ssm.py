"""Mamba-2 (SSD) mixer block: projections, causal conv, gated norm and
the SSD scan (chunked dual form for the cache-free forward, the
sequential recurrence for extend and decode). The port's copy of the
JAX package's ``models/ssm.py``, with its parameter and cache trees.

As in the rest of the port, the cached modes update the caller's cache
in place (the per-layer view of the stacked cache, or a slot's view):
the new state is written into the ``ssm`` leaf by the scan op itself
and the incoming one into ``ssm_ckpt``; ``conv``/``step`` and their
checkpoints are copied in place. ``A_log``, ``D`` and ``dt_bias`` are
float32 whatever the parameter dtype is (``F32_LEAVES``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rmsnorm.ops import gated_rmsnorm
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers import linear

#: parameter leaves kept in float32 in every parameter dtype
F32_LEAVES = ("A_log", "D", "dt_bias")
CACHE_KEYS = ("conv", "ssm", "step", "conv_ckpt", "ssm_ckpt", "step_ckpt")


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, nh, conv_dim


def ssm_param_shapes(cfg: ModelConfig, nb: int):
    """The mixer's parameter tree as shapes, block axis first."""
    s, d_in, nh, conv_dim = _dims(cfg)
    d_proj = 2 * d_in + 2 * s.n_groups * s.d_state + nh
    return {"in_proj": {"w": (nb, cfg.d_model, d_proj)},
            "conv_w": (nb, conv_dim, s.d_conv),
            "conv_b": (nb, conv_dim),
            "A_log": (nb, nh), "D": (nb, nh), "dt_bias": (nb, nh),
            "norm": {"scale": (nb, d_in)},
            "out_proj": {"w": (nb, d_in, cfg.d_model)}}


def init_ssm_leaf(cfg: ModelConfig, key: str, shape, gen, device):
    """One mixer leaf by the JAX package's scheme: A_log = log(linspace(1,
    16, nh)), D = 1, dt_bias = 0 (all f32), conv_b = 0, conv_w ~ 0.5 *
    N(0, 1); None for the leaves the generic scheme makes (projections
    ~ 0.02 * N(0, 1), the norm scale 1)."""
    nh = shape[-1]
    f32 = dict(dtype=torch.float32, device=device)
    if key == "A_log":
        return torch.log(torch.linspace(1.0, 16.0, nh, **f32)).expand(
            shape).clone()
    if key == "D":
        return torch.ones(shape, **f32)
    if key == "dt_bias":
        return torch.zeros(shape, **f32)
    if key == "conv_b":
        return torch.zeros(shape, dtype=cfg.p_dtype, device=device)
    if key == "conv_w":
        return (0.5 * torch.randn(shape, generator=gen, **f32)).to(
            cfg.p_dtype)
    return None


def make_ssm_cache(batch: int, cfg: ModelConfig, dtype, device):
    """Decode/extend cache of one mixer. ``step`` is the per-row depth;
    the ``*_ckpt`` leaves hold the state as it was before the most
    recent advance (the restore point of a rollback)."""
    s, d_in, nh, conv_dim = _dims(cfg)
    conv = torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype,
                       device=device)
    ssm = torch.zeros((batch, nh, s.head_dim, s.d_state),
                      dtype=torch.float32, device=device)
    step = torch.zeros((batch,), dtype=torch.int32, device=device)
    return {"conv": conv, "ssm": ssm, "step": step,
            "conv_ckpt": conv.clone(), "ssm_ckpt": ssm.clone(),
            "step_ckpt": step.clone()}


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: (B, L, Cc), w: (Cc, K); the sum in the
    JAX package's order."""
    K, L = w.shape[1], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:L] * w[:, 0]
    for i in range(1, K):
        out = out + xp[:, i:i + L] * w[:, i]
    return out + b


def _split_proj(zxbcdt, cfg: ModelConfig):
    s, d_in, nh, conv_dim = _dims(cfg)
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:d_in + conv_dim],
            zxbcdt[..., d_in + conv_dim:])


def _split_xbc(xBC, cfg: ModelConfig):
    s, d_in, nh, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    return xBC[..., :d_in], xBC[..., d_in:d_in + gn], xBC[..., d_in + gn:]


def _heads(xBC, cfg: ModelConfig, lead):
    """x (..., nh, p), B and C (..., g, n) views of a conv output."""
    s, d_in, nh, _ = _dims(cfg)
    x, Bc, Cc = _split_xbc(xBC, cfg)
    return (x.reshape(lead + (nh, s.head_dim)),
            Bc.reshape(lead + (s.n_groups, s.d_state)),
            Cc.reshape(lead + (s.n_groups, s.d_state)))


def _advance_conv(cache, tail, lens):
    """Checkpoint then advance the conv tail and the depth, in place."""
    cache["conv_ckpt"].copy_(cache["conv"])
    cache["conv"].copy_(tail)
    cache["step_ckpt"].copy_(cache["step"])
    cache["step"].add_(lens)


def ssm_block(p, u, cfg: ModelConfig, *, cache=None, return_cache=False,
              length=None, mode=None):
    """u: (B, L, d). Returns (y (B, L, d), cache).

    * ``cache=None``: the cache-free forward (chunked SSD); with
      ``return_cache=True`` also a new decode cache. ``length``: optional
      (B,) int32 valid counts of right-padded rows (padded positions get
      dt = 0; the conv tail comes from the last valid inputs).
    * ``cache`` and ``mode="extend"``: row b advances by ``length[b] <=
      L`` tokens (None = all L) through the sequential recurrence;
      masked positions are identity steps (dt = 0) and the new conv tail
      is gathered from the last valid inputs, so a length-0 row's cache
      is bit-untouched apart from its checkpoints.
    * ``cache`` otherwise: one decode step (L == 1).

    The cached modes write into ``cache`` and return it."""
    s, d_in, nh, conv_dim = _dims(cfg)
    Bsz, L, _ = u.shape
    K = s.d_conv
    z, xBC, dt = _split_proj(linear(p["in_proj"], u), cfg)
    dt = F.softplus(dt.float() + p["dt_bias"])
    if length is not None:
        valid = torch.arange(L, device=u.device)[None, :] < length[:, None]
        dt = dt * valid[..., None]
    A = -torch.exp(p["A_log"])

    if cache is None:
        xc = F.silu(_causal_conv(xBC, p["conv_w"], p["conv_b"]))
        xh, Bg, Cg = _heads(xc, cfg, (Bsz, L))
        # pad to a chunk multiple; dt = 0 on padding -> decay 1, zero
        # input, so outputs and the final state are unaffected
        chunk = min(s.chunk, max(16, 1 << (L - 1).bit_length()))
        pad = (-L) % chunk
        if pad:
            xh, Bg, Cg, dt = (F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
                              for a in (xh, Bg, Cg, dt))
        y, final = ssd_ops.ssd(xh, dt, A, Bg, Cg, p["D"], chunk=chunk)
        y = y[:, :L].reshape(Bsz, L, d_in)
        new_cache = None
        if return_cache:
            if length is not None:
                # the last K-1 valid inputs per row; indices before the
                # start of the sequence read as zeros
                idx = length[:, None].long() - (K - 1) + torch.arange(
                    K - 1, device=u.device)[None, :]
                g = torch.gather(xBC, 1, idx.clamp(0, L - 1)[..., None]
                                 .expand(-1, -1, conv_dim))
                tail = torch.where((idx >= 0)[..., None], g,
                                   torch.zeros_like(g))
            else:
                tail = F.pad(xBC[:, max(0, L - (K - 1)):],
                             (0, 0, max(0, K - 1 - L), 0))
            lens = length.to(torch.int32) if length is not None else \
                torch.full((Bsz,), L, dtype=torch.int32, device=u.device)
            tail = tail.to(u.dtype)
            # a fresh stream: the checkpoint is the state itself
            new_cache = {"conv": tail, "ssm": final, "step": lens,
                         "conv_ckpt": tail.clone(),
                         "ssm_ckpt": final.clone(), "step_ckpt": lens.clone()}
    elif mode == "extend":
        # the conv stream is [cached tail | new inputs]; token t's window
        # is conv_in[t : t+K], and the new tail (last K-1 valid inputs)
        # is conv_in[length : length+K-1]: for length 0, the old tail
        conv_in = torch.cat([cache["conv"], xBC.to(cache["conv"].dtype)],
                            dim=1)
        wc = p["conv_w"].float()
        conv_out = conv_in[:, 0:L].float() * wc[:, 0]
        for i in range(1, K):
            conv_out = conv_out + conv_in[:, i:i + L].float() * wc[:, i]
        xc = F.silu(conv_out + p["conv_b"].float())
        xh, Bg, Cg = _heads(xc, cfg, (Bsz, L))
        y, _ = ssd_ops.ssd_extend(cache["ssm"], xh, dt, A, Bg, Cg, p["D"],
                                  out=cache["ssm"], ckpt=cache["ssm_ckpt"])
        y = y.reshape(Bsz, L, d_in)
        lens = length.to(torch.int32) if length is not None else \
            torch.full((Bsz,), L, dtype=torch.int32, device=u.device)
        tidx = lens[:, None].long() + torch.arange(K - 1,
                                                   device=u.device)[None]
        tail = torch.gather(conv_in, 1,
                            tidx[..., None].expand(-1, -1, conv_dim))
        _advance_conv(cache, tail, lens)
        new_cache = cache
    else:
        # single-token recurrence (L == 1)
        conv_full = torch.cat([cache["conv"],
                               xBC.to(cache["conv"].dtype)], dim=1)
        conv_out = torch.einsum("bkc,ck->bc", conv_full.float(),
                                p["conv_w"].float()) + p["conv_b"].float()
        xh, Bg, Cg = _heads(F.silu(conv_out), cfg, (Bsz,))
        y1, _ = ssd_ops.ssd_step(cache["ssm"], xh, dt[:, 0], A, Bg, Cg,
                                 p["D"], out=cache["ssm"],
                                 ckpt=cache["ssm_ckpt"])
        y = y1.reshape(Bsz, 1, d_in)
        _advance_conv(cache, conv_full[:, 1:], 1)
        new_cache = cache

    # gated RMSNorm (Mamba-2): norm(y * silu(z)) in u's dtype (z's), one
    # op that casts the f32 SSD output itself
    y = gated_rmsnorm(y, z, p["norm"]["scale"], eps=cfg.norm_eps)
    return linear(p["out_proj"], y), new_cache
