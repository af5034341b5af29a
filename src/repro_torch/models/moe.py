"""Mixture-of-experts FFN: the port's copy of the JAX package's
``models/moe.py``, with its parameter tree (``router.w`` (d, E) f32,
the stacked experts ``wi``/``wg`` (E, d, f) and ``wo`` (E, f, d) as bare
arrays, and an optional ``shared`` gated MLP) and its three routes:

* ``_route_dense`` (the cached modes: decode and extend): every expert
  runs on every token and a gate-masked sum combines them, so a token's
  output depends on that token alone. Its shapes are static and it makes
  no host sync, so it runs inside the engine's captured step graphs.
* ``_route_tokens`` (the cache-free forward and prefill): sort-based
  top-k dispatch into (E, C) capacity slots, C from ``_capacity``,
  overflowing assignments dropped, outputs gathered back with their
  gates, and the Switch-style load-balance loss. Its expert counts come
  from the sorted ids by binary search, so it makes no host sync either
  and runs inside the captured train step.
* ``_route_grouped`` (``moe.group_routing``): the same dispatch within
  each batch row, combined by gather.

Where the JAX package's arithmetic could drift on the card it is pinned:
the router product runs in full f32 whatever the process's float32
matmul precision is (a TF32 router can flip a top-k, which changes
which expert runs); top-k ties go to the lowest index, as ``lax.top_k``
(``layers.top_k``, the sampler's rule); the dispatch sort is stable, as
``jnp.argsort``; the experts' products run in the activation dtype and
the gate-weighted combine in f32, then one cast. ``_route_tokens`` adds
no two non-zero values through an index (JAX scatter-adds the slots'
outputs into their tokens, which CUDA runs with atomics in no fixed
order): a slot reads its token's own copy of the row (the tokens
repeated k times) and each assignment reads its slot back by the inverse
of the sort, so the forward and the backward are the same bits run
after run on the card. The expert products
are plain batched matmuls (``torch.bmm`` over the expert axis, so the
stacked weights are read in place), as the JAX package leaves them to
XLA: MoE has no Pallas kernel.

On a serving mesh (``distribution.sharding.use_mesh``) a block routes
over the rank's share of the experts, by the sharding rule: the rank's
``E // mp`` experts when E divides the model axis (expert parallelism),
else the rank's ``d_expert // mp`` hidden units of every expert. The
dense route then computes only those and the gate-weighted partial
sums, with the shared expert's row-parallel partial, are combined by
one ``all_reduce``; the capacity route of expert parallelism is
``models/moe_shard_map.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.distribution.sharding import current_mesh
from repro_torch.models.layers import mlp, mlp_partial, top_k


def _capacity(n_tokens: int, m: MoEConfig) -> int:
    """Slots an expert holds: ``n_tokens * top_k * capacity_factor / E``,
    at least 8 and rounded up to a multiple of 8, as in JAX."""
    cap = int(n_tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, ((cap + 7) // 8) * 8)


def _router_logits(x, w):
    """x (..., d) @ w (d, E) in full f32: the float32 matmul precision is
    held at "highest" for the call (no TF32), then restored."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        return x.float() @ w
    finally:
        torch.set_float32_matmul_precision(prev)


def _gates(p, xf, m: MoEConfig):
    """Router probabilities (..., E) and the renormalised top-k gates and
    their expert ids (..., k)."""
    probs = torch.softmax(_router_logits(xf, p["router"]["w"]), dim=-1)
    gate_vals, gate_idx = top_k(probs, m.top_k)
    return probs, gate_vals / gate_vals.sum(-1, keepdim=True), gate_idx


def _experts(p, xe, act_dtype):
    """The SwiGLU experts on per-expert rows xe (E, R, d) -> (E, R, d) in
    ``act_dtype``: ``h`` and the output in that dtype, as the JAX
    einsums round them."""
    xe = xe.to(act_dtype)
    h = F.silu(torch.bmm(xe, p["wg"])) * torch.bmm(xe, p["wi"])
    return torch.bmm(h, p["wo"])


def moe_block(p, x, cfg: ModelConfig, *, dense=False):
    """x: (B, L, d) -> (y, aux_loss). ``dense=True`` (the cached serving
    modes) routes capacity-free per token (``_route_dense``), so chunk
    padding and co-scheduled rows cannot change a token's experts;
    otherwise sort-based capacity dispatch over the whole token stream
    (``_route_tokens``), or within each row under ``group_routing``.
    The shared expert, when there is one, is added to every token."""
    m = cfg.moe
    B, L, d = x.shape
    mesh = current_mesh()
    if mesh is not None:
        return _moe_on_mesh(p, x, cfg, mesh, dense)
    if dense:
        y, aux = _route_dense(p, x.reshape(B * L, d), cfg)
        y = y.reshape(B, L, d)
    elif m.group_routing and L > 1:
        y, aux = _route_grouped(p, x, cfg)
    else:
        y, aux = _route_tokens(p, x.reshape(B * L, d), cfg)
        y = y.reshape(B, L, d)
    if m.n_shared:
        y = y + mlp(p["shared"], x).to(x.dtype)
    return y, aux


def _route_dense(p, xf, cfg: ModelConfig):
    """Capacity-free top-k routing: every expert on every token, combined
    by a gate-masked sum. xf: (T, d) -> (T, d), and a zero aux loss
    (serving never trains)."""
    return _dense_sum(p, xf, cfg).to(xf.dtype), torch.zeros(
        (), dtype=torch.float32, device=xf.device)


def _dense_sum(p, xf, cfg: ModelConfig, lo: int = 0):
    """The dense route's gate-weighted sum in f32 over the experts ``p``
    holds (``p["wi"].shape[0]`` of them, the first one expert ``lo``)."""
    m = cfg.moe
    T, d = xf.shape
    n = p["wi"].shape[0]
    _, gate_vals, gate_idx = _gates(p, xf, m)
    gates = torch.zeros((T, m.n_experts), dtype=torch.float32,
                        device=xf.device).scatter(1, gate_idx, gate_vals)
    ye = _experts(p, xf.unsqueeze(0).expand(n, T, d),
                  cfg.act_dtype)                                # (n, T, d)
    return (ye.float() * gates[:, lo:lo + n].t().unsqueeze(-1)).sum(0)


def _local_experts(m: MoEConfig, mp: int, r: int):
    """Where the rank's share of the routed experts lies, by the sharding
    rule: (the first local expert's index, whether the outputs are
    partial). Experts on the model axis when E divides it, else d_expert
    on it, else every expert whole."""
    if m.n_experts % mp == 0:
        return r * (m.n_experts // mp), True
    return 0, m.d_expert % mp == 0


def _moe_on_mesh(p, x, cfg: ModelConfig, mesh, dense: bool):
    """``moe_block`` on a mesh: the rank's experts (``_local_experts``);
    the routed partial sums and the shared expert's partial combined by
    one ``all_reduce`` over the model group. The capacity route with the
    experts on the model axis is ``moe_block_shard_map``."""
    m = cfg.moe
    mp, r = mesh.axis_size("model"), mesh.axis_index("model")
    B, L, d = x.shape
    if not dense and m.n_experts % mp == 0:
        from repro_torch.models.moe_shard_map import moe_block_shard_map
        return moe_block_shard_map(p, x, cfg, mesh)
    lo, partial = _local_experts(m, mp, r)
    if dense:
        y = _dense_sum(p, x.reshape(B * L, d), cfg, lo).reshape(B, L, d)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    elif m.group_routing and L > 1:
        y, aux = _route_grouped(p, x, cfg)
    else:
        y, aux = _route_tokens(p, x.reshape(B * L, d), cfg)
        y = y.reshape(B, L, d)
    d_shared = m.d_shared or m.n_shared * m.d_expert
    if m.n_shared and partial:
        # one reduction for both: a row-parallel shared expert's partial
        # joins the routed sum (its bias-free wo, as every MoE's)
        sh, sh_partial = mlp_partial(p["shared"], x, d_shared)
        y = y.float() + sh.float() if sh_partial else y
        shared = None if sh_partial else sh
    else:
        shared = mlp(p["shared"], x, d_shared) if m.n_shared else None
    if partial:
        y = mesh.all_reduce(y.float())
    y = y.to(x.dtype)
    return (y if shared is None else y + shared.to(x.dtype)), aux


def _sorted_counts(expert_sorted, E: int):
    """(counts, offsets) (E,) of the ascending expert ids
    ``expert_sorted``: each expert's assignments and where its run
    starts, by binary search (``torch.bincount`` reads the ids' range
    back to the host, a device sync each call; this makes none)."""
    bounds = torch.searchsorted(
        expert_sorted, torch.arange(E + 1, device=expert_sorted.device))
    return bounds[1:] - bounds[:-1], bounds[:-1]


def _route_tokens(p, xf, cfg: ModelConfig):
    """Top-k dispatch over a flat token group xf: (T, d) -> (T, d) and the
    load-balance loss. Assignments are sorted by expert (stable), each
    expert takes the first C of its own in (E, C) slots, and the rest are
    dropped. A slot reads its assignment's copy of the token (xf's rows
    repeated k times, so each copy's gradient has one slot to come from
    and the k copies sum in order); each assignment gathers its slot's
    output through the inverse of the sort, weighted by its gate in f32,
    and a token sums its k in order, then one cast."""
    m = cfg.moe
    T, d = xf.shape
    E, k = m.n_experts, m.top_k
    dev = xf.device
    probs, gate_vals, gate_idx = _gates(p, xf, m)

    # load-balance auxiliary loss (Switch-style)
    me = probs.mean(0)
    assign_frac = torch.zeros((E,), dtype=torch.float32, device=dev) \
        .index_add_(0, gate_idx.reshape(-1),
                    torch.full((T * k,), 1.0 / (T * k), device=dev))
    aux = m.aux_loss_weight * E * torch.sum(assign_frac * me)

    # sort assignments by expert
    A = T * k
    expert_of = gate_idx.reshape(A)
    gate_of = gate_vals.reshape(A)
    order = torch.argsort(expert_of, stable=True)
    expert_sorted = expert_of[order]
    counts, offsets = _sorted_counts(expert_sorted, E)

    C = _capacity(T, m)
    slot = torch.arange(C, device=dev)
    slot_idx = (offsets[:, None] + slot[None]).clamp(0, A - 1)   # (E, C)
    a_idx = order[slot_idx]
    # a slot is valid only if its assignment really belongs here
    slot_valid = (slot[None] < counts[:, None]) \
        & (expert_sorted[slot_idx] == torch.arange(E, device=dev)[:, None])
    xa = xf[:, None].expand(T, k, d).reshape(A, d)                # (A, d)
    xe = torch.where(slot_valid[..., None], xa[a_idx], 0)         # (E, C, d)
    ye = _experts(p, xe, cfg.act_dtype).reshape(E * C, d)

    # combine by gather: assignment a sits at slot inv[a] - offsets[e]
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(A, device=dev))
    c_of = inv - offsets[expert_of]
    flat = (expert_of * C + c_of).clamp(max=E * C - 1)
    contrib = torch.where((c_of < C)[:, None], ye[flat], 0).float() \
        * gate_of[:, None]
    y = contrib.reshape(T, k, d).sum(1)
    return y.to(xf.dtype), aux


def _route_grouped(p, x, cfg: ModelConfig):
    """Grouped dispatch, one group per batch row: x (G, T, d) -> (G, T,
    d) and the load-balance loss. Each row sorts its own assignments,
    fills its own (E, C) slots and gathers its outputs back."""
    m = cfg.moe
    G, T, d = x.shape
    E, k = m.n_experts, m.top_k
    dev = x.device
    probs, gate_vals, gate_idx = _gates(p, x, m)                 # (G, T, .)

    me = probs.mean((0, 1))
    counts_all = F.one_hot(gate_idx, E).float().sum((0, 1, 2))
    aux = m.aux_loss_weight * E * torch.sum(counts_all / (G * T * k) * me)

    A = T * k
    expert_of = gate_idx.reshape(G, A)
    gate_of = gate_vals.reshape(G, A)
    order = torch.argsort(expert_of, dim=-1, stable=True)        # (G, A)
    expert_sorted = torch.take_along_dim(expert_of, order, dim=-1)
    # per-group expert counts by binary search on the sorted ids
    bounds = torch.searchsorted(
        expert_sorted, torch.arange(E + 1, device=dev).expand(G, E + 1)
        .contiguous())
    counts = bounds[:, 1:] - bounds[:, :-1]                       # (G, E)
    offsets = bounds[:, :-1]

    C = _capacity(T, m)
    slot = torch.arange(C, device=dev)
    slot_valid = slot[None, None] < counts[:, :, None]            # (G, E, C)
    slot_idx = (offsets[:, :, None] + slot[None, None]).clamp(0, A - 1)
    a_idx = torch.take_along_dim(order, slot_idx.reshape(G, -1),
                                 dim=-1).reshape(G, E, C)
    tok_idx = a_idx // k
    xe = torch.take_along_dim(x, tok_idx.reshape(G, E * C, 1), dim=1) \
        .reshape(G, E, C, d)
    xe = torch.where(slot_valid[..., None], xe, 0)
    # the experts over every group's slots at once: (E, G * C, d)
    ye = _experts(p, xe.transpose(0, 1).reshape(E, G * C, d),
                  cfg.act_dtype).reshape(E, G, C, d).transpose(0, 1)

    # combine by gather: each assignment's (e, c) slot from the inverse
    # of the sort, its output weighted by its gate, summed over k
    inv = torch.argsort(order, dim=-1)
    c_of = inv - torch.take_along_dim(offsets, expert_of, dim=-1)
    flat = (expert_of * C + c_of).clamp(0, E * C - 1)             # (G, A)
    contrib = torch.take_along_dim(ye.reshape(G, E * C, d), flat[..., None],
                                   dim=1)                         # (G, A, d)
    contrib = torch.where((c_of < C)[..., None], contrib, 0).float()
    contrib = contrib * gate_of[..., None]
    y = contrib.reshape(G, T, k, d).sum(2)
    return y.to(x.dtype), aux
