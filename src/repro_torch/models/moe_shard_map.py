"""Explicit expert-parallel MoE: the port of the JAX package's
``models/moe_shard_map.py``, with the serving mesh in place of
``shard_map``.

* experts are sharded over the ``model`` axis (E_local a rank);
* tokens are data-sharded and replicated across ``model`` (the standard
  activation layout), so every rank of a model group routes the same
  tokens, computes only its local experts' contributions, and a single
  ``all_reduce`` over ``model`` combines them: one collective a MoE
  layer, the least this layout allows;
* the load-balance loss is taken from exact global quantities: the
  expert counts summed over ``model`` and ``data``, the router
  probabilities averaged over ``data``.

The same router and the same capacity rule as ``moe.moe_block`` a local
expert (``_capacity`` of the rank's tokens), as in JAX. The slot outputs
are summed into their tokens by ``index_add_``, JAX's scatter-add: on
the card its order is not fixed, so this route, which no serving step
runs (the engine's MoE steps take the dense route), is held to a
tolerance, not to bits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import mlp, top_k
from repro_torch.models.moe import _capacity, _router_logits


def _local_expert_pass(router_w, wi, wg, wo, x, *, cfg: ModelConfig, mesh,
                       axis: str, n_shards: int, data_axes=("data",)):
    """One rank's body. x: (B_loc, L, d), the same tokens on every rank
    of the model group; wi/wg/wo: (E_loc, ...), this rank's experts."""
    m = cfg.moe
    E, k = m.n_experts, m.top_k
    E_loc = E // n_shards
    lo = mesh.axis_index(axis) * E_loc
    dev = x.device

    B, L, d = x.shape
    T = B * L
    xf = x.reshape(T, d)

    probs = torch.softmax(_router_logits(xf, router_w), dim=-1)  # (T, E)
    gate_vals, gate_idx = top_k(probs, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    # keep only the assignments to this rank's experts; the others get
    # the sentinel id E_loc, sort to the end and claim no capacity
    A = T * k
    eid = gate_idx.reshape(A) - lo
    mine = (eid >= 0) & (eid < E_loc)
    eid_sort = torch.where(mine, eid, torch.full_like(eid, E_loc))
    gate_of = torch.where(mine, gate_vals.reshape(A), 0.0)
    token_of = torch.arange(A, device=dev) // k

    order = torch.argsort(eid_sort, stable=True)
    eid_sorted = eid_sort[order]
    bounds = torch.searchsorted(eid_sorted,
                                torch.arange(E_loc + 1, device=dev))
    counts = bounds[1:] - bounds[:-1]                          # (E_loc,)
    offsets = bounds[:-1]

    C = _capacity(T, m)
    slot = torch.arange(C, device=dev)
    slot_idx = (offsets[:, None] + slot[None, :]).clamp(0, A - 1)
    slot_valid = slot[None, :] < counts[:, None]              # (E_loc, C)
    a_idx = order[slot_idx]
    tok_idx = token_of[a_idx]
    gates = torch.where(slot_valid, gate_of[a_idx], 0.0)

    xe = torch.where(slot_valid[..., None], xf[tok_idx], 0).to(cfg.act_dtype)
    h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wi)
    ye = torch.bmm(h, wo).float() * gates[..., None]

    y_partial = torch.zeros((T, d), dtype=torch.float32, device=dev) \
        .index_add_(0, tok_idx.reshape(-1), ye.reshape(-1, d))

    # load-balance aux from exact global quantities: counts summed over
    # the expert (model) and token (data) axes, router-prob mean over data
    me = probs.mean(0)
    for ax in data_axes:
        me = mesh.all_reduce(me, ax) / mesh.axis_size(ax)
    local_counts = torch.zeros((E,), dtype=torch.float32, device=dev) \
        .index_add_(0, torch.where(mine, eid + lo, 0),
                    mine.to(torch.float32))
    counts_all = mesh.all_reduce(local_counts, axis)
    n_data = 1
    for ax in data_axes:
        counts_all = mesh.all_reduce(counts_all, ax)
        n_data *= mesh.axis_size(ax)
    aux = m.aux_loss_weight * E * torch.sum(
        counts_all / (T * n_data * k) * me)

    # one collective combines the experts' contributions
    y = mesh.all_reduce(y_partial, axis)
    return y.reshape(B, L, d).to(x.dtype), aux


def moe_block_shard_map(p, x, cfg: ModelConfig, mesh, *,
                        axis: str = "model", data_axes=("data",)):
    """Drop-in for ``moe.moe_block`` on a mesh: x is the rank's tokens
    (batch on ``data_axes``), ``p`` the rank's block of the params as
    ``sharding.shard_tree`` cuts them (its ``E // mp`` experts; where
    JAX's ``shard_map`` takes the whole tree and slices it)."""
    m = cfg.moe
    n_shards = mesh.axis_size(axis)
    assert m.n_experts % n_shards == 0, (m.n_experts, n_shards)
    y, aux = _local_expert_pass(
        p["router"]["w"].float(), p["wi"], p["wg"], p["wo"], x, cfg=cfg,
        mesh=mesh, axis=axis, n_shards=n_shards, data_axes=tuple(data_axes))
    if m.n_shared:
        y = y + mlp(p["shared"], x,
                    m.d_shared or m.n_shared * m.d_expert).to(x.dtype)
    return y, aux
