"""Mixture-of-Experts layer with sort-based dispatch (torch).

Counterpart of ``repro/models/moe.py``.  Token routing is the paper's model
D: the expert id is the key's most significant digit, expert-parallel ranks
are the cluster nodes, and dispatch is one ``all_to_all`` each way
(``repro_torch.exchange``) with no merging between ranks.  The stable
grouping sort inside ``partition_exchange`` keeps arrival order per expert.

Each function that takes a ``group`` (an ``AxisGroup``) runs on every rank
of it, on that rank's tokens, as the reference's runs inside ``shard_map``;
``moe_shard_specs`` slices the full params to a rank's experts, the job the
reference's ``shard_map`` in_specs do.  The top-k of the router is the
engine's stable ``topk(impl='xla')``: ties go to the lowest index, as
``lax.top_k``'s do, which ``collapse_router`` relies on.

``moe_apply_adaptive`` and ``moe_apply_local_adaptive`` close the
capacity-learning loop through the planner: the expert capacity factor is
learned per (n_experts, top_k, token bucket, dtype, fingerprint) cell, and
an overflow is retried at double capacity.  The port builds no executable
per capacity, so a retry recompiles nothing.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.carry import check_device
from repro_torch.core.bitonic import next_pow2
from repro_torch.engine.kv import topk
from repro_torch.engine.planner import default_planner, dtype_name, mesh_fingerprint
from repro_torch.exchange import (
    AxisGroup,
    combine_exchange,
    expert_capacity,
    partition_exchange,
    run_with_capacity_retries,
)
from repro_torch.exchange.group import reduce_from

from .layers import Params, gelu, linear_init, normal

__all__ = [
    "DEFAULT_CAPACITY_FACTOR",
    "MoEConfig",
    "moe_init",
    "router_probs",
    "collapse_router",
    "moe_apply_local",
    "moe_apply_ep_replicated",
    "moe_plan_key",
    "moe_apply_adaptive",
    "moe_apply_local_adaptive",
    "moe_shard_specs",
]

DEFAULT_CAPACITY_FACTOR = 2.0


class MoEConfig(NamedTuple):
    d_model: int
    d_ff: int                 # per-expert hidden dim
    n_experts: int
    top_k: int
    capacity_factor: float = DEFAULT_CAPACITY_FACTOR
    mlp_gated: bool = True
    compress_dispatch: bool = False   # int8 all_to_all payloads


def moe_init(gen, cfg: MoEConfig, dtype, *, ep_shards: int, device="cuda") -> Params:
    """Expert weights stacked (E_pad, ...); E padded to a multiple of
    ``ep_shards`` with dummy experts the router never selects."""
    device = check_device(device)
    e_pad = math.ceil(cfg.n_experts / ep_shards) * ep_shards
    s_in = cfg.d_model ** -0.5
    s_out = cfg.d_ff ** -0.5
    p = {
        "router": linear_init(gen, cfg.d_model, e_pad, torch.float32, device=device),
        "w_in": (normal(gen, (e_pad, cfg.d_model, cfg.d_ff), device) * s_in).to(dtype),
        "w_out": (normal(gen, (e_pad, cfg.d_ff, cfg.d_model), device) * s_out).to(dtype),
    }
    if cfg.mlp_gated:
        p["w_gate"] = (normal(gen, (e_pad, cfg.d_model, cfg.d_ff), device) * s_in).to(dtype)
    return p


def router_probs(p: Params, cfg: MoEConfig, x: torch.Tensor):
    """x (T, D) -> (probs (T, E_pad), top_idx (T, k) int32, top_gate (T, k), aux_loss)."""
    e_pad = p["router"]["w"].shape[-1]
    logits = x.float() @ p["router"]["w"].float()
    if e_pad != cfg.n_experts:  # mask the dummy padding experts
        pad = torch.arange(e_pad, device=x.device) >= cfg.n_experts
        logits = torch.where(pad, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    top_gate, top_idx = topk(probs, cfg.top_k, impl="xla")
    top_gate = top_gate / torch.clamp(top_gate.sum(-1, keepdim=True), min=1e-9)
    # Switch-style aux loss: E * sum_e f_e * P_e (f = token fraction, P = prob mass)
    f = torch.zeros((e_pad,), dtype=torch.float32, device=x.device)
    f = f.index_add(0, top_idx.reshape(-1).long(), torch.ones(top_idx.numel(), device=x.device))
    f = f / torch.clamp(f.sum(), min=1.0)
    # sum / max(T, 1), not mean: an empty token slice must not make the loss NaN
    p_mass = probs.sum(dim=0) / max(x.shape[0], 1)
    aux = cfg.n_experts * torch.sum(f * p_mass)
    return probs, top_idx, top_gate, aux


def collapse_router(p: Params, logit_scale: float = 10.0) -> Params:
    """A copy of ``p`` whose router sends every token to a few low-index
    experts: expert 0 gets logit ``logit_scale * sum(x)``, every other real
    expert exactly 0, so the remaining top-k slots tie and drain to the
    lowest indices.  The worst-case skew the capacity loop is tested on."""
    w = p["router"]["w"]
    collapsed = torch.zeros_like(w)
    collapsed[..., 0] = logit_scale  # expert axis last: (D, E) or (groups, D, E)
    return {**p, "router": {"w": collapsed}}


def _expert_ffn(p: Params, recv: torch.Tensor) -> torch.Tensor:
    """(E_loc, t, D) token slabs through their experts' FFNs."""
    h = torch.einsum("etd,edf->etf", recv, p["w_in"].to(recv.dtype))
    if "w_gate" in p:
        g = torch.einsum("etd,edf->etf", recv, p["w_gate"].to(recv.dtype))
        h = F.silu(g) * h
    else:
        h = gelu(h)
    return torch.einsum("etf,efd->etd", h, p["w_out"].to(recv.dtype))


def _combine_gates(back: torch.Tensor, top_gate: torch.Tensor, T: int, k: int) -> torch.Tensor:
    """Gate-weighted sum over the k replicas of each token, in float32."""
    return torch.einsum("tkd,tk->td", back.reshape(T, k, -1).float(), top_gate)


def moe_apply_local(
    p: Params,
    cfg: MoEConfig,
    x: torch.Tensor,
    group: AxisGroup,
    all_group: Optional[AxisGroup] = None,
    *,
    capacity: Optional[int] = None,
    with_stats: bool = False,
):
    """Expert-parallel MoE forward on one rank of ``group``.

    ``x``: (T_loc, D), this rank's tokens; ``p``: this rank's experts
    (``moe_shard_specs``), router replicated.  Returns ``(y (T_loc, D), aux,
    overflow)``, ``aux`` averaged and ``overflow`` maxed over ``all_group``,
    the whole mesh (the reference's ``all_axes``; ``group`` when None).
    Each rank's ``aux`` gradient is its own share.  ``with_stats=True``
    returns ``(y, aux, dropped, counts, peak, overflow)``: group-global
    per-expert ``counts``, the largest per-(sender, expert) count ``peak``
    and the group total of dropped tokens.
    """
    T, D = x.shape
    ep = group.size
    e_loc = p["w_in"].shape[0]
    e_pad = e_loc * ep

    probs, top_idx, top_gate, aux = router_probs(p, cfg, x)

    # dispatch = model D: one MSD-radix all_to_all, expert id as the digit
    keys = top_idx.reshape(-1).to(torch.int32)             # (T*k,) expert ids
    vals = torch.repeat_interleave(x, cfg.top_k, dim=0)    # (T*k, D)
    cap = capacity if capacity is not None else expert_capacity(
        T, cfg.top_k, cfg.n_experts, cfg.capacity_factor
    )
    ex = partition_exchange(keys, vals, keys, group, capacity=cap, n_buckets=e_pad,
                            compress=cfg.compress_dispatch)
    # recv: (ep, e_loc*cap, D) -> (e_loc, ep*cap, D), grouped per local expert
    recv = ex.recv_values.reshape(ep, e_loc, cap, D).permute(1, 0, 2, 3).reshape(e_loc, ep * cap, D)
    rmask = (ex.recv_src_slot.reshape(ep, e_loc, cap) >= 0).permute(1, 0, 2).reshape(e_loc, ep * cap)

    y = _expert_ffn(p, recv)
    y = torch.where(rmask[..., None], y, torch.zeros((), dtype=y.dtype, device=y.device))

    # combine = the inverse exchange, then the gate-weighted sum over k replicas
    y = y.reshape(e_loc, ep, cap, D).permute(1, 0, 2, 3).reshape(ep, e_loc * cap, D)
    back = combine_exchange(y, ex, group)                   # (T*k, D)
    out = _combine_gates(back, top_gate, T, cfg.top_k).to(x.dtype)
    aux, overflow = _over_all(aux, ex.overflow, all_group or group)
    if with_stats:
        counts = group.psum(ex.counts)                      # (e_pad,) global
        dropped = group.psum(torch.clamp(ex.counts - cap, min=0).sum())
        peak = group.pmax(ex.counts.max())
        return out, aux, dropped, counts, peak, overflow
    return out, aux, overflow


def _over_all(aux: torch.Tensor, overflow: torch.Tensor, group: Optional[AxisGroup]):
    """``aux`` averaged over ``group`` (each rank's gradient its own share)
    and ``overflow`` maxed over it."""
    if group is None or group.size == 1:
        return aux, overflow
    aux = reduce_from(group, aux) / group.size
    return aux, group.pmax(overflow.to(torch.int32)).bool()


def moe_apply_ep_replicated(
    p: Params,
    cfg: MoEConfig,
    x: torch.Tensor,
    group: Optional[AxisGroup] = None,
    all_group: Optional[AxisGroup] = None,
    *,
    capacity: Optional[int] = None,
    with_stats: bool = False,
):
    """MoE forward with the tokens replicated over the EP ``group`` (the
    decode path; one device when ``group`` is None).

    Every rank routes the same tokens but runs only its own experts
    (``p`` holds them, ``moe_shard_specs``); the outputs are summed over
    the group.  No all_to_all: for small decode batches the repeated
    routing is cheaper than the exchange.  ``aux`` is averaged and
    ``overflow`` maxed over ``all_group`` (the whole mesh).

    ``capacity`` and ``with_stats`` follow ``moe_apply_local``:
    ``with_stats=True`` returns ``(y, aux, dropped, counts, peak,
    overflow)``.  torch has no scatter that drops out-of-range indices, so
    the slab has one spare slot that every dropped token, and every token
    bound for another rank's experts, writes to, cut off after.
    """
    T, D = x.shape
    e_loc = p["w_in"].shape[0]
    my = 0 if group is None else group.rank
    device = x.device

    probs, top_idx, top_gate, aux = router_probs(p, cfg, x)

    keys = top_idx.reshape(-1).to(torch.int32)              # (T*k,) global expert ids
    local = keys - my * e_loc
    bucket = torch.where((local >= 0) & (local < e_loc), local, e_loc)  # e_loc: another rank's
    m = bucket.shape[0]
    cap = capacity if capacity is not None else expert_capacity(
        T, cfg.top_k, cfg.n_experts, cfg.capacity_factor
    )

    order = torch.argsort(bucket, stable=True)
    sorted_b = bucket[order]
    # the bincount read off the sorted ids: its length is static (a traced step has no data)
    starts = torch.searchsorted(sorted_b, torch.arange(e_loc + 2, dtype=sorted_b.dtype,
                                                       device=device)).to(torch.int32)
    counts = starts[1:] - starts[:-1]
    offsets = starts[:-1]
    pos = torch.arange(m, dtype=torch.int32, device=device) - offsets[sorted_b.long()]
    valid = (pos < cap) & (sorted_b < e_loc)
    slot_sorted = torch.where(valid, sorted_b * cap + pos, e_loc * cap).long()

    vals = torch.repeat_interleave(x, cfg.top_k, dim=0)     # (T*k, D)
    slab = torch.zeros((e_loc * cap + 1, D), dtype=x.dtype, device=device)
    slab = slab.index_put((slot_sorted,), vals[order])[: e_loc * cap]
    smask = torch.zeros((e_loc * cap + 1,), dtype=torch.bool, device=device)
    smask = smask.index_put((slot_sorted,), torch.ones((), dtype=torch.bool, device=device))
    smask = smask[: e_loc * cap]
    send_slot = torch.full((m,), -1, dtype=torch.int32, device=device)
    send_slot[order] = torch.where(valid, slot_sorted, -1).to(torch.int32)

    y = _expert_ffn(p, slab.reshape(e_loc, cap, D))
    y = torch.where(smask.reshape(e_loc, cap)[..., None], y,
                    torch.zeros((), dtype=y.dtype, device=device))

    flat = y.reshape(e_loc * cap, D)
    safe = send_slot.clamp(0, flat.shape[0] - 1).long()
    back = torch.where((send_slot >= 0)[:, None], flat[safe],
                       torch.zeros((), dtype=flat.dtype, device=device))
    out = _combine_gates(back, top_gate, T, cfg.top_k)
    counts = counts[:e_loc]
    overflow = counts.max() > cap
    if group is not None and group.size > 1:
        out = reduce_from(group, out)
        overflow = group.pmax(overflow.to(torch.int32)).bool()
    aux, overflow = _over_all(aux, overflow, all_group)
    out = out.to(x.dtype)
    if with_stats:
        dropped = torch.clamp(counts - cap, min=0).sum()
        peak = counts.max()
        if group is not None and group.size > 1:
            counts = group.all_gather(counts).reshape(-1)
            dropped = group.psum(dropped)
            peak = group.pmax(peak)
        return out, aux, dropped, counts, peak, overflow
    return out, aux, overflow


# ------------------------------------------------------- adaptive dispatch ---
def moe_plan_key(tokens: int, cfg: MoEConfig, dtype=torch.float32, mesh=None, *,
                 device=None) -> str:
    """Plan-cache cell for MoE expert-capacity learning: (n_experts, top_k,
    pow2 token bucket, dtype, fingerprint), what ``expert_capacity`` depends
    on.  ``tokens`` is the global count on a mesh.

    >>> moe_plan_key(1000, MoEConfig(16, 8, 4, 2), device="cpu")
    'moe/E4k2|1024|float32|local/cpu'
    """
    return (
        f"moe/E{cfg.n_experts}k{cfg.top_k}|{next_pow2(tokens)}"
        f"|{dtype_name(dtype)}|{mesh_fingerprint(mesh, device=device)}"
    )


def _drop_report(telemetry, attempt_drops: list):
    """Wrap a telemetry callback with served/averted drop accounting.

    The retry driver reports once, after the final attempt.  Routing, and
    so each attempt's drops, is the same across attempts; only the capacity
    moves.  The final attempt's drops reached the served output iff it
    still overflowed (peak > its capacity); every earlier attempt's were
    recomputed away by the retry.
    """
    if telemetry is None:
        return None

    def report(**kwargs):
        served = (
            attempt_drops[-1]
            if attempt_drops and kwargs["peak"] > kwargs["capacity"]
            else 0
        )
        # later attempts re-drop a subset of the first attempt's tokens, so
        # the distinct tokens at risk are the first (largest) attempt's
        averted = max(attempt_drops, default=0) - served
        telemetry(dropped=served, dropped_averted=averted, **kwargs)

    return report


def _adaptive(forward, cfg: MoEConfig, *, tokens: int, key: str, planner, capacity_factor,
              telemetry, max_retries: int, label: str):
    """The capacity-retry loop both adaptive paths share: ``forward(cap)``
    returns ``moe_apply_*``'s stats 6-tuple for the ``tokens`` a sender
    routes."""
    if capacity_factor is None and telemetry is None:
        planner = planner or default_planner()
        capacity_factor = planner.capacity_factor_for(key, default=cfg.capacity_factor)
        telemetry = planner.exchange_recorder(key, default=cfg.capacity_factor)
    elif capacity_factor is None:
        capacity_factor = cfg.capacity_factor
    cap = expert_capacity(tokens, cfg.top_k, cfg.n_experts, capacity_factor)
    attempt_drops = []

    def run_fn(c):
        out, aux, dropped, counts, peak, overflow = forward(c)
        attempt_drops.append(int(dropped))
        return out, aux, counts, peak, overflow

    (y, aux), counts = run_with_capacity_retries(
        run_fn,
        m=tokens * cfg.top_k,
        part_buckets=max(cfg.n_experts, 1),
        cap=cap,
        max_retries=max_retries,
        telemetry=_drop_report(telemetry, attempt_drops),
        label=label,
        strict=False,
    )
    return y, aux, counts


def moe_apply_adaptive(
    p: Params,
    cfg: MoEConfig,
    x: torch.Tensor,
    *,
    planner=None,
    capacity_factor: Optional[float] = None,
    telemetry=None,
    max_retries: int = 4,
):
    """Adaptive single-device MoE forward: learned capacity, retry over drop.

    Runs ``moe_apply_ep_replicated`` at the learned expert capacity factor
    of this (n_experts, top_k, token bucket) cell, retries with doubled
    capacity while the router's skew overflows it (``T * top_k`` is the
    loss-free bound), and reports the call's telemetry (peak, overflow and
    retry events, ``dropped`` = tokens the served output lost,
    ``dropped_averted`` = tokens the retries saved) through ``planner``
    (the default planner when None), which learns and persists the factor.
    When retries run out the last attempt's output is returned with its
    drops (GShard semantics).  An explicit ``capacity_factor=`` or
    ``telemetry=`` opts out of the planner loop.

    Returns ``(y, aux, counts)``.
    """
    T, _ = x.shape
    key = moe_plan_key(T, cfg, x.dtype, device=x.device)
    return _adaptive(
        lambda c: moe_apply_ep_replicated(p, cfg, x, capacity=c, with_stats=True),
        cfg, tokens=T, key=key, planner=planner, capacity_factor=capacity_factor,
        telemetry=telemetry, max_retries=max_retries, label="moe_apply_adaptive",
    )


def moe_apply_local_adaptive(
    p: Params,
    cfg: MoEConfig,
    x: torch.Tensor,
    group: AxisGroup,
    *,
    planner=None,
    capacity_factor: Optional[float] = None,
    telemetry=None,
    max_retries: int = 4,
):
    """Adaptive expert-parallel MoE forward: ``moe_apply_local`` under the
    capacity-retry loop, on every rank of ``group``.

    ``p`` is the full param tree (every rank slices its experts with
    ``moe_shard_specs``); ``x`` is this rank's (T_loc, D) tokens, and the
    plan cell is keyed by the global count ``T_loc * group.size`` and the
    group's fingerprint.  Overflow is maxed over the group, so every rank
    retries in step.  Returns ``(y (T_loc, D), aux, counts)`` with
    group-global per-expert ``counts``.
    """
    T_loc, _ = x.shape
    key = moe_plan_key(T_loc * group.size, cfg, x.dtype, group, device=x.device)
    p_loc = moe_shard_specs(p, group)
    return _adaptive(
        lambda c: moe_apply_local(p_loc, cfg, x, group, capacity=c, with_stats=True),
        cfg, tokens=T_loc, key=key, planner=planner, capacity_factor=capacity_factor,
        telemetry=telemetry, max_retries=max_retries, label="moe_apply_local_adaptive",
    )


def moe_shard_specs(params: Params, group: AxisGroup) -> Params:
    """This rank's share of full MoE params: the router replicated, every
    expert tensor cut to rows ``[rank * E_loc, (rank + 1) * E_loc)`` (the
    reference's in_specs: ``P()`` for the router, ``P(ep_axis)`` otherwise).
    Views, not copies."""
    e_pad = params["w_in"].shape[0]
    if e_pad % group.size:
        raise ValueError(f"{e_pad} experts do not split over {group.size} ranks")
    e_loc = e_pad // group.size
    lo = group.rank * e_loc
    return {name: (t if name == "router" else t[lo: lo + e_loc]) for name, t in params.items()}
