"""Between-step MoE capacity control (torch): the training half of the adaptive loop.

Counterpart of ``repro/train/adaptive.py``.  Serving learns expert capacity
inside the call (``moe_apply_adaptive`` retries with doubled capacity); a
train step cannot retry (recomputing the batch would change the optimizer
state), so training closes the same loop *between* steps:

1. before a step, ``MoECapacityController.capacity`` converts the planner's
   learned factor for this (n_experts, top_k, token bucket, dtype,
   fingerprint) cell into a per-(sender, expert) capacity
   (``train_step(moe_capacity=...)``);
2. the step threads ``moe_dropped`` / ``moe_peak`` out of the stack
   (``repro_torch.train.steps``);
3. after the step, ``observe`` folds them into the planner as an
   ``ExchangeObservation``, the telemetry schema serving reports, so the
   learned factor jumps above the observed peak and the next step runs at
   the provisioned capacity.

Factors persist through the planner's locked plan cache, so capacity
learned in training warms serving and vice versa.  The reference builds one
executable per capacity; the port builds none, so a capacity change
recompiles nothing.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.bitonic import next_pow2
from repro_torch.exchange import ExchangeObservation, expert_capacity
from repro_torch.models.moe import MoEConfig, moe_plan_key

__all__ = ["MoECapacityController", "parse_mesh_spec"]


class MoECapacityController:
    """Host-side capacity policy for one (model, token shape, group) cell.

    ``tokens`` is the global token count one forward pass dispatches (one
    microbatch: ``batch * seq / n_microbatch``); every rank of ``ctx.mesh``
    is a sender of an equal slice (every mesh axis shards the token
    flatten; ``ctx.mesh is None``: the single-sender path on one device).
    All learning lives in the planner's
    ``CapacityLearner``, all persistence in the plan cache; this class only
    converts between the step's capacity and the planner's factor.
    """

    def __init__(self, cfg: MoEConfig, tokens: int, *, ctx, planner,
                 dtype=torch.float32, device=None):
        self.cfg = cfg
        self.tokens = int(tokens)
        self.planner = planner
        mesh = ctx.mesh
        n_dev = 1 if mesh is None else math.prod(mesh.shape[a] for a in ctx.axes)
        if self.tokens % n_dev:
            raise ValueError(f"tokens {self.tokens} must divide the {n_dev}-rank mesh")
        self.t_loc = self.tokens // n_dev       # per-sender token slice
        self.m = self.t_loc * cfg.top_k         # per-sender assignments
        self.key = moe_plan_key(self.tokens, cfg, dtype, mesh, device=device)

    @property
    def factor(self) -> float:
        """The cell's learned capacity factor (the config's until telemetry
        taught the planner otherwise)."""
        return self.planner.capacity_factor_for(self.key, default=self.cfg.capacity_factor)

    @property
    def capacity(self) -> int:
        """Per-(sender, expert) token capacity for the next step.

        The factor's capacity is bucketed to the next power of two and
        clamped to ``m``, the per-sender assignment count (beyond which
        capacity is loss-free by construction), so a slowly decaying factor
        moves the capacity only when it halves, as in the reference, whose
        driver compiles one step per capacity.
        """
        raw = expert_capacity(self.t_loc, self.cfg.top_k, self.cfg.n_experts, self.factor)
        return min(next_pow2(max(raw, 1)), max(self.m, 1))

    def observe(self, metrics: dict, *, capacity: Optional[int] = None) -> None:
        """Fold one completed step's ``moe_dropped`` / ``moe_peak`` into the
        planner (and its telemetry ledger, which ``AnomalyMonitor`` may
        watch).  ``capacity`` is the value the step ran at (default: the
        current one).  A train step never retries, so every dropped token
        reached the trained-on output: ``dropped`` is real loss, never
        averted.
        """
        cap = int(self.capacity if capacity is None else capacity)
        # peak is maxed over layers and microbatches, dropped summed: the
        # learner reads peak; dropped > 0 only gates the overflow flag
        dropped = int(metrics.get("moe_dropped", 0))
        peak = int(metrics.get("moe_peak", 0))
        obs = ExchangeObservation(
            m=self.m,
            part_buckets=max(self.cfg.n_experts, 1),
            capacity=cap,
            peak=peak,
            overflowed=bool(dropped > 0 or peak > cap),
            retries=0,
            recompiles=0,
            dropped=dropped,
        )
        self.planner.observe_exchange(self.key, obs, default=self.cfg.capacity_factor)


def parse_mesh_spec(spec: str):
    """``"data=2,model=4"`` -> a ``launch.mesh.Mesh`` over the default
    process group (which must be up) plus its axis names, in the spec's
    order (the batch shards over every axis but ``model``, the experts and
    the vocabulary over ``model``, by ``ShardCtx``'s convention).  Raises
    ``ValueError`` on a malformed spec or one whose size is not the world
    size.

    >>> import torch.distributed as dist
    >>> dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    >>> mesh, axes = parse_mesh_spec("data=1,model=1")
    >>> axes, mesh.shape
    (('data', 'model'), {'data': 1, 'model': 1})
    >>> dist.destroy_process_group()
    """
    from repro_torch.launch.mesh import Mesh

    pairs = []
    for part in spec.split(","):
        name, _, size = part.partition("=")
        if not name or not size:
            raise ValueError(f"bad mesh spec {spec!r} (want axis=size,...)")
        pairs.append((name.strip(), int(size)))
    names = tuple(n for n, _ in pairs)
    return Mesh(tuple(s for _, s in pairs), names), names
