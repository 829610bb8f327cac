"""repro_torch.engine — sort plans and key–value sorts.

planner : SortPlan, plan_from_strategy, default_plan, run_plan ('shared',
          'distributed_merge', 'cluster')
kv      : sort_kv / argsort / sort_pairs / topk (impl='kernel' runs the CUDA
          kernels' stable (key, rank) network; mesh= runs model D with the
          records as payload), cluster_sort_kv

The Planner with autotune and the plan cache, the compiled cache, the
services and the frontend are later slices (ROADMAP Queue 1).
"""
from .kv import argsort, cluster_sort_kv, sort_kv, sort_pairs, topk
from .planner import SortPlan, default_plan, plan_from_strategy, run_plan

__all__ = [
    "argsort",
    "cluster_sort_kv",
    "sort_kv",
    "sort_pairs",
    "topk",
    "SortPlan",
    "default_plan",
    "plan_from_strategy",
    "run_plan",
]
