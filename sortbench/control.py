#!/usr/bin/env python3
"""Run a cell with its control in the program's place, and show that the
comparison deciding ``correct`` fails it.

    python3 sortbench/control.py --workload bulk10m.sort_f32 --seeds 1,2,3 --seconds 3

The control is the reference one step below what the configuration
states (``reference.control``: bfloat16 keys for a sort, an unstable
order for the stable argsort), put where the program's answer is made:
the front door of the closed loop, and on a mesh each rank's block (every
rank gathers all shards and keeps its equal share of the control's
answer).  The benchmark's own runs never run this;
``sortbench/tests/test_sortbench_control.py`` runs it at a size a test
holds, and PERF.md gives its readings on the card at the cells' sizes.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from sortbench import harness  # noqa: E402
from sortbench.reference import numpy_sort as ref  # noqa: E402


def control_patches(cell: harness.Cell):
    """The patches that put the control in the program's place (a
    ``run_cell`` hook, so every rank of a mesh applies them)."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch import engine

    driver, op = cell.config["driver"], cell.traffic.get("op", "sort")

    def on_host(x, **kw):
        return torch.from_numpy(np.ascontiguousarray(ref.control(op, x.cpu().numpy()))).to(x.device)

    if driver == "closed_loop" and op == "sort":
        return [mock.patch.object(repro_torch, "sort", on_host)]
    if driver == "closed_loop" and op == "argsort":
        return [mock.patch.object(engine, "argsort", on_host)]
    if driver == "ranks":
        import torch.distributed as dist

        from repro_torch.exchange import as_axis_group

        def lower(x, *, mesh, **kw):
            # every rank's shard, the control's answer of all of them, and
            # this rank's equal share of it
            g = as_axis_group(mesh)
            parts = [torch.empty_like(x) for _ in range(g.size)]
            dist.all_gather(parts, x)
            ans = ref.control(op, torch.cat(parts).cpu().numpy())
            share = len(ans) // g.size
            mine = torch.from_numpy(ans[g.rank * share:(g.rank + 1) * share].copy()).to(x.device)
            return mine, torch.ones(share, dtype=torch.bool, device=x.device)
        return [mock.patch.object(repro_torch, "sort", lower)]
    raise ValueError(f"no control for {cell.name}")


def run_control(workload: str, seed: int, seconds: float, device: str = "cuda",
                overrides=None) -> dict:
    """One run of ``workload`` with the control in the program's place."""
    return harness.run_cell(workload, seed, seconds, False, device=device, overrides=overrides,
                            info=lambda obj: None, hooks=("sortbench.control:control_patches",),
                            plans=os.environ.get("REPRO_SORT_PLANS"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    scratch = tempfile.mkdtemp(prefix="sortbench-control-")
    os.environ["REPRO_SORT_PLANS"] = os.path.join(scratch, "plans.json")
    try:
        for seed in args.seeds.split(","):
            r = run_control(args.workload, int(seed), args.seconds)
            print(json.dumps({"workload": args.workload, "seed": int(seed),
                              "correct": r["correct"], "attempted": r["attempted"],
                              "checks": r["checks"]}), flush=True)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
