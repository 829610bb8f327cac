#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 sortbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It needs as many CUDA cards as the cell
asks for and fails without them; it never falls back to the CPU.  The last
line of standard output is the result (sortbench/README.md); the numbers
compared for ``correct`` are the last lines of standard error too.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from sortbench import harness  # noqa: E402


def info(obj: dict) -> None:
    """An earlier line of standard output: not the result."""
    print(json.dumps({"info": obj}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    chips = harness.find_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"sortbench: {args.workload} needs {chips} CUDA card(s), found {have}",
              file=sys.stderr)
        return 2

    # a fresh plan file a run, under TMPDIR, so no plan outlives it
    scratch = tempfile.mkdtemp(prefix="sortbench-")
    plans = os.environ["REPRO_SORT_PLANS"] = os.path.join(scratch, "plans.json")
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  device="cuda", t_start=T_START, info=info, plans=plans)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    bad = harness.forbidden_modules()
    if bad:
        print(f"sortbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    harness.print_checks(result)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
