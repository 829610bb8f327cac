"""Per-rank entry point of the port's multihost harness (never imported by pytest).

Runs in a fresh interpreter per rank: joins the gloo group through the
run's ``FileStore``, loads the body function by file path, runs it with a
``MultihostContext`` and writes one JSON report atomically.  Any exception,
a failed group init included, still produces a report, so the coordinator
shows *why* a rank failed and not only that it did.
"""
from __future__ import annotations

import argparse
import datetime
import importlib.util
import json
import os
import sys
import time
import traceback


class MultihostContext:
    """What a body gets: identity, the group, the device and the SPMD plumbing.

    Bodies run once per rank with identical ``args``; the gloo group is up
    by the time the body runs (a one-rank group for ``nprocs == 1``).
    """

    def __init__(self, rank: int, nprocs: int, args: dict, group, device, report_dir: str):
        self.rank = rank
        self.nprocs = nprocs
        self.args = args
        self.group = group  # repro_torch.exchange.AxisGroup over every rank
        self.device = device
        self.report_dir = report_dir

    def shard(self, host_array):
        """This rank's block of a host-replicated array (the same full value
        on every rank, made from the shared seed), as a tensor on
        ``device``."""
        import numpy as np
        import torch

        m = host_array.shape[0] // self.nprocs
        block = np.ascontiguousarray(host_array[self.rank * m:(self.rank + 1) * m])
        return torch.from_numpy(block).to(self.device)

    def allgather(self, t):
        """Every rank's block of ``t`` concatenated in rank order, as a numpy
        array on every rank (bool blocks travel as uint8)."""
        import torch

        if t.dtype == torch.bool:
            return self.allgather(t.to(torch.uint8)).astype(bool)
        return self.group.gather(t, 0).cpu().numpy()

    def maybe_fault(self, point: str) -> None:
        """Fault-injection hook: trigger the configured fault at ``point``.

        ``args["fault"] = {"rank": r, "point": p, "kind": ...}`` arms one
        point on one rank.  ``kind="crash"`` exits hard (``os._exit``: no
        report, no group shutdown); ``kind="hang"`` sleeps far past any test
        timeout, wedging whatever collective the peers are blocked in.
        Before either, the rank leaves ``fault-<rank>.reached`` (holding
        ``point``) in the report directory, so a test can tell the injected
        fault from a run that failed before reaching it.  Unarmed ranks and
        unmatched points are no-ops.
        """
        fault = self.args.get("fault")
        if not fault or fault.get("rank") != self.rank:
            return
        if fault.get("point") != point:
            return
        write_report(os.path.join(self.report_dir, f"fault-{self.rank}.reached"), point)
        if fault.get("kind", "crash") == "crash":
            os._exit(int(fault.get("exit_code", 13)))
        time.sleep(float(fault.get("sleep_s", 600.0)))


def load_body(spec: str):
    """``"<file.py>:<function>"`` -> callable, file relative to this dir."""
    fname, _, func = spec.partition(":")
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), fname)
    mod_spec = importlib.util.spec_from_file_location("_torch_multihost_bodies", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return getattr(mod, func)


def write_report(path: str, doc) -> None:
    """``doc`` as JSON at ``path``, atomically (tmp file, then rename)."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spec", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--report", required=True)
    ap.add_argument("--args-json", default="{}")
    ns = ap.parse_args()

    t0 = time.monotonic()
    doc = {"rank": ns.rank, "ok": False, "result": None, "error": None, "joined": False}
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        args = json.loads(ns.args_json)
        device = torch.device(args.get("device", "cpu"))
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("args['device'] is 'cuda' but no CUDA card is available")
            torch.cuda.set_device(0)  # every rank on the one card; gloo stages through the host
        kw = {}
        if args.get("gloo_timeout_s") is not None:
            kw["timeout"] = datetime.timedelta(seconds=float(args["gloo_timeout_s"]))
        store = dist.FileStore(ns.store, ns.nprocs)
        # every rank arrives first, under the store's own (long) timeout:
        # ``gloo_timeout_s`` bounds the collectives, not the ranks' start
        store.set(f"arrived/{ns.rank}", "1")
        store.wait([f"arrived/{r}" for r in range(ns.nprocs)])
        dist.init_process_group("gloo", store=store, rank=ns.rank, world_size=ns.nprocs, **kw)
        doc["joined"] = True
        from repro_torch.exchange import AxisGroup

        body = load_body(ns.spec)
        ctx = MultihostContext(ns.rank, ns.nprocs, args, AxisGroup(), device,
                               os.path.dirname(os.path.abspath(ns.report)))
        doc["result"] = body(ctx)
        doc["ok"] = True
    except BaseException as e:  # report even SystemExit-ish failures
        doc["error"] = repr(e)
        doc["traceback"] = traceback.format_exc()
    doc["duration_s"] = round(time.monotonic() - t0, 3)
    write_report(ns.report, doc)
    if doc["joined"] and not doc["ok"]:
        # a group whose peer died may block the interpreter's teardown: exit
        # now, so the coordinator sees the failure at once
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    if doc["joined"]:
        dist.destroy_process_group()
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
