"""Device milliseconds a call of model B spends in its merge tree: the
operations launched under the benchmark's span around
``repro_torch.core.shared_sort.merge_adjacent``."""
NAME = "merge_device_ms.bulk"
UNIT = "ms"
LAYER = "Model B merge tree (core/shared_sort.py, core/merge.py)"
SOURCE = "device_trace"
MOVES = "keys_per_s"
WORKLOADS = ["bulk10m.sort_f32"]


def read(run):
    if run.trace is None:
        return None
    ops = run.trace.ops_under("sb.merge")
    if not ops:
        return None
    return run.trace.busy_s(ops) / run.counters["calls"] * 1e3
