"""Device milliseconds a model D call spends in NCCL kernels on rank 0
(the all_to_all of the exchange and the count and peak reductions)."""
NAME = "exchange_device_ms.mesh"
UNIT = "ms"
LAYER = "Exchange (exchange/collective.py, core/cluster_sort.py)"
SOURCE = "device_trace"
MOVES = "mesh_keys_per_s"
WORKLOADS = ["cluster40m.uniform_f32"]


def read(run):
    if run.trace is None:
        return None
    ops = [op for op in run.trace.ops if op.name.lower().startswith("nccl")]
    if not ops:
        return None
    return run.trace.busy_s(ops) / run.counters["calls"] * 1e3
