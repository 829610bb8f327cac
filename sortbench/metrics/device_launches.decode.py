"""Device kernels a decode top-k call launches, counted in the profiler
trace (copies and fills left out), whoever wrote them."""
NAME = "device_launches.decode"
UNIT = "launches"
LAYER = "Kernels (kernels/bitonic_sort)"
SOURCE = "device_trace"
MOVES = "keys_per_s"
WORKLOADS = ["topk_cmdr256k.decode"]


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return sum(op.is_kernel for op in run.trace.ops) / run.counters["calls"]
