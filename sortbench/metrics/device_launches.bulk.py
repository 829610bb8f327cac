"""Device kernels a bulk call launches, counted in the profiler trace
(copies and fills left out), whoever wrote them."""
NAME = "device_launches.bulk"
UNIT = "launches"
LAYER = "Kernels (kernels/bitonic_sort)"
SOURCE = "device_trace"
MOVES = "keys_per_s"
WORKLOADS = ["bulk10m.sort_f32", "bulk10m.argsort_i32"]


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return sum(op.is_kernel for op in run.trace.ops) / run.counters["calls"]
