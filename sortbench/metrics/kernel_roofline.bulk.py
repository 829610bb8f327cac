"""Share of the memory roofline a bulk call reaches: the least bytes the
operation needs (each input read once, each output written once) over the
device-busy time of a call, every operation it launches counted, at the
data sheet's 3.35 TB/s.  It reads the same work whatever implements it."""
from sortbench.frozen.roofline import roofline_share

NAME = "kernel_roofline.bulk"
UNIT = "%"
LAYER = "Kernels (kernels/bitonic_sort)"
SOURCE = "device_trace"
MOVES = "keys_per_s"
WORKLOADS = ["bulk10m.sort_f32", "bulk10m.argsort_i32"]


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    busy_per_call = run.trace.busy_s() / run.counters["calls"]
    return roofline_share(run.counters["least_bytes_per_call"], busy_per_call)
