"""Share of the memory roofline a decode top-k call reaches: the least
bytes the operation needs (the logits read once, the k values and k int32
indices of each row written once) over the device-busy time of a call,
every operation it launches counted, at the data sheet's 3.35 TB/s.  It
reads the same work whatever implements it."""
from sortbench.frozen.roofline import roofline_share

NAME = "topk_roofline.decode"
UNIT = "%"
LAYER = "Kernels (kernels/bitonic_sort)"
SOURCE = "device_trace"
MOVES = "keys_per_s"
WORKLOADS = ["topk_cmdr256k.decode"]


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    busy_per_call = run.trace.busy_s() / run.counters["calls"]
    return roofline_share(run.counters["least_bytes_per_call"], busy_per_call)
