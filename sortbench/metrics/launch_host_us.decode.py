"""Host microseconds a kernel launch of a decode top-k call costs: the
host time of the program's ``repro_torch.kv.order`` span in the call least
held back by the card, over the port's kernel launches a call (the
wrappers' ``launch_counts``).  The loop is device-bound: once the card's
launch queue is full, every launch waits for the card, so the mean over
the window reads the card's pace and not the host's cost; the window opens
on an empty queue, so its first calls are not held back."""
from sortbench import program_spans

NAME = "launch_host_us.decode"
UNIT = "us"
LAYER = "Kv path (engine/kv.py)"
SOURCE = "program_span"
MOVES = "keys_per_s"
WORKLOADS = ["topk_cmdr256k.decode"]


def read(run):
    per_call = {}
    for r in program_spans.records() or ():
        if r.name == "repro_torch.kv.order" and r.end_ns is not None:
            key = (r.thread, r.call)
            per_call[key] = per_call.get(key, 0) + r.end_ns - r.start_ns
    launches = run.counters["launches_per_call"]
    if not per_call or not launches:
        return None
    return min(per_call.values()) / 1e3 / launches
