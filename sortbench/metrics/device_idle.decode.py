"""Share of the traced window in which no operation ran on the device,
in the decode top-k cell."""
NAME = "device_idle.decode"
UNIT = "%"
LAYER = "Device"
SOURCE = "device_trace"
MOVES = "keys_per_s"
WORKLOADS = ["topk_cmdr256k.decode"]


def read(run):
    return None if run.trace is None else run.trace.idle_share()
