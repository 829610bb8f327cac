"""Share of the traced window in which no operation ran on the device."""
NAME = "device_idle.bulk"
UNIT = "%"
LAYER = "Device"
SOURCE = "device_trace"
MOVES = "keys_per_s"
WORKLOADS = ["bulk10m.sort_f32", "bulk10m.argsort_i32"]


def read(run):
    return None if run.trace is None else run.trace.idle_share()
