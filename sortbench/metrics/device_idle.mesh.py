"""Share of the traced window in which no operation ran on the device of
rank 0."""
NAME = "device_idle.mesh"
UNIT = "%"
LAYER = "Device"
SOURCE = "device_trace"
MOVES = "mesh_keys_per_s"
WORKLOADS = ["cluster40m.uniform_f32"]


def read(run):
    return None if run.trace is None else run.trace.idle_share()
