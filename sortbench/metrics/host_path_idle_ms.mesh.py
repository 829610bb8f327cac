"""Device-idle milliseconds a model D call on rank 0 while the host was in
the program's own path: inside ``repro_torch.sort`` but not blocked in
``repro_torch.retry.read``.  The program's records are put on the trace's
clock once a call, at the benchmark's ``sb.call`` span; the rest of the
window's idle time is the driver's loop and the waits on other ranks."""
from sortbench import program_spans

NAME = "host_path_idle_ms.mesh"
UNIT = "ms"
LAYER = "Front door and planner (core/api.py, engine/planner.py)"
SOURCE = "program_span"
MOVES = "mesh_keys_per_s"
WORKLOADS = ["cluster40m.uniform_f32"]


def read(run):
    split = program_spans.idle_split(run.trace, program_spans.records())
    if split is None or not run.counters["calls"]:
        return None
    return split.inside_s * 1e3 / run.counters["calls"]
