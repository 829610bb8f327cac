"""Host microseconds a model D call on rank 0 spends choosing its plan and
folding its exchange telemetry into the planner: the program's
``repro_torch.plan`` and ``repro_torch.planner.observe`` spans."""
from sortbench import program_spans

NAME = "plan_host_us.mesh"
UNIT = "us"
LAYER = "Front door and planner (core/api.py, engine/planner.py)"
SOURCE = "program_span"
MOVES = "mesh_keys_per_s"
WORKLOADS = ["cluster40m.uniform_f32"]


def read(run):
    ms = program_spans.host_ms_per_call(
        program_spans.records(), ("repro_torch.plan", "repro_torch.planner.observe"),
        run.counters["calls"])
    return None if ms is None else ms * 1e3
