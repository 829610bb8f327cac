"""Capacity retries a model D call, from the telemetry the capacity loop
records (the planner's exchange ledger) over the window."""
NAME = "capacity_retries.mesh"
UNIT = "retries"
LAYER = "Exchange retry (exchange/retry.py)"
SOURCE = "program_counter"
MOVES = "mesh_keys_per_s"
WORKLOADS = ["cluster40m.uniform_f32"]


def read(run):
    calls = run.counters["exchanges"]
    return run.counters["retries"] / calls if calls else None
