"""Host milliseconds a model D call on rank 0 is blocked reading each
attempt's peak and overflow back from the card: the program's
``repro_torch.retry.read`` spans."""
from sortbench import program_spans

NAME = "host_wait_ms.mesh"
UNIT = "ms"
LAYER = "Exchange retry (exchange/retry.py)"
SOURCE = "program_span"
MOVES = "mesh_keys_per_s"
WORKLOADS = ["cluster40m.uniform_f32"]


def read(run):
    return program_spans.host_ms_per_call(program_spans.records(), ("repro_torch.retry.read",),
                                          run.counters["calls"])
