"""Device milliseconds a model D call spends in its exchange on rank 0,
read from the program's own spans: the CUDA event pair of its
``repro_torch.cluster.exchange`` span (the partition, the count exchange
and the all_to_all of the keys)."""
from sortbench import program_spans

NAME = "exchange_span_ms.mesh"
UNIT = "ms"
LAYER = "Exchange (exchange/collective.py, core/cluster_sort.py)"
SOURCE = "program_span"
MOVES = "mesh_keys_per_s"
WORKLOADS = ["cluster40m.uniform_f32"]


def read(run):
    return program_spans.device_ms_per_call(program_spans.records(),
                                            "repro_torch.cluster.exchange", run.counters["calls"])
