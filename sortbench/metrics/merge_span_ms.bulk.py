"""Device milliseconds a call of model B spends in its merge tree, read
from the program's own spans: the CUDA event pairs of its
``repro_torch.shared.merge`` spans, one a round of the tree."""
from sortbench import program_spans

NAME = "merge_span_ms.bulk"
UNIT = "ms"
LAYER = "Model B merge tree (core/shared_sort.py, core/merge.py)"
SOURCE = "program_span"
MOVES = "keys_per_s"
WORKLOADS = ["bulk10m.sort_f32"]


def read(run):
    return program_spans.device_ms_per_call(program_spans.records(), "repro_torch.shared.merge",
                                            run.counters["calls"])
