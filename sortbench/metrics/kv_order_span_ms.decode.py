"""Device milliseconds a decode top-k call spends ordering its rows, read
from the program's own spans: the CUDA event pair of its
``repro_torch.kv.order`` span (the descending key and the kernels' stable
argsort of every row)."""
from sortbench import program_spans

NAME = "kv_order_span_ms.decode"
UNIT = "ms"
LAYER = "Kv path (engine/kv.py)"
SOURCE = "program_span"
MOVES = "keys_per_s"
WORKLOADS = ["topk_cmdr256k.decode"]


def read(run):
    return program_spans.device_ms_per_call(program_spans.records(), "repro_torch.kv.order",
                                            run.counters["calls"])
