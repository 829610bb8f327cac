"""The port's examples (``examples/torch_*.py``) run end to end on the CPU.

Each runs at its smallest setting with ``--device cpu`` in a subprocess of
its own, under a time limit of its own (gloo ranks meet through a
``FileStore``), and must exit 0 printing every line its checks end in.
The JAX examples (``examples/*.py``) are left to the reference's own runs.
"""
import os
import subprocess
import sys

import pytest

from conftest import REPO

LIMIT_S = 300
# (script, arguments, lines the output must hold)
RUNS = {
    "quickstart": ("torch_quickstart.py", ["--n", "5000"],
                   ["model A", "model B", "kernel   bitonic sort on cpu", "sort_kv / argsort",
                    "SortService bucket cache"]),
    "distributed_sort": ("torch_distributed_sort_demo.py", ["--ranks", "2", "--n", "4000"],
                         ["model C", "model D  decimal", "model D+ sample splitters"]),
    "moe_routing": ("torch_moe_routing_demo.py", ["--ranks", "2", "--n", "512"],
                    ["dispatch:", "engine: distributed sort_kv", "MoE layer:", "adaptive:"]),
    "train_tiny": ("torch_train_lm.py", ["--tiny", "--steps", "2"], ["done: loss"]),
    "train_moe": ("torch_train_lm.py", ["--moe", "--steps", "2", "--ranks", "2"],
                  ["moe-train-smoke: 2 steps on data=1,model=2, all losses finite"]),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_runs_on_the_cpu(name, tmp_path):
    script, args, lines = RUNS[name]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), TMPDIR=str(tmp_path))
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "examples", script), *args,
                           "--device", "cpu"], env=env, cwd=tmp_path, capture_output=True,
                          text=True, timeout=LIMIT_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for line in lines:
        assert line in proc.stdout, (line, proc.stdout)
