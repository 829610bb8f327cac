"""Nothing a run loads has the top-level name ``jax``, ``jaxlib``,
``flax``, ``repro`` or ``benchmarks`` (compared whole: the port is
``repro_torch``), and the reference loads nothing of the program."""
import os
import re
import subprocess
import sys

from sortbench import harness

_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|flax|repro|benchmarks)(?:\.|\s|$)",
                     re.MULTILINE)


def _run(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(harness.ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_of_every_driver_loads_nothing_forbidden():
    code = (
        "import os, sys, tempfile\n"
        "sys.path.insert(0, os.getcwd())\n"
        "os.environ['REPRO_SORT_PLANS'] = os.path.join(tempfile.mkdtemp(), 'p.json')\n"
        "from sortbench import harness, control\n"
        "from sortbench.tests.test_sortbench_drivers import TINY\n"
        "for name, ov in sorted(TINY.items()):\n"
        "    for trace in (0, 1):\n"
        "        harness.run_cell(name, 5, 0.3, bool(trace), device='cpu', overrides=ov,\n"
        "                         info=lambda obj: None, plans=os.environ['REPRO_SORT_PLANS'])\n"
        "for m in harness.load_benchmark()['per_layer']:\n"
        "    harness.load_metric(m['name'])\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & set(harness.FORBIDDEN)))\n")
    assert _run(code) == "[]"


def test_the_reference_loads_nothing_of_the_program():
    code = ("import os, sys\nsys.path.insert(0, os.getcwd())\n"
            "import sortbench.reference.numpy_sort\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('repro_torch', 'torch', 'jax', 'repro', 'benchmarks')))\n")
    assert _run(code) == "[]"


def test_no_benchmark_source_imports_a_forbidden_name():
    sources = [os.path.join(d, f) for d, _, fs in os.walk(harness.HERE) for f in fs
               if f.endswith(".py")]
    assert len(sources) >= 20
    assert [p for p in sources if _IMPORT.search(open(p).read())] == []
    ref = os.path.join(harness.HERE, "reference", "numpy_sort.py")
    assert "repro_torch" not in open(ref).read().replace("imports nothing of", "")
