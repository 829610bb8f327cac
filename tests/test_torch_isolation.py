"""The port stands alone: ``repro_torch`` imports neither ``jax`` nor
``repro``, and its front doors never fall back to the CPU on their own."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "src", "repro_torch")

_FORBIDDEN_IMPORT = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)(?:\.|\s|$)", re.MULTILINE)


def test_import_loads_no_jax_and_no_reference_module():
    code = (
        "import sys, repro_torch, repro_torch.engine, repro_torch.carry, "
        "repro_torch.kernels.bitonic_sort.ops, repro_torch.exchange, "
        "repro_torch.core.cluster_sort, repro_torch.core.distributed_sort, "
        "repro_torch.engine.adapt, repro_torch.engine.cache, repro_torch.engine.planner, "
        "repro_torch.engine.service, repro_torch.engine.queue, repro_torch.engine.frontend, "
        "repro_torch.engine.frontend.warmup, repro_torch.engine.frontend.scheduler, "
        "repro_torch.engine.frontend.loadgen, repro_torch.models.layers, "
        "repro_torch.models.moe, repro_torch.models.attention, repro_torch.models.mamba2, "
        "repro_torch.models.transformer, repro_torch.configs.base, repro_torch.train.steps, "
        "repro_torch.launch.serve\n"
        "bad = [m for m in sys.modules if m in ('jax', 'repro') or m.startswith(('jax.', 'repro.'))]\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_source_file_imports_jax_or_the_reference():
    sources = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")]
    assert len(sources) >= 34
    offenders = [p for p in sources if _FORBIDDEN_IMPORT.search(open(p).read())]
    assert offenders == []


def test_chip_smoke_imports_no_jax_or_reference():
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    assert not _FORBIDDEN_IMPORT.search(src)


_FRONT_DOORS = {
    "sort": lambda a, **kw: repro_torch.sort(a, **kw),
    "argsort": lambda a, **kw: engine.argsort(a, **kw),
    "sort_kv": lambda a, **kw: engine.sort_kv(a, {"v": np.arange(len(a))}, **kw),
    "topk": lambda a, **kw: engine.topk(a, 2, **kw),
}


@pytest.mark.parametrize("door", list(_FRONT_DOORS))
def test_front_door_with_no_card_raises(door, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _FRONT_DOORS[door](np.array([3.0, 1.0, 2.0], np.float32))


@pytest.mark.parametrize("door", list(_FRONT_DOORS))
def test_front_door_runs_on_the_cpu_when_asked(door):
    out = _FRONT_DOORS[door]([3.0, 1.0, 2.0], device="cpu")
    first = out[0] if isinstance(out, tuple) else out
    assert first.device.type == "cpu"


def test_kernel_wrappers_refuse_other_devices():
    from repro_torch.kernels.bitonic_sort import bitonic_sort as kernels

    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.block_sort(torch.zeros(16, device="meta"), 4)


def test_serving_driver_with_no_card_raises(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for flags in (["--reduced", "--gen", "2"], ["--moe", "--gen", "1"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(flags)
