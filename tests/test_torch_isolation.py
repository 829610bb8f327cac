"""The port stands alone: ``repro_torch`` imports neither ``jax`` nor
``repro``, and its front doors never fall back to the CPU on their own."""
import ast
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
        "repro_torch.launch.serve, repro_torch.tree, repro_torch.optim.adamw, "
        "repro_torch.data.pipeline, repro_torch.checkpoint.manager, "
        "repro_torch.distributed.fault_tolerance, repro_torch.train.adaptive, "
        "repro_torch.launch.train, repro_torch.launch.mesh, repro_torch.distributed.sharding\n"
        "bad = [m for m in sys.modules if m in ('jax', 'repro') or m.startswith(('jax.', 'repro.'))]\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_layers_import_only_downward():
    """``repro_torch.keys`` loads nothing of the package, and the kernels
    load ``keys``, ``exchange`` and ``tracing`` but no sort model and no
    engine: imports point from ``engine`` to ``core`` to ``kernels``."""
    code = (
        "import sys, importlib\n"
        "def loaded(name):\n"
        "    before = set(sys.modules)\n"
        "    importlib.import_module(name)\n"
        "    return sorted(m for m in set(sys.modules) - before if m.startswith('repro_torch'))\n"
        "print(loaded('repro_torch.keys'))\n"
        "print(loaded('repro_torch.kernels.bitonic_sort'))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    keys, kernels = (ast.literal_eval(line) for line in out.stdout.strip().splitlines())
    assert keys == ["repro_torch", "repro_torch.keys"]
    assert "repro_torch.kernels.bitonic_sort.bitonic_sort" in kernels
    assert [m for m in kernels if m.startswith(("repro_torch.core", "repro_torch.engine"))] == []


def test_every_module_imports_without_jax_or_the_reference():
    """Every module of the package, found by walking it (the dry-run
    included), loads neither jax nor the reference."""
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'repro_torch.launch.dryrun' in sys.modules\n"
        "bad = [m for m in sys.modules if m in ('jax', 'repro') or m.startswith(('jax.', 'repro.'))]\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_source_file_imports_jax_or_the_reference():
    sources = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")]
    assert len(sources) >= 45
    offenders = [p for p in sources if _FORBIDDEN_IMPORT.search(open(p).read())]
    assert offenders == []


def test_chip_smoke_imports_no_jax_or_reference():
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    assert not _FORBIDDEN_IMPORT.search(src)


@pytest.mark.parametrize("name", ["_torch_multihost.py", "_torch_multihost_worker.py",
                                  "_torch_multihost_bodies.py"])
def test_multihost_harness_imports_no_jax_or_reference(name):
    """The port's multihost harness, worker and bodies run on the card
    machine (chip_smoke.py's multihost phase), which has no JAX."""
    src = open(os.path.join(REPO, "tests", name)).read()
    assert not _FORBIDDEN_IMPORT.search(src)
    assert "multihost import" not in src and "tests.multihost" not in src


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


def _inits():
    from repro_torch.configs.base import ARCHS, reduced
    from repro_torch.models import attention, layers, mamba2, moe, transformer

    cfg = reduced(ARCHS["jamba-1.5-large-398b"])
    gen = torch.Generator()
    return {
        "model_init": lambda: transformer.model_init(gen, cfg),
        "init_cache": lambda: transformer.init_cache(cfg, 1, 4),
        "moe_init": lambda: moe.moe_init(gen, cfg.moe_cfg(), torch.float32, ep_shards=1),
        "attn_init": lambda: attention.attn_init(gen, cfg.attn_cfg("attn"), torch.float32),
        "init_kv_cache": lambda: attention.init_kv_cache(cfg.attn_cfg("attn"), 1, 4, torch.float32),
        "mamba_init": lambda: mamba2.mamba_init(gen, cfg.mamba_cfg(), torch.float32),
        "init_mamba_cache": lambda: mamba2.init_mamba_cache(cfg.mamba_cfg(), 1, torch.float32),
        "rmsnorm_init": lambda: layers.rmsnorm_init(4, torch.float32),
        "linear_init": lambda: layers.linear_init(gen, 4, 4, torch.float32),
        "mlp_init": lambda: layers.mlp_init(gen, 4, 8, torch.float32),
        "embed_init": lambda: layers.embed_init(gen, 8, 4, torch.float32),
    }


_INIT_NAMES = ["model_init", "init_cache", "moe_init", "attn_init", "init_kv_cache", "mamba_init",
               "init_mamba_cache", "rmsnorm_init", "linear_init", "mlp_init", "embed_init"]


@pytest.mark.parametrize("name", _INIT_NAMES)
def test_model_init_with_no_card_raises(name, monkeypatch):
    """The model stack's inits default to the card: with none they raise
    instead of returning CPU tensors."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _inits()[name]()


def test_model_init_runs_on_the_cpu_when_asked():
    from repro_torch.configs.base import ARCHS, reduced
    from repro_torch.models import transformer

    params = transformer.model_init(torch.Generator(), reduced(ARCHS["qwen3-0.6b"]), device="cpu")
    assert params["embed"]["table"].device.type == "cpu"
    assert set(_inits()) == set(_INIT_NAMES)


def test_training_driver_with_no_card_raises(monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced", "--steps", "1"])


def test_training_driver_on_a_mesh_with_no_card_raises(monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced", "--steps", "1", "--mesh", "data=1,model=1"])


def test_nccl_on_the_cpu_raises_rather_than_falling_back_to_gloo():
    import torch.distributed as dist

    from repro_torch.launch import train

    with pytest.raises(ValueError, match="nccl backend needs a CUDA device"):
        train.main(["--reduced", "--steps", "1", "--device", "cpu", "--mesh", "data=1,model=1",
                    "--dist-backend", "nccl"])
    assert not dist.is_initialized()


def test_a_mesh_needs_a_process_group_of_its_size():
    import torch.distributed as dist

    from repro_torch.launch.mesh import Mesh, make_production_mesh

    with pytest.raises(RuntimeError, match="initialise it first"):
        Mesh((1, 1), ("data", "model"))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="needs a world of 256 ranks"):
            make_production_mesh()
        with pytest.raises(ValueError, match="needs a world of 512 ranks"):
            make_production_mesh(multi_pod=True)
    finally:
        dist.destroy_process_group()
