"""``launch/train.py --mesh`` on the card: one NCCL rank.

Marked ``gpu``; every test takes the ``cuda`` fixture, which skips when no
card is present.  Run on a machine with a card:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_mesh.py``.
On a (data=1, model=1) mesh every collective is over one rank, so the
driver must give the one-device driver's losses bit for bit (reduced
float32 configs, TF32 off), with checkpoints saved through the mesh path
and a restart replayed.
"""
import pytest
import torch
import torch.distributed as dist

from repro_torch.distributed.fault_tolerance import TrainingAnomaly
from repro_torch.launch import train

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-3b-a800m"])
def test_one_nccl_rank_mesh_equals_the_one_device_driver(cuda, arch):
    flags = ["--arch", arch, "--reduced", "--steps", "4", "--batch", "4", "--seq", "32",
             "--lr", "5e-3", "--log-every", "100"]
    want = train.main(flags)
    got = train.main(flags + ["--mesh", "data=1,model=1", "--dist-backend", "nccl"])
    assert got == want
    assert not dist.is_initialized()


def test_a_mesh_restart_replays_bit_for_bit(cuda, tmp_path, monkeypatch):
    flags = ["--reduced", "--steps", "6", "--batch", "2", "--seq", "16", "--lr", "5e-3",
             "--log-every", "100", "--ckpt-every", "2", "--mesh", "data=1,model=1"]
    clean = train.main(flags + ["--ckpt-dir", str(tmp_path / "clean")])
    real, calls = train.train_step, []

    def failing_once(*a, **k):
        calls.append(len(calls))
        if len(calls) == 6:  # step 5, after the checkpoint at step 4
            raise TrainingAnomaly("injected")
        return real(*a, **k)

    monkeypatch.setattr(train, "train_step", failing_once)
    replayed = train.main(flags + ["--ckpt-dir", str(tmp_path / "replayed")])
    assert replayed == clean[:5] + clean[4:]
