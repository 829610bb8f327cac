"""The training path on the card, at a small size: one ``train_step`` of each
training arch against the same step on the CPU, the driver's restart
replayed bit for bit, and length bucketing on the card.

Marked ``gpu``; every test takes the ``cuda`` fixture, which skips when no
card is present.  Run on a machine with a card:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_train.py``.
Tolerances: the CPU tests' against the reference (loss and grad norm 1e-5
relative, the update per leaf 1e-3 relative L2), float32 configs, TF32 off.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import ARCHS, reduced
from repro_torch.data.pipeline import SyntheticLM, length_bucketed_batches
from repro_torch.distributed.fault_tolerance import TrainingAnomaly
from repro_torch.launch import train
from repro_torch.models.transformer import model_init
from repro_torch.optim.adamw import OptConfig, init_opt_state
from repro_torch.train.steps import train_step
from repro_torch.tree import at_path, map_leaves, paths

pytestmark = pytest.mark.gpu

METRIC_RTOL, UPDATE_RL2 = 1e-5, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _rel_l2(got, want) -> float:
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-3b-a800m", "mamba2-1.3b",
                                  "jamba-1.5-large-398b", "gemma3-12b"])
@pytest.mark.parametrize("mb", [1, 2])
def test_train_step_on_the_card_equals_the_cpu(cuda, arch, mb):
    cfg = reduced(ARCHS[arch])
    ocfg = OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    params = model_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    b = SyntheticLM(cfg.vocab_size, 4, 32, seed=1)._batch_at(0)
    out = []
    for dev in (torch.device("cpu"), cuda):
        p = map_leaves(lambda t: t.to(dev), params)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        new, _, m = train_step(p, init_opt_state(p, ocfg), batch, cfg=cfg, opt_cfg=ocfg,
                               n_microbatch=mb, loss_chunk=16)
        out.append((map_leaves(lambda t: t.cpu(), new), {k: v.cpu() for k, v in m.items()}))
    (cpu_new, cpu_m), (gpu_new, gpu_m) = out
    for k in ("loss", "grad_norm", "lr"):
        assert float(gpu_m[k]) == pytest.approx(float(cpu_m[k]), rel=METRIC_RTOL), k
    for k in ("moe_dropped", "moe_peak", "moe_overflow"):
        assert int(gpu_m[k]) == int(cpu_m[k]), k
    for path, old in paths(params):
        got = at_path(gpu_new, path).double() - old.double()
        want = at_path(cpu_new, path).double() - old.double()
        assert bool(torch.isfinite(got).all()) and _rel_l2(got, want) <= UPDATE_RL2, path


def test_driver_restart_replays_bit_for_bit_on_the_card(cuda, tmp_path, monkeypatch):
    flags = ["--arch", "granite-moe-3b-a800m", "--reduced", "--steps", "6", "--batch", "4",
             "--seq", "32", "--lr", "5e-3", "--log-every", "100", "--ckpt-every", "2"]
    clean = train.main(flags + ["--ckpt-dir", str(tmp_path / "clean")])
    real, calls = train.train_step, []

    def failing_once(*a, **k):
        calls.append(len(calls))
        if len(calls) == 6:
            raise TrainingAnomaly("injected")
        return real(*a, **k)

    monkeypatch.setattr(train, "train_step", failing_once)
    replayed = train.main(flags + ["--ckpt-dir", str(tmp_path / "replayed")])
    assert replayed == clean[:5] + clean[4:]
    ends = [np.load(tmp_path / run / "step_00000006" / "leaves.npz") for run in ("clean", "replayed")]
    for k in ends[0].files:
        assert ends[0][k].tobytes() == ends[1][k].tobytes(), k


def test_length_bucketing_on_the_card_equals_the_cpu(cuda):
    lengths = np.random.default_rng(0).integers(10, 2048, size=4096)
    got = length_bucketed_batches(lengths, 16, device=cuda)
    want = length_bucketed_batches(lengths, 16, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
