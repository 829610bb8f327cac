"""The LM serving path on the card, at a small size: NaN merges, prefill and
decode against ``forward``, ``serve.main`` on every top-k route with the
top-k on kernel plans, and the MoE capacity loop on one NCCL rank.

Marked ``gpu``; every test takes the ``cuda`` fixture, which skips when no
card is present.  Run on a machine with a card:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_lm.py``.
Tolerances: the reference serving test's (prefill atol 2e-3, decode atol
5e-3, rtol 1e-3; float32 configs) and the reference MoE tests' 1e-4.
"""
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch
import repro_torch.engine.planner as planner_mod
from repro_torch import engine
from repro_torch.configs.base import ARCHS, reduced
from repro_torch.engine.planner import Planner, plan_key
from repro_torch.exchange import AxisGroup
from repro_torch.kernels.bitonic_sort import bitonic_sort as kernels
from repro_torch.launch import serve
from repro_torch.models import moe, transformer
from repro_torch.train import steps

pytestmark = pytest.mark.gpu

SPECIAL = [float("nan"), -float("nan"), float("inf"), -float("inf"), 0.0, -0.0]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    kernels.reset_launch_counts()
    return torch.device("cuda")


def _nan_keys(n, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.round(torch.randn(n, generator=g) * 4)
    at = torch.rand(n, generator=g) < 0.25
    x[at] = torch.tensor(SPECIAL)[torch.randint(0, 6, (int(at.sum()),), generator=g)]
    return x


@pytest.mark.parametrize("local_impl", ["xla", "merge", "kernel"])
def test_nan_keys_sort_without_a_device_assert(cuda, local_impl):
    for n in (7, 1000, (1 << 16) + 5):
        x = _nan_keys(n, n)
        got = repro_torch.sort(x.to(cuda), strategy="shared", local_impl=local_impl, n_threads=8)
        idx = engine.argsort(x.to(cuda), impl="kernel" if local_impl == "kernel" else "xla")
        torch.cuda.synchronize()
        assert got.shape == (n,) and idx.shape == (n,)
        if local_impl != "kernel":
            want = repro_torch.sort(x, strategy="shared", local_impl=local_impl, n_threads=8,
                                    device="cpu")
            assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("family", ["dense", "moe", "hybrid"])
def test_prefill_and_decode_match_forward(cuda, family):
    arch = {"dense": "qwen3-0.6b", "moe": "granite-moe-3b-a800m",
            "hybrid": "jamba-1.5-large-398b"}[family]
    cfg = reduced(ARCHS[arch])
    params = transformer.model_init(torch.Generator(cuda).manual_seed(0), cfg, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(1), dtype=torch.int32)
    last, cache = steps.prefill_step(params, cfg, toks[:, :9], cache_len=12)
    full, _ = transformer.forward(params, cfg, toks)
    torch.testing.assert_close(last, full[:, 8], atol=2e-3, rtol=1e-3)
    for t in range(9, 12):
        lg, cache = steps.serve_decode_step(params, cfg, toks[:, t:t + 1], cache)
        torch.testing.assert_close(lg[:, 0], full[:, t], atol=5e-3, rtol=1e-3)


def test_serve_main_on_kernel_plans(cuda, tmp_path, monkeypatch, capsys):
    path = tmp_path / "plans.json"
    plan = {"strategy": "shared", "local_impl": "pallas", "block_n": 1024}
    path.write_text(json.dumps({"version": 3, "plans": {
        plan_key(128, torch.float32, device=cuda): plan}}))
    monkeypatch.setenv("REPRO_SORT_PLANS", str(path))
    monkeypatch.setattr(planner_mod, "_DEFAULT", None)
    flags = ["--reduced", "--batch", "4", "--prompt-len", "8", "--gen", "4", "--temperature", "0"]
    direct = serve.main(flags)
    kernels.reset_launch_counts()
    queued = serve.main(flags + ["--topk-queue"])
    assert kernels.launch_counts()["block_sort_kv"] >= 4  # one batch a step at least
    fronted = serve.main(flags + ["--tenants", "web:3:0,batch:1:1", "--slo-ms", "500", "--warmup"])
    np.testing.assert_array_equal(queued, direct)
    np.testing.assert_array_equal(fronted, direct)
    assert planner_mod.default_planner().plans[plan_key(128, torch.float32, device=cuda)] \
        .local_impl == "kernel"
    capsys.readouterr()


def test_moe_capacity_loop_on_the_card(cuda, tmp_path):
    cfg = moe.MoEConfig(d_model=64, d_ff=32, n_experts=8, top_k=2)
    p = moe.collapse_router(moe.moe_init(torch.Generator(cuda).manual_seed(0), cfg, torch.float32,
                                         ep_shards=1, device=cuda))
    x = torch.randn(256, 64, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    planner = Planner(str(tmp_path / "plans.json"), device=cuda)
    key = moe.moe_plan_key(256, cfg, torch.float32, device=cuda)
    want, _, _ = moe.moe_apply_ep_replicated(p, cfg._replace(capacity_factor=16.0), x)
    for call in range(3):
        y, _, _ = moe.moe_apply_adaptive(p, cfg, x, planner=planner)
        assert (planner.telemetry.last(key).retries >= 1) == (call == 0)
        torch.testing.assert_close(y, want, atol=1e-4, rtol=1e-4)
    reloaded = Planner(str(tmp_path / "plans.json"), device=cuda)
    moe.moe_apply_adaptive(p, cfg, x, planner=reloaded)
    assert reloaded.telemetry.last(key).retries == 0
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        group = AxisGroup()
        for compress in (False, True):
            y, _, counts = moe.moe_apply_local_adaptive(
                p, cfg._replace(compress_dispatch=compress), x, group, planner=Planner(device=cuda))
            assert int(counts.sum()) == 256 * 2
            if not compress:
                torch.testing.assert_close(y, want, atol=1e-4, rtol=1e-4)
    finally:
        dist.destroy_process_group()
