"""The port's Planner against the reference's (``repro.engine.planner``).

Keys, the candidate grid, plan-cache files both ways (v1/v2/v3, the
reference's ``'pallas'`` read as the port's ``'kernel'``), merge-on-save
under concurrent threads and processes, the learned table and its save
decisions, ``plan_for`` / ``cluster_kwargs`` / ``warmup_cells``, and the
CPU autotune's kernel-candidate rule.  Every comparison is exact; none
compares times.
"""
import doctest
import importlib
import json
import os
import subprocess
import sys
import threading
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import REPO
from repro.engine import adapt as ref_adapt
from repro.engine import planner as ref
from repro_torch import carry
from repro_torch.engine import adapt, planner as port
from repro_torch.engine.planner import Planner, SortPlan

FINGERPRINTS = ["local/cpu", "local/cuda:NVIDIA H100 80GB HBM3", "cpu/ranks=2/procs2x1",
                "cuda:NVIDIA H100 80GB HBM3/ranks=4/procs4x1", "cpu/x=4/procs2x2"]
DTYPES = ["int32", "uint16", "float32", "bfloat16", "int8"]


def _mapped(plan_dict: dict) -> dict:
    """A reference plan dict with the port's local-sort name."""
    return carry.plan_from_reference(plan_dict).to_dict()


# ------------------------------------------------------------------- keys ---
@pytest.mark.parametrize("fp", FINGERPRINTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_key_round_trips_and_matches_reference(dtype, fp):
    for n in (1, 3, 1000, 4096, 4097, (1 << 22) - 5):
        key = port.plan_key(n, getattr(torch, dtype), fingerprint=fp)
        assert key == ref.plan_key(n, jnp.dtype(dtype), fingerprint=fp)
        bucket, name, got_fp = port.parse_plan_key(key)
        assert (bucket, name, got_fp) == ref.parse_plan_key(key)
        assert name == dtype and got_fp == fp and bucket >= n and bucket & (bucket - 1) == 0
        assert port.plan_key(bucket, name, fingerprint=got_fp) == key


@pytest.mark.parametrize("bad", ["", "4096|int32", "4096|int32|cpu/x=2|extra",
                                 "moe/E8k2|256|float32|local/cpu", "notanumber|int32|cpu/x=2"])
def test_parse_plan_key_rejects_what_the_reference_rejects(bad):
    for mod in (ref, port):
        with pytest.raises(ValueError):
            mod.parse_plan_key(bad)


def test_fingerprint_on_the_cpu_is_the_references():
    assert port.mesh_fingerprint(device="cpu") == "local/cpu" == ref.mesh_fingerprint()
    assert port.plan_key(3000, torch.int32, device="cpu") == ref.plan_key(3000, jnp.int32)
    assert "|" not in port.mesh_fingerprint(device="cpu")


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.bfloat16, torch.uint16,
                                   np.int32, np.float16, "float32", "int16"])
def test_dtype_name_is_the_references(dtype):
    ref_dtype = jnp.bfloat16 if dtype is torch.bfloat16 else (
        str(dtype).removeprefix("torch.") if isinstance(dtype, torch.dtype) else dtype)
    assert port.dtype_name(dtype) == jnp.dtype(ref_dtype).name


@pytest.mark.parametrize("quick", [False, True])
@pytest.mark.parametrize("mesh", [None, "group"])
def test_candidate_plans_are_the_references_mapped(mesh, quick):
    want = [_mapped(p.to_dict()) for p in ref.candidate_plans(mesh, quick=quick)]
    assert [p.to_dict() for p in port.candidate_plans(mesh, quick=quick)] == want
    assert port.KERNEL_BLOCK_SWEEP == ref.PALLAS_BLOCK_SWEEP
    assert port.KERNEL_PLAIN_MAX == ref.PALLAS_INTERPRET_MAX


# ------------------------------------------------------------------ files ---
def _ref_tables():
    plans = {
        "4096|int32|local/cpu": ref.SortPlan("shared", local_impl="pallas", block_n=512,
                                             us_per_call=12.5),
        "1048576|float32|local/cpu": ref.SortPlan("shared", local_impl="xla", n_threads=16),
        "8192|int32|cpu/x=4": ref.SortPlan("cluster", capacity_factor=1.5, mode="radix",
                                           partition="sample"),
        "2048|uint16|cpu/x=2": ref.SortPlan("distributed_merge", local_impl="merge"),
    }
    learned = {
        "8192|int32|cpu/x=4": ref_adapt.LearnedCapacity(3.75, 3.0, 7, "sample", 3, 2, 1),
        "moe/E8k2|256|float32|local/cpu": ref_adapt.LearnedCapacity(4.0, 3.5, 2),
    }
    return plans, learned


def _port_view(planner):
    return ({k: p.to_dict() for k, p in planner.plans.items()},
            {k: e.to_dict() for k, e in planner.learned.items()})


@pytest.mark.parametrize("version", [1, 2, 3])
def test_reference_files_load_into_the_port(tmp_path, version):
    plans, learned = _ref_tables()
    path = tmp_path / f"v{version}.json"
    if version == 3:
        rp = ref.Planner()
        rp.plans.update(plans)
        rp.learned.update(learned)
        rp.save(str(path))
    else:
        doc = {"version": version, "plans": {k: {f: v for f, v in p.to_dict().items()
                                                 if f != "partition"} for k, p in plans.items()}}
        if version == 2:
            doc["learned"] = {k: {f: v for f, v in e.to_dict().items()
                                  if f in ("capacity_factor", "peak_factor", "observations")}
                              for k, e in learned.items()}
        path.write_text(json.dumps(doc))
    rp = ref.Planner(str(path))
    want = ({k: _mapped(p.to_dict()) for k, p in rp.plans.items()},
            {k: e.to_dict() for k, e in rp.learned.items()})
    assert _port_view(Planner(str(path), device="cpu")) == want
    assert _port_view(carry.planner_from_reference(str(path), device="cpu")) == want
    with open(path) as f:
        assert _port_view(carry.planner_from_reference(json.load(f))) == want
    assert Planner(str(path), device="cpu").plans["4096|int32|local/cpu"].local_impl == "kernel"


def test_the_port_file_parses_in_the_reference(tmp_path):
    plans, learned = _ref_tables()
    pp = Planner(device="cpu")
    pp.plans.update({k: carry.plan_from_reference(p.to_dict()) for k, p in plans.items()})
    pp.learned.update({k: adapt.LearnedCapacity(**e.to_dict()) for k, e in learned.items()})
    path = str(tmp_path / "port.json")
    pp.save(path)
    rp = ref.Planner(str(path))
    for k, p in rp.plans.items():
        want = plans[k].to_dict()
        got = p.to_dict()
        assert got["local_impl"] == ("kernel" if want["local_impl"] == "pallas" else want["local_impl"])
        assert {f: v for f, v in got.items() if f != "local_impl"} == {
            f: v for f, v in want.items() if f != "local_impl"}
    assert {k: e.to_dict() for k, e in rp.learned.items()} == {k: e.to_dict() for k, e in learned.items()}
    with open(path) as f:
        assert json.load(f)["version"] == 3


def test_rotted_and_unknown_files_warn_and_keep_the_table_like_the_reference(tmp_path):
    good = tmp_path / "good.json"
    good.write_text(json.dumps({"version": 1, "plans": {
        "4096|int32|local/cpu": {"strategy": "shared", "local_impl": "xla"}}}))
    for body in ("{not json", json.dumps({"version": 99, "plans": {}}),
                 json.dumps({"version": 2, "plans": {}, "learned": {"k": {"x": 1}}}),
                 json.dumps({"version": 3, "plans": {"k": {"strategy": "bogus"}}})):
        bad = tmp_path / "bad.json"
        bad.write_text(body)
        for p in (ref.Planner(str(good)), Planner(str(good), device="cpu")):
            with pytest.warns(RuntimeWarning, match="plan cache"):
                p.load(str(bad))
            assert set(p.plans) == {"4096|int32|local/cpu"}
            with pytest.raises(Exception):
                p.load(str(bad), strict=True)


def test_a_reference_writer_and_a_port_writer_share_one_file(tmp_path):
    """Merge-on-save across the two packages: neither clobbers the other."""
    path = str(tmp_path / "shared.json")
    rp, pp = ref.Planner(path), Planner(path, device="cpu")
    rp.plans["1024|int32|cpu/x=4"] = ref.SortPlan("shared", local_impl="pallas", block_n=256)
    rp.learned["512|int32|cpu/x=2"] = ref_adapt.LearnedCapacity(2.0, 2.1, 9)
    rp.save()
    pp.plans["4096|float32|local/cpu"] = SortPlan("shared", local_impl="kernel", block_n=1024)
    pp.learned["512|int32|cpu/x=2"] = adapt.LearnedCapacity(4.0, 4.2, 3)
    pp.save()
    fresh = Planner(path, device="cpu")
    assert set(fresh.plans) == {"1024|int32|cpu/x=4", "4096|float32|local/cpu"}
    assert fresh.plans["1024|int32|cpu/x=4"].local_impl == "kernel"
    assert fresh.learned["512|int32|cpu/x=2"] == adapt.LearnedCapacity(2.0, 4.2, 9)
    assert ref.Planner(path).learned["512|int32|cpu/x=2"] == ref_adapt.LearnedCapacity(2.0, 4.2, 9)


@pytest.mark.parametrize("flip", [False, True])
def test_interleaved_saves_merge_like_the_reference(tmp_path, flip):
    docs = []
    for name, mod, lc in (("ref", ref, ref_adapt.LearnedCapacity),
                          ("port", port, adapt.LearnedCapacity)):
        path = str(tmp_path / f"{name}.json")
        kw = {} if mod is ref else {"device": "cpu"}
        p1, p2 = mod.Planner(path, **kw), mod.Planner(path, **kw)
        key = "512|int32|cpu/x=2"
        p1.learned[key] = lc(2.0, 2.1, 9)
        p2.learned[key] = lc(4.0, 4.2, 3)
        p1.plans["1024|int32|cpu/x=4"] = mod.SortPlan("cluster", capacity_factor=2.5)
        p2.plans["4096|float32|cpu/x=8"] = mod.SortPlan("shared")
        first, second = (p2, p1) if flip else (p1, p2)
        first.save()
        second.save()
        with open(path) as f:
            docs.append(json.load(f))
    assert docs[1] == docs[0]


def test_threaded_saves_keep_every_key(tmp_path):
    path = str(tmp_path / "plans.json")
    errors = []

    def work(t):
        try:
            p = Planner(path, device="cpu")
            for i in range(8):
                p.learned[f"{2 ** (i + 1)}|int32|cpu/ranks=2/t{t}"] = adapt.LearnedCapacity(
                    2.0 + t, 2.0 + t, 1)
                p.save()
        except Exception as e:  # surfaced by the assert below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    assert not errors
    assert len(Planner(path, device="cpu").learned) == 32
    assert len(ref.Planner(path).learned) == 32  # and the reference reads it whole


def test_process_saves_keep_every_key(tmp_path):
    """Separate processes through the fcntl-locked read-merge-write."""
    path = str(tmp_path / "plans.json")
    code = (
        "import sys\n"
        "from repro_torch.engine.planner import Planner\n"
        "from repro_torch.engine.adapt import LearnedCapacity\n"
        "t = int(sys.argv[1])\n"
        "for i in range(6):\n"
        "    p = Planner(sys.argv[2], device='cpu')\n"
        "    p.learned[f'{2 ** (i + 1)}|int32|cpu/ranks=3/p{t}'] = LearnedCapacity(2.0 + t, 2.0, i + 1)\n"
        "    p.save()\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(t), path], env=env)
             for t in range(3)]
    for p in procs:
        assert p.wait(timeout=120) == 0
    got = Planner(path, device="cpu").learned
    assert len(got) == 18
    assert got["4|int32|cpu/ranks=3/p2"] == adapt.LearnedCapacity(4.0, 2.0, 2)


# -------------------------------------------------------- learned + lookup ---
def _obs_fields(seed):
    rng = np.random.default_rng(seed)
    for i in range(120):
        m = int(rng.integers(64, 512))
        peak = int(m / 8 * rng.uniform(0.9, 5.0 if (i // 20) % 2 == 0 else 1.2))
        cap = int(m / 8 * 2)
        yield dict(m=m, part_buckets=8, capacity=cap, peak=peak, overflowed=peak > cap,
                   retries=int(peak > cap), partition=["radix", "sample", None][i % 3])


@pytest.mark.parametrize("seed", range(3))
def test_observe_exchange_learns_and_saves_like_the_reference(tmp_path, seed):
    saves = {"ref": [], "port": []}
    planners = {"ref": ref.Planner(str(tmp_path / "r.json")),
                "port": Planner(str(tmp_path / "p.json"), device="cpu")}
    for name, p in planners.items():
        p.learner = replace(p.learner, demote_after=2)
        real = p.save
        p.save = lambda path=None, real=real, name=name: saves[name].append(
            planners[name].telemetry.calls) or real(path)
    for fields in _obs_fields(seed):
        key = "4096|int32|cpu/x=4"
        er = planners["ref"].observe_exchange(key, ref_adapt.ExchangeObservation(**fields))
        ep = planners["port"].observe_exchange(key, adapt.ExchangeObservation(**fields))
        assert ep.to_dict() == er.to_dict()
    assert saves["port"] == saves["ref"] and saves["ref"]
    with open(tmp_path / "r.json") as f, open(tmp_path / "p.json") as g:
        assert json.load(g) == json.load(f)


def _seeded_tables(mod, lc):
    """The same tuned and learned cells for both packages (local keys)."""
    plans = {
        "1024|int32|local/cpu": mod.SortPlan("cluster", capacity_factor=1.5, mode="radix"),
        "4096|int32|local/cpu": mod.SortPlan("cluster", capacity_factor=2.0, mode="sample"),
        "8192|float32|local/cpu": mod.SortPlan("shared", local_impl="merge"),
        "65536|int32|local/cpu": mod.SortPlan("cluster", mode="range", partition="radix"),
        "256|int32|cpu/x=4": mod.SortPlan("shared"),
        "moe/E8k2|256|float32|local/cpu": mod.SortPlan(),
    }
    learned = {
        "1024|int32|local/cpu": lc(3.75, 3.0, 7, "sample", 3),
        "4096|int32|local/cpu": lc(2.5, 2.0, 4),
        "65536|int32|local/cpu": lc(1.25, 1.0, 9, "sample", 0, 5, 1),
        "16384|uint16|local/cpu": lc(2.0, 2.0, 1),
        "32768|int32|local/cpu@h0": lc(3.0, 3.0, 2),
        "2048|int32|local/cpu@h1": lc(3.0, 3.0, 2),
    }
    return plans, learned


@pytest.mark.parametrize("scope", ["global", "per_host"])
def test_plan_for_cluster_kwargs_and_warmup_cells_match_reference(scope):
    rp, pp = ref.Planner(learned_scope=scope), Planner(learned_scope=scope, device="cpu")
    for p, mod, lc in ((rp, ref, ref_adapt.LearnedCapacity), (pp, port, adapt.LearnedCapacity)):
        plans, learned = _seeded_tables(mod, lc)
        p.plans.update(plans)
        p.learned.update(learned if scope == "global" else {
            (k if "@h" in k else f"{k}@h0"): v for k, v in learned.items()})
    assert pp.warmup_cells() == rp.warmup_cells()
    for n in (700, 1024, 3000, 8000, 65536, 16384, 100):
        for rd, pd in ((jnp.int32, torch.int32), (jnp.float32, torch.float32),
                       (jnp.uint16, torch.uint16)):
            assert pp.plan_for(n, pd).to_dict() == _mapped(rp.plan_for(n, rd).to_dict())
            lp, lr = pp.lookup(n, pd), rp.lookup(n, rd)
            assert (lp and lp.to_dict()) == (lr and _mapped(lr.to_dict()))
            for mode in (None, "radix"):
                for default in (None, 3.0):
                    kp = pp.cluster_kwargs(n, pd, default=default, mode=mode)
                    kr = rp.cluster_kwargs(n, rd, default=default, mode=mode)
                    tel_p, tel_r = kp.pop("telemetry"), kr.pop("telemetry")
                    assert kp == kr
                    obs = dict(m=128, part_buckets=8, capacity=32, peak=64, overflowed=True,
                               retries=1, partition="radix")
                    tel_p(**obs)
                    tel_r(**obs)
    assert _port_view(pp)[1] == {k: e.to_dict() for k, e in rp.learned.items()}
    assert pp.telemetry.keys() == rp.telemetry.keys()


def test_service_stats_sink_sees_exchange_retries_like_the_reference():
    from repro.engine import SortService as RefService
    from repro_torch.engine import SortService

    rp, pp = ref.Planner(), Planner(device="cpu")
    rs, ps = RefService(planner=rp), SortService(planner=pp, device="cpu")
    for fields in _obs_fields(7):
        rp.recorder(4096, jnp.int32)(**fields, recompiles=1)
        pp.recorder(4096, torch.int32)(**fields)
    for f in ("overflow_retries", "peak_mean_ratio"):
        assert getattr(ps.stats, f) == getattr(rs.stats, f)
    assert ps.stats.recompiles == 0  # the port compiles nothing per capacity


def test_scope_policy_like_the_reference(monkeypatch):
    key = "4096|int32|cpu/x=2"
    assert Planner(device="cpu").scoped_key(key) == ref.Planner().scoped_key(key) == key
    assert Planner(learned_scope="per_host", device="cpu").scoped_key(key) == key + "@h0"
    monkeypatch.setenv("REPRO_LEARNED_SCOPE", "per_host")
    assert Planner(device="cpu").learned_scope == "per_host"
    with pytest.raises(ValueError):
        Planner(learned_scope="per_rank", device="cpu")
    assert port.LEARNED_SCOPES == ref.LEARNED_SCOPES


# --------------------------------------------------------------- autotune ---
_CANDS = [("xla", None), ("kernel", 256)]


@pytest.mark.parametrize("n", [1 << 12, 1 << 17])
def test_cpu_autotune_sweeps_kernel_candidates_only_up_to_the_plain_limit(n, tmp_path):
    seen = {"ref": [], "port": []}
    for name, mod in (("ref", ref), ("port", port)):
        kw = {} if mod is ref else {"device": "cpu"}
        p = mod.Planner(str(tmp_path / f"{name}.json"), **kw)
        impl = {"kernel": "pallas"} if mod is ref else {}
        cands = [mod.SortPlan("shared", local_impl=impl.get(i, i), block_n=b) for i, b in _CANDS]
        best = p.autotune(n, candidates=cands, reps=1,
                          on_candidate=lambda i, c, name=name: seen[name].append(i))
        assert best.us_per_call > 0 and p.last_autotune_wrote
        key = (ref.plan_key(n, jnp.int32) if mod is ref
               else port.plan_key(n, torch.int32, device="cpu"))
        assert key in mod.Planner(str(tmp_path / f"{name}.json"), **kw).plans
    assert seen["port"] == seen["ref"] == ([0, 1] if n <= port.KERNEL_PLAIN_MAX else [0])
    timed = p.last_autotune_candidates  # the port's: every candidate it timed
    assert [(c.local_impl, c.block_n) for c in timed] == [_CANDS[i] for i in seen["port"]]
    assert all(c.us_per_call > 0 for c in timed) and best in timed


def test_autotune_raises_when_a_kernel_candidate_fails(monkeypatch):
    """The reference skips a 'pallas' candidate that raises; the port raises,
    so a broken kernel never turns silently into an 'xla' plan."""
    import repro_torch.core.seqsort as seqsort

    def broken(*a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(seqsort, "kernel_local_sort", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        Planner(device="cpu").autotune(4096, candidates=[SortPlan("shared"),
                                                         SortPlan("shared", local_impl="kernel",
                                                                  block_n=256)], reps=1)


def test_autotune_checks_the_group_divides_the_bucket():
    from repro_torch.exchange import AxisGroup

    g = AxisGroup.__new__(AxisGroup)  # a three-rank group's shape, no collective needed
    g.size, g.rank, g.group = 3, 0, None
    with pytest.raises(ValueError, match="must divide"):
        Planner(device="cpu").autotune(4096, mesh=g, distributed=False,
                                       candidates=[SortPlan("shared")], reps=1)


def test_planner_for_the_card_with_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Planner(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        Planner().autotune(64, candidates=[SortPlan("shared")], reps=1, save=False)


# ---------------------------------------------------------------- doctests ---
@pytest.mark.parametrize("module", [
    "repro_torch.carry", "repro_torch.core.api", "repro_torch.engine.adapt",
    "repro_torch.engine.cache", "repro_torch.engine.planner", "repro_torch.engine.service",
    "repro_torch.engine.queue", "repro_torch.engine.frontend.warmup",
    "repro_torch.engine.frontend.scheduler", "repro_torch.engine.frontend.loadgen",
    "repro_torch.keys",
])
def test_doctests_run_on_the_cpu(module):
    result = doctest.testmod(importlib.import_module(module))
    assert result.attempted > 0 and result.failed == 0
