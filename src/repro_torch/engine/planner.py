"""Autotuned sort planning — measure the paper's crossover instead of guessing.

Counterpart of ``repro/engine/planner.py``.  A ``SortPlan`` pins one
concrete execution recipe (strategy, local sort impl, thread count,
capacity factor, partitioner mode, kernel tile width).  ``run_plan``
executes it: ``'shared'`` (paper models A/B) on one device,
``'distributed_merge'`` (model C) and ``'cluster'`` (model D) across the
ranks of a process group.  ``Planner.autotune`` microbenchmarks every
candidate for a (size-bucket, dtype, device fingerprint) cell and persists
the winner to a JSON plan cache so serving processes start with tuned
choices.

The plan-cache file is the reference's, schema v3::

    {"version": 3,
     "plans": {"<size_bucket>|<dtype>|<fingerprint>": {"strategy": "shared", ...}},
     "learned": {"<size_bucket>|<dtype>|<fingerprint>": {"capacity_factor": 3.75,
                                                         "peak_factor": 3.0,
                                                         "observations": 7,
                                                         "partition": null,
                                                         "skew_strikes": 0}}}

The ``learned`` section is the capacity-learning loop's persistent state
(``repro_torch.engine.adapt``): per-cell capacity factors distilled from
observed exchange telemetry, the skew-promotion latch and its probation
counters.  Version-1 and -2 files load too.  The reference's local-sort name
``'pallas'`` is ``'kernel'`` here; ``load`` maps it, so a reference file
serves the port (``carry.planner_from_reference``), and the reference reads
the port's file with only that name differing.

Fingerprints name the hardware a plan was tuned on: ``local/cpu``, or
``local/cuda:<card name>`` on a card, so a plan tuned on one card never
serves another; with a process group of P ranks, ``<platform>/ranks=P``.
When the default process group has W > 1 ranks, ``/procs<W>x1`` follows:
each rank of the port is a process with one device, the reference's
multi-process case.

With a group of more than one rank, ``Planner.autotune`` runs a
**rank-coordinated** sweep on ``torch.distributed``: a barrier before each
candidate, per-rank median-of-reps timings reduced by max over ranks, rank
0's winner sent to every rank, and rank 0 alone writing the plan file
through the fcntl-locked merge-on-save path.
"""
from __future__ import annotations

import json
import os
import threading
import time
import warnings
import weakref
from contextlib import contextmanager
from dataclasses import asdict, dataclass, replace
from typing import Dict, Optional

try:  # advisory plan-file locking is POSIX-only; elsewhere merge-on-save
    import fcntl  # still unions concurrent writers, just without mutual
except ImportError:  # exclusion of the read-merge-write itself
    fcntl = None  # type: ignore[assignment]

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.carry import check_device, plan_from_reference
from repro_torch.core.bitonic import next_pow2
from repro_torch.core.cluster_sort import cluster_sort
from repro_torch.core.distributed_sort import distributed_merge_sort
from repro_torch.core.seqsort import LOCAL_SORTS
from repro_torch.core.shared_sort import shared_memory_sort
from repro_torch.exchange import PARTITION_MODES, AxisGroup, as_axis_group, partition_of
from repro_torch.tracing import span

from .adapt import CapacityLearner, ExchangeObservation, ExchangeTelemetry, LearnedCapacity

__all__ = [
    "SortPlan",
    "Planner",
    "default_planner",
    "default_plan",
    "dtype_name",
    "mesh_fingerprint",
    "plan_key",
    "parse_plan_key",
    "plan_from_strategy",
    "run_plan",
    "autotune",
    "candidate_plans",
    "LEARNED_SCOPES",
    "KERNEL_BLOCK_SWEEP",
    "KERNEL_PLAIN_MAX",
]

# how learned capacity factors are keyed across ranks: 'global' shares one
# entry per cell, 'per_host' suffixes keys with '@h<rank>'
LEARNED_SCOPES = ("global", "per_host")


@contextmanager
def _plan_file_lock(path: str):
    """Advisory ``fcntl`` lock serializing read-merge-write on one plan file,
    taken on a ``<path>.lock`` sidecar (the writer ``os.replace``s the plan
    file itself, which would drop a lock held on the replaced inode)."""
    if fcntl is None:
        yield
        return
    with open(f"{path}.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)


_PLAN_VERSION = 3
_LOADABLE_VERSIONS = (1, 2, _PLAN_VERSION)

# the learner floor handed to promoted (sample-partition) cells
SAMPLE_DEFAULT_FACTOR = 1.25

# strategy names: 'shared' covers paper models A/B (A = local_impl='merge',
# B = local_impl='xla'/'bitonic'/'kernel'); C and D keep their api.py names.
_PLAN_STRATEGIES = ("shared", "distributed_merge", "cluster")


@dataclass(frozen=True)
class SortPlan:
    """One executable sort recipe; ``us_per_call`` records a tuned timing.

    ``block_n`` is the CUDA kernels' shared-memory tile width; it only
    matters for ``local_impl='kernel'``.  ``partition`` pins the cluster
    partition family (``"radix"`` or ``"sample"``); ``None`` means the family
    of ``mode``.

    >>> plan = SortPlan("shared", local_impl="kernel", block_n=512)
    >>> SortPlan.from_dict(plan.to_dict()) == plan
    True
    >>> SortPlan("cluster", mode="range").effective_partition()
    'radix'
    >>> SortPlan("cluster", mode="range", partition="sample").partitioner_mode()
    'sample'
    """

    strategy: str = "shared"
    local_impl: str = "xla"
    n_threads: int = 8
    capacity_factor: float = 2.0
    mode: str = "splitters"
    block_n: Optional[int] = None
    us_per_call: float = -1.0
    partition: Optional[str] = None

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SortPlan":
        known = {k: d[k] for k in cls.__dataclass_fields__ if k in d}
        return cls(**known)

    def effective_partition(self) -> str:
        """The partition family this plan runs: the explicit ``partition``
        override if set, else ``mode``'s own family."""
        return self.partition or partition_of(self.mode)

    def partitioner_mode(self) -> str:
        """The concrete partitioner mode the plan executes: ``mode`` when it
        belongs to ``effective_partition``'s family, else that family's
        canonical mode (``"sample"`` / ``"radix"``)."""
        if self.partition is None or partition_of(self.mode) == self.partition:
            return self.mode
        return "sample" if self.partition == "sample" else "radix"


def dtype_name(dtype) -> str:
    """The reference's dtype name (``jnp.dtype(dtype).name``) of a torch
    dtype, a numpy dtype or a name.

    >>> dtype_name(torch.int32), dtype_name(np.float32), dtype_name("bfloat16")
    ('int32', 'float32', 'bfloat16')
    """
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if dtype == "bfloat16":
        return dtype  # numpy knows this name only once ml_dtypes is imported
    return np.dtype(dtype).name


def _rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _platform(device) -> str:
    if device is None:  # this process's default device, as jax.devices()[0]
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    name = torch.cuda.get_device_name(device)
    return "cuda:" + name.replace("|", "-").replace("/", "-")


def mesh_fingerprint(mesh=None, *, device=None) -> str:
    """Stable id for the hardware a plan was tuned on.

    ``local/<platform>`` with no group, ``<platform>/ranks=<P>`` for a group
    of P ranks, ``<platform>/<axis>=<size>,...`` for a named mesh; the platform is the device type, with the card's name on
    CUDA.  When the default group has W > 1 ranks, ``/procs<W>x1`` follows
    (one device a process), so a multi-process plan never masquerades as a
    single-process one.  ``device`` defaults to this process's default
    device (the card when there is one).

    >>> mesh_fingerprint(device="cpu")
    'local/cpu'
    """
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    topo = f"/procs{world}x1" if world > 1 else ""
    if mesh is None:
        return f"local/{_platform(device)}{topo}"
    if hasattr(mesh, "axis_names"):  # a named mesh (launch.mesh.Mesh): its axes, as the reference's
        axes = ",".join(f"{name}={size}" for name, size in mesh.shape.items())
        return f"{_platform(device)}/{axes}{topo}"
    return f"{_platform(device)}/ranks={as_axis_group(mesh).size}{topo}"


def plan_key(n: int, dtype, mesh=None, *, fingerprint: Optional[str] = None, device=None) -> str:
    """(size-bucket, dtype, fingerprint) -> plan-cache key.

    >>> plan_key(3000, torch.int32, device="cpu") == plan_key(4096, torch.int32, device="cpu")
    True
    >>> plan_key(100, torch.int32, fingerprint="cpu/x=4/procs2x2")
    '128|int32|cpu/x=4/procs2x2'
    """
    fp = mesh_fingerprint(mesh, device=device) if fingerprint is None else fingerprint
    return f"{next_pow2(n)}|{dtype_name(dtype)}|{fp}"


def parse_plan_key(key: str):
    """Inverse of ``plan_key``: ``(size_bucket, dtype_name, fingerprint)``.
    Non-sort cells (``moe/E<e>k<k>|...``) raise ``ValueError``.

    >>> parse_plan_key(plan_key(3000, torch.int32, fingerprint="cpu/x=8"))
    (4096, 'int32', 'cpu/x=8')
    """
    parts = key.split("|")
    if len(parts) != 3 or not parts[0].isdigit():
        raise ValueError(f"not a sort plan-cache key: {key!r}")
    bucket, dtype_name_, fp = parts
    return int(bucket), dtype_name_, fp


def plan_from_strategy(strategy: str, *, n_threads: int = 8) -> SortPlan:
    """Map the public api.py strategy names onto plans.

    >>> plan_from_strategy("shared_merge").local_impl
    'merge'
    >>> plan_from_strategy("shared").strategy
    'shared'
    """
    table = {
        "shared": SortPlan("shared", local_impl="xla", n_threads=n_threads),
        "shared_merge": SortPlan("shared", local_impl="merge", n_threads=n_threads),
        "shared_hybrid": SortPlan("shared", local_impl="xla", n_threads=n_threads),
        "distributed_merge": SortPlan("distributed_merge"),
        "cluster": SortPlan("cluster"),
    }
    if strategy not in table:
        raise ValueError(f"strategy must be one of {tuple(table)}")
    return table[strategy]


def default_plan(mesh=None) -> SortPlan:
    """The pre-autotune rule: model D on a mesh, model B on one device.

    >>> default_plan().strategy
    'shared'
    """
    return SortPlan("cluster") if mesh is not None else SortPlan("shared")


def run_plan(
    plan: SortPlan,
    x: torch.Tensor,
    *,
    mesh=None,
    axis: Optional[str] = None,
    ascending: bool = True,
    **kwargs,
):
    """Execute a plan on ``x`` where it lives.  Cluster plans return
    ``(slab, valid)`` like ``cluster_sort``; mesh plans take ``mesh=`` (an
    ``AxisGroup`` or a ``ProcessGroup``) and this rank's shard.

    >>> run_plan(SortPlan("shared"), torch.tensor([3, 1, 2])).tolist()
    [1, 2, 3]
    """
    if not ascending and plan.strategy == "cluster":
        raise ValueError(
            "the cluster strategy sorts ascending only; for descending "
            "distributed sorts use sort_kv(ascending=False)"
        )
    if plan.strategy == "shared":
        return shared_memory_sort(
            x,
            n_threads=plan.n_threads,
            local_impl=plan.local_impl,
            ascending=ascending,
            block_n=plan.block_n,
        )
    if plan.strategy not in ("distributed_merge", "cluster"):
        raise ValueError(f"unknown plan strategy {plan.strategy!r}")
    if mesh is None:
        raise ValueError(f"plan strategy {plan.strategy!r} requires mesh=")
    kwargs.setdefault("local_impl", plan.local_impl)
    kwargs.setdefault("block_n", plan.block_n)
    if plan.strategy == "distributed_merge":
        out = distributed_merge_sort(x, mesh, axis, **kwargs)
        return out if ascending else torch.flip(out, dims=(-1,))
    # partitioner_mode folds the plan's partition override in
    kwargs.setdefault("mode", plan.partitioner_mode())
    kwargs.setdefault("capacity_factor", plan.capacity_factor)
    return cluster_sort(x, mesh, axis, **kwargs)


def _time_plan_reps(plan, x, mesh, axis, *, reps: int, **kwargs) -> list:
    """Per-rep host-clock timings (microseconds) after one warm-up call,
    each rep between two synchronizes of ``x``'s card."""

    def sync():
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)

    run_plan(plan, x, mesh=mesh, axis=axis, **kwargs)
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run_plan(plan, x, mesh=mesh, axis=axis, **kwargs)
        sync()
        times.append((time.perf_counter() - t0) * 1e6)
    return times


def _median(xs) -> float:
    s = sorted(xs)
    k = len(s) // 2
    return s[k] if len(s) % 2 else 0.5 * (s[k - 1] + s[k])


# ------------------------------------------------ distributed coordination ---
# A rank-coordinated sweep needs a barrier (every rank times the same
# candidate), a max over ranks (a candidate scores as its slowest rank), and
# an agreement step (every rank proceeds with rank 0's winner).

def _wire_device(g: AxisGroup) -> torch.device:
    """Where the group's collectives take tensors: the card for NCCL."""
    if dist.get_backend(g.group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _dist_barrier(g: AxisGroup) -> None:
    g.psum(torch.zeros(1, dtype=torch.int32, device=_wire_device(g)))


def _max_over_ranks(g: AxisGroup, value: float) -> float:
    """Reduce one per-rank float64 to its max over the group (a collective;
    a rank whose candidate failed contributes ``inf``)."""
    return float(g.pmax(torch.tensor([value], dtype=torch.float64, device=_wire_device(g))).item())


# the fixed wire size for the winning-plan agreement: every rank sends the
# same shape, so rank 0's JSON is zero-padded to this
_PLAN_WIRE_BYTES = 4096


def _broadcast_plan(g: AxisGroup, plan: Optional[SortPlan]) -> SortPlan:
    """Rank 0's winning plan on every rank: zero-padded JSON in a uint8
    buffer, all-gathered, row 0 decoded (JSON never contains NUL)."""
    buf = torch.zeros(_PLAN_WIRE_BYTES, dtype=torch.uint8)
    if g.rank == 0:
        if plan is None:
            raise RuntimeError("rank 0 has no winning plan to broadcast")
        payload = json.dumps(plan.to_dict()).encode()
        if len(payload) > _PLAN_WIRE_BYTES:
            raise ValueError(f"plan JSON exceeds {_PLAN_WIRE_BYTES} bytes")
        buf[: len(payload)] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    rows = g.all_gather(buf.to(_wire_device(g))).cpu()
    return SortPlan.from_dict(json.loads(bytes(rows[0].tolist()).rstrip(b"\x00").decode()))


KERNEL_BLOCK_SWEEP = (256, 512, 1024)

# A 'kernel' candidate on a CPU tensor runs the kernels' plain versions, a
# correctness path: it is swept up to this bucket and skipped above it.  On
# the card it is always timed.
KERNEL_PLAIN_MAX = 1 << 16


def candidate_plans(mesh=None, *, quick: bool = False):
    """The tuning grid: strategies x local_impl (x capacity for model D),
    the reference's list with ``'pallas'`` as ``'kernel'``, in its order.

    >>> [(p.local_impl, p.block_n) for p in candidate_plans(quick=True)]
    [('xla', None), ('merge', None), ('kernel', 256)]
    """
    impls = ("xla", "merge") if quick else tuple(i for i in LOCAL_SORTS if i != "kernel")
    cands = [SortPlan("shared", local_impl=i) for i in impls]
    blocks = KERNEL_BLOCK_SWEEP[:1] if quick else KERNEL_BLOCK_SWEEP
    cands += [SortPlan("shared", local_impl="kernel", block_n=b) for b in blocks]
    if mesh is not None:
        cands += [SortPlan("distributed_merge", local_impl="xla")]
        cfs = (2.0,) if quick else (1.5, 2.0)
        modes = ("splitters", "sample") if quick else ("splitters", "sample", "radix")
        cands += [
            SortPlan("cluster", local_impl="xla", capacity_factor=cf, mode=md)
            for cf in cfs
            for md in modes
        ]
    return cands


class Planner:
    """Plan table: lookup tuned plans, autotune missing cells, persist JSON.

    Beyond the tuned-plan table, the planner closes the capacity-learning
    loop: ``recorder`` hands ``cluster_sort`` / ``cluster_sort_kv`` a
    telemetry callback bound to a plan-cache key, ``observe_exchange`` folds
    each observation into a learned per-key ``capacity_factor``, and
    ``plan_for`` serves cluster plans with the learned factor applied.

    ``device`` is where ``autotune`` places its keys (the card when None)
    and whose fingerprint keys a lookup that names no device; a CUDA device
    with no card raises here.

    >>> Planner(device="cpu").plan_for(1000, torch.int32).strategy   # untuned
    'shared'
    """

    def __init__(
        self,
        path: Optional[str] = None,
        *,
        learned_scope: Optional[str] = None,
        device=None,
    ):
        scope = learned_scope or os.environ.get("REPRO_LEARNED_SCOPE", "global")
        if scope not in LEARNED_SCOPES:
            raise ValueError(f"learned_scope must be one of {LEARNED_SCOPES}")
        self.device = None if device is None else check_device(device)
        self.path = path
        self.learned_scope = scope
        self.plans: Dict[str, SortPlan] = {}
        self.telemetry = ExchangeTelemetry()
        self.learner = CapacityLearner()
        self.learned: Dict[str, LearnedCapacity] = {}
        # services register their stats here so overflow retries observed on
        # the exchange path surface in serving telemetry
        self._stats_sinks: list = []
        self._lock = threading.Lock()
        if path and os.path.exists(path):
            self.load(path)

    def _device_for(self, device):
        return self.device if device is None else device

    # ------------------------------------------------------------ storage ---
    @staticmethod
    def _parse_doc(doc) -> tuple:
        """Validate one plan-cache JSON document -> (plans, learned); the
        reference's ``'pallas'`` plans come back as ``'kernel'``."""
        if doc.get("version") not in _LOADABLE_VERSIONS:
            raise ValueError(f"plan cache version {doc.get('version')!r} unsupported")
        raw = doc["plans"]
        if not isinstance(raw, dict):
            raise ValueError("'plans' must be an object")
        plans = {}
        for k, v in raw.items():
            if not isinstance(v, dict):
                raise ValueError(f"plan entry {k!r} is not an object")
            plan = plan_from_reference(v)  # unknown fields: forward-compat
            if plan.strategy not in _PLAN_STRATEGIES:
                raise ValueError(f"plan entry {k!r} has unknown strategy {plan.strategy!r}")
            if plan.partition is not None and plan.partition not in PARTITION_MODES:
                raise ValueError(f"plan entry {k!r} has unknown partition {plan.partition!r}")
            plans[k] = plan
        raw_learned = doc.get("learned", {})  # absent in v1 files
        if not isinstance(raw_learned, dict):
            raise ValueError("'learned' must be an object")
        learned = {}
        for k, v in raw_learned.items():
            if not isinstance(v, dict) or "capacity_factor" not in v:
                raise ValueError(f"learned entry {k!r} is malformed")
            learned[k] = LearnedCapacity.from_dict(v)
        return plans, learned

    @staticmethod
    def _merge_learned(
        mine: Dict[str, LearnedCapacity], theirs: Dict[str, LearnedCapacity]
    ) -> Dict[str, LearnedCapacity]:
        """Union two learned tables; shared keys merge via
        ``LearnedCapacity.merge`` (commutative and idempotent)."""
        out = dict(theirs)
        for k, entry in mine.items():
            other = out.get(k)
            out[k] = entry.merge(other) if other is not None else entry
        return out

    def load(self, path: str, *, strict: bool = False) -> "Planner":
        """Load a plan-cache file.  A corrupt file, an unknown version or a
        malformed entry warns and keeps the current table (``strict=True``
        re-raises).  ``plans`` are replaced (the file is the tuning
        authority); the ``learned`` section merges into memory."""
        try:
            with open(path) as f:
                doc = json.load(f)
            plans, learned = self._parse_doc(doc)
        except Exception as e:
            if strict:
                raise
            warnings.warn(
                f"ignoring unreadable plan cache {path!r} ({e}); "
                f"keeping the {len(self.plans)} previously loaded plan(s)",
                RuntimeWarning,
                stacklevel=2,
            )
            return self
        with self._lock:
            self.plans = plans
            self.learned = self._merge_learned(self.learned, learned)
        return self

    def save(self, path: Optional[str] = None) -> str:
        """Persist plans + learned state: a read-merge-write under an
        advisory ``fcntl`` lock (``<path>.lock``), then an atomic
        ``os.replace``.  Concurrent writers (threads, processes, ranks) never
        clobber each other."""
        path = path or self.path
        if path is None:
            raise ValueError("no path given and Planner has no default path")
        with self._lock:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            with _plan_file_lock(path):
                disk_plans: Dict[str, SortPlan] = {}
                disk_learned: Dict[str, LearnedCapacity] = {}
                if os.path.exists(path):
                    try:
                        with open(path) as f:
                            disk_plans, disk_learned = self._parse_doc(json.load(f))
                    except Exception:
                        # a rotted file must not block persisting fresh state
                        disk_plans, disk_learned = {}, {}
                plans = {**disk_plans, **self.plans}  # ours win shared keys
                learned = self._merge_learned(self.learned, disk_learned)
                doc = {
                    "version": _PLAN_VERSION,
                    "plans": {k: p.to_dict() for k, p in sorted(plans.items())},
                    "learned": {k: c.to_dict() for k, c in sorted(learned.items())},
                }
                # per-pid tmp name: two writers never rename one tmp file
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(doc, f, indent=1)
                os.replace(tmp, path)
            self.path = self.path or path
        return path

    # ------------------------------------------------------------- lookup ---
    def lookup(self, n: int, dtype, mesh=None, *, device=None) -> Optional[SortPlan]:
        return self.plans.get(plan_key(n, dtype, mesh, device=self._device_for(device)))

    def warmup_cells(self, mesh=None, *, device=None):
        """The (size_bucket, dtype name) cells this plan table names for the
        given fingerprint — tuned plans and learned cells alike; non-sort
        keys are skipped.

        >>> p = Planner(device="cpu")
        >>> p.plans["4096|int32|local/cpu"] = SortPlan("shared")
        >>> p.plans["moe/E8k2|256|float32|local/cpu"] = SortPlan()
        >>> p.warmup_cells()
        [(4096, 'int32')]
        """
        fp = mesh_fingerprint(mesh, device=self._device_for(device))
        my_suffix = f"@h{_rank()}"  # per_host-scoped learned keys
        cells = set()
        for key in list(self.plans) + list(self.learned):
            if key.endswith(my_suffix):
                key = key[: -len(my_suffix)]
            parts = key.split("|")
            if len(parts) != 3 or not parts[0].isdigit():
                continue  # MoE dispatch cells and future non-sort keys
            bucket, dtype_name_, key_fp = parts
            if key_fp == fp:
                cells.add((int(bucket), dtype_name_))
        return sorted(cells)

    def plan_for(self, n: int, dtype, mesh=None, *, device=None) -> SortPlan:
        """Tuned plan if one exists, else the default rule — with the learned
        capacity factor and the skew-promotion latch folded into cluster
        plans."""
        plan = self.lookup(n, dtype, mesh, device=device) or default_plan(mesh)
        if plan.strategy == "cluster":
            key = plan_key(n, dtype, mesh, device=self._device_for(device))
            promoted, _ = self.promotion_state(key)
            if promoted == "sample" and plan.effective_partition() == "radix":
                plan = replace(plan, partition="sample")
            cf = self.capacity_factor_for(key, default=plan.capacity_factor)
            if cf != plan.capacity_factor:
                plan = replace(plan, capacity_factor=cf)
        return plan

    # -------------------------------------------------- capacity learning ---
    def scoped_key(self, key: str) -> str:
        """Apply the learned-factor scope policy: ``global`` leaves the key,
        ``per_host`` suffixes ``@h<rank>`` (the default group's rank)."""
        if self.learned_scope == "per_host":
            return f"{key}@h{_rank()}"
        return key

    def capacity_factor_for(self, key: str, default: float = 2.0) -> float:
        """The learned capacity factor for a plan-cache key (``default``
        until telemetry for that key has taught otherwise)."""
        key = self.scoped_key(key)
        with self._lock:
            entry = self.learned.get(key)
        return entry.capacity_factor if entry is not None else default

    def promotion_state(self, key: str) -> tuple:
        """``(partition, skew_strikes)`` of a key's learned entry; ``(None,
        0)`` until the key has radix-skew history."""
        key = self.scoped_key(key)
        with self._lock:
            entry = self.learned.get(key)
        if entry is None:
            return (None, 0)
        return (entry.partition, entry.skew_strikes)

    # persistence debounce: a learned-factor move below this fraction of the
    # default stays in memory only
    _SAVE_REL_DELTA = 0.05

    def observe_exchange(
        self, key: str, obs: ExchangeObservation, *, default: float = 2.0
    ) -> LearnedCapacity:
        """Fold one exchange observation into the learned table (and the
        telemetry ledger); persist when the planner has a file and the
        learned state moved materially."""
        with span("repro_torch.planner.observe"):
            key = self.scoped_key(key)
            self.telemetry.record(key, obs)
            with self._lock:
                prev = self.learned.get(key)
                prev_cf = prev.capacity_factor if prev else default
                cf = self.learner.update(prev_cf, obs, default=default)
                prev_part = prev.partition if prev else None
                strikes = self.learner.promotion_strikes(prev.skew_strikes if prev else 0, obs)
                part = prev_part
                calm = prev.calm_streak if prev else 0
                demotions = prev.demotions if prev else 0
                if part != "sample" and self.learner.should_promote(strikes):
                    part = "sample"  # the latch
                    calm = 0
                elif part == "sample":
                    # promoted cell on probation: long calm stretches demote it
                    calm = self.learner.calm_streak(calm, obs)
                    if self.learner.should_demote(calm, demotions):
                        part, strikes, calm = None, 0, 0
                        demotions += 1
                entry = LearnedCapacity(
                    capacity_factor=cf,
                    peak_factor=max(prev.peak_factor if prev else 0.0, obs.required_factor()),
                    observations=(prev.observations if prev else 0) + 1,
                    partition=part,
                    skew_strikes=strikes,
                    calm_streak=calm,
                    demotions=demotions,
                )
                self.learned[key] = entry
                changed = part != prev_part or (
                    cf != prev_cf
                    and (
                        abs(cf - prev_cf) >= self._SAVE_REL_DELTA * default
                        or cf == default  # the decay's landing point: worth a write
                    )
                )
                self._stats_sinks = [r for r in self._stats_sinks if r() is not None]
                sinks = list(self._stats_sinks)
            for ref in sinks:
                svc = ref()
                if svc is not None:
                    svc._note_exchange(obs)
            if changed and self.path:
                self.save()
            return entry

    def exchange_recorder(self, key: str, *, default: float = 2.0):
        """A telemetry callback bound to this planner and a plan-cache key."""

        def record(**kwargs) -> None:
            self.observe_exchange(key, ExchangeObservation(**kwargs), default=default)

        return record

    def recorder(self, n: int, dtype, mesh=None, *, default: float = 2.0, device=None):
        """A telemetry callback for ``cluster_sort(telemetry=...)`` bound to
        the (n, dtype, mesh) plan-cache key.  On a mesh ``n`` is the global
        length (every rank's shard together)."""
        key = plan_key(n, dtype, mesh, device=self._device_for(device))
        return self.exchange_recorder(key, default=default)

    def cluster_kwargs(
        self,
        n: int,
        dtype,
        mesh=None,
        *,
        default: Optional[float] = None,
        mode: Optional[str] = None,
        device=None,
    ) -> dict:
        """The ``capacity_factor=`` / ``telemetry=`` kwargs that close the
        capacity-learning loop for one cluster call (``n`` is the global
        length).  ``default`` is the learner's floor (a tuned cluster plan's
        own factor when omitted).  With no caller ``mode`` and a promoted
        cell, ``"mode": "sample"`` is added and the floor drops to
        ``SAMPLE_DEFAULT_FACTOR``."""
        device = self._device_for(device)
        if default is None:
            base = self.lookup(n, dtype, mesh, device=device)
            default = (
                base.capacity_factor
                if base is not None and base.strategy == "cluster"
                else SortPlan.capacity_factor
            )
        key = plan_key(n, dtype, mesh, device=device)
        out = {}
        if mode is None:
            promoted, _ = self.promotion_state(key)
            if promoted == "sample":
                out["mode"] = "sample"
                default = min(default, SAMPLE_DEFAULT_FACTOR)
        out["capacity_factor"] = self.capacity_factor_for(key, default=default)
        out["telemetry"] = self.recorder(n, dtype, mesh, default=default, device=device)
        return out

    def add_stats_sink(self, service) -> None:
        """Register a service whose stats should see exchange retry counts
        (held weakly)."""
        with self._lock:
            self._stats_sinks.append(weakref.ref(service))

    # ----------------------------------------------------------- autotune ---
    # True iff the last autotune call persisted the plan file from this
    # process (rank 0 in a coordinated sweep)
    last_autotune_wrote: bool = False
    # every candidate the last autotune call timed, with its us_per_call
    last_autotune_candidates: tuple = ()

    def autotune(
        self,
        n: int,
        dtype=torch.int32,
        *,
        mesh=None,
        axis: Optional[str] = None,
        reps: int = 3,
        quick: bool = False,
        seed: int = 0,
        save: bool = True,
        distributed: Optional[bool] = None,
        candidates=None,
        on_candidate=None,
        device=None,
        **kwargs,
    ) -> SortPlan:
        """Microbenchmark every candidate on synthetic keys; persist winner.

        Timed at the size bucket (next pow2 of ``n``) on ``device`` (the
        planner's, else the card).  With ``mesh=`` each rank times its
        ``nb / P`` shard for the mesh candidates and the whole bucket for
        the one-device ones.  ``distributed=None`` coordinates the sweep
        when the group (``mesh``, else the default group) has more than one
        rank.  A candidate that raises fails the sweep: on a group every
        rank first owes the max-reduction its score (``inf``), then every
        rank raises, the failing one with its own error.  ``'kernel'``
        candidates on a CPU device are skipped above ``KERNEL_PLAIN_MAX``.
        ``candidates=`` substitutes an explicit plan list; ``on_candidate(i,
        plan)`` runs before each candidate is timed, and
        ``last_autotune_candidates`` keeps every timed one with its
        ``us_per_call``.
        """
        dev = check_device(device if device is not None else (self.device or "cuda"))
        group = as_axis_group(mesh) if mesh is not None else None
        coord = group
        if coord is None and dist.is_available() and dist.is_initialized():
            coord = AxisGroup()
        if distributed is None:
            distributed = coord is not None and coord.size > 1
        if distributed and coord is None:
            raise ValueError("a distributed autotune needs an initialised process group")
        nb = next_pow2(n)
        keys = np.random.default_rng(seed).integers(100, 1000, size=nb).astype("int64")
        tdtype = getattr(torch, dtype_name(dtype))
        x = torch.from_numpy(keys).to(device=dev, dtype=tdtype)
        x_mesh = x
        if group is not None:
            if nb % group.size:
                raise ValueError(f"axis size {group.size} must divide the size bucket {nb}")
            m = nb // group.size
            x_mesh = x[group.rank * m:(group.rank + 1) * m].clone()
        key = plan_key(nb, dtype, mesh, device=dev)
        cands = candidate_plans(mesh, quick=quick) if candidates is None else list(candidates)
        best, timed = None, []
        for i, cand in enumerate(cands):
            if cand.local_impl == "kernel" and dev.type == "cpu" and nb > KERNEL_PLAIN_MAX:
                continue  # the plain versions: a correctness path, not timeable
            if on_candidate is not None:
                on_candidate(i, cand)
            if distributed:
                _dist_barrier(coord)
            arr = x if cand.strategy == "shared" else x_mesh
            failure = None
            try:
                times = _time_plan_reps(cand, arr, mesh, axis, reps=reps, **kwargs)
                us = _median(times) if distributed else sum(times) / len(times)
            except Exception as e:
                if not distributed:
                    raise
                failure, us = e, float("inf")  # the reduction still needs this rank
            if distributed:
                us = _max_over_ranks(coord, us)
                if failure is not None:
                    raise failure
                if us == float("inf"):
                    raise RuntimeError(f"autotune: candidate {cand} failed on another rank ({key})")
            cand = replace(cand, us_per_call=round(us, 2))
            timed.append(cand)
            if best is None or cand.us_per_call < best.us_per_call:
                best = cand
        if best is None:
            raise RuntimeError(f"autotune: no timeable candidate for {key}")
        if distributed:
            best = _broadcast_plan(coord, best)
        self.plans[key] = best
        self.last_autotune_candidates = tuple(timed)
        self.last_autotune_wrote = False
        if save and self.path:
            if not distributed or coord.rank == 0:
                self.save()
                self.last_autotune_wrote = True
            if distributed:
                # hold every rank until the winner is on disk
                _dist_barrier(coord)
        return best


_DEFAULT: Optional[Planner] = None


def default_planner() -> Planner:
    """Process-wide planner; honours $REPRO_SORT_PLANS as its backing file.

    >>> default_planner() is default_planner()   # one table per process
    True
    """
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Planner(os.environ.get("REPRO_SORT_PLANS"))
    return _DEFAULT


def autotune(n: int, dtype=torch.int32, **kwargs) -> SortPlan:
    """Module-level convenience: autotune into the default planner.

    >>> autotune(64, reps=1, quick=True, save=False, device="cpu").strategy
    'shared'
    """
    return default_planner().autotune(n, dtype, **kwargs)
