"""Coordinator for the port's multi-process tests: real ``torch.distributed``
gloo ranks, with crash and hang containment.

The port's counterpart of ``tests/multihost/harness.py``.  ``run_multihost``
starts ``nprocs`` fresh interpreters (``_torch_multihost_worker.py``), each
one rank of a gloo group that meets through a ``FileStore`` in the run's
report directory (no TCP port, so parallel test workers never collide),
runs one *body* of ``_torch_multihost_bodies.py`` in every rank, and
collects per-rank JSON reports back over files.

* **Isolation** - the pytest process never joins a process group; every run
  gets fresh interpreters.
* **Crash containment** - a rank that dies would leave its peers inside a
  collective.  The coordinator polls; once one rank has failed, the rest get
  ``GRACE_AFTER_FAILURE_S`` to finish and are then terminated (killed 3 s
  later).  A hung run is killed at ``timeout`` seconds.  Either way the
  test fails with per-rank diagnostics; the pytest run never hangs.
* **Reports** - each rank writes ``report-<rank>.json`` atomically (tmp
  file, then ``os.replace``), in the reference's schema
  (``validate_report_doc``).  ``$REPRO_MULTIHOST_REPORT_DIR`` keeps them;
  otherwise they land in a throwaway tempdir.

``args["device"]`` (``"cpu"`` by default) is where the body works;
``"cuda"`` puts every rank on card 0 (gloo stages CUDA tensors through host
memory, so several ranks share one card) and fails where there is no card.
``args["gloo_timeout_s"]`` bounds every collective
(``init_process_group(timeout=)``); the ranks first meet on the store under
its own long timeout, so a slow start never fails the group's init.  A
report says whether its rank joined the group (``joined``), and a rank that
reaches an injected fault leaves ``fault-<rank>.reached`` beside the
reports (``MultihostRun.fault_reached``).

``run_single`` runs the same body on one rank: the within-port bit-identity
oracle, as ``run_forced_mesh`` is the reference's.  ``run_together`` starts
a test file's runs (the port's and the reference's) at once.  ``contain`` is
the polling loop, shared with ``_torch_ranks.run_port``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "_torch_multihost_worker.py")

DEFAULT_TIMEOUT_S = 240.0
# once one rank has failed, how long the surviving ranks get to exit on
# their own before the coordinator terminates them (they are usually stuck
# in a collective whose peer no longer exists)
GRACE_AFTER_FAILURE_S = 8.0
_STDIO_TAIL = 4000  # chars of stdout/stderr kept per rank in the report


def validate_report_doc(doc: Any) -> dict:
    """Validate one per-rank report document against the report schema.

    ``rank``/``ok``/``result``/``error`` always present, a non-negative int
    rank, a bool ``ok``, ``error``/``traceback`` null or strings,
    ``duration_s`` null or a number, ``returncode`` null or an int, a failed
    report carrying an error, and the whole document JSON-serializable.
    Returns the document; raises ``ValueError`` on any violation.
    """
    if not isinstance(doc, dict):
        raise ValueError(f"report must be an object, got {type(doc).__name__}")
    missing = {"rank", "ok", "result", "error"} - set(doc)
    if missing:
        raise ValueError(f"report missing fields: {sorted(missing)}")
    rank = doc["rank"]
    if not isinstance(rank, int) or isinstance(rank, bool) or rank < 0:
        raise ValueError(f"rank must be a non-negative int: {rank!r}")
    if not isinstance(doc["ok"], bool):
        raise ValueError(f"ok must be a bool: {doc['ok']!r}")
    for key in ("error", "traceback"):
        if doc.get(key) is not None and not isinstance(doc[key], str):
            raise ValueError(f"{key} must be null or a string: {doc[key]!r}")
    dur = doc.get("duration_s")
    if dur is not None and (isinstance(dur, bool) or not isinstance(dur, (int, float))):
        raise ValueError(f"duration_s must be null or a number: {dur!r}")
    rc = doc.get("returncode")
    if rc is not None and (isinstance(rc, bool) or not isinstance(rc, int)):
        raise ValueError(f"returncode must be null or an int: {rc!r}")
    if not doc["ok"] and doc["error"] is None:
        raise ValueError("a failed report must carry an error")
    try:
        json.dumps(doc)
    except (TypeError, ValueError) as e:
        raise ValueError(f"report is not JSON-serializable: {e}") from None
    return doc


@dataclass
class RankReport:
    """One rank's outcome: its JSON report plus process-level diagnostics."""

    rank: int
    ok: bool
    result: Any = None
    error: Optional[str] = None
    traceback: Optional[str] = None
    returncode: Optional[int] = None
    duration_s: Optional[float] = None
    joined: bool = False  # the rank reported that it had joined the gloo group
    stdout: str = ""
    stderr: str = ""

    def to_doc(self) -> dict:
        """This report as a schema-valid JSON document, alike for ranks that
        reported themselves and ranks the coordinator synthesized after they
        died (stdio tails are diagnostics, not part of the schema)."""
        return {
            "rank": self.rank,
            "ok": self.ok,
            "result": self.result,
            "error": self.error,
            "traceback": self.traceback,
            "returncode": self.returncode,
            "duration_s": self.duration_s,
            "joined": self.joined,
        }

    def summary(self) -> str:
        status = "ok" if self.ok else f"FAILED (rc={self.returncode})"
        lines = [f"rank {self.rank}: {status}"]
        if self.error:
            lines.append(f"  error: {self.error}")
        if self.traceback:
            lines.append("  " + self.traceback.strip().replace("\n", "\n  "))
        if not self.ok and self.stderr:
            lines.append("  stderr tail:")
            lines.append("  " + self.stderr.strip().replace("\n", "\n  "))
        return "\n".join(lines)


@dataclass
class MultihostRun:
    """Everything one ``run_multihost`` call produced."""

    nprocs: int
    reports: List[RankReport] = field(default_factory=list)
    timed_out: bool = False
    wall_s: float = 0.0
    report_dir: str = ""
    # seconds from the start to the first rank's non-zero exit (None: none)
    first_failure_s: Optional[float] = None

    @property
    def ok(self) -> bool:
        return (
            not self.timed_out
            and len(self.reports) == self.nprocs
            and all(r.ok for r in self.reports)
        )

    def result(self, rank: int = 0) -> Any:
        """The body's return value on ``rank`` (requires that rank succeeded)."""
        report = self.reports[rank]
        assert report.ok, self.describe()
        return report.result

    def results(self) -> List[Any]:
        return [self.result(r) for r in range(self.nprocs)]

    def describe(self) -> str:
        head = (
            f"multihost run: nprocs={self.nprocs} ok={self.ok} "
            f"timed_out={self.timed_out} wall={self.wall_s:.1f}s "
            f"reports in {self.report_dir}"
        )
        return "\n".join([head] + [r.summary() for r in self.reports])

    def require_success(self) -> "MultihostRun":
        assert self.ok, self.describe()
        return self

    def fault_reached(self, rank: int) -> Optional[str]:
        """The fault point ``rank`` reached before its injected fault fired,
        or None if it never reached one."""
        try:
            with open(os.path.join(self.report_dir, f"fault-{rank}.reached")) as f:
                return json.load(f)
        except OSError:
            return None


def rank_env(env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """A rank's environment: the port on ``PYTHONPATH``, gloo on loopback."""
    out = dict(os.environ)
    out["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + out["PYTHONPATH"] if out.get("PYTHONPATH") else ""
    )
    out.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if env:
        out.update(env)
    return out


def _read_tail(path: str) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-_STDIO_TAIL:]
    except OSError:
        return ""


def _terminate(procs: List[subprocess.Popen]) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + 3.0
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def contain(procs: List[subprocess.Popen], timeout: float):
    """Poll ``procs`` until all exit, or until ``GRACE_AFTER_FAILURE_S``
    after the first non-zero exit, or until ``timeout`` seconds; terminate
    whatever still runs.  Returns ``(timed_out, first_failure_s)``: whether
    the run hit ``timeout``, and when (seconds after the call) the first
    non-zero exit was seen, or None."""
    t0 = time.monotonic()
    first_failure: Optional[float] = None
    while True:
        codes = [p.poll() for p in procs]
        now = time.monotonic()
        if first_failure is None and any(c not in (None, 0) for c in codes):
            first_failure = now - t0
        if all(c is not None for c in codes):
            return False, first_failure
        if now - t0 >= timeout:
            _terminate(procs)
            return True, first_failure
        if first_failure is not None and now - t0 - first_failure > GRACE_AFTER_FAILURE_S:
            _terminate(procs)
            return False, first_failure
        time.sleep(0.05)


def _report_dir() -> str:
    base = os.environ.get("REPRO_MULTIHOST_REPORT_DIR")
    if base:
        os.makedirs(base, exist_ok=True)
        return tempfile.mkdtemp(prefix="run-", dir=base)
    return tempfile.mkdtemp(prefix="repro-torch-multihost-")


def _collect(rank: int, p: subprocess.Popen, report_dir: str, timed_out: bool,
             timeout: float) -> RankReport:
    report = RankReport(
        rank=rank,
        ok=False,
        returncode=p.poll(),
        stdout=_read_tail(os.path.join(report_dir, f"stdout-{rank}.log")),
        stderr=_read_tail(os.path.join(report_dir, f"stderr-{rank}.log")),
    )
    rpath = os.path.join(report_dir, f"report-{rank}.json")
    if os.path.exists(rpath):
        try:
            with open(rpath) as f:
                doc = validate_report_doc(json.load(f))
        except (OSError, ValueError) as e:  # an unreadable or invalid report fails the rank
            report.error = f"unreadable report: {e!r}"
            return report
        report.ok = doc["ok"] and p.poll() == 0
        report.result = doc.get("result")
        report.error = doc.get("error")
        report.traceback = doc.get("traceback")
        report.duration_s = doc.get("duration_s")
        report.joined = bool(doc.get("joined"))
        if not report.ok and report.error is None:
            # the rank said ok but its process still died (rc != 0)
            report.error = f"rank reported ok but exited rc={p.poll()}"
    elif timed_out:
        report.error = f"no report: run exceeded {timeout:.0f}s timeout"
    elif p.poll() not in (0, None):
        report.error = f"process died with rc={p.poll()} before reporting"
    else:
        report.error = "process exited without writing a report"
    return report


def run_multihost(
    spec: str,
    nprocs: int,
    *,
    args: Optional[dict] = None,
    timeout: float = DEFAULT_TIMEOUT_S,
    env: Optional[Dict[str, str]] = None,
) -> MultihostRun:
    """Run body ``spec`` (``"<file.py>:<function>"``, file relative to this
    directory) in ``nprocs`` gloo ranks.  Returns a ``MultihostRun``; call
    ``require_success()`` for an assert with per-rank diagnostics."""
    report_dir = _report_dir()
    store = os.path.join(report_dir, "store")
    wenv = rank_env(env)
    procs: List[subprocess.Popen] = []
    t0 = time.monotonic()
    for rank in range(nprocs):
        cmd = [
            sys.executable, WORKER,
            "--spec", spec,
            "--rank", str(rank),
            "--nprocs", str(nprocs),
            "--store", store,
            "--report", os.path.join(report_dir, f"report-{rank}.json"),
            "--args-json", json.dumps(args or {}),
        ]
        with open(os.path.join(report_dir, f"stdout-{rank}.log"), "w") as out_f, \
                open(os.path.join(report_dir, f"stderr-{rank}.log"), "w") as err_f:
            procs.append(subprocess.Popen(cmd, env=wenv, stdout=out_f, stderr=err_f, cwd=REPO))
    timed_out, first_failure_s = contain(procs, timeout)
    run = MultihostRun(nprocs=nprocs, timed_out=timed_out, wall_s=time.monotonic() - t0,
                       report_dir=report_dir, first_failure_s=first_failure_s)
    run.reports = [_collect(rank, p, report_dir, timed_out, timeout)
                   for rank, p in enumerate(procs)]
    return run


def run_single(spec: str, *, args: Optional[dict] = None,
               timeout: float = DEFAULT_TIMEOUT_S) -> MultihostRun:
    """The same body on one rank (a one-rank gloo group): the port's
    counterpart of ``run_forced_mesh``, against which a multi-rank run must
    agree bit for bit."""
    return run_multihost(spec, 1, args=args, timeout=timeout)


def run_together(calls: dict, max_workers: int = 6) -> dict:
    """``{name: zero-argument callable}`` -> ``{name: its result}``, the
    calls (each a run of processes) started at once, at most
    ``max_workers`` at a time."""
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        futures = {name: pool.submit(call) for name, call in calls.items()}
        return {name: f.result() for name, f in futures.items()}
