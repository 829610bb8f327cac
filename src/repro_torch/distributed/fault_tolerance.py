"""Fault tolerance (torch): watchdog, retry-from-checkpoint, anomaly monitors.

Counterpart of ``repro/distributed/fault_tolerance.py``, which is plain
Python and numpy, so this is the same code:

* ``StepWatchdog``: a wall-clock deadline on one step.  A straggling or
  hung step raises ``StepTimeout`` instead of wedging the job; the driver
  restores the last checkpoint and continues.
* ``run_with_recovery``: the restart loop.  Run steps, checkpoint every K,
  and on ``StepTimeout`` / ``TrainingAnomaly`` restore and replay (bit-exact
  when the pipeline state is in the checkpoint).  ``max_restarts`` bounds
  flapping.
* ``AnomalyMonitor``: NaN/inf loss, exploding grad norm, and MoE capacity
  overflow (routing collapse) counters, fed also by the exchange
  telemetry's served drops (``watch_exchange`` on
  ``repro_torch.exchange.telemetry.ExchangeTelemetry``); each trips
  recovery rather than silently corrupting the run.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch


class StepTimeout(RuntimeError):
    pass


class TrainingAnomaly(RuntimeError):
    pass


class StepWatchdog:
    """Context manager enforcing a wall-clock deadline on one step."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self._timer: Optional[threading.Timer] = None
        self._expired = threading.Event()

    def __enter__(self):
        self._timer = threading.Timer(self.seconds, self._expired.set)
        self._timer.start()
        return self

    def __exit__(self, *exc):
        assert self._timer is not None
        self._timer.cancel()
        if self._expired.is_set() and exc[0] is None:
            raise StepTimeout(f"step exceeded {self.seconds}s deadline")
        return False

    @property
    def expired(self) -> bool:
        return self._expired.is_set()


@dataclass
class AnomalyMonitor:
    grad_norm_limit: float = 1e4
    overflow_patience: int = 10      # consecutive MoE-overflow steps tolerated
    _overflow_streak: int = 0
    _pending_dropped: int = 0        # served drops reported since last check()
    _dropped_total: int = 0
    # exchange observations arrive from whichever thread ran the dispatch
    # (sync callers, the async queue's dispatcher, concurrent warmups), so
    # the drop counters must not lose updates to read-modify-write races
    _drop_lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def watch_exchange(self, telemetry: Any) -> "AnomalyMonitor":
        """Subscribe to an ``ExchangeTelemetry`` ledger's observation stream
        (``repro_torch.exchange.telemetry``).

        Each ``ExchangeObservation.dropped`` (tokens the *served* MoE output
        actually lost — fixed-capacity or retry-exhausted dispatch) accrues
        into a pending counter that the next ``check`` treats as an
        ``moe_overflow`` step even when the training metrics themselves
        don't carry the flag.  Averted drops (loss-free retries) don't
        count: the routing-collapse signal is about corrupted output, not
        about retry cost.  Returns self so construction chains.
        """
        telemetry.subscribe(self._on_exchange)
        return self

    def _on_exchange(self, key: str, obs: Any) -> None:
        dropped = int(getattr(obs, "dropped", 0))
        if dropped > 0:
            with self._drop_lock:
                self._pending_dropped += dropped
                self._dropped_total += dropped

    @property
    def dropped_total(self) -> int:
        """Lifetime served-output drops seen via ``watch_exchange``."""
        with self._drop_lock:
            return self._dropped_total

    def check(self, metrics: dict) -> None:
        loss = float(metrics.get("loss", 0.0))
        if not np.isfinite(loss):
            raise TrainingAnomaly(f"non-finite loss {loss}")
        gn = float(metrics.get("grad_norm", 0.0))
        if gn > self.grad_norm_limit:
            raise TrainingAnomaly(f"grad norm {gn:.3e} above limit")
        with self._drop_lock:
            dropped, self._pending_dropped = self._pending_dropped, 0
        if bool(metrics.get("moe_overflow", False)) or dropped > 0:
            self._overflow_streak += 1
            if self._overflow_streak >= self.overflow_patience:
                raise TrainingAnomaly(
                    f"MoE capacity overflow for {self._overflow_streak} consecutive "
                    f"steps (routing collapse; {self._dropped_total} tokens dropped "
                    "from served output) — raise capacity_factor or restore"
                )
        else:
            self._overflow_streak = 0


def run_with_recovery(
    *,
    n_steps: int,
    step_fn: Callable[[int], dict],            # runs step i, returns metrics
    save_fn: Callable[[int], None],            # checkpoint at step i
    restore_fn: Callable[[], int],             # restore; returns resume step
    checkpoint_every: int = 50,
    step_deadline_s: float = 3600.0,
    max_restarts: int = 3,
    monitor: Optional[AnomalyMonitor] = None,
    agree: Optional[Callable[[bool], bool]] = None,
) -> dict:
    """The production training control loop, minus the cluster scheduler.

    ``agree(failed)`` (on a mesh: ``any_rank(group)``) turns this rank's
    verdict on a step into every rank's, so all restore together.
    Returns summary {steps_run, restarts, last_metrics}.
    """
    monitor = monitor or AnomalyMonitor()
    restarts = 0
    step = 0
    last_metrics: dict = {}
    while step < n_steps:
        failure: Optional[Exception] = None
        try:
            with StepWatchdog(step_deadline_s):
                last_metrics = step_fn(step)
            monitor.check(last_metrics)
        except (StepTimeout, TrainingAnomaly) as e:
            failure = e
        if agree is not None and agree(failure is not None) and failure is None:
            failure = TrainingAnomaly(f"another rank failed step {step}")
        if failure is None:
            step += 1
            if step % checkpoint_every == 0 or step == n_steps:
                save_fn(step)
            continue
        restarts += 1
        if restarts > max_restarts:
            raise failure
        step = restore_fn()
    return {"steps_run": step, "restarts": restarts, "last_metrics": last_metrics}


def any_rank(group, device="cpu") -> Callable[[bool], bool]:
    """``agree`` for ``run_with_recovery``: True on every rank of ``group``
    (an ``AxisGroup``) when any rank passes True.  ``device`` carries the
    flag (the card under NCCL)."""
    def agree(flag: bool) -> bool:
        return bool(group.pmax(torch.tensor([int(flag)], device=device)).item())

    return agree


def agree_metrics(metrics: dict, group, device="cpu") -> dict:
    """``metrics`` with every scalar replaced by rank 0's of ``group``, so
    every rank's monitor and capacity controller decide alike; other
    entries pass through."""
    keys = sorted(k for k, v in metrics.items() if isinstance(v, (int, float)))
    vals = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64, device=device)
    vals = group.broadcast(vals, 0).tolist()
    return {**metrics, **dict(zip(keys, vals))}
