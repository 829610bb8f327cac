"""The port's fault-tolerance control plane (``repro_torch.distributed.fault_tolerance``):
the reference's cases on the port's watchdog, anomaly monitor and recovery
loop, fed by the port's exchange telemetry."""
import time

import pytest

from repro_torch.distributed.fault_tolerance import (
    AnomalyMonitor,
    StepTimeout,
    StepWatchdog,
    TrainingAnomaly,
    run_with_recovery,
)


def test_watchdog_passes_fast_step():
    with StepWatchdog(5.0):
        time.sleep(0.01)


def test_watchdog_raises_on_timeout():
    with pytest.raises(StepTimeout):
        with StepWatchdog(0.05):
            time.sleep(0.2)


def test_monitor_nan_loss():
    with pytest.raises(TrainingAnomaly):
        AnomalyMonitor().check({"loss": float("nan")})


def test_monitor_grad_explosion():
    with pytest.raises(TrainingAnomaly):
        AnomalyMonitor(grad_norm_limit=10).check({"loss": 1.0, "grad_norm": 100.0})


def test_monitor_overflow_patience():
    m = AnomalyMonitor(overflow_patience=3)
    m.check({"loss": 1.0, "moe_overflow": True})
    m.check({"loss": 1.0, "moe_overflow": True})
    with pytest.raises(TrainingAnomaly):
        m.check({"loss": 1.0, "moe_overflow": True})
    # streak resets on a clean step
    m2 = AnomalyMonitor(overflow_patience=2)
    m2.check({"loss": 1.0, "moe_overflow": True})
    m2.check({"loss": 1.0, "moe_overflow": False})
    m2.check({"loss": 1.0, "moe_overflow": True})  # no raise


def test_recovery_restores_and_replays():
    """A step that fails once recovers from the last checkpoint and finishes."""
    state = {"ckpt": 0, "failed": False}
    log = []

    def step(i):
        if i == 7 and not state["failed"]:
            state["failed"] = True
            return {"loss": float("nan")}
        log.append(i)
        return {"loss": 1.0}

    def save(i):
        state["ckpt"] = i

    def restore():
        return state["ckpt"]

    summary = run_with_recovery(
        n_steps=10, step_fn=step, save_fn=save, restore_fn=restore,
        checkpoint_every=5, max_restarts=2,
    )
    assert summary["steps_run"] == 10
    assert summary["restarts"] == 1
    assert 7 in log  # replayed after restore


def test_recovery_gives_up_after_max_restarts():
    def bad_step(i):
        return {"loss": float("nan")}

    with pytest.raises(TrainingAnomaly):
        run_with_recovery(
            n_steps=3, step_fn=bad_step, save_fn=lambda i: None,
            restore_fn=lambda: 0, max_restarts=2,
        )


# --- ExchangeObservation.dropped -> routing-collapse signal ----------------

def _obs(dropped=0, averted=0):
    from repro_torch.exchange.telemetry import ExchangeObservation
    return ExchangeObservation(m=64, part_buckets=4, capacity=16, peak=20,
                               overflowed=dropped > 0 or averted > 0,
                               retries=int(averted > 0), dropped=dropped,
                               dropped_averted=averted)


def test_watch_exchange_folds_served_drops_into_overflow_signal():
    from repro_torch.exchange.telemetry import ExchangeTelemetry

    led = ExchangeTelemetry()
    mon = AnomalyMonitor(overflow_patience=3).watch_exchange(led)
    # clean steps don't advance the streak
    mon.check({"loss": 1.0})
    for i in range(2):
        led.record("moe/E4k1|64|float32|local", _obs(dropped=5))
        mon.check({"loss": 1.0})
    assert mon.dropped_total == 10
    led.record("moe/E4k1|64|float32|local", _obs(dropped=1))
    with pytest.raises(TrainingAnomaly, match="tokens dropped"):
        mon.check({"loss": 1.0})


def test_watch_exchange_ignores_averted_drops():
    from repro_torch.exchange.telemetry import ExchangeTelemetry

    led = ExchangeTelemetry()
    mon = AnomalyMonitor(overflow_patience=1).watch_exchange(led)
    # the adaptive path retried loss-free: no served-output corruption,
    # so no anomaly no matter how many times it happens
    for _ in range(5):
        led.record("moe/E4k1|64|float32|local", _obs(averted=7))
        mon.check({"loss": 1.0})
    assert mon.dropped_total == 0


def test_watch_exchange_streak_resets_on_clean_step():
    from repro_torch.exchange.telemetry import ExchangeTelemetry

    led = ExchangeTelemetry()
    mon = AnomalyMonitor(overflow_patience=2).watch_exchange(led)
    led.record("k", _obs(dropped=3))
    mon.check({"loss": 1.0})       # streak 1
    mon.check({"loss": 1.0})       # clean -> reset
    led.record("k", _obs(dropped=3))
    mon.check({"loss": 1.0})       # streak 1 again, no raise
    assert mon.dropped_total == 6


def test_telemetry_subscribers_see_every_record():
    from repro_torch.exchange.telemetry import ExchangeTelemetry

    led = ExchangeTelemetry()
    seen = []
    led.subscribe(lambda key, obs: seen.append((key, obs.dropped)))
    led.record("a", _obs(dropped=2))
    led.record("b", _obs())
    assert seen == [("a", 2), ("b", 0)]
    # subscribers run outside the ledger lock: reading back must not deadlock
    led.subscribe(lambda key, obs: led.last(key))
    led.record("a", _obs(dropped=1))
    assert led.total_dropped == 3


def test_telemetry_and_monitor_survive_concurrent_observers():
    """Observations arrive from whichever thread ran the dispatch (sync
    callers, the async queue, concurrent warmups).  Subscriber delivery and
    the monitor's drop counters must not lose updates under that load."""
    import threading

    from repro_torch.exchange.telemetry import ExchangeTelemetry

    led = ExchangeTelemetry()
    mon = AnomalyMonitor(overflow_patience=10**9).watch_exchange(led)
    seen = []
    seen_lock = threading.Lock()

    def subscriber(key, obs):
        with seen_lock:
            seen.append((key, obs.dropped))

    led.subscribe(subscriber)

    n_threads, per_thread = 8, 50
    start = threading.Barrier(n_threads)

    def work(t):
        start.wait()  # maximize interleaving
        for i in range(per_thread):
            led.record(f"k{t}", _obs(dropped=1 if i % 2 == 0 else 0))

    threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()

    total = n_threads * per_thread
    drops = n_threads * (per_thread // 2)
    assert len(seen) == total, "subscriber missed records"
    assert sum(d for _, d in seen) == drops
    assert mon.dropped_total == drops, "monitor lost concurrent drop updates"
    assert led.total_dropped == drops
    assert led.calls == total
    for t in range(n_threads):
        assert led.last(f"k{t}") is not None
    # one check() drains the whole pending backlog exactly once
    mon.check({"loss": 1.0})
    mon.check({"loss": 1.0})
    assert mon.dropped_total == drops


def test_subscribers_added_mid_stream_see_only_later_records():
    from repro_torch.exchange.telemetry import ExchangeTelemetry

    led = ExchangeTelemetry()
    led.record("a", _obs(dropped=1))
    late = []
    led.subscribe(lambda key, obs: late.append(key))
    led.record("b", _obs())
    assert late == ["b"]


def test_recovery_replays_from_the_restored_step():
    """The loop resumes at the step restore returns and saves on schedule."""
    saved, ran, failed = [], [], []

    def step(i):
        if i == 5 and not failed:
            failed.append(i)
            raise TrainingAnomaly("injected")
        ran.append(i)
        return {"loss": 1.0}

    summary = run_with_recovery(
        n_steps=8, step_fn=step, save_fn=saved.append, restore_fn=lambda: max(saved),
        checkpoint_every=2,
    )
    assert summary == {"steps_run": 8, "restarts": 1, "last_metrics": {"loss": 1.0}}
    assert ran == [0, 1, 2, 3, 4, 4, 5, 6, 7]
    assert saved == [2, 4, 6, 8]
