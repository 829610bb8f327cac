"""Distribution (torch): layout rules and per-rank blocks, watchdog, anomaly monitor and the recovery loop."""
