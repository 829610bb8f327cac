"""Fault tolerance (torch): watchdog, anomaly monitor and the recovery loop."""
