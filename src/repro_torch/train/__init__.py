"""Serving steps (torch): prefill and decode; the training steps wait for the training slice."""
