"""Step functions (torch): training, prefill and decode."""
