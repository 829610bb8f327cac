"""Optimizer (torch): AdamW with int8 moments and compressed gradients."""
