"""Checkpoints (torch): atomic, async saves in the reference's on-disk layout."""
