"""Drivers (torch): the serving driver; train, mesh and dry-run wait."""
