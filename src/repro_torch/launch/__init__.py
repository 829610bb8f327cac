"""Drivers (torch): serving, training on one device or a mesh, and named meshes; the dry-run waits."""
