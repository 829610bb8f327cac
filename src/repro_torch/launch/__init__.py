"""Entry points (torch): serving, training on one device or a mesh, named meshes, and the production-mesh dry-run on fake tensors."""
