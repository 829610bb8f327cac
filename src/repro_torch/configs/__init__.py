"""Architecture configs (torch): the ten ARCHS and their smoke-test reduction."""
