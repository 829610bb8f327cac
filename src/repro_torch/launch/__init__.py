"""Drivers (torch): serving and single-device training; mesh and dry-run wait."""
