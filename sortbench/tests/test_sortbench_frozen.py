"""The frozen copies hold the program's sound arithmetic as it was (a test
may read the program; the benchmark's frozen copy does not)."""


def test_roofline_peak_matches_the_smoke_script():
    import ast
    import os

    from sortbench import harness
    from sortbench.frozen.roofline import HBM_BYTES_PER_S

    tree = ast.parse(open(os.path.join(harness.ROOT, "chip_smoke.py")).read())
    peak = next(node.value.value for node in tree.body if isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == "HBM_BYTES_PER_S")
    assert HBM_BYTES_PER_S == peak
