"""Copies of the program's sound traffic and roofline arithmetic, frozen at
the commit each module names, so later changes to the program cannot move
the yardstick."""
