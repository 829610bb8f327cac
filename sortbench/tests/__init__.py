"""CPU tests of the benchmark itself (names, files, arithmetic, drivers,
controls and planted faults); they need no card."""
