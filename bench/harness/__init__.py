"""The benchmark's general code: cells found by name, weights from the
seed, the timed window over the program, the trace, the comparison."""
