"""CPU tests of the benchmark: the cells at a tiny size through the plain
paths, the yardstick, the control and the faults that ``correct`` must
catch."""
