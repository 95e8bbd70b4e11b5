"""The benchmark's general code: the cell spec, the traffic generator, the
records of a window, tracing and the correctness check."""
