"""The harness: cells and their files, the traffic generator, seeded weights,
the yardstick (peaks, operation and byte counts), tracing and the comparison
that decides ``correct``."""
