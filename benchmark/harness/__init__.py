"""The benchmark's harness: loading cells by name, the traffic generator,
weights from a seed, the timed window, the trace reduction and the
comparison with the plain reference (`reference/`)."""
