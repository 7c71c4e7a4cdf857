"""The benchmark's own code: specification, load generation, the served
program's set-up, tracing and the run of one cell."""
