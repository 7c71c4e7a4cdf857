"""The plain reference of the benchmark: numpy and torch only, nothing of
the program or of the JAX package."""
