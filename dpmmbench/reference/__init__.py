"""Plain references the benchmark judges the port against.

Plain PyTorch in float64 (or in a stated lower precision for the
control).  Nothing here imports the port, JAX or the JAX package, and
nothing takes a value the port derived from its inputs: feature rows,
natural parameters, priors and sums are worked out again from the raw
points and from the port's sampled state (the draws, which no reference
can repeat).
"""
