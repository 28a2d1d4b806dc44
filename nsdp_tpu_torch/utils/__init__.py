"""Host-side helpers of the port: config loading, query bucketing, weight
carry-over from the JAX package's variables, and what the evaluation entry
points use: mesh IO, metrics, output writers, error colormaps, logging."""
