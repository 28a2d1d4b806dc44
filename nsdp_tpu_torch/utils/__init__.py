"""Host-side helpers of the port: config loading, query bucketing, weight
carry-over from the JAX package's variables."""
