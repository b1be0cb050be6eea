"""Models of the port: the GPT-2-family causal transformer, its builder and
the JAX weight interchange."""
