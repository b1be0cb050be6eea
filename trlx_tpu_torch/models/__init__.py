"""Models of the port: the causal transformer families, the policy
heads, the reward model, the methods' configs and losses, the builder
(LoRA included) and the JAX weight interchange."""
