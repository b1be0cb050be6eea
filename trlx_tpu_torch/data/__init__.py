"""Config system and data types of the port (``trlx_tpu/data``): the typed
config tree, the method registry, default presets, PPO batch types and the
builtin tokenizers."""
