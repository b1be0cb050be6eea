"""Tiny Hugging Face models for the port's checkpoint tests.

Each family the port imports, built by ``transformers`` from a config with
weights seeded by ``torch.manual_seed(0)`` (the shapes of
``tests/test_models.py::_tiny_hf`` and ``tests/test_seq2seq.py::_tiny_hf``),
and the ways ``transformers`` writes a checkpoint directory
(:data:`SAVE_MODES`). ``transformers`` is the tests' oracle only: the port
reads and writes these directories without it.
"""

import numpy as np
import torch
import transformers as tf

CAUSAL_FAMILIES = ("gpt2", "llama", "gpt_neox", "gptj", "opt", "bloom", "mistral", "mixtral")
T5_VARIANTS = ("t5", "flan")
# model.safetensors, pytorch_model.bin, and each sharded behind its index
SAVE_MODES = ("safetensors", "bin", "safetensors_sharded", "bin_sharded")


def hf_config(family: str):
    """The tiny ``transformers`` config of a causal family (``llama_tied``:
    llama with tied embeddings), or of T5 (``t5``: v1.0, tied, relu;
    ``flan``: v1.1, untied, gated-gelu; ``mt5``)."""
    small = dict(vocab_size=97, hidden_size=32, num_hidden_layers=2, num_attention_heads=4)
    if family == "gpt2":
        return tf.GPT2Config(vocab_size=97, n_positions=64, n_embd=32, n_layer=2, n_head=4)
    if family in ("llama", "llama_tied"):
        return tf.LlamaConfig(**small, num_key_value_heads=2, intermediate_size=64,
                              max_position_embeddings=64,
                              tie_word_embeddings=family == "llama_tied")
    if family == "gpt_neox":
        return tf.GPTNeoXConfig(**small, intermediate_size=128, max_position_embeddings=64,
                                rotary_pct=0.25, use_parallel_residual=True)
    if family == "gptj":
        return tf.GPTJConfig(vocab_size=97, n_positions=64, n_embd=32, n_layer=2, n_head=4,
                             rotary_dim=8)
    if family == "opt":
        return tf.OPTConfig(**small, ffn_dim=128, max_position_embeddings=64,
                            word_embed_proj_dim=32)
    if family == "bloom":
        return tf.BloomConfig(vocab_size=97, hidden_size=32, n_layer=2, n_head=4)
    if family == "mistral":
        # sliding_window 8 < the tests' 12 tokens: the window is held to HF's
        return tf.MistralConfig(**small, num_key_value_heads=2, intermediate_size=64,
                                max_position_embeddings=64, sliding_window=8,
                                tie_word_embeddings=False, attn_implementation="eager")
    if family == "mixtral":
        return tf.MixtralConfig(**small, num_key_value_heads=2, intermediate_size=64,
                                max_position_embeddings=64, num_local_experts=4,
                                num_experts_per_tok=2, sliding_window=None,
                                tie_word_embeddings=False)
    t5 = dict(vocab_size=97, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_decoder_layers=2,
              num_heads=4, relative_attention_num_buckets=8,
              relative_attention_max_distance=20, dropout_rate=0.0, decoder_start_token_id=0)
    if family == "t5":
        return tf.T5Config(**t5, feed_forward_proj="relu", tie_word_embeddings=True)
    if family == "flan":
        return tf.T5Config(**t5, feed_forward_proj="gated-gelu", tie_word_embeddings=False)
    if family == "mt5":
        return tf.MT5Config(**t5)
    raise ValueError(family)


def tiny_hf(family: str):
    """A seeded tiny HF model in eval mode."""
    torch.manual_seed(0)
    cfg = hf_config(family)
    if family in ("t5", "flan", "mt5"):
        return tf.AutoModelForSeq2SeqLM.from_config(cfg).eval()
    return tf.AutoModelForCausalLM.from_config(cfg).eval()


def save(model, directory: str, mode: str) -> str:
    """``model.save_pretrained`` in one of :data:`SAVE_MODES`."""
    model.save_pretrained(directory, safe_serialization=mode.startswith("safetensors"),
                          max_shard_size="20KB" if mode.endswith("sharded") else "10GB")
    return directory


def causal_ids(vocab: int, rows: int = 2, cols: int = 12, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, vocab, (rows, cols))


def t5_inputs(vocab: int, seed: int = 0):
    """``(encoder ids, encoder mask with a padded row, decoder ids)``."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, vocab, (2, 10))
    mask = np.ones((2, 10), np.int64)
    mask[0, 7:] = 0
    return ids, mask, rs.randint(1, vocab, (2, 6))
