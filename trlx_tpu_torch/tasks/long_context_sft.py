"""Long-context SFT with ring-attention sequence parallelism.

Port of ``examples/long_context_sft.py``: Llama-architecture SFT on
8192-token synthetic documents over a ``parallel.sequence: 4`` mesh
(rotary positions; activations shard ``seq_length / sequence`` per
process and ring attention, ``trlx_tpu_torch/parallel/ring_attention.py``,
keeps the attention exact). ``LONG_CTX_CI=1`` runs at 512 tokens over
``sequence`` 2.

Run one process per device, ``parallel.data: -1`` taking the rest:

- on GPUs: ``torchrun --nproc_per_node 4 -m
  trlx_tpu_torch.tasks.long_context_sft``;
- on the CPU: four processes with ``TRLX_TPU_COORDINATOR=host:port``,
  ``TRLX_TPU_NUM_PROCESSES=4`` and ``TRLX_TPU_PROCESS_ID=<rank>`` (or
  torchrun's variables), each ``python -m
  trlx_tpu_torch.tasks.long_context_sft '{}' cpu`` (``gloo``).

The optional first argument is a JSON object of dot-path overrides
(``'{"train.seq_length": 16384, "parallel.sequence": 8}'``).
"""

import json
import os
import sys

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import default_sft_config


def synthetic_documents(n: int, target_chars: int, seed: int = 0):
    """Byte-tokenizer-friendly long documents with long-range structure: a
    'key' stated at the start is restated at the end, so loss on the tail
    depends on distant context."""
    import numpy as np

    rng = np.random.RandomState(seed)
    words = ["alpha", "bravo", "carbon", "delta", "ember", "falcon", "granite", "harbor"]
    docs = []
    for _ in range(n):
        key = " ".join(rng.choice(words, 3))
        body_words = rng.choice(words, max(target_chars // 7, 8))
        body = " ".join(body_words)[: max(target_chars - 2 * len(key) - 40, 0)]
        docs.append(f"KEY: {key}. {body} The key stated above was: {key}.")
    return docs


def config(hparams=None) -> TRLConfig:
    """The example's config (``LONG_CTX_CI=1``: 512 tokens, ``sequence``
    2), with ``hparams`` applied."""
    ci = os.environ.get("LONG_CTX_CI") == "1"
    seq_length = 512 if ci else 8192
    cfg = default_sft_config().evolve(
        train=dict(
            seq_length=seq_length,
            batch_size=4 if ci else 8,
            total_steps=2 if ci else 500,
            eval_interval=2 if ci else 100,
            checkpoint_interval=10_000,
            epochs=1 if ci else 100,
            checkpoint_dir="ckpts/long_context_sft",
            tracker=None if ci else "jsonl",
        ),
        # llama architecture (rotary, RMSNorm) at a small width: the point
        # is context length; max_position_embeddings covers the sequence
        model=dict(
            model_path="builtin:llama-test",
            model_extra_kwargs=dict(
                num_layers=4,
                hidden_size=256,
                num_heads=8,
                num_kv_heads=8,
                intermediate_size=512,
                max_position_embeddings=seq_length,
                # ring attention runs on the flash path: what 'auto' picks
                # on the card, and the kernels' plain versions on the CPU
                attention_impl="pallas",
            ),
        ),
        tokenizer=dict(tokenizer_path="builtin:bytes"),
        parallel=dict(data=-1, fsdp=1, model=1, sequence=2 if ci else 4),
        method=dict(gen_kwargs=dict(max_new_tokens=32, top_k=0, top_p=1.0, do_sample=True)),
    )
    if hparams:
        cfg = TRLConfig.update(cfg, hparams)
    return cfg


def main(hparams=None, device=None):
    """Train as ``examples/long_context_sft.py`` does; returns the trainer."""
    from trlx_tpu_torch import trlx

    cfg = config(hparams)
    ci = os.environ.get("LONG_CTX_CI") == "1"
    docs = synthetic_documents(64 if ci else 512, target_chars=cfg.train.seq_length - 64)
    eval_prompts = [d[: d.index(".") + 1] for d in docs[:8]]
    return trlx.train(samples=docs, eval_prompts=eval_prompts, config=cfg, device=device)


if __name__ == "__main__":
    main(json.loads(sys.argv[1]) if len(sys.argv) > 1 else None,
         sys.argv[2] if len(sys.argv) > 2 else None)
