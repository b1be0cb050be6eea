"""Stages 2 and 3 of the TL;DR summarization RLHF recipe, through the port.

The port's version of ``examples/summarize_rlhf/train_reward_model.py``
and of ``ppo_summarize.py``'s reward model and reward function:

- **stage 2**, :func:`train_reward_model`: the pairwise reward model
  (``models/reward.py``) trained on preference pairs tokenized by
  :func:`tokenize_pairs` (right truncation; identical pairs warned about),
  batches drawn by ``np.random.RandomState(0).randint``, AdamW at the
  example's ``optax.adamw(lr)`` — weight decay 1e-4, not torch's 1e-2 —
  and the example's defaults: ``max_length`` 256, batch 8, lr 1e-5, 256
  pairs. Every parameter takes the decay, one without a gradient too (the
  untied LM head, which the reward model never runs), as in optax.
  :func:`save_reward_checkpoint` writes the port's own format: one
  ``torch.save`` of the state dict, the config's fields and the tokenizer;
- **stage 3**, :func:`load_reward_fn` (the trained model's ``end_scores``)
  and :func:`make_reward_fn` (the score minus the cached score of the
  prompt's reference summary), then PPO through ``trlx_tpu_torch.train``
  with the example's settings (:func:`ppo_config`: ``seq_length`` 256,
  batch 16, 64 rollouts in chunks of 16, 50 new tokens at top-p 0.95,
  ``num_layers_unfrozen`` 8) and its ROUGE metric.

Nothing is downloaded: the models are ``builtin:`` specs with seeded
random weights (``builtin:gpt2-small`` by default, the example's offline
choice; its GPT-J-6B reward model waits for ``models/hf_interop.py``) on
the byte tokenizer, and the data are the example's templated posts and
comparisons (copies of ``summarize_util.py``'s offline fallbacks).

Run (on the GPU, or on the device named last)::

    python -m trlx_tpu_torch.tasks.summarize_rlhf builtin:gpt2-test '{"total_steps": 8}' '{"train.total_steps": 4}' [cpu]
"""

import dataclasses
import logging
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

import trlx_tpu_torch.trlx as trlx
from trlx_tpu_torch.data.configs import TokenizerConfig, TRLConfig
from trlx_tpu_torch.data.default_configs import default_ppo_config
from trlx_tpu_torch.data.tokenizer import from_config as tokenizer_from_config
from trlx_tpu_torch.models.reward import (
    RewardModel,
    build_reward_model,
    end_scores,
    reward_loss_fn,
)
from trlx_tpu_torch.models.transformer import TransformerConfig
from trlx_tpu_torch.ops.kernel_utils import resolve_device
from trlx_tpu_torch.utils import get_optimizer

logger = logging.getLogger(__name__)

__all__ = ["load_tldr", "load_comparisons", "rouge_scores", "tokenize_pairs",
           "train_reward_model", "save_reward_checkpoint", "load_reward_checkpoint",
           "load_reward_fn", "make_reward_fn", "ppo_config", "main"]

_TOPICS = [
    ("my cat keeps knocking things off the shelf", "cat knocks things off shelves"),
    ("my neighbor plays loud music every night", "neighbor plays loud music nightly"),
    ("i burned dinner twice this week while multitasking", "multitasking ruined dinner twice"),
    ("our project deadline moved up by a month", "project deadline moved up a month"),
    ("the gym near my house closed without notice", "local gym closed suddenly"),
    ("my laptop battery dies within an hour now", "laptop battery barely lasts an hour"),
]

_FILLER = (
    "So basically what happened was that over the last few weeks things kept "
    "getting worse and I did not really know what to do about it. I talked to "
    "a few friends and got conflicting advice, and now I am posting here to "
    "get an outside perspective on the whole situation."
)


def load_tldr(n: int = 256, seed: int = 0) -> List[Dict[str, str]]:
    """``[{prompt, label}]``: templated posts and their reference summaries."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        topic, summary = _TOPICS[rng.randint(len(_TOPICS))]
        out.append({"prompt": f"SUBREDDIT: r/advice POST: {topic}. {_FILLER} TL;DR:",
                    "label": " " + summary})
    return out


def load_comparisons(n: int = 256, seed: int = 0) -> List[Dict[str, str]]:
    """``[{prompt, chosen, rejected}]``: the reference summary against a
    shuffle of filler words, on a short post (byte tokens must fit the
    pair inside small context windows)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        topic, summary = _TOPICS[rng.randint(len(_TOPICS))]
        bad = " ".join(rng.permutation(_FILLER.split()[:8]))
        out.append({"prompt": f"POST: {topic}. TL;DR:", "chosen": " " + summary,
                    "rejected": " " + bad})
    return out


def _ngrams(tokens: List[str], n: int):
    return [tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)]


def _f1(match: int, pred: int, ref: int) -> float:
    if pred == 0 or ref == 0 or match == 0:
        return 0.0
    p, r = match / pred, match / ref
    return 2 * p * r / (p + r)


def _lcs_len(a: List[str], b: List[str]) -> int:
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def rouge_scores(preds: List[str], refs: List[str]) -> Dict[str, float]:
    """Mean ROUGE-1, ROUGE-2 and ROUGE-L F1 over whitespace tokens, and
    their average."""
    r1s, r2s, rls = [], [], []
    for pred, ref in zip(preds, refs):
        pt, rt = pred.lower().split(), ref.lower().split()
        for n, acc in ((1, r1s), (2, r2s)):
            pn, rn = _ngrams(pt, n), _ngrams(rt, n)
            counts: Dict[tuple, int] = {}
            for g in rn:
                counts[g] = counts.get(g, 0) + 1
            overlap = 0
            for g in pn:
                if counts.get(g, 0) > 0:
                    counts[g] -= 1
                    overlap += 1
            acc.append(_f1(overlap, len(pn), len(rn)))
        rls.append(_f1(_lcs_len(pt, rt), len(pt), len(rt)))
    out = {"rouge1": float(np.mean(r1s) if r1s else 0.0),
           "rouge2": float(np.mean(r2s) if r2s else 0.0),
           "rougeL": float(np.mean(rls) if rls else 0.0)}
    out["rouge_avg"] = (out["rouge1"] + out["rouge2"] + out["rougeL"]) / 3
    return out


# ---------------------------------------------------------------------------
# stage 2: the reward model
# ---------------------------------------------------------------------------


def _encode_right(tokenizer, text: str, max_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """Ids (right-truncated, zero-padded) and their mask, ``[max_length]``."""
    ids = tokenizer.encode(text)[:max_length]
    out = np.zeros(max_length, np.int32)
    mask = np.zeros(max_length, np.int32)
    out[: len(ids)] = ids
    mask[: len(ids)] = 1
    return out, mask


def tokenize_pairs(comparisons, tokenizer, max_length: int) -> Dict[str, np.ndarray]:
    """Preference pairs → ``chosen_ids``, ``rejected_ids``, ``chosen_mask``
    and ``rejected_mask`` of ``[n, max_length]`` (prompt + completion,
    right truncation); warns when pairs come out identical."""
    batch: Dict[str, list] = {"chosen_ids": [], "rejected_ids": [], "chosen_mask": [],
                              "rejected_mask": []}
    identical = 0
    for c in comparisons:
        ci, cm = _encode_right(tokenizer, c["prompt"] + c["chosen"], max_length)
        ri, rm = _encode_right(tokenizer, c["prompt"] + c["rejected"], max_length)
        identical += int(np.array_equal(ci, ri))
        batch["chosen_ids"].append(ci)
        batch["rejected_ids"].append(ri)
        batch["chosen_mask"].append(cm)
        batch["rejected_mask"].append(rm)
    if identical:
        # right truncation can cut the continuations off entirely; such
        # pairs carry no signal
        logger.warning("%d/%d pairs identical after truncation to %d tokens — raise "
                       "max_length", identical, len(comparisons), max_length)
    return {k: np.stack(v) for k, v in batch.items()}


def train_reward_model(
    model_path: str = "builtin:gpt2-small",
    tokenizer_path: str = "builtin:bytes",
    max_length: int = 256,
    batch_size: int = 8,
    total_steps: int = 500,
    lr: float = 1e-5,
    n_pairs: int = 256,
    seed: int = 0,
    device: Any = None,
    model_extra_kwargs: Optional[Dict[str, Any]] = None,
    checkpoint_dir: Optional[str] = "ckpts/reward_model",
    init_hook: Optional[Callable[[RewardModel], None]] = None,
    step_hook: Optional[Callable[[int], None]] = None,
) -> Tuple[RewardModel, TransformerConfig, List[Dict[str, float]]]:
    """Stage 2: ``(model, config, per-step stats)``. ``init_hook(model)``
    runs before the first step (e.g. to load other weights),
    ``step_hook(step)`` after each; the checkpoint is written to
    ``checkpoint_dir`` unless it is None."""
    device = resolve_device(device)
    tokenizer = tokenizer_from_config(TokenizerConfig(tokenizer_path=tokenizer_path))
    model, cfg = build_reward_model(model_path, seed=seed, device=device,
                                    **(model_extra_kwargs or {}))
    if init_hook is not None:
        init_hook(model)
    if max_length > cfg.max_position_embeddings:
        logger.warning("max_length %d exceeds the model's position table (%d); clamping",
                       max_length, cfg.max_position_embeddings)
        max_length = cfg.max_position_embeddings
    pairs = tokenize_pairs(load_comparisons(n_pairs, seed=0), tokenizer, max_length)
    # optax.adamw(lr): b1 0.9, b2 0.999, eps 1e-8 and weight decay 1e-4
    optimizer = get_optimizer("adamw", dict(lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                            weight_decay=1e-4), model.parameters())
    n = pairs["chosen_ids"].shape[0]
    rng = np.random.RandomState(0)
    history: List[Dict[str, float]] = []
    for it in range(total_steps):
        ix = rng.randint(0, n, batch_size)
        batch = {k: torch.as_tensor(v[ix]).to(device) for k, v in pairs.items()}
        optimizer.zero_grad(set_to_none=False)
        loss, stats = reward_loss_fn(model, batch)
        loss.backward()
        for p in model.parameters():
            if p.grad is None:  # optax decays a leaf with no gradient too
                p.grad = torch.zeros_like(p)
        optimizer.step()
        history.append({k: float(v) for k, v in stats.items()})
        if step_hook is not None:
            step_hook(it)
        if it % 50 == 0:
            logger.info("step %d: loss %.4f acc %.3f", it, history[-1]["reward/loss"],
                        history[-1]["reward/accuracy"])
    if checkpoint_dir is not None:
        save_reward_checkpoint(checkpoint_dir, model, cfg, tokenizer_path)
    return model, cfg, history


def save_reward_checkpoint(directory: str, model: RewardModel, cfg: TransformerConfig,
                           tokenizer_path: str) -> None:
    """``directory/reward_model.pt``: the state dict, the config's fields
    and the tokenizer path."""
    os.makedirs(directory, exist_ok=True)
    torch.save({"state_dict": model.state_dict(),
                "config": {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)},
                "tokenizer_path": tokenizer_path},
               os.path.join(directory, "reward_model.pt"))


def load_reward_checkpoint(directory: str, device: Any = None, dtype: Any = None
                           ) -> Optional[Tuple[RewardModel, TransformerConfig, str]]:
    """``(model, config, tokenizer_path)`` of a stage-2 checkpoint on
    ``device`` (computing in ``dtype`` if given), or None when
    ``directory`` holds none."""
    path = os.path.join(directory, "reward_model.pt")
    if not os.path.exists(path):
        return None
    device = resolve_device(device)
    ckpt = torch.load(path, map_location=device, weights_only=True)
    cfg = TransformerConfig(**ckpt["config"])
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    with torch.device("meta"):
        model = RewardModel(cfg)
    model.load_state_dict(ckpt["state_dict"], assign=True)
    return model.eval().requires_grad_(False), cfg, ckpt["tokenizer_path"]


def load_reward_fn(directory: str, device: Any = None, dtype: Any = None
                   ) -> Optional[Callable[..., np.ndarray]]:
    """``score(texts, max_length=256)`` → the stage-2 model's end scores
    (``[n]`` numpy f32; texts right-truncated and zero-padded), or None
    when ``directory`` holds no checkpoint. ``dtype`` overrides the
    checkpoint's compute dtype."""
    loaded = load_reward_checkpoint(directory, device, dtype)
    if loaded is None:
        return None
    model, _, tokenizer_path = loaded
    tokenizer = tokenizer_from_config(TokenizerConfig(tokenizer_path=tokenizer_path))
    dev = next(model.parameters()).device

    @torch.no_grad()
    def score(texts: List[str], max_length: int = 256) -> np.ndarray:
        rows = [_encode_right(tokenizer, t, max_length) for t in texts]
        ids = torch.as_tensor(np.stack([r[0] for r in rows])).to(dev)
        mask = torch.as_tensor(np.stack([r[1] for r in rows])).to(dev)
        rewards = model(ids, attention_mask=mask)["rewards"]
        return end_scores(rewards, mask).cpu().numpy()

    return score


# ---------------------------------------------------------------------------
# stage 3: PPO against the reward model
# ---------------------------------------------------------------------------


def make_reward_fn(rm_score: Callable[[List[str]], np.ndarray],
                   label_by_prompt: Dict[str, str]) -> Callable[..., List[float]]:
    """The example's reward: the score of prompt + output minus the score
    of prompt + the prompt's reference summary, each baseline scored once
    and cached."""
    baseline_cache: Dict[str, float] = {}

    def reward_fn(samples, prompts, outputs, **kwargs) -> List[float]:
        scores = rm_score([p + o for p, o in zip(prompts, outputs)])
        missing = list(dict.fromkeys(p for p in prompts if p not in baseline_cache))
        if missing:
            base = rm_score([p + label_by_prompt.get(p, "") for p in missing])
            baseline_cache.update(zip(missing, np.asarray(base)))
        baselines = np.asarray([baseline_cache[p] for p in prompts])
        return list(np.asarray(scores) - baselines)

    return reward_fn


def ppo_config(model_path: str = "builtin:gpt2-small",
               hparams: Optional[Dict[str, Any]] = None) -> TRLConfig:
    """The example's PPO settings; ``hparams`` are dot-path overrides."""
    cfg = default_ppo_config().evolve(
        train=dict(seq_length=256, batch_size=16, total_steps=6000, eval_interval=200,
                   checkpoint_interval=6000, checkpoint_dir="ckpts/ppo_summarize"),
        model=dict(model_path=model_path, num_layers_unfrozen=8),
        method=dict(num_rollouts=64, chunk_size=16,
                    gen_kwargs=dict(max_new_tokens=50, top_k=0, top_p=0.95, do_sample=True)),
    )
    return TRLConfig.update(cfg, hparams) if hparams else cfg


def main(model_path: str = "builtin:gpt2-small", hparams: Optional[Dict[str, Any]] = None,
         reward_checkpoint_dir: str = "ckpts/reward_model", device: Any = None,
         **train_kwargs):
    """Stage 3 through ``trlx_tpu_torch.train``; returns the trainer. The
    reward is the stage-2 checkpoint's (:func:`make_reward_fn`), or without
    one the example's fallback, ROUGE against the reference summary."""
    rm_score = load_reward_fn(reward_checkpoint_dir, device)
    data, eval_data = load_tldr(256, seed=0), load_tldr(64, seed=1)
    label_by_prompt = {d["prompt"]: d["label"] for d in data + eval_data}
    if rm_score is not None:
        reward_fn = make_reward_fn(rm_score, label_by_prompt)
    else:
        def reward_fn(samples, prompts, outputs, **kwargs):
            return [rouge_scores([o], [label_by_prompt.get(p, "")])["rouge_avg"]
                    for p, o in zip(prompts, outputs)]

    def metric_fn(samples, prompts, outputs, **kwargs):
        refs = [label_by_prompt.get(p, "") for p in prompts]
        return {k: [v] * len(outputs) for k, v in rouge_scores(outputs, refs).items()}

    train_kwargs.setdefault("reward_fn", reward_fn)
    return trlx.train(metric_fn=metric_fn, prompts=[d["prompt"] for d in data],
                      eval_prompts=[d["prompt"] for d in eval_data],
                      config=ppo_config(model_path, hparams), device=device, **train_kwargs)


if __name__ == "__main__":
    import json
    import sys

    path = sys.argv[1] if len(sys.argv) > 1 else "builtin:gpt2-small"
    dev = sys.argv[4] if len(sys.argv) > 4 else None
    _, _, stage2 = train_reward_model(path, device=dev,
                                      **(json.loads(sys.argv[2]) if len(sys.argv) > 2 else {}))
    trainer = main(path, json.loads(sys.argv[3]) if len(sys.argv) > 3 else None, device=dev)
    print(json.dumps({"reward_accuracy": [st["reward/accuracy"] for st in stage2],
                      "ppo_reward": [st["reward/mean"] for _, st in trainer.tracker.history
                                     if "reward/mean" in st]}))
