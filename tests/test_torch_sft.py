"""The SFT path of the port (``trlx_tpu_torch/trainer/sft.py``,
``models/sft.py``, ``ops/chunked.py``, the dialogue pipeline) against the
JAX package, on the CPU.

Inputs are made by numpy from a seed. Held:

- the loss and the chunked loss (any T, the chunk padded) on the
  next-token labels (``next_token_labels``) against JAX's
  ``SFTConfig.loss``, which shifts inside, at 1e-5 relative in f32, and
  the chunked loss's gradient against the full loss's;
- ``tokenize_dialogue`` (both truncation sides, bare strings, the eos
  rule) and ``DialogStore``'s collated batches element for element; both
  loaders shuffle with ``random.Random(seed)``, so the same store yields
  the same batches in the same order;
- ``SFTTrainer`` against the JAX ``SFTTrainer`` from the same initial
  weights (``params_from_jax``), ``logit_chunk`` 0 and 5, the port with
  ``attention_impl`` ``xla`` and ``pallas`` (the flash branch's plain
  versions): each step's loss, perplexity, learning rate and gradient
  norm at ``rtol=1e-4`` and the final weights at ``atol=1e-4``;
- ``trlx_tpu_torch.train(samples=...)`` end to end, and the settings the
  offline trainers still reject.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
from trlx_tpu.data.default_configs import default_sft_config as jax_default_sft_config
from trlx_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from trlx_tpu.models.sft import SFTConfig as JaxSFTConfig
from trlx_tpu.pipeline.offline_pipeline import DialogStore as JaxDialogStore
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPromptPipeline
from trlx_tpu.pipeline.offline_pipeline import tokenize_dialogue as jax_tokenize_dialogue
from trlx_tpu.trainer.sft import SFTTrainer as JaxSFTTrainer
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import default_sft_config
from trlx_tpu_torch.data.tokenizer import ByteTokenizer
from trlx_tpu_torch.models.sft import IGNORE_INDEX, SFTConfig, next_token_labels
from trlx_tpu_torch.models.weights import params_from_jax
from trlx_tpu_torch.pipeline.offline_pipeline import (
    DialogStore,
    PromptPipeline,
    tokenize_dialogue,
)
from trlx_tpu_torch.trainer.sft import SFTTrainer
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

RTOL, ATOL = 1e-4, 1e-4
LOSS_RTOL = 1e-5
STAT_KEYS = ("losses/loss", "losses/ppl", "learning_rate", "gradients/global_norm")


def _words(rs, lo, hi):
    return "".join(chr(c) for c in rs.randint(97, 123, size=rs.randint(lo, hi)))


def _samples(n=12, seed=0):
    """Prompt/output dialogues of varied lengths (some past seq_length, so
    truncation runs), a two-exchange dialogue and bare strings."""
    rs = np.random.RandomState(seed)
    out = [[_words(rs, 2, 9), _words(rs, 3, 16)] for _ in range(n - 3)]
    out.append([_words(rs, 2, 5), _words(rs, 2, 5), _words(rs, 2, 5), _words(rs, 2, 6)])
    out += [_words(rs, 4, 12), _words(rs, 4, 30)]
    return out


def _logits_labels(rs, B, T, V):
    logits = (rs.randn(B, T, V) * 2).astype(np.float32)
    labels = rs.randint(0, V, size=(B, T)).astype(np.int32)
    labels[:, : T // 3] = IGNORE_INDEX
    labels[0, -2:] = IGNORE_INDEX
    return logits, labels


@pytest.mark.parametrize("T", [9, 16, 23])
def test_loss_matches_jax(T):
    rs = np.random.RandomState(T)
    logits, labels = _logits_labels(rs, 3, T, 37)
    want, wstats = JaxSFTConfig().loss(jnp.asarray(logits), jnp.asarray(labels))
    got, stats = SFTConfig().loss(torch.tensor(logits), torch.tensor(next_token_labels(labels)))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    for k in ("losses/loss", "losses/ppl"):
        np.testing.assert_allclose(float(stats[k]), float(wstats[k]), rtol=LOSS_RTOL, err_msg=k)


class _Head(torch.nn.Module):
    """A model with only ``project_logits`` (a linear vocab projection)."""

    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(w)

    def project_logits(self, h):
        return h @ self.w


@pytest.mark.parametrize("T,chunk", [(9, 4), (16, 5), (23, 7), (23, 64)])
def test_chunked_loss_equals_loss(T, chunk):
    """At T not a multiple of the chunk the chunk pads; the loss and the
    gradients of the projection and of the hidden states equal the full
    loss's."""
    rs = np.random.RandomState(100 + T)
    hidden = torch.tensor(rs.randn(3, T, 8).astype(np.float32), requires_grad=True)
    w = torch.tensor(rs.randn(8, 37).astype(np.float32))
    _, labels_np = _logits_labels(rs, 3, T, 37)
    labels = torch.tensor(next_token_labels(labels_np))
    method = SFTConfig(logit_chunk=chunk)
    head = _Head(w.clone())
    full, _ = method.loss(head.project_logits(hidden), labels)
    g_full = torch.autograd.grad(full, (hidden, head.w))
    head_c = _Head(w.clone())
    chunked, stats = method.chunked_loss(head_c, hidden, labels, chunk)
    g_chunk = torch.autograd.grad(chunked, (hidden, head_c.w))
    np.testing.assert_allclose(chunked.item(), full.item(), rtol=LOSS_RTOL)
    np.testing.assert_allclose(stats["losses/ppl"].item(), float(np.exp(full.item())),
                               rtol=LOSS_RTOL)
    for a, b in zip(g_chunk, g_full):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-5)
    want, _ = JaxSFTConfig().loss(jnp.asarray((hidden @ w).detach().numpy()),
                                  jnp.asarray(labels_np))
    np.testing.assert_allclose(chunked.item(), float(want), rtol=LOSS_RTOL)


@pytest.mark.parametrize("side", ["right", "left"])
def test_tokenize_dialogue_and_store_match_jax(side):
    ours_tok, jax_tok = ByteTokenizer(), JaxByteTokenizer()
    ours_tok.truncation_side = jax_tok.truncation_side = side
    samples = _samples(16, seed=3) + [["ab", "cd" + jax_tok.eos_token], "", ["", "xyz"]]
    ours = [tokenize_dialogue(s, ours_tok, 12) for s in samples]
    theirs = [jax_tokenize_dialogue(s, jax_tok, 12) for s in samples]
    assert [[(m.is_output, tuple(m.tokens)) for m in d] for d in ours] == \
        [[(m.is_output, tuple(m.tokens)) for m in d] for d in theirs]
    assert any(sum(len(m.tokens) for m in d) == 12 for d in ours)  # truncation ran
    with pytest.raises(ValueError, match="even number"):
        tokenize_dialogue(["a", "b", "c"], ours_tok)

    store, jstore = DialogStore(ours, ours_tok), JaxDialogStore(theirs, jax_tok)
    for kw in (dict(shuffle=False), dict(shuffle=True, seed=3), dict(fixed_length=16)):
        batches = list(store.create_loader(5, **kw))
        jbatches = list(jstore.create_loader(5, **kw))
        assert len(batches) == len(jbatches) == 4
        for b, jb in zip(batches, jbatches):
            assert sorted(b) == sorted(jb)
            for k in b:
                np.testing.assert_array_equal(b[k], np.asarray(jb[k]), err_msg=k)


class _Recorder:
    def __init__(self):
        self.history = []

    def log(self, stats, step):
        self.history.append((int(step), dict(stats)))

    def finish(self):
        pass


def _config_dict(tmp, logit_chunk=0):
    d = jax_default_sft_config().to_dict()
    d["model"].update(model_path="builtin:gpt2-test")
    d["parallel"].update(compute_dtype="float32")
    d["train"].update(seq_length=24, batch_size=4, total_steps=5, epochs=10,
                      save_best=False, checkpoint_interval=1000, eval_interval=1000,
                      checkpoint_dir=str(tmp), tracker=None)
    d["method"].update(logit_chunk=logit_chunk,
                       gen_kwargs=dict(max_new_tokens=6, do_sample=False))
    # the PPO parity test's rates: Adam scales an element whose gradient is
    # f32 rounding noise near eps up to a sizeable fraction of lr, so the
    # final weights are held at atol 1e-4 after steps of lr <= 1e-3
    d["optimizer"]["kwargs"].update(lr=1e-3)
    d["scheduler"].update(name="cosine_annealing", kwargs=dict(T_max=8, eta_min=1e-4, lr=1e-3))
    return d


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


_JAX_RUNS = {}


def _jax_run(tmp_path_factory, logit_chunk):
    if logit_chunk not in _JAX_RUNS:
        config = JaxTRLConfig.from_dict(
            _config_dict(tmp_path_factory.mktemp("jax_sft"), logit_chunk))
        trainer = JaxSFTTrainer(config=config)
        params0 = _np_tree(trainer.state.params)
        trainer.tracker = _Recorder()
        trainer.make_experience(_samples(), config.train.seq_length)
        trainer.add_eval_pipeline(JaxPromptPipeline(["ab", "cde"], 18, trainer.tokenizer))
        trainer.learn()
        _JAX_RUNS[logit_chunk] = dict(params0=params0, history=trainer.tracker.history,
                                      params=_np_tree(trainer.state.params))
    return _JAX_RUNS[logit_chunk]


def _step_stats(history):
    return [(s, st) for s, st in history if "gradients/global_norm" in st]


@pytest.mark.parametrize("logit_chunk", [0, 5])
@pytest.mark.parametrize("attention_impl", ["xla", "pallas"])
def test_sft_trainer_matches_jax(tmp_path_factory, tmp_path, logit_chunk, attention_impl):
    jax_run = _jax_run(tmp_path_factory, logit_chunk)
    d = _config_dict(tmp_path, logit_chunk)
    d["model"]["model_extra_kwargs"] = {"attention_impl": attention_impl}
    config = TRLConfig.from_dict(d)
    trainer = SFTTrainer(config=config, device="cpu")
    trainer.model.load_state_dict(params_from_jax(jax_run["params0"], trainer.tcfg))
    trainer.make_experience(_samples(), config.train.seq_length)
    trainer.add_eval_pipeline(PromptPipeline(["ab", "cde"], 18, trainer.tokenizer))
    trainer.learn()

    ours, theirs = _step_stats(trainer.tracker.history), _step_stats(jax_run["history"])
    assert len(ours) == len(theirs) == config.train.total_steps
    for (s_o, st_o), (s_t, st_t) in zip(ours, theirs):
        assert s_o == s_t
        for k in STAT_KEYS:
            np.testing.assert_allclose(st_o[k], float(st_t[k]), rtol=RTOL, atol=1e-6,
                                       err_msg=f"step {s_o} {k}")
    final = params_from_jax(jax_run["params"], trainer.tcfg)
    for k, v in trainer.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), atol=ATOL, rtol=0, err_msg=k)


def test_train_entry_point_sft(tmp_path):
    import trlx_tpu_torch

    d = _config_dict(tmp_path)
    d["model"]["model_extra_kwargs"] = {"attention_impl": "pallas"}
    d["method"]["gen_kwargs"] = dict(max_new_tokens=6, do_sample=True, top_k=20)
    d["train"].update(total_steps=4, checkpoint_interval=3, eval_interval=2)
    config = TRLConfig.from_dict(d)
    seen = {}
    trainer = trlx_tpu_torch.train(
        samples=_samples(), config=config, device="cpu",
        metric_fn=lambda samples, **kw: seen.setdefault("m", {"n": [len(s) for s in samples]}),
    )
    assert trainer.iter_count == 4 and trainer.step == 4
    losses = [st["losses/loss"] for _, st in trainer.tracker.history if "losses/loss" in st]
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    # eval prompts default to bos × batch_size
    assert len(seen["m"]["n"]) == config.train.batch_size
    assert (tmp_path / "checkpoint_3" / "state.pt").exists()
    assert (tmp_path / "checkpoint_4" / "state.pt").exists()
    with pytest.raises(ValueError, match="should match the number of rewards"):
        trlx_tpu_torch.train(samples=["a", "b"], rewards=[1.0], config=config, device="cpu")
    with pytest.raises(ValueError, match="Either `samples` or `reward_fn`"):
        trlx_tpu_torch.train(config=config, device="cpu")


def test_default_sft_config_matches_jax():
    assert default_sft_config().to_dict() == jax_default_sft_config().to_dict()


@pytest.mark.parametrize(
    "override,setting",
    [
        ({"model": {"model_arch_type": "seq2seq"}}, "model.model_arch_type"),
        # LoRA runs (tests/test_torch_lora.py); an unknown LoRA key raises, as in JAX
        ({"model": {"peft_kwargs": {"peft_type": "lora", "r": 8, "dropout": 0.1}}},
         "model.peft_kwargs"),
        ({"train": {"grad_accum": 3}}, "train.grad_accum"),  # batch 4 does not split
        # the retention ring and elastic restore run
        # (tests/test_torch_resilience_trainer.py, test_torch_elastic.py);
        # tensor parallelism waits for its slice
        ({"parallel": {"model": 2}}, "parallel.model"),
        ({"parallel": {"fsdp": 2}}, "parallel.fsdp"),
        ({"serve": {"enabled": True}}, "serve.enabled"),
    ],
)
def test_offline_trainer_rejects_unported_settings(tmp_path, override, setting):
    d = _config_dict(tmp_path)
    for section, values in override.items():
        d[section].update(values)
    with pytest.raises(ValueError, match=setting.replace(".", r"\.")) as err:
        SFTTrainer(config=TRLConfig.from_dict(copy.deepcopy(d)), device="cpu")
    if setting == "model.peft_kwargs":  # JAX raises it too: its message, named
        with pytest.raises(ValueError) as jax_err:
            JaxSFTTrainer(config=JaxTRLConfig.from_dict(d))
        assert str(jax_err.value) in str(err.value)


@pytest.mark.parametrize(
    "override",
    [{"train": {"grad_accum": 2}}, {"train": {"resume_from_checkpoint": True}}],
    ids=["grad_accum", "resume"],
)
def test_offline_trainer_takes_a_step_with_ported_settings(tmp_path, override):
    """Settings the offline trainers rejected before they were ported
    (gradient accumulation, resume) build a trainer that takes a step."""
    d = _config_dict(tmp_path)
    for section, values in override.items():
        d[section].update(values)
    trainer = SFTTrainer(config=TRLConfig.from_dict(d), device="cpu")
    trainer.make_experience(_samples(), d["train"]["seq_length"])
    trainer.maybe_resume()  # an empty checkpoint_dir: nothing to load
    trainer.prepare_learning()
    stats = trainer.train_step(next(iter(trainer.train_dataloader)))
    assert trainer.step == 1 and np.isfinite(float(stats["losses/loss"].detach()))


def test_offline_trainer_takes_the_presets_engine_settings(tmp_path):
    """The presets' serial rollout path and gather kernels are rollout
    settings: the offline trainers run with them and evaluate on the paged
    engine (PPO collects on the serial path with them)."""
    d = _config_dict(tmp_path)
    assert d["train"]["continuous_batching"] is False
    assert d["engine"]["backend"] == "dense" and d["engine"]["decode_kernel"] == "xla"
    trainer = SFTTrainer(config=TRLConfig.from_dict(d), device="cpu")
    trainer.add_eval_pipeline(PromptPipeline(["ab"], 18, trainer.tokenizer))
    assert "time/generate" in trainer.evaluate()


def test_logit_chunk_on_a_model_without_projection_is_ignored(tmp_path):
    trainer = SFTTrainer(config=TRLConfig.from_dict(_config_dict(tmp_path, 5)), device="cpu")
    assert trainer._resolved_logit_chunk() == 5
    trainer.model = torch.nn.Linear(2, 2)
    assert trainer._resolved_logit_chunk() == 0

