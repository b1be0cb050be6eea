"""Hugging Face export of the port (``trlx_tpu_torch/models/hf_interop.py``,
``utils/checkpoint.py``) against ``transformers`` and the JAX package, and
training from a checkpoint directory, on the CPU. Mirrors
``tests/test_hf_export.py``:

- round trip: per family and for both T5 variants, import → the port's
  ``save_pretrained_hf`` → ``transformers.AutoModelFor*.from_pretrained``
  gives the original's logits (atol 1e-6);
- agreement with JAX: the exported state dict equals JAX's
  ``params_to_hf_state_dict`` key for key, bitwise, on the same weights
  (the families, T5, and the value and ILQL heads of ``gpt2-test``);
- heads and layouts: the value and ILQL heads under the reference's
  prefixes, a ``scan_layers`` config exporting as the unscanned one, and
  LoRA adapters merged into their weights (causal and T5);
- the trainer's ``save_pretrained`` and ``push_to_hub`` through an
  injected ``uploader`` (a staging directory kept, a failed upload keeping
  the staged export, no ``huggingface_hub`` raising before staging);
- PPO from a checkpoint: ``trlx_tpu_torch.train`` with ``model_path`` a
  tiny GPT-2 directory and the vendored BPE tokenizer against JAX's
  ``train()`` on the same directory, the store, each step's stats and
  the final weights within 1e-5 (the port's value head set from JAX's,
  its imported backbone held bitwise to JAX's first).
"""

import dataclasses
import glob
import json
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers as tf

import trlx_tpu
import trlx_tpu_torch
from trlx_tpu.data.configs import ModelConfig as JaxModelConfig
from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
from trlx_tpu.data.default_configs import default_ppo_config as jax_default_ppo_config
from trlx_tpu.models import hf_interop as jax_hf
from trlx_tpu.models.builder import build_causal_lm as jax_build_causal_lm
from trlx_tpu.models.builder import build_seq2seq_lm as jax_build_seq2seq_lm
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models import hf_interop
from trlx_tpu_torch.models.builder import build_causal_lm, build_seq2seq_lm
from trlx_tpu_torch.models.weights import params_from_jax, seq2seq_params_from_jax
from trlx_tpu_torch.trainer.ppo import PPOTrainer  # noqa: F401 (registers the PPO config)
from trlx_tpu_torch.utils import checkpoint
from torch_hf_cases import CAUSAL_FAMILIES, T5_VARIANTS, causal_ids, t5_inputs, tiny_hf
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "tiny_bpe")
RTOL, ATOL, STAT_ATOL = 1e-5, 1e-5, 1e-6


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _assert_same_export(ours, theirs):
    assert set(ours) == set(theirs), set(ours) ^ set(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("family", CAUSAL_FAMILIES)
def test_roundtrip_exact_logits(family, tmp_path):
    hf = tiny_hf(family)
    state_dict, cfg = hf_interop.params_from_hf(hf)
    out = str(tmp_path / family)
    hf_interop.save_pretrained_hf(out, state_dict, cfg)
    reloaded = tf.AutoModelForCausalLM.from_pretrained(out).eval()
    ids = torch.tensor(causal_ids(cfg.vocab_size))
    with torch.no_grad():
        np.testing.assert_allclose(reloaded(ids).logits.numpy(), hf(ids).logits.numpy(),
                                   atol=1e-6, rtol=0)
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f)["model_type"] == hf.config.model_type

    jax_params, jax_cfg = jax_hf.params_from_hf(hf)
    _assert_same_export(hf_interop.params_to_hf_state_dict(state_dict, cfg),
                        jax_hf.params_to_hf_state_dict(_np_tree(jax_params), jax_cfg))


@pytest.mark.parametrize("variant", T5_VARIANTS)
def test_t5_roundtrip_exact_logits(variant, tmp_path):
    hf = tiny_hf(variant)
    state_dict, cfg = hf_interop.seq2seq_params_from_hf(hf)
    out = str(tmp_path / variant)
    hf_interop.save_pretrained_hf(out, state_dict, cfg)
    reloaded = tf.AutoModelForSeq2SeqLM.from_pretrained(out).eval()
    ids, mask, dec = (torch.tensor(x) for x in t5_inputs(cfg.vocab_size))
    with torch.no_grad():
        np.testing.assert_allclose(
            reloaded(input_ids=ids, attention_mask=mask, decoder_input_ids=dec).logits.numpy(),
            hf(input_ids=ids, attention_mask=mask, decoder_input_ids=dec).logits.numpy(),
            atol=1e-6, rtol=0)

    jax_params, jax_cfg = jax_hf.seq2seq_params_from_hf(hf)
    _assert_same_export(hf_interop.params_to_hf_state_dict(state_dict, cfg),
                        jax_hf.params_to_hf_state_dict(_np_tree(jax_params), jax_cfg))


@pytest.mark.parametrize("head", ["value", "ilql"])
def test_heads_match_jax_export(head, tmp_path):
    """The value and ILQL heads under the reference's prefixes, key for key
    and bitwise as JAX exports them; ``pytorch_model.bin`` carries them."""
    _, jparams, jcfg = jax_build_causal_lm(JaxModelConfig("builtin:gpt2-test"), head=head)
    jparams = _np_tree(jparams)
    model, cfg = build_causal_lm("builtin:gpt2-test", device="cpu", head=head)
    model.load_state_dict(params_from_jax(jparams, cfg))
    ours = hf_interop.params_to_hf_state_dict(model.state_dict(), cfg)
    _assert_same_export(ours, jax_hf.params_to_hf_state_dict(jparams, jcfg))
    keys = (("v_head.0.weight", "v_head.2.weight") if head == "value" else
            ("ilql_heads.heads.v_head.0.weight", "ilql_heads.heads.q_heads.0.2.weight",
             "ilql_heads.heads.q_heads.1.0.bias", "ilql_heads.heads.target_q_heads.0.0.weight"))
    for key in keys:
        assert key in ours, key
    if head == "value":  # torch Linear layout [out, in]
        assert ours["v_head.0.weight"].shape == (2 * cfg.hidden_size, cfg.hidden_size)
        assert ours["v_head.2.weight"].shape == (1, 2 * cfg.hidden_size)
    out = str(tmp_path / head)
    hf_interop.save_pretrained_hf(out, model.state_dict(), cfg)
    saved = torch.load(os.path.join(out, "pytorch_model.bin"), weights_only=True)
    assert set(saved) == set(ours) and all(v.dtype == torch.float32 for v in saved.values())
    tf.AutoModelForCausalLM.from_pretrained(out)  # plain transformers ignores the heads


def test_t5_head_prefix_merge(tmp_path):
    _, jparams, jcfg = jax_build_seq2seq_lm(
        JaxModelConfig("builtin:t5-test", model_arch_type="seq2seq"), head="value")
    jparams = _np_tree(jparams)
    model, scfg = build_seq2seq_lm("builtin:t5-test", device="cpu", head="value")
    model.load_state_dict(seq2seq_params_from_jax(jparams, scfg))
    ours = hf_interop.params_to_hf_state_dict(model.state_dict(), scfg)
    _assert_same_export(ours, jax_hf.params_to_hf_state_dict(jparams, jcfg))
    assert {"v_head.0.weight", "v_head.2.weight", "shared.weight", "lm_head.weight"} <= set(ours)
    out = str(tmp_path / "t5_vhead")
    hf_interop.save_pretrained_hf(out, model.state_dict(), scfg)
    assert tf.AutoModelForSeq2SeqLM.from_pretrained(out).config.d_model == scfg.hidden_size


def test_scan_layout_exports_identically():
    """The port keeps per-layer modules under ``scan_layers``: the export
    is the unscanned one's."""
    state_dict, cfg = hf_interop.params_from_hf(tiny_hf("gpt2"))
    flat = hf_interop.params_to_hf_state_dict(state_dict, cfg)
    scanned = hf_interop.params_to_hf_state_dict(
        state_dict, dataclasses.replace(cfg, scan_layers=True))
    assert flat.keys() == scanned.keys()
    assert all(torch.equal(flat[k], scanned[k]) for k in flat)


LORA = {"peft_type": "lora", "r": 4, "lora_alpha": 8, "modified_modules": "attention"}


@pytest.mark.parametrize("arch", ["causal", "t5"])
def test_lora_merged_on_export(arch):
    """Trained adapters fold into their weights (W += (alpha / r)·(A B)ᵀ),
    against JAX's export of the same adapters."""
    from trlx_tpu_torch.models.builder import parse_peft_overrides

    if arch == "causal":
        mc = JaxModelConfig("builtin:gpt2-test", peft_kwargs=LORA)
        _, jparams, jcfg = jax_build_causal_lm(mc, head="value")
        proj = jparams["backbone"]["h_0"]["attn"]["q_proj"]
        build, spec, key = build_causal_lm, "builtin:gpt2-test", "transformer.h.0.attn.c_attn.weight"
    else:
        mc = JaxModelConfig("builtin:t5-test", model_arch_type="seq2seq", peft_kwargs=LORA)
        _, jparams, jcfg = jax_build_seq2seq_lm(mc, head="value")
        proj = jparams["backbone"]["dec_0"]["cross_attn"]["q_proj"]
        build, spec = build_seq2seq_lm, "builtin:t5-test"
        key = "decoder.block.0.layer.1.EncDecAttention.q.weight"
    proj["lora_b"] = jnp.ones_like(proj["lora_b"]) * 0.01  # a merge to observe
    jparams = _np_tree(jparams)
    model, cfg = build(spec, device="cpu", head="value", **parse_peft_overrides(LORA))
    convert = params_from_jax if arch == "causal" else seq2seq_params_from_jax
    model.load_state_dict(convert(jparams, cfg))
    ours = hf_interop.params_to_hf_state_dict(model.state_dict(), cfg)
    theirs = jax_hf.params_to_hf_state_dict(jparams, jcfg)
    assert set(ours) == set(theirs) and not any("lora" in k for k in ours)
    for k in theirs:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]), atol=1e-6, rtol=0,
                                   err_msg=k)
    p = {k: np.asarray(v) for k, v in _np_tree(proj).items()}
    expected = p["kernel"] + (p["lora_a"] @ p["lora_b"]) * (cfg.lora_alpha / cfg.lora_r)
    merged = ours[key].numpy()
    merged = merged[:, : cfg.hidden_size] if arch == "causal" else merged.T
    np.testing.assert_allclose(merged, expected, atol=1e-6)


def _sft_trainer(tmp_path):
    from trlx_tpu_torch.data.default_configs import default_sft_config
    from trlx_tpu_torch.trainer.sft import SFTTrainer

    cfg = default_sft_config().evolve(
        train=dict(seq_length=32, batch_size=8, total_steps=1, eval_interval=100,
                   checkpoint_interval=100, epochs=1, checkpoint_dir=str(tmp_path / "ckpts"),
                   tracker=None),
        model=dict(model_path="builtin:gpt2-test"))
    return SFTTrainer(config=cfg, device="cpu")


def test_trainer_save_pretrained(tmp_path):
    trainer = _sft_trainer(tmp_path)
    out = str(tmp_path / "hf_out")
    trainer.save_pretrained(out)
    model = tf.AutoModelForCausalLM.from_pretrained(out)
    assert model.config.vocab_size == trainer.tcfg.vocab_size
    with open(os.path.join(out, checkpoint.PRETRAINED_CONFIG)) as f:
        fields = json.load(f)
    assert fields["framework"] == "trlx_tpu_torch" and fields["tokenizer_path"] == "builtin:bytes"
    assert fields["hidden_size"] == trainer.tcfg.hidden_size
    loaded = checkpoint.load_pretrained_params(out, device="cpu")
    want = trainer.model.state_dict()
    assert set(loaded) == set(want) and all(torch.equal(loaded[k], want[k]) for k in want)
    # the default directory, and an import of the export as a model path
    trainer.save_pretrained()
    default = os.path.join(trainer.config.train.checkpoint_dir, "hf_model")
    back, _ = build_causal_lm(default, device="cpu")
    assert all(torch.equal(v, want[k]) for k, v in back.state_dict().items())


def test_save_pretrained_without_a_family_keeps_the_native_dump(tmp_path):
    model, cfg = build_causal_lm("builtin:gpt2-test", device="cpu")
    cfg = dataclasses.replace(cfg, model_type=None)
    checkpoint.save_pretrained(str(tmp_path), model.state_dict(), cfg)
    files = sorted(os.listdir(tmp_path))
    assert files == [checkpoint.PRETRAINED_CONFIG, checkpoint.PRETRAINED_FILE]


def test_push_to_hub_payload(tmp_path):
    trainer = _sft_trainer(tmp_path)
    seen = {}

    def uploader(repo_id, staged):
        seen["repo_id"], seen["files"] = repo_id, sorted(os.listdir(staged))
        with open(os.path.join(staged, checkpoint.PRETRAINED_CONFIG)) as f:
            seen["config"] = json.load(f)
        return f"local://{repo_id}"

    assert trainer.push_to_hub("org/tiny", uploader=uploader) == "local://org/tiny"
    assert seen["repo_id"] == "org/tiny"
    for name in (checkpoint.PRETRAINED_FILE, checkpoint.PRETRAINED_CONFIG, "pytorch_model.bin",
                 "config.json"):
        assert name in seen["files"], seen["files"]
    assert seen["config"]["tokenizer_path"] == "builtin:bytes"


def test_push_to_hub_staging_dir_persists(tmp_path):
    model, cfg = build_causal_lm("builtin:gpt2-test", device="cpu")
    staged = str(tmp_path / "staged")
    checkpoint.push_to_hub("org/x", model.state_dict(), cfg, staging_dir=staged,
                           uploader=lambda r, d: r)
    assert os.path.exists(os.path.join(staged, checkpoint.PRETRAINED_FILE))


def test_push_to_hub_failure_keeps_staged_export(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    model, cfg = build_causal_lm("builtin:gpt2-test", device="cpu")

    def boom(repo_id, staged):
        raise ConnectionError("hub unreachable")

    with pytest.raises(ConnectionError):
        checkpoint.push_to_hub("org/x", model.state_dict(), cfg, uploader=boom)
    kept = glob.glob(str(tmp_path / "trlx_tpu_torch_hub_*"))
    assert len(kept) == 1
    assert os.path.exists(os.path.join(kept[0], "pytorch_model.bin"))


def test_push_to_hub_needs_huggingface_hub_before_staging(tmp_path, monkeypatch):
    # built before the temp dir moves: a process's first meta-device build
    # imports torch._dynamo, which makes its cache directory under the temp
    # dir; what is held here is that push_to_hub stages nothing
    model, cfg = build_causal_lm("builtin:gpt2-test", device="cpu")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(RuntimeError, match="huggingface_hub"):
        checkpoint.push_to_hub("org/x", model.state_dict(), cfg)
    assert os.listdir(tmp_path) == []


# ---------------------------------------------------------------------------
# PPO from a checkpoint directory
# ---------------------------------------------------------------------------

STAT_PREFIXES = ("losses/", "policy/", "values/", "old_values/", "returns/")
STAT_KEYS = ("ratio", "learning_rate", "gradients/global_norm")
PPO_STEPS = 4


def _ppo_dict(model_path, ckpt):
    """``default_ppo_config()`` cut in lengths and steps, greedy, f32: one
    collection of 32 rollouts, batch 16, 2 PPO epochs (4 steps)."""
    d = jax_default_ppo_config().to_dict()
    d["model"].update(model_path=model_path, num_layers_unfrozen=1)
    d["tokenizer"].update(tokenizer_path=FIXTURE)
    d["parallel"].update(compute_dtype="float32")
    d["train"].update(seq_length=24, total_steps=PPO_STEPS, batch_size=16,
                      checkpoint_dir=str(ckpt), eval_interval=1000)
    d["method"].update(num_rollouts=32, chunk_size=32, ppo_epochs=2)
    d["method"]["gen_kwargs"].update(max_new_tokens=8, do_sample=False)
    return d


def _prompts(n=32, seed=0):
    rs = np.random.RandomState(seed)
    words = ["the", "movie", "was", "great", "terrible", "film", "review", "hello", "world"]
    return [" ".join(words[i] for i in rs.randint(0, len(words), rs.randint(1, 6)))
            for _ in range(n)]


def reward_fn(samples, prompts, outputs):
    return [sum(ch in "aeiou" for ch in o) / max(len(o), 1) for o in outputs]


class _Recorder:
    def __init__(self):
        self.history = []

    def log(self, stats, step):
        self.history.append((int(step), dict(stats)))

    def finish(self):
        pass


def _store(trainer):
    return [(e.query_tensor, e.response_tensor, e.logprobs, e.values, e.rewards)
            for e in trainer.store.history]


@pytest.fixture(scope="module")
def gpt2_dir(tmp_path_factory):
    """A tiny GPT-2 checkpoint covering the BPE fixture's 351 ids (350 and
    the filled pad), as safetensors."""
    torch.manual_seed(0)
    hf = tf.GPT2LMHeadModel(tf.GPT2Config(vocab_size=352, n_positions=64, n_embd=32,
                                          n_layer=2, n_head=4)).eval()
    path = str(tmp_path_factory.mktemp("gpt2_ckpt"))
    hf.save_pretrained(path)
    return path


def test_ppo_from_checkpoint_matches_jax(gpt2_dir, tmp_path):
    jax_out = {}

    def jax_hook(trainer):
        jax_out["params0"] = _np_tree(jax.tree_util.tree_map(np.asarray, trainer.state.params))
        trainer.tracker = _Recorder()

    jt = trlx_tpu.train(reward_fn=reward_fn, prompts=_prompts(),
                        config=JaxTRLConfig.from_dict(_ppo_dict(gpt2_dir, tmp_path / "jax")),
                        init_trainer_hook=jax_hook)

    def hook(trainer):
        want = params_from_jax(jax_out["params0"], trainer.tcfg)
        got = trainer.model.state_dict()
        for k, v in got.items():  # the imported backbone equals JAX's bitwise
            if k.startswith("backbone."):
                assert torch.equal(v, want[k]), k
        trainer.model.load_state_dict(want)  # JAX's value head
        trainer.ref_params = trainer._ref_snapshot()
        trainer.tracker = _Recorder()

    pt = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=_prompts(),
                              config=TRLConfig.from_dict(_ppo_dict(gpt2_dir, tmp_path / "port")),
                              init_trainer_hook=hook, device="cpu")
    ours, theirs = _store(pt), _store(jt)
    assert len(ours) == len(theirs) == 32
    for i, (a, b) in enumerate(zip(ours, theirs)):
        np.testing.assert_array_equal(a[0], b[0], err_msg=f"query {i}")
        np.testing.assert_array_equal(a[1], b[1], err_msg=f"response {i}")
        for j, name in ((2, "logprobs"), (3, "values"), (4, "rewards")):
            np.testing.assert_allclose(np.asarray(a[j], np.float32), np.asarray(b[j], np.float32),
                                       atol=ATOL, rtol=0, err_msg=f"{name} {i}")
    steps = [(s, st) for s, st in pt.tracker.history if "gradients/global_norm" in st]
    jsteps = [(s, st) for s, st in jt.tracker.history if "gradients/global_norm" in st]
    assert len(steps) == len(jsteps) == PPO_STEPS
    for (s_o, st_o), (s_t, st_t) in zip(steps, jsteps):
        keys = [k for k in st_t if k.startswith(STAT_PREFIXES) or k in STAT_KEYS]
        assert s_o == s_t and len(keys) > 20
        for k in keys:
            np.testing.assert_allclose(st_o[k], float(st_t[k]), rtol=RTOL, atol=STAT_ATOL,
                                       err_msg=f"step {s_o} {k}")
    final = params_from_jax(_np_tree(jax.tree_util.tree_map(np.asarray, jt.state.params)),
                            pt.tcfg)
    for k, v in pt.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), atol=ATOL, rtol=0, err_msg=k)
