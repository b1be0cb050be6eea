"""The DPO path of the port (``trlx_tpu_torch/models/dpo.py``,
``pipeline/dpo_pipeline.py``, ``trainer/dpo.py``) against the JAX package,
on the CPU.

Inputs are made by numpy from a seed. Held:

- ``DPOConfig.loss`` against JAX's: plain, ``label_smoothing`` 0.1 and
  ``reference_free``, the sketches on; loss, stats and the gradients with
  respect to the policy logprobs at 1e-5 relative in f32;
- ``DPOStore``: its collated batches against JAX's element for element
  (interleaved pairs, right padding to a multiple of 8, the references
  only once all are filled in), and the triple check;
- ``completion_logps``: the full and the streamed (``logit_chunk``) forms
  against each other, values and gradients, and against JAX's
  ``_completion_logps``;
- the whole slice: ``trlx_tpu.train`` and ``trlx_tpu_torch.train`` on
  ``default_dpo_config()`` cut in model (``builtin:gpt2-test``, f32),
  length, batch and steps, the port starting from the JAX initial weights
  (``params_from_jax``): the store's reference logprobs, each step's stats
  at 1e-5 relative (1e-6 absolute) and the weights after 3 steps at 1e-5.
  ``grad_accum`` 2 takes the same steps (every stat is a mean over whole
  pairs); a run resumed from its step-1 or step-2 checkpoint (inside an
  epoch of two batches, and at its end) equals the uninterrupted one;
- the construction checks: fewer pairs than a batch, seq2seq and a wrong
  method config raise as JAX's do; the settings the port does not run
  raise naming themselves.
"""

import copy
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trlx_tpu
import trlx_tpu_torch
from trlx_tpu.data.configs import ModelConfig as JaxModelConfig
from trlx_tpu.data.configs import TokenizerConfig as JaxTokenizerConfig
from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
from trlx_tpu.data.default_configs import default_dpo_config as jax_default_dpo_config
from trlx_tpu.data.default_configs import default_sft_config as jax_default_sft_config
from trlx_tpu.data.tokenizer import from_config as jax_tokenizer_from_config
from trlx_tpu.models.builder import build_causal_lm as jax_build_causal_lm
from trlx_tpu.pipeline.dpo_pipeline import DPOStore as JaxDPOStore
from trlx_tpu.trainer.dpo import DPOTrainer as JaxDPOTrainer
from trlx_tpu.trainer.dpo import _completion_logps as jax_completion_logps
from trlx_tpu_torch.data.configs import TokenizerConfig, TRLConfig
from trlx_tpu_torch.data.default_configs import default_dpo_config
from trlx_tpu_torch.data.tokenizer import from_config as tokenizer_from_config
from trlx_tpu_torch.models.builder import build_causal_lm
from trlx_tpu_torch.models.weights import params_from_jax
from trlx_tpu_torch.pipeline.dpo_pipeline import DPOStore
from trlx_tpu_torch.trainer.dpo import DPOTrainer, completion_logps
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

RTOL, ATOL = 1e-5, 1e-5
STAT_ATOL = 1e-6
TOTAL_STEPS = 3
STAT_KEYS = ("losses/total_loss", "rewards/chosen", "rewards/rejected", "rewards/margin",
             "rewards/accuracy", "logps/chosen", "logps/rejected", "learning_rate",
             "gradients/global_norm")


def _words(rs, lo, hi):
    return "".join(chr(c) for c in rs.randint(97, 123, size=rs.randint(lo, hi)))


def _triples(n=20, seed=0):
    """Prompt, chosen and rejected byte strings of varied lengths (some
    past the cut preset's seq_length, so truncation runs)."""
    rs = np.random.RandomState(seed)
    return [(_words(rs, 2, 12), " " + _words(rs, 1, 24), " " + _words(rs, 1, 24))
            for _ in range(n)]


def _config_dict(tmp, **train):
    d = jax_default_dpo_config().to_dict()
    d["model"].update(model_path="builtin:gpt2-test")
    d["parallel"].update(compute_dtype="float32")
    # lr 1e-3 (the preset's 5e-6 would move the weights by less than the
    # tolerance)
    d["optimizer"]["kwargs"].update(lr=1e-3)
    d["scheduler"]["kwargs"].update(lr=1e-3, eta_min=1e-3)
    d["train"].update(seq_length=32, batch_size=8, total_steps=TOTAL_STEPS,
                      checkpoint_interval=1, checkpoint_dir=str(tmp), **train)
    d["method"]["gen_kwargs"].update(max_new_tokens=6)
    return d


class _Recorder:
    def __init__(self):
        self.history = []

    def log(self, stats, step):
        self.history.append((int(step), dict(stats)))

    def finish(self):
        pass


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _refs(trainer):
    return np.asarray([(e["ref_chosen_logp"], e["ref_rejected_logp"])
                       for e in trainer.store.history], np.float64)


@pytest.fixture(scope="module")
def jax_dpo(tmp_path_factory):
    out = {}

    def hook(trainer):
        out["params0"] = _np_tree(trainer.state.params)
        trainer.tracker = _Recorder()

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TRLX_TPU_MFU", "0")
        trainer = trlx_tpu.train(
            samples=_triples(), eval_prompts=["ab", "cde"],
            config=JaxTRLConfig.from_dict(_config_dict(tmp_path_factory.mktemp("jax_dpo"))),
            init_trainer_hook=hook)
    out.update(history=trainer.tracker.history, refs=_refs(trainer),
               params=_np_tree(trainer.state.params))
    return out


def _port_run(tmp, jax_run, **train):
    def hook(trainer):
        trainer.model.load_state_dict(params_from_jax(jax_run["params0"], trainer.tcfg))

    return trlx_tpu_torch.train(samples=_triples(), eval_prompts=["ab", "cde"],
                                config=TRLConfig.from_dict(_config_dict(tmp, **train)),
                                init_trainer_hook=hook, device="cpu")


def _steps(history):
    return [(s, st) for s, st in history if "gradients/global_norm" in st]


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_dpo_slice_matches_jax_trainer(jax_dpo, tmp_path, grad_accum):
    trainer = _port_run(tmp_path, jax_dpo, grad_accum=grad_accum)
    np.testing.assert_allclose(_refs(trainer), jax_dpo["refs"], rtol=RTOL, atol=ATOL)
    steps, jsteps = _steps(trainer.tracker.history), _steps(jax_dpo["history"])
    assert len(steps) == len(jsteps) == TOTAL_STEPS
    # the first step: the policy is its own reference
    np.testing.assert_allclose(steps[0][1]["losses/total_loss"], np.log(2.0), rtol=1e-6)
    for (s_o, st_o), (s_t, st_t) in zip(steps, jsteps):
        assert s_o == s_t
        for k in STAT_KEYS:
            np.testing.assert_allclose(st_o[k], float(st_t[k]), rtol=RTOL, atol=STAT_ATOL,
                                       err_msg=f"step {s_o} {k}")
    assert steps[-1][1]["rewards/margin"] != 0.0
    final = params_from_jax(jax_dpo["params"], trainer.tcfg)
    start = params_from_jax(jax_dpo["params0"], trainer.tcfg)
    moved = 0.0
    for k, v in trainer.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), atol=ATOL, rtol=0, err_msg=k)
        moved = max(moved, float((v - start[k]).abs().max()))
    assert moved > 1e-3


@pytest.mark.parametrize("at", [1, 2], ids=["mid_epoch", "epoch_end"])
def test_dpo_resume_equals_the_uninterrupted_run(tmp_path, at):
    start = {}

    def hook(trainer):  # the port's own seeded weights, the same in both runs
        start.update({k: v.clone() for k, v in trainer.model.state_dict().items()})

    def run(tmp, **train):
        return trlx_tpu_torch.train(samples=_triples(), eval_prompts=["ab", "cde"],
                                    config=TRLConfig.from_dict(_config_dict(tmp, **train)),
                                    init_trainer_hook=hook, device="cpu")

    full = run(tmp_path / "full")
    shutil.copytree(tmp_path / "full" / f"checkpoint_{at}",
                    tmp_path / "resumed" / f"checkpoint_{at}")
    resumed = run(tmp_path / "resumed", resume_from_checkpoint=True)
    assert resumed.iter_count == full.iter_count == TOTAL_STEPS
    np.testing.assert_array_equal(_refs(resumed), _refs(full))
    # a multi-threaded CPU may sum the embeddings' scatter-add gradients in
    # another order, and Adam turns the rounding noise of gradients that
    # are zero in exact arithmetic (the key biases) into steps of ~1e-6:
    # held at 1e-3 of the run's largest change, where a resume fault moves
    # every trained tensor by about its own update
    sd = resumed.model.state_dict()
    moved = max(float((v - start[k]).abs().max()) for k, v in full.model.state_dict().items())
    assert moved > 1e-3
    for k, v in full.model.state_dict().items():
        assert float((sd[k] - v).abs().max()) <= 1e-3 * moved, k
    np.testing.assert_allclose(_steps(resumed.tracker.history)[-1][1]["losses/total_loss"],
                               _steps(full.tracker.history)[-1][1]["losses/total_loss"],
                               rtol=RTOL)


def _loss_inputs(B=7, seed=0):
    rs = np.random.RandomState(seed)
    pc, pr = rs.randn(B) * 5 - 40, rs.randn(B) * 5 - 42
    return {"policy_chosen_logps": pc.astype(np.float32),
            "policy_rejected_logps": pr.astype(np.float32),
            "ref_chosen_logps": (pc + rs.randn(B)).astype(np.float32),
            "ref_rejected_logps": (pr + rs.randn(B)).astype(np.float32)}


@pytest.mark.parametrize("kw", [{}, {"label_smoothing": 0.1}, {"reference_free": True}],
                         ids=["plain", "label_smoothing", "reference_free"])
def test_dpo_loss_matches_jax(kw):
    import dataclasses

    inputs = _loss_inputs(seed=len(kw))
    jm = dataclasses.replace(jax_default_dpo_config().method, beta=0.3, **kw)
    pm = dataclasses.replace(default_dpo_config().method, beta=0.3, **kw)
    names = ("policy_chosen_logps", "policy_rejected_logps")

    def jax_loss(pc, pr, rest):
        return jm.loss(policy_chosen_logps=pc, policy_rejected_logps=pr, **rest)

    rest = {k: jnp.asarray(v) for k, v in inputs.items() if k not in names}
    (jl, jstats), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        *(jnp.asarray(inputs[k]) for k in names), rest)
    pol = [torch.tensor(inputs[k], requires_grad=True) for k in names]
    pl, pstats = pm.loss(*pol, **{k: torch.tensor(v) for k, v in inputs.items()
                                  if k not in names})
    pl.backward()
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=1e-5)
    assert set(pstats) == set(jstats) and "dist/reward_margin_hist" in pstats
    for k, v in jstats.items():
        np.testing.assert_allclose(np.asarray(pstats[k]), np.asarray(v), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    for p, g in zip(pol, jgrads):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-8)


def test_dpo_store_layout_matches_jax():
    triples = _triples(5, seed=3) + [("prompt a", " good stuff", " bad stuff")]
    tok = tokenizer_from_config(TokenizerConfig(tokenizer_path="builtin:bytes",
                                                truncation_side="left"))
    jtok = jax_tokenizer_from_config(JaxTokenizerConfig(tokenizer_path="builtin:bytes",
                                                        truncation_side="left"))
    store, jstore = DPOStore(triples, tok, 20), JaxDPOStore(triples, jtok, 20)
    assert len(store) == len(jstore) == 6
    no_refs = store.collate(store.history)
    assert "ref_logps" not in no_refs
    for s in (store, jstore):
        for i, e in enumerate(s.history):
            e["ref_chosen_logp"], e["ref_rejected_logp"] = float(i), float(-2 * i)
    batch, jbatch = store.collate(store.history), jstore.collate(jstore.history)
    assert set(batch) == set(jbatch) == {"input_ids", "attention_mask", "out_mask",
                                         "ref_logps"}
    for k in batch:
        np.testing.assert_array_equal(batch[k], jbatch[k], err_msg=k)
    assert batch["input_ids"].shape[0] == 12 and batch["input_ids"].shape[1] % 8 == 0
    # chosen rows even, rejected odd; the prompt carries no out_mask
    prompt_len = len(tok.encode("prompt a", add_special_tokens=False))
    assert batch["out_mask"][10][:prompt_len].sum() == 0 and batch["out_mask"][10].sum() > 0
    loader, jloader = (s.create_loader(4, shuffle=True, seed=5) for s in (store, jstore))
    for b, jb in zip(loader, jloader):
        for k in b:
            np.testing.assert_array_equal(b[k], jb[k])
    for S, t in ((DPOStore, tok), (JaxDPOStore, jtok)):
        with pytest.raises(ValueError, match="triples"):
            S([("a", "b")], t, 64)


def test_completion_logps_streamed_and_full_match_jax():
    module, params, _ = jax_build_causal_lm(JaxModelConfig(
        "builtin:gpt2-test", model_extra_kwargs=dict(dtype=jnp.float32,
                                                     param_dtype=jnp.float32)))
    model, cfg = build_causal_lm("builtin:gpt2-test", device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(_np_tree(params), cfg))
    model.requires_grad_(True)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 250, (4, 25)).astype(np.int32)
    attn = np.ones((4, 25), np.int32)
    attn[1, 20:] = 0  # right padding
    out_mask = rs.randint(0, 2, (4, 25)).astype(np.int32)
    want = np.asarray(jax_completion_logps(module, params, *map(jnp.asarray,
                                                                (ids, attn, out_mask)))[0])
    tensors = [torch.as_tensor(x) for x in (ids, attn, out_mask)]
    grads = {}
    for chunk in (0, 8, 7):  # 24 % 8 == 0; 7 pads
        model.zero_grad(set_to_none=True)
        got = completion_logps(model, *tensors, chunk)[0]
        got.sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, err_msg=str(chunk))
        grads[chunk] = {n: p.grad.clone() for n, p in model.named_parameters()}
        jwant = np.asarray(jax_completion_logps(module, params, *map(jnp.asarray,
                                                                     (ids, attn, out_mask)),
                                                chunk)[0])
        np.testing.assert_allclose(got.detach().numpy(), jwant, rtol=1e-5)
    for chunk in (8, 7):
        for n, g in grads[0].items():
            np.testing.assert_allclose(grads[chunk][n].numpy(), g.numpy(), atol=1e-5,
                                       err_msg=f"chunk {chunk}: {n}")


def test_dpo_rejects_dataset_smaller_than_batch(tmp_path):
    d = _config_dict(tmp_path)
    d["train"]["batch_size"] = 16
    triples = [(f"p{i}", " good", " bad") for i in range(4)]
    with pytest.raises(ValueError, match="batch_size"):
        trlx_tpu.train(samples=triples, config=JaxTRLConfig.from_dict(copy.deepcopy(d)))
    with pytest.raises(ValueError, match="batch_size"):
        trlx_tpu_torch.train(samples=triples, config=TRLConfig.from_dict(d), device="cpu")


def _sft_method():
    return jax_default_sft_config().to_dict()["method"]


@pytest.mark.parametrize("override,error,match", [
    ({"model": {"model_arch_type": "seq2seq"}}, NotImplementedError, "causal LMs"),
    ({"method": "sft"}, ValueError, "DPOConfig"),
])
def test_construction_checks_raise_as_jax(tmp_path, override, error, match):
    d = _config_dict(tmp_path)
    if override.get("method") == "sft":
        d["method"] = _sft_method()
    else:
        for section, values in override.items():
            d[section].update(values)
    with pytest.raises(error, match=match):
        JaxDPOTrainer(config=JaxTRLConfig.from_dict(copy.deepcopy(d)))
    with pytest.raises(error, match=match):
        DPOTrainer(config=TRLConfig.from_dict(d), device="cpu")


@pytest.mark.parametrize("override,setting", [
    ({"parallel": {"fsdp": 2}}, "parallel.fsdp"),
    # remat, trackers and the retention ring run; these wait for their
    # subsystems
    ({"resilience": {"fault_plan": "actor_crash@collection:2"}}, "resilience.fault_plan"),
    ({"resilience": {"fault_plan": "flightrec_dump@step:4; topology_shrink@resume:1"}},
     "resilience.fault_plan"),
    ({"parallel": {"scan_layers": True, "pipe": 4}}, "parallel.pipe"),
    ({"train": {"grad_accum": 3}}, "train.grad_accum"),
])
def test_unported_settings_raise(tmp_path, override, setting):
    d = _config_dict(tmp_path)
    for section, values in override.items():
        d[section].update(values)
    with pytest.raises(ValueError, match=setting.replace(".", r"\.")):
        DPOTrainer(config=TRLConfig.from_dict(d), device="cpu")


def test_default_dpo_config_matches_jax():
    assert default_dpo_config().to_dict() == jax_default_dpo_config().to_dict()
