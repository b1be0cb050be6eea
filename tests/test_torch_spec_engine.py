"""Speculative continuous batching in the port (``engine.speculative: k``):
``ops/slot_refill.py``'s speculative segments on the paged
``ContinuousEngine``, and PPO through them, against the solo samplers and
the JAX package, on the CPU (``builtin:gpt2-test`` in f32, weights carried
from JAX through ``params_from_jax``; the kernel wrappers run their plain
versions).

- Sampled harvests (5 requests through 2 slots, block sizes 4 and 3,
  temperature 0.7, one row ending at an eos) equal the port's solo
  ``generate_speculative`` of each row bit for bit in all four fields: a
  row's draws depend only on its seed and round, and its caches only on
  its own columns. (The CPU's GEMMs round by row count below a few rows:
  the prompt width 12 keeps every refill and round on the GEMM path the
  solo run takes.)
- Greedy harvests equal JAX's solo ``generate_speculative`` of each row
  (tokens and mask equal, logprobs and values at 1e-5) — the oracle is the
  reference function, not the JAX engine's parity verdicts.
- Accept-all and reject-all accounting (JAX ``test_spec_engine.py``): the
  target as its own draft reads acceptance 1.0 and ``G + 1`` tokens per
  round; a draft proposing a token the target forbids reads 0.0 and 1.
- A speculative PPO trainer's store and per-step stats equal JAX
  ``PPOTrainer``'s under greedy ``gen_kwargs``, at the tolerances of
  ``tests/test_torch_ppo_trainer.py``; the JAX draft's weights load into
  the port's draft through ``params_from_jax`` unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_ppo_trainer import (
    RTOL,
    STAT_KEYS,
    STAT_PREFIXES,
    _compare_stores,
    _config_dict,
    _np_tree,
    _prompts as _text_prompts,
    _Recorder,
    _step_stats,
    _store,
    reward_fn,
)
from tests.test_torch_speculative import jax_solo, spec_models
from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
from trlx_tpu.ops.sampling import GenerationConfig as JaxGenerationConfig
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPromptPipeline
from trlx_tpu.trainer.ppo import PPOTrainer as JaxPPOTrainer
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.engine.core import ContinuousEngine
from trlx_tpu_torch.models.transformer import CausalTransformer
from trlx_tpu_torch.models.weights import params_from_jax
from trlx_tpu_torch.ops.paged_kv import PagedSpec, num_table_blocks
from trlx_tpu_torch.ops.sampling import GenerationConfig
from trlx_tpu_torch.ops.slot_refill import make_slot_refill_fns
from trlx_tpu_torch.ops.speculative import generate_speculative
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.trainer.ppo import PPOTrainer
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

B, P, N, G = 2, 12, 10, 3
PAD = 258
FIELDS = ("tokens", "logprobs", "values", "mask")


@pytest.fixture(scope="module")
def models():
    return spec_models()


def _prompts(R=5):
    """R requests through B=2 slots: refills mid-collection, ragged left
    padding."""
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 250, (R, P)).astype(np.int32)
    mask = np.ones((R, P), np.int32)
    mask[0, :3] = 0
    mask[2:3, :5] = 0
    ids[mask == 0] = PAD
    return ids, mask


def _engine(tcfg, target, draft, config, block_size=4, segment_len=2):
    paged = PagedSpec(block_size, 1 + 3 * B * num_table_blocks(P + N + G, block_size))
    fns = make_slot_refill_fns(tcfg, B, P, config, segment_len=segment_len, paged=paged,
                               speculative=G, draft_cfg=tcfg, device="cpu")
    return ContinuousEngine(fns, (target, draft), PAD)


def _harvest(engine, ids, mask, seeds):
    engine.enqueue_prompts(ids, mask, seeds)
    return {c.index: c for c in engine.run()}


def _sampled_config(eos):
    return GenerationConfig(max_new_tokens=N, do_sample=True, temperature=0.7,
                            eos_token_id=eos, pad_token_id=PAD)


def _solo(target, draft, ids, mask, seeds, config, i):
    out = generate_speculative(target, draft, torch.tensor(ids[i:i + 1]),
                               torch.tensor(mask[i:i + 1]), torch.tensor(seeds[i:i + 1]),
                               config, gamma=G)
    return {f: getattr(out, f"response_{f}")[0].numpy() for f in FIELDS}


@pytest.fixture(scope="module")
def sampled_case(models):
    """The requests, their seeds, an eos that ends row 1 early (its 4th
    sampled token) and the solo references under it."""
    _, target, draft, _ = models
    ids, mask = _prompts()
    seeds = np.arange(5, dtype=np.int64) + 100
    free = _solo(target, draft, ids, mask, seeds, _sampled_config(None), 1)
    config = _sampled_config(int(free["tokens"][3]))
    refs = [_solo(target, draft, ids, mask, seeds, config, i) for i in range(len(ids))]
    assert int(refs[1]["mask"].sum()) <= 4 < N
    return ids, mask, seeds, config, refs


@pytest.mark.parametrize("block_size", [4, 3])
def test_sampled_harvests_equal_solo_bitwise(models, sampled_case, block_size):
    _, target, draft, tcfg = models
    ids, mask, seeds, config, refs = sampled_case
    engine = _engine(tcfg, target, draft, config, block_size)
    got = _harvest(engine, ids, mask, seeds)
    assert sorted(got) == list(range(len(ids)))
    for i, ref in enumerate(refs):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got[i], f), ref[f],
                                          err_msg=f"bs={block_size} request {i} {f}")
    st = engine.stats
    m = st.metrics()
    assert st.harvested == 5 and st.refill_prefills >= 3
    assert m["rollout/spec_rounds"] > 0
    assert 0.0 < m["engine/spec_acceptance_rate"] <= 1.0
    assert 1.0 <= m["engine/spec_tokens_per_round"] <= G + 1
    assert st.spec_committed > st.spec_rounds  # several tokens per round
    # the plain versions ran on the CPU: no kernel launched
    assert m["engine/verify_kernel_launches"] == 0.0
    assert m["engine/spec_verify_kernel_pallas"] == 0.0
    assert engine.allocator.blocks_in_use == 0
    assert m["memory/kv_cache_bytes"] > sum(
        t.numel() * t.element_size() for layer in engine.state.cache.pool for t in layer.values())


def test_greedy_harvests_match_jax_solo(models):
    jm, target, draft, tcfg = models
    ids, mask = _prompts()
    free = generate_speculative(target, draft, torch.tensor(ids[2:3]), torch.tensor(mask[2:3]),
                                torch.zeros(1), GenerationConfig(
                                    max_new_tokens=N, do_sample=False, pad_token_id=PAD),
                                gamma=G)
    eos = int(free.response_tokens[0, 4])  # ends row 2 early
    jcfg = JaxGenerationConfig(max_new_tokens=N, do_sample=False, eos_token_id=eos,
                               pad_token_id=PAD)
    want = [jax_solo(jm, ids[i:i + 1], mask[i:i + 1], jax.random.PRNGKey(0), jcfg)
            for i in range(len(ids))]
    config = GenerationConfig(max_new_tokens=N, do_sample=False, eos_token_id=eos,
                              pad_token_id=PAD)
    got = _harvest(_engine(tcfg, target, draft, config, block_size=3), ids, mask,
                   np.arange(len(ids)))
    assert int(np.asarray(want[2].response_mask).sum()) <= 5
    for i, w in enumerate(want):
        for f in ("tokens", "mask"):
            np.testing.assert_array_equal(getattr(got[i], f),
                                          np.asarray(getattr(w, f"response_{f}"))[0])
        for f in ("logprobs", "values"):
            np.testing.assert_allclose(getattr(got[i], f),
                                       np.asarray(getattr(w, f"response_{f}"))[0],
                                       atol=1e-5, rtol=0, err_msg=f"request {i} {f}")


class _ForceToken(torch.nn.Module):
    """A model whose logits put all mass on ``token`` (``allow=True``) or
    forbid it (``allow=False``), with ``inner``'s caches and values."""

    def __init__(self, inner, token, allow):
        super().__init__()
        self.inner, self.token, self.allow = inner, token, allow

    def forward(self, *args, **kwargs):
        out = self.inner(*args, **kwargs)
        logits = out["logits"].clone()
        if self.allow:
            logits.fill_(-1e9)
            logits[..., self.token] = 0.0
        else:
            logits[..., self.token] = -1e9
        return {**out, "logits": logits}


def test_accept_all_and_reject_all_accounting(models):
    _, target, draft, tcfg = models
    ids, mask = _prompts(R=2)
    # N a multiple of G + 1 and no eos: no partial round blurs the count
    config = GenerationConfig(max_new_tokens=G + 1, do_sample=False, eos_token_id=None,
                              pad_token_id=PAD)
    engine = _engine(tcfg, target, target.backbone, config)
    _harvest(engine, ids, mask, np.arange(2))
    assert engine.stats.spec_acceptance_rate == 1.0
    assert engine.stats.spec_tokens_per_round == G + 1
    # the draft always proposes token 3, which the target forbids
    engine = _engine(tcfg, _ForceToken(target, 3, False), _ForceToken(draft, 3, True), config)
    _harvest(engine, ids, mask, np.arange(2))
    assert engine.stats.spec_acceptance_rate == 0.0
    assert engine.stats.spec_tokens_per_round == 1.0


def test_engine_validation(models):
    _, target, draft, tcfg = models
    paged = PagedSpec(4, 64)
    config = _sampled_config(None)
    with pytest.raises(ValueError, match="draft model"):
        make_slot_refill_fns(tcfg, B, P, config, paged=paged, speculative=G, device="cpu")
    with pytest.raises(ValueError, match="must be >= 0"):
        make_slot_refill_fns(tcfg, B, P, config, paged=paged, speculative=-1, device="cpu")
    with pytest.raises(ValueError, match="require the paged KV backend"):
        make_slot_refill_fns(tcfg, B, P, config, speculative=G, draft_cfg=tcfg, device="cpu")
    # the hooks run under speculation (tests/test_torch_engine_paths.py)
    hooked = make_slot_refill_fns(tcfg, B, P, config, paged=paged, speculative=G,
                                  draft_cfg=tcfg, device="cpu",
                                  adjust_logits=lambda step_out, logits: logits,
                                  transition_mask=np.ones((259, 259), bool))
    assert hooked.speculative == G
    engine = _engine(tcfg, target, draft, config)
    ids, mask = _prompts(R=1)
    with pytest.raises(ValueError, match="per-row greedy flag"):
        engine.enqueue_prompts(ids, mask, [0], greedy=[True])
    # the (target, draft) pair swaps as one object: a fresh tuple around the
    # same models is no change
    assert not engine.swap_params((target, draft))
    assert engine.swap_params((target, target.backbone))


def test_trainer_config_validation(tmp_path, caplog):
    """Each precondition its own error at construction, as in the JAX
    trainer; a draft without ``engine.speculative`` builds: the paged
    engine runs plain segments with it, as JAX's does, and the serial path
    speculates with it (``tests/test_torch_serial_rollouts.py``)."""
    def build(**over):
        d = _config_dict(tmp_path)
        for section, values in over.items():
            d[section].update(values)
        return PPOTrainer(config=TRLConfig.from_dict(d), reward_fn=reward_fn, device="cpu")

    with pytest.raises(ValueError, match="requires model.draft_model_path"):
        build(engine=dict(speculative=2))
    with pytest.raises(ValueError, match="backend: paged"):
        build(engine=dict(speculative=2, backend="dense"),
              model=dict(draft_model_path="builtin:gpt2-test"))
    with pytest.raises(ValueError, match="must be >= 0"):
        build(engine=dict(speculative=-1))
    t = build(engine=dict(speculative=2), model=dict(
        draft_model_path="builtin:gpt2-test", draft_model_extra_kwargs={"num_layers": 1}))
    assert t.draft_tcfg.num_layers == 1 and t.draft_tcfg.dtype == t.tcfg.dtype
    # the draft is seeded from train.seed + 1: not the policy's weights
    assert not torch.equal(t.draft_model.wte.weight, t.model.backbone.wte.weight)
    pair = t._engine_params()
    assert pair[0] is t.model and pair[1] is t.draft_model
    t = build(model=dict(draft_model_path="builtin:gpt2-test"))
    with caplog.at_level("WARNING"):
        fns = t._get_slot_refill_fns(*t._resolve_gen_config(), 2, 8, 3)
    assert fns.speculative == 0 and "engine.speculative" not in caplog.text


def test_train_entry_point_with_speculation(tmp_path):
    """``trlx_tpu_torch.train`` end to end with sampled speculative
    rollouts: every collection reports the spec gauges in range."""
    import trlx_tpu_torch

    d = _spec_config_dict(tmp_path)
    d["method"]["gen_kwargs"] = dict(max_new_tokens=8, do_sample=True, top_k=20)
    trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=_text_prompts(),
                                   config=TRLConfig.from_dict(d), device="cpu")
    assert trainer.iter_count == 4
    losses = [st["losses/total_loss"] for _, st in trainer.tracker.history
              if "losses/total_loss" in st]
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    collections = [st for _, st in trainer.tracker.history if "time/exp" in st]
    assert collections
    for st in collections:
        assert 0.0 < st["engine/spec_acceptance_rate"] <= 1.0
        assert 1.0 <= st["engine/spec_tokens_per_round"] <= G + 1
        assert st["rollout/spec_rounds"] > 0


# ---------------------------------------------------------------------------
# PPO through the speculative engine against JAX PPOTrainer
# ---------------------------------------------------------------------------

def _spec_config_dict(tmp):
    d = _config_dict(tmp)
    d["model"].update(draft_model_path="builtin:gpt2-test")
    d["engine"].update(speculative=G)
    d["train"].update(total_steps=4)
    return d


@pytest.fixture(scope="module")
def jax_spec_run(tmp_path_factory):
    d = _spec_config_dict(tmp_path_factory.mktemp("jax_spec_ckpt"))
    d["engine"].update(decode_kernel="xla", prefill_kernel="xla")
    config = JaxTRLConfig.from_dict(d)
    trainer = JaxPPOTrainer(config=config, reward_fn=reward_fn)
    params0, draft = _np_tree(trainer.state.params), _np_tree(trainer.draft_params)
    trainer.tracker = _Recorder()
    max_prompt = config.train.seq_length - config.method.gen_kwargs["max_new_tokens"]
    trainer.add_prompt_pipeline(JaxPromptPipeline(_text_prompts(), max_prompt, trainer.tokenizer))
    trainer.make_experience(config.method.num_rollouts)
    first = (_store(trainer), dict(trainer.make_experience_stats))
    trainer.add_eval_pipeline(JaxPromptPipeline(_text_prompts(4, seed=1), max_prompt,
                                                trainer.tokenizer))
    trainer.learn()
    return dict(params0=params0, draft=draft, first=first, final_store=_store(trainer),
                history=trainer.tracker.history)


def test_spec_ppo_matches_jax_trainer(jax_spec_run, tmp_path):
    config = TRLConfig.from_dict(_spec_config_dict(tmp_path))
    trainer = PPOTrainer(config=config, reward_fn=reward_fn, device="cpu")
    assert isinstance(trainer.draft_model, CausalTransformer)
    trainer.model.load_state_dict(params_from_jax(jax_spec_run["params0"], trainer.tcfg))
    trainer.ref_params = trainer._ref_snapshot()
    # the JAX draft (a bare LM tree) goes through params_from_jax unchanged
    draft_sd = params_from_jax(jax_spec_run["draft"], trainer.draft_tcfg)
    assert set(draft_sd) == set(trainer.draft_model.state_dict())
    trainer.draft_model.load_state_dict(draft_sd, strict=True)
    max_prompt = config.train.seq_length - config.method.gen_kwargs["max_new_tokens"]
    trainer.add_prompt_pipeline(PromptPipeline(_text_prompts(), max_prompt, trainer.tokenizer))
    trainer.make_experience(config.method.num_rollouts)
    want_store, want_stats = jax_spec_run["first"]
    _compare_stores(_store(trainer), want_store)
    stats = trainer.make_experience_stats
    # the rounds and the committed tokens follow the greedy decisions
    for k in ("rollout/spec_rounds", "engine/spec_tokens_per_round"):
        assert stats[k] == pytest.approx(want_stats[k], rel=1e-9), k
    assert 0.0 < stats["engine/spec_acceptance_rate"] <= 1.0
    trainer.add_eval_pipeline(PromptPipeline(_text_prompts(4, seed=1), max_prompt,
                                             trainer.tokenizer))
    trainer.learn()
    _compare_stores(_store(trainer), jax_spec_run["final_store"])
    ours = _step_stats(trainer.tracker.history, config.train.total_steps)
    theirs = _step_stats(jax_spec_run["history"], config.train.total_steps)
    for (s_o, st_o), (s_t, st_t) in zip(ours, theirs):
        assert s_o == s_t
        keys = [k for k in st_t if k.startswith(STAT_PREFIXES) or k in STAT_KEYS]
        assert len(keys) > 20
        for k in keys:
            np.testing.assert_allclose(st_o[k], float(st_t[k]), rtol=RTOL, atol=1e-6,
                                       err_msg=f"step {s_o} {k}")
