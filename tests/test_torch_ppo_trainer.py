"""The PPO slice of the port (``trlx_tpu_torch/trainer/ppo.py``) against the
JAX ``PPOTrainer``, on the CPU.

Both trainers run ``builtin:gpt2-test`` with ``num_layers_unfrozen: 1``
(the hydra reference branch), f32 compute, greedy rollouts on the paged
continuous-batching path (JAX with ``decode_kernel: xla``, bit-identical to
``pallas`` by its own contract; the port with its kernels' plain
versions) and ``loss_kernel: pallas`` on both sides; the port runs once
with ``attention_impl: xla`` and once with ``pallas`` (the flash branch's
plain versions). The port starts from the JAX initial weights
(``params_from_jax``). Held: the rollout store element by element and in
order (tokens equal; logprobs, values and rewards ``atol=1e-4``), each
optimizer step's loss, policy, value, return, ratio, learning-rate and
gradient-norm stats (``rtol=1e-4``), the final parameters (``atol=1e-4``)
and the frozen block bit-unchanged. ``trlx_tpu_torch.trlx.train`` is
driven end to end; the settings the port does not run raise ``ValueError``
naming the setting, and those it runs since the serial path was ported
(the serial path, ``grad_accum``, resume, the staged loss) each build a
trainer that takes a step. ``tests/test_torch_serial_rollouts.py`` holds
the serial path against the JAX trainer.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
from trlx_tpu.data.default_configs import default_ppo_config as jax_default_ppo_config
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPromptPipeline
from trlx_tpu.trainer.ppo import PPOTrainer as JaxPPOTrainer
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.default_configs import default_ppo_config
from trlx_tpu_torch.models.weights import params_from_jax
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.trainer.ppo import PPOTrainer
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

STAT_PREFIXES = ("losses/", "policy/", "values/", "old_values/", "returns/")
STAT_KEYS = ("ratio", "learning_rate", "gradients/global_norm")
RTOL, ATOL = 1e-4, 1e-4


def _config_dict(tmp):
    d = jax_default_ppo_config().to_dict()
    d["model"].update(model_path="builtin:gpt2-test", num_layers_unfrozen=1)
    d["parallel"].update(compute_dtype="float32")
    d["train"].update(
        seq_length=24, batch_size=4, total_steps=6, epochs=10, continuous_batching=True,
        continuous_batching_segment=3, rollout_pipeline_depth=0, prefetch_batches=0,
        save_best=False, checkpoint_interval=1000, eval_interval=1000,
        checkpoint_dir=str(tmp), tracker=None,
    )
    d["method"].update(
        num_rollouts=8, chunk_size=4, ppo_epochs=2, loss_kernel="pallas",
        init_kl_coef=0.05, gen_kwargs=dict(max_new_tokens=8, do_sample=False),
    )
    d["optimizer"]["kwargs"].update(lr=1e-3)
    d["scheduler"].update(name="cosine_annealing", kwargs=dict(T_max=10, eta_min=1e-4, lr=1e-3))
    d["engine"].update(backend="paged", kv_block_size=4, decode_kernel="pallas",
                       prefill_kernel="pallas")
    return d


def _prompts(n=8, seed=0):
    rs = np.random.RandomState(seed)
    return ["".join(chr(c) for c in rs.randint(97, 123, size=rs.randint(5, 15)))
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


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def _store(trainer):
    return [(e.query_tensor, e.response_tensor, e.logprobs, e.values, e.rewards)
            for e in trainer.store.history]


def _step_stats(history, n_steps):
    """The per-optimizer-step stats records (they carry a gradient norm)."""
    steps = [(s, st) for s, st in history if "gradients/global_norm" in st]
    assert len(steps) == n_steps
    return steps


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    d = _config_dict(tmp_path_factory.mktemp("jax_ckpt"))
    d["engine"].update(decode_kernel="xla", prefill_kernel="xla")
    config = JaxTRLConfig.from_dict(d)
    trainer = JaxPPOTrainer(config=config, reward_fn=reward_fn)
    params0 = _np_tree(trainer.state.params)
    ref0 = _np_tree(trainer.ref_params)
    trainer.tracker = _Recorder()
    max_prompt = config.train.seq_length - config.method.gen_kwargs["max_new_tokens"]
    trainer.add_prompt_pipeline(JaxPromptPipeline(_prompts(), max_prompt, trainer.tokenizer))
    trainer.make_experience(config.method.num_rollouts)
    first_store = copy.deepcopy(_store(trainer))
    trainer.add_eval_pipeline(JaxPromptPipeline(_prompts(4, seed=1), max_prompt,
                                                trainer.tokenizer))
    trainer.learn()
    return dict(params0=params0, ref0=ref0, first_store=first_store,
                final_store=_store(trainer), history=trainer.tracker.history,
                params=_np_tree(trainer.state.params))


def _compare_stores(ours, theirs):
    assert len(ours) == len(theirs)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        np.testing.assert_array_equal(a[0], b[0], err_msg=f"query {i}")
        np.testing.assert_array_equal(a[1], b[1], err_msg=f"response {i}")
        for j, name in ((2, "logprobs"), (3, "values"), (4, "rewards")):
            np.testing.assert_allclose(np.asarray(a[j], np.float32),
                                       np.asarray(b[j], np.float32),
                                       atol=ATOL, rtol=0, err_msg=f"{name} {i}")


@pytest.mark.parametrize("attention_impl", ["xla", "pallas"])
def test_ppo_slice_matches_jax_trainer(jax_run, tmp_path, attention_impl):
    d = _config_dict(tmp_path)
    d["model"]["model_extra_kwargs"] = {"attention_impl": attention_impl}
    config = TRLConfig.from_dict(d)
    trainer = PPOTrainer(config=config, reward_fn=reward_fn, device="cpu")
    trainer.model.load_state_dict(params_from_jax(jax_run["params0"], trainer.tcfg))
    trainer.ref_params = trainer._ref_snapshot()
    # the hydra reference is the JAX one, mapped through params_from_jax
    ref_sd = params_from_jax(jax_run["ref0"], trainer.tcfg)
    assert set(ref_sd) == set(trainer.ref_params.state_dict())
    for k, v in trainer.ref_params.state_dict().items():
        assert torch.equal(v, ref_sd[k]), k
    frozen0 = {k: v.clone() for k, v in trainer.model.state_dict().items()
               if k.startswith("backbone.blocks.0.")}

    max_prompt = config.train.seq_length - config.method.gen_kwargs["max_new_tokens"]
    trainer.add_prompt_pipeline(PromptPipeline(_prompts(), max_prompt, trainer.tokenizer))
    trainer.make_experience(config.method.num_rollouts)
    _compare_stores(_store(trainer), jax_run["first_store"])
    trainer.add_eval_pipeline(PromptPipeline(_prompts(4, seed=1), max_prompt,
                                             trainer.tokenizer))
    trainer.learn()
    _compare_stores(_store(trainer), jax_run["final_store"])

    ours = _step_stats(trainer.tracker.history, config.train.total_steps)
    theirs = _step_stats(jax_run["history"], config.train.total_steps)
    for (s_o, st_o), (s_t, st_t) in zip(ours, theirs):
        assert s_o == s_t
        keys = [k for k in st_t if k.startswith(STAT_PREFIXES) or k in STAT_KEYS]
        assert len(keys) > 20
        for k in keys:
            np.testing.assert_allclose(st_o[k], float(st_t[k]), rtol=RTOL, atol=1e-6,
                                       err_msg=f"step {s_o} {k}")
    final = params_from_jax(jax_run["params"], trainer.tcfg)
    for k, v in trainer.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), atol=ATOL, rtol=0, err_msg=k)
    for k, v in frozen0.items():
        assert torch.equal(trainer.model.state_dict()[k], v), k
    start = params_from_jax(jax_run["params0"], trainer.tcfg)
    for k in ("backbone.blocks.1.attn.q_proj.weight", "backbone.wte.weight",
              "backbone.ln_f.weight", "v_head.out_proj.weight"):
        assert not torch.equal(trainer.model.state_dict()[k], start[k]), k


def test_train_entry_point_end_to_end(tmp_path):
    import trlx_tpu_torch

    d = _config_dict(tmp_path)
    d["model"]["model_extra_kwargs"] = {"attention_impl": "pallas"}
    d["method"]["gen_kwargs"] = dict(max_new_tokens=8, do_sample=True, top_k=20)
    d["train"].update(total_steps=5, checkpoint_interval=4)
    config = TRLConfig.from_dict(d)
    trainer = trlx_tpu_torch.train(reward_fn=reward_fn, prompts=_prompts(), config=config,
                                   device="cpu")
    assert trainer.iter_count == 5 and trainer.step == 5
    losses = [st["losses/total_loss"] for _, st in trainer.tracker.history
              if "losses/total_loss" in st]
    assert len(losses) == 5 and np.all(np.isfinite(losses))
    assert (tmp_path / "checkpoint_4" / "state.pt").exists()
    assert (tmp_path / "checkpoint_5" / "state.pt").exists()
    state = torch.load(tmp_path / "checkpoint_5" / "state.pt")
    assert state["step"] == 5 and "kl_ctl_value" in state["extra"]


@pytest.mark.parametrize(
    "override,setting",
    [
        # async collection runs (tests/test_torch_async_rl.py); the parallel
        # axes wait for their subsystem
        ({"parallel": {"sequence": 2}}, "parallel.sequence"),
        # serving inside the trainer, the prefix cache and chunked prefill
        # run (tests/test_torch_serve_training.py, test_torch_prefix_cache.py,
        # test_torch_chunked_prefill.py); JAX's serve.* checks refuse
        ({"train": {"continuous_batching": False}, "serve": {"enabled": True}},
         "serve.enabled"),
        ({"serve": {"enabled": True, "host_tier_blocks": 4}}, "serve.host_tier_blocks"),
        ({"serve": {"enabled": True, "slots": 2, "reserve_slots": 2}}, "serve.reserve_slots"),
        ({"serve": {"enabled": True, "default_class": "vip"}}, "serve.default_class"),
        ({"engine": {"speculative": 2}}, "engine.speculative"),
        # speculation with the prefix cache and chunked prefill, the gather
        # kernels and the dense backend run (tests/test_torch_engine_paths.py);
        # the JAX trainer's checks: the paged knobs need the paged backend
        # on either path
        ({"train": {"continuous_batching": False},
          "engine": {"backend": "dense", "prefix_cache": True}}, "engine.prefix_cache"),
        ({"train": {"continuous_batching": False},
          "engine": {"backend": "dense"}}, "engine.decode_kernel"),
        ({"parallel": {"fsdp": 2}}, "parallel.fsdp"),
        ({"parallel": {"model": 2}}, "parallel.model"),
        # scanned layers run as per-layer modules, but not pipelined
        ({"parallel": {"scan_layers": True, "pipe": 2}}, "parallel.pipe"),
        # remat, trackers, profiles, rollout logs, the update guard, the
        # retention ring and the polled fault kinds run
        # (tests/test_torch_resilience_trainer.py, test_torch_trackers.py,
        # test_torch_remat.py), and so do the async kinds
        # (tests/test_torch_async_rl.py), and so do sigterm_one_proc and
        # topology_shrink (tests/test_torch_elastic.py): every kind is
        # polled. Expert parallelism waits for its slice
        ({"parallel": {"expert": 2}}, "parallel.expert"),
        # seq2seq PPO runs (tests/test_torch_seq2seq_trainers.py; its
        # continuous-batching refusal is tested below); an arch type the
        # port does not know is refused
        ({"model": {"model_arch_type": "encoder"}}, "model.model_arch_type"),
        # LoRA runs (tests/test_torch_lora.py); another PEFT type raises, as in JAX
        ({"model": {"peft_kwargs": {"peft_type": "prefix"}}}, "model.peft_kwargs"),
        # a draft whose vocabulary is not the policy's (50257 against 259)
        ({"model": {"draft_model_path": "builtin:gpt2-small"}}, "model.draft_model_path"),
        # data and fsdp run over several processes
        # (tests/test_torch_parallel_rl.py): at one process an axis of 2
        # does not fit the world, and a dcn factor must divide the data axis
        ({"parallel": {"data": 2}}, "parallel.data"),
        ({"parallel": {"dcn_data_parallelism": 2}}, "parallel.dcn_data_parallelism"),
        # flightrec_dump, health_trip and sleep_one_proc are polled
        # (tests/test_torch_health.py); a loss kernel of another name is not
        ({"method": {"loss_kernel": "triton"}}, "method.loss_kernel"),
        ({"parallel": {"pipe": 2}}, "parallel.pipe"),
        ({"parallel": {"data": 1, "fsdp": 2}}, "parallel.fsdp"),
        ({"method": {"loss_kernel": "mosaic"}}, "method.loss_kernel"),
        ({"train": {"batch_size": 5, "grad_accum": 2}}, "train.grad_accum"),
    ],
)
def test_rejected_settings_raise(tmp_path, override, setting):
    d = _config_dict(tmp_path)
    for section, values in override.items():
        d[section].update(values)
    with pytest.raises(ValueError, match=setting.replace(".", r"\.")) as err:
        PPOTrainer(config=TRLConfig.from_dict(copy.deepcopy(d)), reward_fn=reward_fn,
                   device="cpu")
    if setting == "model.peft_kwargs":  # JAX raises it too: its message, named
        with pytest.raises(ValueError) as jax_err:
            JaxPPOTrainer(config=JaxTRLConfig.from_dict(d), reward_fn=reward_fn)
        assert str(jax_err.value) in str(err.value)


def test_seq2seq_under_continuous_batching_raises_jax_message(tmp_path):
    """Seq2seq PPO runs (``tests/test_torch_seq2seq_trainers.py``), but not
    on the continuous path: JAX's ``NotImplementedError``, word for word."""
    d = _config_dict(tmp_path)
    assert d["train"]["continuous_batching"]
    d["model"].update(model_path="builtin:t5-test", model_arch_type="seq2seq")
    with pytest.raises(NotImplementedError) as err:
        PPOTrainer(config=TRLConfig.from_dict(d), reward_fn=reward_fn, device="cpu")
    assert str(err.value) == ("train.continuous_batching supports causal LMs only: the "
                              "seq2seq decoder has no slot-refill path")


@pytest.mark.parametrize(
    "override",
    [
        # settings the trainer rejected before the serial path was ported
        {"train": {"continuous_batching": False},
         "engine": {"backend": "dense", "decode_kernel": "xla", "prefill_kernel": "xla"}},
        {"train": {"grad_accum": 2}},
        {"train": {"resume_from_checkpoint": True}},
        {"method": {"loss_kernel": "xla"}},
    ],
    ids=["serial", "grad_accum", "resume", "staged_loss"],
)
def test_ported_settings_take_a_step(tmp_path, override):
    d = _config_dict(tmp_path)
    for section, values in override.items():
        d[section].update(values)
    trainer = PPOTrainer(config=TRLConfig.from_dict(d), reward_fn=reward_fn, device="cpu")
    max_prompt = d["train"]["seq_length"] - d["method"]["gen_kwargs"]["max_new_tokens"]
    trainer.add_prompt_pipeline(PromptPipeline(_prompts(), max_prompt, trainer.tokenizer))
    trainer.maybe_resume()  # an empty checkpoint_dir: nothing to load
    trainer.make_experience(d["method"]["num_rollouts"])
    trainer.prepare_learning()
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    stats = trainer.train_step(next(iter(trainer.train_dataloader)))
    assert trainer.step == 1 and np.isfinite(float(stats["losses/total_loss"]))
    assert float(stats["train/loss_kernel_pallas"]) == 0.0  # CPU tensors: plain versions
    moved = [k for k, v in trainer.model.state_dict().items() if not torch.equal(v, before[k])]
    assert "v_head.out_proj.weight" in moved


@pytest.mark.parametrize("num_rollouts,chunk_size,warns", [(4, 8, True), (8, 4, False),
                                                           (8, 8, False)])
def test_chunk_wider_than_collection_warns(tmp_path, caplog, num_rollouts, chunk_size, warns):
    # a collection that keeps part of a chunk keeps the rows that finish
    # first: the trainer says so when it is built
    d = _config_dict(tmp_path)
    d["method"].update(num_rollouts=num_rollouts, chunk_size=chunk_size)
    with caplog.at_level("WARNING", logger="trlx_tpu_torch.trainer.base"):
        PPOTrainer(config=TRLConfig.from_dict(d), reward_fn=reward_fn, device="cpu")
    assert any("short answers" in r.getMessage() for r in caplog.records) == warns


def test_config_tree_round_trips_and_rejects_typos():
    base = default_ppo_config()
    assert base.to_dict() == jax_default_ppo_config().to_dict()
    upd = TRLConfig.update(base.to_dict(), {"train.seed": 7, "method.gen_kwargs.top_k": 3})
    assert upd.train.seed == 7 and upd.method.gen_kwargs["top_k"] == 3
    assert base.evolve(method=dict(gamma=0.9)).method.gamma == 0.9
    with pytest.raises(ValueError, match="train.sede"):
        TRLConfig.update(base.to_dict(), {"train.sede": 1})


@pytest.mark.parametrize("name,kwargs", [
    ("cosine_annealing", dict(T_max=7, eta_min=1e-5)),
    ("linear", dict(end_value=1e-5, total_steps=6)),
    ("constant", {}),
    ("warmup_cosine", dict(warmup_steps=3, decay_steps=9, end_value=2e-5)),
])
def test_schedules_match_jax(name, kwargs):
    from trlx_tpu.utils import get_scheduler as jax_get_scheduler
    from trlx_tpu_torch.utils import get_scheduler

    ours = get_scheduler(name, kwargs, default_lr=3e-4)
    theirs = jax_get_scheduler(name, kwargs, default_lr=3e-4)
    for step in range(12):
        np.testing.assert_allclose(ours(step), float(theirs(step)), rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("name", ["adamw", "adam"])
def test_optimizers_match_optax(name):
    """optax.adamw and torch AdamW (and the two Adams) take the same steps:
    decoupled decay from the pre-step value, eps outside the root."""
    from trlx_tpu.utils import get_optimizer as jax_get_optimizer
    from trlx_tpu.utils import get_scheduler as jax_get_scheduler
    from trlx_tpu_torch.utils import get_optimizer, get_scheduler

    kwargs = dict(lr=1e-2, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1)
    sched = dict(T_max=5, eta_min=1e-3)
    rs = np.random.RandomState(0)
    w0 = rs.randn(4, 3).astype(np.float32)
    grads = [rs.randn(4, 3).astype(np.float32) for _ in range(4)]
    opt = jax_get_optimizer(name, kwargs, jax_get_scheduler("cosine_annealing", sched, 1e-2))
    params = {"w": jax.numpy.asarray(w0)}
    state = opt.init(params)
    w = torch.nn.Parameter(torch.tensor(w0))
    topt = get_optimizer(name, kwargs, [w])
    schedule = get_scheduler("cosine_annealing", sched, 1e-2)
    for step, g in enumerate(grads):
        updates, state = opt.update({"w": jax.numpy.asarray(g)}, state, params)
        params = {"w": params["w"] + updates["w"]}
        for group in topt.param_groups:
            group["lr"] = schedule(step)
        w.grad = torch.tensor(g)
        topt.step()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(params["w"]),
                                   rtol=1e-5, atol=1e-7, err_msg=f"step {step}")


def test_sketches_match_jax():
    from trlx_tpu.observability import dynamics as jax_dynamics
    from trlx_tpu_torch.observability import dynamics

    rs = np.random.RandomState(3)
    x = (rs.randn(5, 9) * 3).astype(np.float32)
    x[0, :3] = [-5.0, 0.3125, 5.0]  # a lower edge, an interior edge, the upper edge
    mask = (rs.rand(5, 9) > 0.3).astype(np.float32)
    for lo, hi in ((-5.0, 5.0), (0.0, 1.0)):
        want = np.asarray(jax_dynamics.sketch(jax.numpy.asarray(x), jax.numpy.asarray(mask),
                                              lo=lo, hi=hi))
        np.testing.assert_array_equal(
            dynamics.sketch(torch.tensor(x), torch.tensor(mask), lo=lo, hi=hi).numpy(), want)
        np.testing.assert_array_equal(dynamics.sketch_np(x, mask, lo=lo, hi=hi), want)
    logits = rs.randn(3, 7).astype(np.float32)
    np.testing.assert_allclose(
        dynamics.entropy_of_logits(torch.tensor(logits)).numpy(),
        np.asarray(jax_dynamics.entropy_of_logits(jax.numpy.asarray(logits))), rtol=1e-6)
    assert dynamics.SKETCH_RANGES == jax_dynamics.SKETCH_RANGES
