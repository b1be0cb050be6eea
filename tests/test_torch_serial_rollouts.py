"""The PPO default path of the port — serial dense rollouts, plain,
pipelined and speculative, the staged loss and gradient accumulation —
against the JAX package, on the CPU.

- the whole slice: ``trlx_tpu.train`` and ``trlx_tpu_torch.train`` on
  ``default_ppo_config()`` cut only in model (``builtin:gpt2-test``, f32),
  lengths, steps and greedy rollouts, the port starting from the JAX
  initial weights (``params_from_jax``): at pipeline depth 0 and 2, with
  ``loss_kernel`` xla and pallas, and with ``grad_accum`` 1 and 2. The
  last store agrees element by element (tokens equal, logprobs, values and
  rewards at ``ATOL``), each optimizer step's stats at ``RTOL`` relative
  (``STAT_ATOL`` absolute) and the final weights at ``ATOL``;
- the serial speculative ``generate`` of a PPO trainer (a draft of other
  weights) equals JAX's token for token, with the same acceptance;
- the transition ``logit_mask`` shapes the serial greedy rollouts as JAX's;
- ``dense_kv_bytes`` equals JAX's and what the port allocates, and the
  trainer's ``memory/kv_cache_bytes`` gauge counts it (and the draft's
  cache under speculation);
- :class:`SerialEngine` steps equal serial ``generate`` calls and refuse
  the continuous queue;
- sampled rollouts: the store at depth 2 equals depth 0 element for
  element;
- :class:`RolloutPipeline`: the six cases of
  ``tests/test_rollout_pipeline.py::TestRolloutPipeline``, and the
  prefetch loader and ILQL's pipelined tokenization against depth 0.
"""

import copy
import dataclasses
import threading
import time

import jax
import numpy as np
import pytest
import torch

import trlx_tpu
import trlx_tpu_torch
from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
from trlx_tpu.data.default_configs import default_ppo_config as jax_default_ppo_config
from trlx_tpu.ops.paged_kv import dense_kv_bytes as jax_dense_kv_bytes
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JaxPromptPipeline
from trlx_tpu.trainer.ppo import PPOTrainer as JaxPPOTrainer
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.engine.core import SerialEngine
from trlx_tpu_torch.models.transformer import TransformerConfig, make_kv_cache
from trlx_tpu_torch.models.weights import params_from_jax
from trlx_tpu_torch.ops.paged_kv import dense_kv_bytes, kv_bytes
from trlx_tpu_torch.ops.sampling import GenerationConfig, generate
from trlx_tpu_torch.pipeline import BatchLoader, PrefetchLoader
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.pipeline.rollout_pipeline import RolloutPipeline
from trlx_tpu_torch.trainer.ppo import PPOTrainer
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

STAT_PREFIXES = ("losses/", "policy/", "values/", "old_values/", "returns/")
STAT_KEYS = ("ratio", "learning_rate", "gradients/global_norm")
RTOL, ATOL = 1e-5, 1e-5
# an absolute floor for the stats that vanish in exact arithmetic: a
# collection's first policy loss (whitened advantages at ratio 1) is
# rounding noise of ~1e-7 on both sides
STAT_ATOL = 1e-6


def _config_dict(tmp, **train):
    """``default_ppo_config()`` cut in model, lengths and steps, greedy:
    num_rollouts 128 in chunks of 128, batch 32 and 4 PPO epochs are the
    preset's, so 20 steps are two collections."""
    d = jax_default_ppo_config().to_dict()
    d["model"].update(model_path="builtin:gpt2-test", num_layers_unfrozen=1)
    d["parallel"].update(compute_dtype="float32")
    d["train"].update(seq_length=24, total_steps=20, checkpoint_dir=str(tmp), **train)
    d["method"]["gen_kwargs"].update(max_new_tokens=8, do_sample=False)
    return d


def _prompts(n=48, seed=0):
    rs = np.random.RandomState(seed)
    return ["".join(chr(c) for c in rs.randint(97, 123, size=rs.randint(3, 17)))
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


def _jax_run(tmp, **train):
    """JAX ``train()`` on the cut preset; its initial weights, history,
    last store and final weights."""
    out = {}

    def hook(trainer):
        out["params0"] = jax.tree_util.tree_map(np.asarray, trainer.state.params)
        trainer.tracker = _Recorder()

    trainer = trlx_tpu.train(reward_fn=reward_fn, prompts=_prompts(),
                             config=JaxTRLConfig.from_dict(_config_dict(tmp, **train)),
                             init_trainer_hook=hook)
    out.update(history=trainer.tracker.history, store=_store(trainer),
               params=jax.tree_util.tree_map(np.asarray, trainer.state.params))
    return out


def _port_run(tmp, jax_run, **overrides):
    """The port's ``train()`` on the same config (``overrides`` by
    section), from the JAX initial weights."""
    d = _config_dict(tmp)
    for section, values in overrides.items():
        d[section].update(values)

    def hook(trainer):
        trainer.model.load_state_dict(params_from_jax(jax_run["params0"], trainer.tcfg))
        trainer.ref_params = trainer._ref_snapshot()

    return trlx_tpu_torch.train(reward_fn=reward_fn, prompts=_prompts(),
                                config=TRLConfig.from_dict(d), init_trainer_hook=hook,
                                device="cpu")


@pytest.fixture(scope="module")
def jax_serial(tmp_path_factory):
    return _jax_run(tmp_path_factory.mktemp("jax_serial"))


@pytest.fixture(scope="module")
def jax_accum(tmp_path_factory):
    return _jax_run(tmp_path_factory.mktemp("jax_accum"), grad_accum=2)


def _compare(trainer, jax_run):
    ours, theirs = _store(trainer), jax_run["store"]
    assert len(ours) == len(theirs) == 128
    for i, (a, b) in enumerate(zip(ours, theirs)):
        np.testing.assert_array_equal(a[0], b[0], err_msg=f"query {i}")
        np.testing.assert_array_equal(a[1], b[1], err_msg=f"response {i}")
        for j, name in ((2, "logprobs"), (3, "values"), (4, "rewards")):
            np.testing.assert_allclose(np.asarray(a[j], np.float32), np.asarray(b[j], np.float32),
                                       atol=ATOL, rtol=0, err_msg=f"{name} {i}")
    steps = [(s, st) for s, st in trainer.tracker.history if "gradients/global_norm" in st]
    jsteps = [(s, st) for s, st in jax_run["history"] if "gradients/global_norm" in st]
    assert len(steps) == len(jsteps) == 20
    for (s_o, st_o), (s_t, st_t) in zip(steps, jsteps):
        assert s_o == s_t
        keys = [k for k in st_t if k.startswith(STAT_PREFIXES) or k in STAT_KEYS]
        assert len(keys) > 20
        for k in keys:
            np.testing.assert_allclose(st_o[k], float(st_t[k]), rtol=RTOL, atol=STAT_ATOL,
                                       err_msg=f"step {s_o} {k}")
    final = params_from_jax(jax_run["params"], trainer.tcfg)
    for k, v in trainer.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), atol=ATOL, rtol=0, err_msg=k)
    # the collections' stats carry the JAX serial path's keys
    collections = [st for _, st in trainer.tracker.history if "time/exp" in st]
    jcollections = [st for _, st in jax_run["history"] if "time/exp" in st]
    assert len(collections) == len(jcollections) == 2
    for key in ("time/rollout", "time/exp_generate", "time/generate",
                "throughput/slot_utilization", "throughput/rollout_overlap_frac",
                "memory/kv_cache_bytes"):
        assert key in collections[-1], key
    np.testing.assert_allclose(collections[-1]["throughput/slot_utilization"],
                               jcollections[-1]["throughput/slot_utilization"], rtol=1e-12)


@pytest.mark.parametrize("depth,loss_kernel", [(0, "xla"), (2, "xla"), (2, "pallas")])
def test_serial_slice_matches_jax_trainer(jax_serial, tmp_path, depth, loss_kernel):
    trainer = _port_run(tmp_path, jax_serial, train={"rollout_pipeline_depth": depth},
                        method={"loss_kernel": loss_kernel})
    assert not trainer.config.train.continuous_batching
    assert trainer.config.train.prefetch_batches == 2
    _compare(trainer, jax_serial)
    steps = [st for _, st in trainer.tracker.history if "gradients/global_norm" in st]
    # CPU tensors: the fused path ran its kernels' plain versions
    assert all(st["train/loss_kernel_pallas"] == 0.0 for st in steps)


@pytest.mark.parametrize("loss_kernel", ["xla", "pallas"])
def test_grad_accum_matches_jax_trainer(jax_accum, tmp_path, loss_kernel):
    trainer = _port_run(tmp_path, jax_accum, train={"grad_accum": 2},
                        method={"loss_kernel": loss_kernel})
    _compare(trainer, jax_accum)


def test_grad_accum_is_the_mean_of_its_micro_batches(tmp_path):
    """``grad_accum`` 2 on a batch gives the mean of the ``grad_accum`` 1
    gradients and stats of its two halves (each half whitens its own
    advantages, as JAX's scan does)."""
    d = _config_dict(tmp_path)
    d["method"].update(num_rollouts=16, chunk_size=16)
    trainer = PPOTrainer(config=TRLConfig.from_dict(d), reward_fn=reward_fn, device="cpu")
    max_prompt = 24 - 8
    trainer.add_prompt_pipeline(PromptPipeline(_prompts(16), max_prompt, trainer.tokenizer))
    trainer.make_experience(16)
    batch = next(iter(trainer.store.create_loader(16)))
    arrays = trainer._device_batch(batch)
    halves = []
    for i in range(2):
        trainer.config.train.grad_accum = 1
        stats = trainer.accumulate_grads({k: v[8 * i: 8 * (i + 1)] for k, v in arrays.items()})
        halves.append(({k: v.clone() for k, v in stats.items()},
                       {n: p.grad.clone() for n, p in trainer.model.named_parameters()}))
    trainer.config.train.grad_accum = 2
    stats = trainer.accumulate_grads(arrays)
    for k, v in stats.items():
        torch.testing.assert_close(v, (halves[0][0][k] + halves[1][0][k]) / 2, rtol=0, atol=0)
    for n, p in trainer.model.named_parameters():
        torch.testing.assert_close(p.grad, (halves[0][1][n] + halves[1][1][n]) / 2,
                                   rtol=0, atol=0)


def _trainer_pair(tmp_path, logit_mask=None, **model):
    """A JAX and a port PPO trainer on the cut preset (serial, greedy)
    with the port's weights (and draft) set from JAX's."""
    d = _config_dict(tmp_path)
    d["model"].update(model)
    jt = JaxPPOTrainer(config=JaxTRLConfig.from_dict(copy.deepcopy(d)), reward_fn=reward_fn,
                       logit_mask=logit_mask)
    pt = PPOTrainer(config=TRLConfig.from_dict(d), reward_fn=reward_fn, device="cpu",
                    logit_mask=logit_mask)
    pt.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jt.state.params), pt.tcfg))
    if pt.draft_model is not None:
        pt.draft_model.load_state_dict(params_from_jax(jax.tree_util.tree_map(
            np.asarray, jt.draft_params), pt.draft_tcfg))
    batch = next(iter(PromptPipeline(_prompts(6, seed=5), 16, pt.tokenizer).create_loader(6)))
    return jt, pt, np.asarray(batch["input_ids"]), np.asarray(batch["attention_mask"])


def test_serial_speculative_generate_matches_jax(tmp_path):
    jt, pt, ids, mask = _trainer_pair(tmp_path, draft_model_path="builtin:gpt2-test",
                                      draft_gamma=3)
    theirs = jt.generate(ids, mask)
    ours = pt.generate(ids, mask)
    np.testing.assert_array_equal(ours["response_tokens"], np.asarray(theirs.response_tokens))
    np.testing.assert_array_equal(ours["response_mask"], np.asarray(theirs.response_mask))
    np.testing.assert_allclose(ours["response_logprobs"], np.asarray(theirs.response_logprobs),
                               atol=ATOL, rtol=0)
    for k in ("rollout/spec_acceptance_rate", "rollout/spec_rounds"):
        assert pt.last_generate_stats[k] == pytest.approx(jt.last_spec_stats[k], rel=1e-6), k
    assert 0.0 < pt.last_generate_stats["rollout/spec_acceptance_rate"] < 1.0
    # greedy speculation equals the plain greedy generate
    plain = generate(pt.model, torch.tensor(ids), torch.tensor(mask), torch.zeros(6),
                     pt._resolve_gen_config()[0])
    np.testing.assert_array_equal(ours["response_tokens"], plain.response_tokens.numpy())
    # the gauge: target and draft caches of P + N + gamma columns
    S = ids.shape[1] + 8 + 3
    assert pt.last_generate_stats["memory/kv_cache_bytes"] == (
        jax_dense_kv_bytes(jt.tcfg, 6, S) + jax_dense_kv_bytes(jt.draft_tcfg, 6, S))
    # a transition mask under speculation shapes draft and target alike,
    # as JAX's serial speculative sampler does
    rs = np.random.RandomState(3)
    logit_mask = rs.rand(pt.tcfg.vocab_size, pt.tcfg.vocab_size) < 0.3
    logit_mask[:, 97:123] |= rs.rand(pt.tcfg.vocab_size, 26) < 0.5
    for t in (jt, pt):
        t.logit_mask = logit_mask
        t._generate_fns.clear()
    theirs = jt.generate(ids, mask)
    ours = pt.generate(ids, mask)
    np.testing.assert_array_equal(ours["response_tokens"], np.asarray(theirs.response_tokens))
    np.testing.assert_allclose(ours["response_logprobs"], np.asarray(theirs.response_logprobs),
                               atol=ATOL, rtol=0)
    toks, prev = ours["response_tokens"], np.concatenate([ids[:, -1:], ours["response_tokens"]
                                                          [:, :-1]], axis=1)
    live = ours["response_mask"] > 0
    assert logit_mask[prev[live], toks[live]].all()


def test_logit_mask_shapes_serial_rollouts_as_jax(tmp_path):
    V = 259
    rs = np.random.RandomState(3)
    logit_mask = rs.rand(V, V) < 0.3
    logit_mask[:, 97:123] |= rs.rand(V, 26) < 0.5  # keep letters reachable
    jt, pt, ids, mask = _trainer_pair(tmp_path, logit_mask=logit_mask)
    theirs = jt.generate(ids, mask)
    ours = pt.generate(ids, mask)
    np.testing.assert_array_equal(ours["response_tokens"], np.asarray(theirs.response_tokens))
    np.testing.assert_allclose(ours["response_logprobs"], np.asarray(theirs.response_logprobs),
                               atol=1e-4, rtol=0)
    toks = ours["response_tokens"]
    prev = np.concatenate([ids[:, -1:], toks[:, :-1]], axis=1)
    live = ours["response_mask"] > 0
    assert logit_mask[prev[live], toks[live]].all()


@pytest.mark.parametrize("spec", ["test", "small"])
def test_dense_kv_bytes_match_jax_and_the_allocation(spec):
    from trlx_tpu.models.transformer import TransformerConfig as JaxConfig

    for dtype, jdtype in ((torch.float32, jax.numpy.float32),
                          (torch.bfloat16, jax.numpy.bfloat16)):
        cfg = TransformerConfig.gpt2(spec, dtype=dtype)
        jcfg = dataclasses.replace(JaxConfig.gpt2(spec), dtype=jdtype)
        for B, S in ((1, 1), (3, 17), (128, 104)):
            assert dense_kv_bytes(cfg, B, S) == jax_dense_kv_bytes(jcfg, B, S)
            if spec == "test":
                assert dense_kv_bytes(cfg, B, S) == kv_bytes(make_kv_cache(cfg, B, S))


def test_serial_engine_steps_equal_generate_calls(tmp_path):
    d = _config_dict(tmp_path)
    d["method"]["gen_kwargs"].update(do_sample=True)
    trainer = PPOTrainer(config=TRLConfig.from_dict(d), reward_fn=reward_fn, device="cpu")
    batch = next(iter(PromptPipeline(_prompts(6), 16, trainer.tokenizer).create_loader(6)))
    ids, mask = np.asarray(batch["input_ids"]), np.asarray(batch["attention_mask"])
    gen_config, extra = trainer._resolve_gen_config()
    engine = trainer._get_serial_engine(gen_config, extra)
    assert isinstance(engine, SerialEngine)
    with pytest.raises(NotImplementedError, match="submit_chunk"):
        engine.enqueue_prompts(ids, mask, np.arange(6))
    seeds = np.arange(100, 112)
    engine.submit_chunk(ids, mask, seeds[:6])
    engine.submit_chunk(ids[::-1], mask[::-1], seeds[6:])
    done = engine.run()
    assert [c.index for c in done] == list(range(12)) and not engine.busy
    for chunk, (i, m, s) in enumerate(((ids, mask, seeds[:6]),
                                       (ids[::-1], mask[::-1], seeds[6:]))):
        out = generate(trainer.model, torch.tensor(np.ascontiguousarray(i)),
                       torch.tensor(np.ascontiguousarray(m)), torch.tensor(s), gen_config)
        for r in range(6):
            c = done[6 * chunk + r]
            np.testing.assert_array_equal(c.tokens, out.response_tokens[r].numpy())
            np.testing.assert_array_equal(c.logprobs, out.response_logprobs[r].numpy())
            np.testing.assert_array_equal(c.prompt_ids, i[r])
    assert engine.stats.harvested == 12 and engine.stats.segments == 2
    assert 0.0 < engine.stats.slot_utilization <= 1.0


def test_sampled_store_at_depth_2_equals_depth_0(tmp_path):
    stores = {}
    for depth in (0, 2):
        d = _config_dict(tmp_path / str(depth), rollout_pipeline_depth=depth)
        d["method"].update(num_rollouts=40, chunk_size=16)
        d["method"]["gen_kwargs"].update(do_sample=True)
        trainer = PPOTrainer(config=TRLConfig.from_dict(d), reward_fn=reward_fn, device="cpu")
        trainer.add_prompt_pipeline(PromptPipeline(_prompts(), 16, trainer.tokenizer))
        trainer.make_experience(40)
        trainer.make_experience(40)  # the second collection continues both streams
        stores[depth] = (_store(trainer), trainer.running_moments.mean,
                         trainer.running_moments.var, trainer._prompt_chunks_drawn)
    (a, *ma), (b, *mb) = stores[0], stores[2]
    assert ma == mb and ma[-1] == 6
    assert len(a) == len(b) == 80
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


def _pipeline_threads():
    return [t for t in threading.enumerate() if t.name.startswith("trlx-") and t.is_alive()]


class TestRolloutPipeline:
    def test_ordered_finalize_under_varying_work_times(self):
        done = []
        with RolloutPipeline(depth=3, finalize=done.append) as pipe:
            for i in range(8):
                # earlier chunks sleep longer: the order must still hold
                pipe.submit(lambda i=i: (time.sleep(0.02 * (8 - i)), i)[1])
        assert done == list(range(8))
        assert pipe.stats.chunks == 8
        assert pipe.stats.host_work_s > 0

    def test_backpressure_bounds_in_flight(self):
        active, peak = [], []
        lock = threading.Lock()

        def work(i):
            with lock:
                active.append(i)
                peak.append(len(active))
            time.sleep(0.01)
            with lock:
                active.remove(i)
            return i

        done = []
        with RolloutPipeline(depth=2, finalize=done.append) as pipe:
            in_flight_at_submit = []
            for i in range(6):
                in_flight_at_submit.append(pipe.in_flight)
                pipe.submit(lambda i=i: work(i))
        assert max(peak) == 1  # one worker
        assert max(in_flight_at_submit) <= 2
        assert done == list(range(6))

    def test_worker_exception_propagates_and_joins(self):
        class Boom(RuntimeError):
            pass

        def bad():
            raise Boom("reward exploded")

        done = []
        pipe = RolloutPipeline(depth=2, finalize=done.append)
        pipe.submit(lambda: 1)
        pipe.submit(bad)
        with pytest.raises(Boom, match="reward exploded"):
            for _ in range(10):
                pipe.submit(lambda: 2)
                time.sleep(0.01)
            pipe.drain()
        assert _pipeline_threads() == []  # the worker joined on the failure
        assert done[0] == 1  # the completed prefix finalized first

    def test_finalize_exception_cancels(self):
        def finalize(r):
            raise ValueError("finalize rejects")

        with pytest.raises(ValueError, match="finalize rejects"):
            with RolloutPipeline(depth=1, finalize=finalize) as pipe:
                pipe.submit(lambda: 1)
                pipe.submit(lambda: 2)  # forces the retirement of chunk 1
                pipe.drain()
        assert _pipeline_threads() == []

    def test_depth_validation(self):
        with pytest.raises(ValueError):
            RolloutPipeline(depth=0)

    def test_overlap_accounting(self):
        # the worker busy 4 × 30 ms while the submitter "computes" 4 × 30 ms
        with RolloutPipeline(depth=2, finalize=lambda r: r) as pipe:
            t0 = time.perf_counter()
            for _ in range(4):
                pipe.submit(lambda: time.sleep(0.03))
                time.sleep(0.03)  # stand-in for device work
            pipe.drain()
            total = time.perf_counter() - t0
        frac = pipe.stats.overlap_frac(total)
        assert 0.0 < frac <= 1.0
        assert pipe.stats.overlap_s > 0.03


def test_prefetch_loader_keeps_order_and_raises():
    data = list(range(23))
    loader = BatchLoader(data, 4, collate_fn=list, shuffle=True, seed=3)
    reference = BatchLoader(data, 4, collate_fn=list, shuffle=True, seed=3)
    prefetched = PrefetchLoader(loader, depth=2)
    assert len(prefetched) == 6
    for _ in range(2):  # two epochs: the shuffle stream advances alike
        assert list(prefetched) == list(reference)
    for batch in prefetched:  # an early break stops the worker
        break
    time.sleep(0.3)
    assert not [t for t in threading.enumerate() if t.name == "trlx-prefetch" and t.is_alive()]

    def broken():
        yield [1]
        raise RuntimeError("collate failed")

    class Broken:
        def __iter__(self):
            return broken()

    with pytest.raises(RuntimeError, match="collate failed"):
        list(PrefetchLoader(Broken(), depth=1))


def test_ilql_pipelined_tokenization_equals_depth_0():
    from trlx_tpu_torch.data.tokenizer import from_config
    from trlx_tpu_torch.data.configs import TokenizerConfig
    from trlx_tpu_torch.trainer.ilql import make_experience

    tok = from_config(TokenizerConfig(tokenizer_path="builtin:bytes"))
    rs = np.random.RandomState(0)
    samples = [["".join(chr(c) for c in rs.randint(97, 123, size=rs.randint(1, 9))),
                "".join(chr(c) for c in rs.randint(97, 123, size=rs.randint(1, 9)))]
               for _ in range(150)]
    rewards = rs.randn(150).tolist()
    a = make_experience(samples, rewards, tok, max_length=32, pipeline_depth=0)
    b = make_experience(samples, rewards, tok, max_length=32, pipeline_depth=2)
    assert len(a) == len(b) == 150
    for x, y in zip(a.history, b.history):
        assert vars(x).keys() == vars(y).keys()
        for k in vars(x):
            np.testing.assert_array_equal(getattr(x, k), getattr(y, k))
