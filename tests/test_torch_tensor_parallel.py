"""Tensor parallelism over the mesh's ``model`` axis
(``trlx_tpu_torch/parallel/tensor_parallel.py``).

In one process, with no processes started:

- the head-aligned split and replicate decisions of ``port_param_spec`` /
  ``tp_param_dims``: 4 query heads over 2 KV heads at ``model`` 4 (the
  query heads split, k/v replicate and each rank keeps the KV head its
  query head reads), GPT-2's 50257 vocabulary at ``model`` 4 (replicated,
  as JAX's ``fit_spec`` drops the axis), and ALiBi's slopes at ``model``
  2 (each rank takes those of its global heads);
- the vocab-parallel log-softmax and entropy against ``torch.log_softmax``
  on a split ``[B, T, V]``, forward and gradient; whole models cut with
  ``apply_tensor_parallel`` against the unsplit model (logits, loss and
  every gradient), at ``model`` 2 and, for llama's GQA, at ``model`` 4,
  where k/v replicate and their gradients are summed over ``model``;
  and the paged engine on each rank's heads against the
  unsharded engine's greedy tokens — with threads and an in-process
  stand-in for the ``model`` group's collectives
  (``tests/torch_tp_cases.py``).

Over two ``gloo`` processes at ``model`` 2 (``tests/torch_parallel_rl_worker.py``)
against JAX's ``train()`` on the virtual mesh, with JAX's initial weights:

- PPO with the fused loss kernels' plain versions on ``gpt2-test``
  (its 259-token vocabulary replicates the head);
- ILQL on ``gptneox-test`` with a 260-token vocabulary: the word
  embedding, the LM head and the Q heads' ``out_proj`` run
  vocab-parallel / row-parallel, with ``fsdp`` 2 beside ``model`` 2 (four
  ranks);
- GRPO on ``mixtral-test`` (the experts' ffn over ``model``, GQA) and
  DPO with LoRA on ``llama-test`` (adapters replicated, their gradients
  summed over ``model``), both with a 260-token vocabulary, so their
  losses read the vocab-parallel log-softmax of each rank's slice. DPO
  with LoRA is held to the port's one-process run: JAX's mask trains the
  frozen base of a head-less policy (ROADMAP's documented disagreements).

Every step's losses and gradient norm agree with JAX's to 1e-5 relative,
the final weights to 1e-5 in each tensor's 2-norm, and the ranks' stores
and gathered weights are bitwise equal.
"""

import json

import numpy as np
import pytest
import torch

from torch_rl_runs import NOISE_ONLY, check_params, check_steps, config_dict, jax_run, \
    run_world, with_sections
from torch_threads import use_one_cpu_thread
from torch_tp_cases import ENGINE_OVERRIDES, ENGINE_SPEC, engine_prompts, engine_tokens, \
    run_ranks

from trlx_tpu_torch.models.builder import build_causal_lm, resolve_transformer_config
from trlx_tpu_torch.models.transformer import alibi_slopes, attn_inputs
from trlx_tpu_torch.parallel import tensor_parallel as tpm
from trlx_tpu_torch.parallel.mesh import mesh_shape_from_config
from trlx_tpu_torch.parallel.sharding import port_param_spec
from trlx_tpu_torch.data.configs import ParallelConfig

use_one_cpu_thread()

MESH4 = {"data": 1, "pipe": 1, "fsdp": 1, "model": 4, "sequence": 1, "expert": 1}


# ---------------------------------------------------------------------------
# the split decisions
# ---------------------------------------------------------------------------


def test_gqa_heads_split_and_kv_heads_replicate_at_model_4():
    cfg = resolve_transformer_config("builtin:llama-test")  # H 4, KV 2
    assert (cfg.num_heads, cfg.kv_heads) == (4, 2)
    spec = {name: port_param_spec(name, shape, False, MESH4, cfg)
            for name, shape in [("blocks.0.attn.q_proj.weight", (64, 64)),
                                ("blocks.0.attn.k_proj.weight", (32, 64)),
                                ("blocks.0.attn.v_proj.weight", (32, 64)),
                                ("blocks.0.attn.o_proj.weight", (64, 64))]}
    assert spec["blocks.0.attn.q_proj.weight"][0] == "model"
    assert "model" not in spec["blocks.0.attn.k_proj.weight"]
    assert "model" not in spec["blocks.0.attn.v_proj.weight"]
    assert spec["blocks.0.attn.o_proj.weight"][1] == "model"
    assert tpm.tp_param_dims("blocks.0.attn.k_proj.weight", (32, 64), cfg, 4) is None
    assert tpm.tp_param_dims("blocks.0.attn.q_proj.weight", (64, 64), cfg, 4) == 0
    # one query head per rank, reading KV head h // 2
    assert [tpm.kv_heads_of_rank(cfg, 4, r) for r in range(4)] == [[0], [0], [1], [1]]
    assert tpm.local_kv_heads(cfg, 4) == 1
    assert [tpm.kv_heads_of_rank(cfg, 2, r) for r in range(2)] == [[0], [1]]
    # model 3 divides no head count: attention replicates
    assert not tpm.attention_split(cfg, 3)
    assert tpm.tp_param_dims("blocks.0.attn.q_proj.weight", (64, 64), cfg, 3) is None


def test_gpt2_vocab_replicates_at_model_4():
    cfg = resolve_transformer_config("builtin:gpt2-small")
    assert cfg.vocab_size == 50257 and not tpm.vocab_split(cfg, 4)
    assert port_param_spec("wte.weight", (50257, 768), False, MESH4, cfg) == (None, None)
    assert tpm.tp_param_dims("wte.weight", (50257, 768), cfg, 4) is None
    # its heads (12) and ffn (3072) split
    assert tpm.tp_param_dims("blocks.0.attn.q_proj.weight", (768, 768), cfg, 4) == 0
    assert tpm.tp_param_dims("blocks.0.mlp.down_proj.weight", (768, 3072), cfg, 4) == 1
    # GPT-NeoX-20B's 50432 splits (12608 ids a rank) under its ILQL heads
    neox = resolve_transformer_config("builtin:gptneox-20b")
    assert port_param_spec("backbone.wte.weight", (50432, 6144), True, MESH4, neox)[0] == \
        ("model", "fsdp")
    assert tpm.tp_param_dims("backbone.wte.weight", (50432, 6144), neox, 4) == 0


def test_alibi_slopes_follow_the_ranks_heads():
    cfg = resolve_transformer_config("builtin:bloom-test")  # H 4
    mask = torch.ones((1, 5), dtype=torch.int64)
    slots = torch.arange(5)[None]
    whole = alibi_slopes(cfg.num_heads)
    for r, heads in enumerate([(0, 2), (2, 4)]):
        _, args = attn_inputs(cfg, mask, slots, slots, True, heads=heads)
        np.testing.assert_array_equal(args["alibi_slopes"].numpy(),
                                      whole[2 * r:2 * r + 2].astype(np.float32))


def test_fsdp_is_inferred_beside_model():
    """``examples/ilql_sentiments_20b.py``'s axes: fsdp takes what model leaves."""
    par = ParallelConfig(data=1, fsdp=-1, model=4)
    assert mesh_shape_from_config(par, 4) == (1, 1, 1, 4, 1, 1)
    assert mesh_shape_from_config(par, 8) == (1, 1, 2, 4, 1, 1)


@pytest.mark.parametrize("n", [2, 4])
def test_vocab_parallel_logprobs_and_entropy(monkeypatch, n):
    rs = np.random.RandomState(0)
    logits = torch.tensor(rs.randn(3, 5, 16) * 3, dtype=torch.float32)
    labels = torch.tensor(rs.randint(0, 16, (3, 5)))
    weights = torch.tensor(rs.randn(3, 5), dtype=torch.float32)
    full = logits.clone().requires_grad_(True)
    want = torch.log_softmax(full, -1).gather(-1, labels[..., None])[..., 0]
    (want * weights).sum().backward()
    p = torch.softmax(logits, -1)
    want_h = -(p * torch.log_softmax(logits, -1)).sum(-1)

    def rank(tp):
        lo, hi = tp.part(16)
        x = logits[..., lo:hi].clone().requires_grad_(True)
        lp = tpm.vocab_parallel_logprobs(x, labels, lo, tp)
        (lp * weights).sum().backward()
        return lp.detach(), x.grad, tpm.vocab_parallel_entropy(x, tp)

    got = run_ranks(n, rank, monkeypatch)
    for lp, _, h in got:
        torch.testing.assert_close(lp, want.detach(), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(h, want_h, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(torch.cat([g for _, g, _ in got], -1), full.grad,
                               rtol=1e-6, atol=1e-6)


# spec → overrides of a cut model whose every split runs at model 2
MODELS = {
    "bloom-alibi": ("builtin:bloom-test", dict(vocab_size=260), None),
    "llama-gqa-lora": ("builtin:llama-test", dict(vocab_size=260, lora_r=4, lora_alpha=8.0,
                                                  lora_targets=("q_proj", "v_proj",
                                                                "o_proj", "down_proj")),
                       None),
    "mixtral-moe": ("builtin:mixtral-test", dict(vocab_size=260), None),
    "gptneox-ilql": ("builtin:gptneox-test", dict(vocab_size=260), "ilql"),
}


# every model at 2 ranks; llama's 2 KV heads at 4 ranks replicate k/v,
# each rank reading the KV head of its one query head
CUTS = [pytest.param(case, 2, id=case) for case in MODELS] + [
    pytest.param("llama-gqa-lora", 4, id="llama-gqa-lora-model4")]


@pytest.mark.parametrize("case,n", CUTS)
def test_cut_model_matches_the_whole_one(monkeypatch, case, n):
    """A model cut to each of ``n`` ranks' share gives the whole model's
    outputs, and its gradients are the whole model's, split."""
    spec, overrides, head = MODELS[case]
    kw = dict(param_dtype=torch.float32, dtype=torch.float32, **overrides)
    model, cfg = build_causal_lm(spec, seed=0, device="cpu", head=head, **kw)
    model.requires_grad_(True)
    rs = np.random.RandomState(1)
    ids = torch.tensor(rs.randint(0, cfg.vocab_size, (2, 7)))
    mask = torch.ones_like(ids)
    mask[0, :2] = 0

    def loss_of(m):
        out = m(ids, attention_mask=mask)
        loss = (out["logits"] * torch.linspace(-1, 1, out["logits"].shape[-1])).sum()
        if head == "ilql":
            loss = loss + sum((q * 0.5).sum() for q in out["qs"]) + out["vs"].sum()
        if "router_aux_loss" in out:
            loss = loss + out["router_aux_loss"].sum()
        return out["logits"].detach(), loss

    want_logits, want_loss = loss_of(model)
    want_loss.backward()
    want = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def rank(tp):
        m, _ = build_causal_lm(spec, seed=0, device="cpu", head=head, **kw)
        m.load_state_dict(state)
        m.requires_grad_(True)
        dims = tpm.apply_tensor_parallel(m, tp)
        logits, loss = loss_of(m)
        loss.backward()
        tpm.sync_model_grads(m)
        return logits, loss.detach(), dims, {k: p.grad for k, p in m.named_parameters()
                                               if p.grad is not None}

    got = run_ranks(n, rank, monkeypatch)
    dims = got[0][2]
    assert dims, "nothing was split"
    # the cut is the one the rule table's port specs name
    assert dims == {k: d for k, p in model.named_parameters()
                    if (d := tpm.tp_param_dims(k, tuple(p.shape), cfg, n)) is not None}
    for logits, loss, _, _ in got:
        torch.testing.assert_close(logits, want_logits, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(loss, want_loss.detach(), rtol=1e-5, atol=1e-4)
    for k, g in want.items():
        if k in dims:
            joined = torch.cat([r[3][k] for r in got], dims[k])
        else:
            joined = got[0][3][k]
            for r in got[1:]:  # replicated: equal on every rank
                assert torch.equal(joined, r[3][k]), k
        torch.testing.assert_close(joined, g, rtol=1e-4, atol=1e-5, msg=k)


def test_engine_on_each_ranks_heads_gives_the_unsharded_tokens(monkeypatch):
    """The paged engine of a model cut over 2 ranks: each rank's pool
    holds its KV heads, prefill and decode run on its heads, the sampler on
    the gathered logits, and every rank's greedy tokens are the whole
    model's."""
    kw = dict(param_dtype=torch.float32, dtype=torch.float32, **ENGINE_OVERRIDES)
    model, cfg = build_causal_lm(ENGINE_SPEC, seed=0, device="cpu", head="value", **kw)
    ids, mask = engine_prompts(cfg.vocab_size)
    want = engine_tokens(model, cfg, "cpu", ids, mask)

    def rank(tp):
        m, c = build_causal_lm(ENGINE_SPEC, seed=0, device="cpu", head="value",
                               tensor_parallel=tp, **kw)
        assert c.cache_kv_heads == cfg.kv_heads // 2
        return engine_tokens(m, c, "cpu", ids, mask)

    for got in run_ranks(2, rank, monkeypatch):
        assert sorted(got) == sorted(want)
        for row in want:
            np.testing.assert_array_equal(got[row], want[row])


# ---------------------------------------------------------------------------
# the trainers on two (four) gloo ranks against JAX's train()
# ---------------------------------------------------------------------------

LOSS_KEYS = {"ppo": ("losses/total_loss", "losses/policy_loss", "losses/value_loss"),
             "grpo": ("losses/total_loss", "losses/policy_loss", "losses/kl_loss"),
             "ilql": ("losses/loss", "losses/loss_q", "losses/loss_v", "losses/loss_cql",
                      "losses/loss_awac"),
             "dpo": ("losses/total_loss", "rewards/accuracy", "rewards/margin")}
PEFT = {"peft_type": "lora", "r": 4, "lora_alpha": 8, "modified_modules": "all"}

# case: (trainer, parallel axes, world, port-only method overrides, the
# sections both sides share)
CASES = {
    "ppo-model2": ("ppo", dict(data=1, model=2), 2, dict(loss_kernel="pallas"), {}),
    "ilql-model2-fsdp2-vocab": ("ilql", dict(data=1, fsdp=2, model=2), 4, {},
                                dict(model=dict(model_path="builtin:gptneox-test",
                                                model_extra_kwargs=dict(vocab_size=260)))),
    "grpo-model2-moe": ("grpo", dict(data=1, model=2), 2, {},
                        dict(model=dict(model_path="builtin:mixtral-test",
                                        model_extra_kwargs=dict(vocab_size=260)))),
    "dpo-model2-lora": ("dpo", dict(data=1, model=2), 2, {},
                        dict(model=dict(model_path="builtin:llama-test", peft_kwargs=PEFT,
                                        model_extra_kwargs=dict(vocab_size=260)))),
}
# the V head's output bias takes Adam steps of f32 noise on the ILQL model
# (its exact gradient vanishes): 1.07e-5 in the 2-norm at world 1 too
NOISE = {"ilql-model2-fsdp2-vocab": (NOISE_ONLY, ".v_head.out_proj.bias")}
_JAX = {}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    def get(case):
        kind, _, _, _, shared = CASES[case]
        key = (kind, json.dumps(shared, sort_keys=True))
        if key not in _JAX:
            _JAX[key] = jax_run(kind, tmp_path_factory.mktemp(f"jax_{kind}"), **shared)
        return _JAX[key]
    return get


def _port(tmp_path, case, params0, **parallel):
    kind, axes, world, method, shared = CASES[case]
    d = with_sections(config_dict(kind, tmp_path / "ckpt", **(parallel or axes)), **shared)
    d["method"].update(method)
    return d, run_world(kind, tmp_path / case, d, params0, world=world if not parallel else 1)


@pytest.mark.parametrize("case", list(CASES))
def test_tensor_parallel_trainer_matches_jax(tmp_path, jax_runs, case):
    """Against JAX's ``train()``; DPO with LoRA against the port's
    one-process run of the same config instead: JAX's mask trains every
    leaf of a head-less policy, the frozen base under LoRA too (ROADMAP's
    documented disagreements), so its weights are not the oracle's."""
    kind, _, world, _, _ = CASES[case]
    want = jax_runs(case)
    d, got = _port(tmp_path, case, want["params0"])
    assert got["world"] == world
    keys = LOSS_KEYS[kind] + ("gradients/global_norm",)
    if kind == "dpo":
        _, want = _port(tmp_path / "one", case, want["params0"], data=-1, model=1)
        check_steps(got, want, want["steps"], keys)
        for k, w in want["params"].items():
            gap = np.linalg.norm(got["params"][k] - w) / max(np.linalg.norm(w), 1e-30)
            assert gap <= 1e-5, (k, gap)
    else:
        check_steps(got, want, want["steps"], keys)
        check_params(got["params"], want["params"], kind, config=d,
                     noise_only=NOISE.get(case, (NOISE_ONLY,)))
    assert len({r["weights"] for r in got["ranks"]}) == 1
    assert len({r["store"] for r in got["ranks"]}) == 1
