"""The RL and preference trainers over several processes: the port's
``train()`` on two ``gloo`` ranks (``tests/torch_parallel_rl_worker.py``)
against JAX's ``train()`` on the virtual 8-device mesh (data 2, fsdp 4).

The result does not depend on the mesh, so one JAX run of each trainer
is the oracle of its cases:

- PPO at ``data`` 2 (the fused loss kernels' plain versions on the
  gathered minibatch) and at ``fsdp`` 2 (the staged loss): each rank
  generates, scores and rewards its rows of every prompt chunk, and every
  rank's rows are joined before the ordered tail, so every rank holds the
  store one process builds; the loss operands are joined over the data
  axes, and each rank's backward keeps its own rows;
- GRPO at ``data`` 2: each rank takes whole groups;
- ILQL at ``fsdp`` 2: the per-token terms of every rank joined before the
  masked means; the target heads sharded like the Q heads;
- DPO at ``data`` 2: whole pairs per rank, in the reference pass and the
  step;
- PPO at ``data`` 2 with ``dcn_data_parallelism`` 2 (JAX's hybrid layout),
  which equals the dcn-1 run bitwise;
- PPO and GRPO at ``data`` 2 on the continuous paged path
  (``train.continuous_batching``, against JAX's on the same settings),
  with an end-of-sequence token that greedy rows meet at different
  steps, so one process's completion order differs from row order and
  from the ranks' joined harvests.

``builtin:gpt2-test`` in f32 with greedy rollouts, the JAX run's initial
weights carried over. Every step's losses and gradient norm agree with
JAX's to 1e-5 relative (1e-6 absolute for losses that vanish in exact
arithmetic), the final weights to 1e-5 relative in each tensor's 2-norm,
and the two ranks' stores and full weights are bitwise equal.
"""

import pytest

from torch_rl_runs import (
    check_params,
    check_steps,
    config_dict,
    jax_run,
    run_world,
    with_sections,
)
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

# the stats held against JAX, beside gradients/global_norm
LOSS_KEYS = {"ppo": ("losses/total_loss", "losses/policy_loss", "losses/value_loss"),
             "grpo": ("losses/total_loss", "losses/policy_loss", "losses/kl_loss"),
             "ilql": ("losses/loss", "losses/loss_q", "losses/loss_v", "losses/loss_cql",
                      "losses/loss_awac"),
             "dpo": ("losses/total_loss", "rewards/accuracy", "rewards/margin")}


def continuous(eos):
    """The continuous paged path on both sides, with ``eos`` as the
    end-of-sequence token: one that ends a few greedy rows of the first
    collection early (PPO) or a group of the second rank's (GRPO), at
    different steps."""
    return dict(train=dict(continuous_batching=True, continuous_batching_segment=2),
                engine=dict(backend="paged", kv_block_size=4),
                method=dict(gen_kwargs=dict(eos_token_id=eos)))


# case: (trainer, parallel axes of the two ranks, method overrides, the
# sections both sides share)
CASES = {
    "ppo-data2": ("ppo", dict(data=2), dict(loss_kernel="pallas"), {}),
    "ppo-fsdp2": ("ppo", dict(data=1, fsdp=2), dict(loss_kernel="xla"), {}),
    "grpo-data2": ("grpo", dict(data=2), {}, {}),
    "ilql-fsdp2": ("ilql", dict(data=1, fsdp=2), {}, {}),
    "dpo-data2": ("dpo", dict(data=2), {}, {}),
    "ppo-data2-dcn2": ("ppo", dict(data=2, dcn_data_parallelism=2),
                       dict(loss_kernel="pallas"), {}),
    "ppo-data2-cb": ("ppo", dict(data=2), dict(loss_kernel="pallas"), continuous(110)),
    "grpo-data2-cb": ("grpo", dict(data=2), {}, continuous(115)),
}
_JAX = {}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's run of a trainer on the shared sections of a case, made once
    per module on first use."""
    def get(case):
        kind, _, _, shared = CASES[case]
        key = (kind, bool(shared))
        if key not in _JAX:
            _JAX[key] = jax_run(kind, tmp_path_factory.mktemp(f"jax_{kind}"), **shared)
        return _JAX[key]
    return get


def _port(tmp_path, case, params0):
    kind, parallel, method, shared = CASES[case]
    d = with_sections(config_dict(kind, tmp_path / "ckpt", **parallel), **shared)
    d["method"].update(method)
    return run_world(kind, tmp_path / case, d, params0, world=2)


@pytest.mark.parametrize("case", list(CASES))
def test_parallel_rl_matches_jax(tmp_path, jax_runs, case):
    kind = CASES[case][0]
    want = jax_runs(case)
    got = _port(tmp_path, case, want["params0"])
    assert got["world"] == 2 and len(want["steps"]) == (6 if kind in ("ppo", "grpo") else 4)
    check_steps(got, want, want["steps"], LOSS_KEYS[kind] + ("gradients/global_norm",))
    check_params(got["params"], want["params"], kind)
    # every rank holds the same store and the same full weights
    assert len({r["weights"] for r in got["ranks"]}) == 1
    assert len({r["store"] for r in got["ranks"]}) == 1
    if case == "ppo-data2-dcn2":  # the hybrid layout is the dcn-1 run, bitwise
        plain = _port(tmp_path / "dcn1", "ppo-data2", want["params0"])
        keys = LOSS_KEYS[kind] + ("gradients/global_norm",)
        assert [[st[k] for k in keys] for st in plain["stats"]] == \
            [[st[k] for k in keys] for st in got["stats"]]
        assert plain["ranks"][0]["weights"] == got["ranks"][0]["weights"]
