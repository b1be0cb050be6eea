"""The port's fused PPO loss (``trlx_tpu_torch/ops/fused_loss.py``) and PPO
math (``models/ppo.py``, ``utils/stats.py``) against the JAX package.

On the CPU the fused loss's wrappers run their plain versions, wired
through the same ``torch.autograd.Function`` the kernels use on the card.
They are held against JAX ``fused_ppo_loss`` (the Pallas program in
interpret mode) and the staged ``method.loss``: the loss and every stat at
``rtol=1e-5``, every sketch bin exactly (except a value within 1e-5 of a
bin edge), and the gradients against ``jax.grad`` — including exact ties,
which are the rule inside the clip range and at masked positions and are
planted at the value-clip bound. GAE, whitening, the KL rewards, the KL
controllers and ``RunningMoments`` reuse the golden constants of
``tests/test_parity_golden.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_parity_golden import (
    GAE_ADV,
    GAE_ADV_WHITE,
    GAE_RET,
    KL_MEAN_K3,
    KL_REWARDS,
    PPO_GOLD,
    WHITEN,
    _arr,
)
from trlx_tpu.models.ppo import AdaptiveKLController as JaxAdaptiveKL
from trlx_tpu.models.ppo import PPOConfig as JaxPPOConfig
from trlx_tpu.ops.fused_loss import _stat_keys as jax_stat_keys
from trlx_tpu.ops.fused_loss import fused_ppo_loss as jax_fused_ppo_loss
from trlx_tpu.utils.stats import RunningMoments as JaxRunningMoments
from trlx_tpu_torch.models.ppo import (
    AdaptiveKLController,
    FixedKLController,
    PPOConfig,
    kl_penalty_rewards_np,
)
from trlx_tpu_torch.ops.fused_loss import (
    LossParams,
    fused_loss_bwd,
    fused_loss_bwd_reference,
    fused_loss_fwd,
    fused_loss_fwd_reference,
    fused_ppo_loss,
    loss_params_of,
    residual_views,
    stat_keys,
)
from trlx_tpu_torch.utils.dynamics import SKETCH_BINS, SKETCH_RANGES
from trlx_tpu_torch.utils.stats import RunningMoments, whiten
from tests.torch_kernel_cases import loss_case
from torch_threads import use_one_cpu_thread

use_one_cpu_thread()

B, R = 7, 13
RTOL = 1e-5
_EDGE_TOL = 1e-5
_HIST_SOURCES = {  # sketch key → index of the per-element quantity below
    "dist/log_ratio_hist": "log_ratio",
    "dist/kl_hist": "kl",
    "dist/advantages_hist": "advantages",
    "dist/value_error_hist": "value_error",
}


def _methods(**kw):
    base = dict(gamma=0.95, lam=0.9, cliprange=0.2, cliprange_value=0.2, vf_coef=0.5,
                iw_clip=1.05, **kw)
    return JaxPPOConfig(**base), PPOConfig(**base)


def _operands(mask_kind, seed, tie_values=False):
    rs = np.random.RandomState(seed)
    lp = (rs.randn(B, R) * 0.1).astype(np.float32)
    v = rs.randn(B, R).astype(np.float32)
    olp = (lp + rs.randn(B, R) * 0.05).astype(np.float32)
    ov = rs.randn(B, R).astype(np.float32)
    rw = (rs.randn(B, R) * 0.05).astype(np.float32)
    if mask_kind == "all_zero":
        mask = np.zeros((B, R), np.float32)
    elif mask_kind == "single_token":
        mask = np.zeros((B, R), np.float32)
        mask[np.arange(B), rs.randint(0, R, B)] = 1.0
    else:
        mask = (rs.rand(B, R) > 0.3).astype(np.float32)
        if mask_kind == "allmasked_row":
            mask[0] = 0.0
    if tie_values:  # new values exactly on the value-clip bounds
        hi = (ov + np.float32(0.2)).astype(np.float32)
        lo = (ov - np.float32(0.2)).astype(np.float32)
        v[:, ::3] = hi[:, ::3]
        v[:, 1::3] = lo[:, 1::3]
    blp = (olp + rs.randn(B, R) * 0.03).astype(np.float32)
    return [lp, v, olp, ov, rw, mask], blp


def _jax_loss_and_grads(jm, ops, blp):
    """JAX ``fused_ppo_loss`` (interpret) and its ``jax.grad`` w.r.t.
    logprobs and values, jitted with every operand a runtime argument."""
    def fused(*a):
        return jax_fused_ppo_loss(jm, *a, interpret=True)

    def loss_of(lp, v, *rest):
        return fused(lp, v, *rest)[0]

    args = list(ops) + ([blp] if blp is not None else [None])
    loss, stats = jax.jit(fused)(*args)
    g = jax.jit(jax.grad(loss_of, argnums=(0, 1)))(*args)
    return loss, stats, [np.asarray(x) for x in g]


def _near_edge(stats_np, key, lo, hi, mask):
    """Count of masked values within _EDGE_TOL of a bin edge."""
    x = stats_np[key]
    edges = lo + (hi - lo) / SKETCH_BINS * np.arange(SKETCH_BINS + 1)
    d = np.abs(x[..., None] - edges).min(axis=-1)
    return int(((d < _EDGE_TOL) & (mask > 0)).sum())


@pytest.mark.parametrize(
    "mask_kind,use_iw,tie_values",
    [
        ("random", False, False),
        ("random", True, False),
        ("allmasked_row", False, True),
        ("single_token", True, True),
        ("all_zero", False, False),
    ],
)
def test_fused_loss_matches_jax(mask_kind, use_iw, tie_values):
    jm, tm = _methods(iw_correction="clip" if use_iw else "off")
    ops, blp = _operands(mask_kind, seed=3, tie_values=tie_values)
    jblp = jnp.asarray(blp) if use_iw else None
    jops = [jnp.asarray(x) for x in ops]
    jloss, jstats, jgrads = _jax_loss_and_grads(jm, jops, jblp)

    tops = [torch.tensor(x) for x in ops]
    lp, v = tops[0].requires_grad_(True), tops[1].requires_grad_(True)
    tloss, tstats = fused_ppo_loss(tm, lp, v, *tops[2:], torch.tensor(blp) if use_iw else None)
    tloss.backward()

    assert set(tstats) == set(jstats)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=RTOL, atol=1e-7)
    # the per-element quantities the sketches bin, for the edge rule
    m = ops[5]
    lr = (ops[0] - ops[2]) * m
    adv_j, ret_j = jm.get_advantages_and_returns(jops[3], jops[4], jops[5])
    per_el = {"log_ratio": lr, "kl": (np.exp(lr) - 1) - lr,
              "advantages": np.asarray(adv_j), "value_error": ops[1] - np.asarray(ret_j)}
    for k, jv in jstats.items():
        tv = tstats[k].numpy()
        if k.endswith("_hist"):
            name = _HIST_SOURCES[k]
            lo, hi = SKETCH_RANGES[name]
            slack = _near_edge(per_el, name, lo, hi, m)
            assert np.abs(tv - np.asarray(jv)).sum() <= 2 * slack, k
        else:
            np.testing.assert_allclose(tv, np.asarray(jv), rtol=RTOL, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(lp.grad.numpy(), jgrads[0], rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(v.grad.numpy(), jgrads[1], rtol=RTOL, atol=1e-7)


def kernel_lanes(R):
    """The lanes the forward kernel gives a row (its launcher's rule)."""
    return 32 if R > 64 else (16 if R > 32 else 8)


def chunked_gae(ov, rw, gamma, gamma_lam, lanes):
    """The forward kernel's GAE (``csrc/fused_loss_fwd.cu``), emulated in
    f32: each of a row's ``lanes`` lanes runs A_t = delta_t + c A_{t+1}
    backwards over its chunk of C = ceil(R / lanes) columns from A = 0,
    keeping c^len; a Kogge-Stone suffix scan composes the lanes' (c^len,
    A_first) pairs ((a, b) o (a', b') = (a a', b + a b')); a fix-up adds
    c^(end - t) times the next lane's scanned value. Returns the raw
    advantages and returns."""
    Bn, Rn = ov.shape
    C = -(-Rn // lanes)
    pad = lanes * C - Rn
    ovp = torch.nn.functional.pad(ov, (0, pad)).view(Bn, lanes, C)
    rwp = torch.nn.functional.pad(rw, (0, pad)).view(Bn, lanes, C)
    L = (Rn - torch.arange(lanes) * C).clamp(0, C)  # a lane's columns in range
    g, c = torch.tensor(gamma, dtype=torch.float32), torch.tensor(gamma_lam, dtype=torch.float32)
    zero = torch.zeros(Bn, 1)
    nv = torch.cat([ovp[:, 1:, 0], zero], 1)  # the next lane's first value (0 past R)
    A, a = torch.zeros(Bn, lanes), torch.ones(Bn, lanes)
    local = torch.zeros(Bn, lanes, C)
    for j in reversed(range(C)):
        on = j < L
        delta = (rwp[:, :, j] + g * nv) - ovp[:, :, j]
        A = torch.where(on, delta + c * A, A)
        a = torch.where(on, a * c, a)
        nv = torch.where(on, ovp[:, :, j], nv)
        local[:, :, j] = A
    o = 1
    while o < lanes:  # every lane reads its right neighbour's old pair
        a2 = torch.cat([a[:, o:], torch.ones(Bn, o)], 1)
        A2 = torch.cat([A[:, o:], torch.zeros(Bn, o)], 1)
        inside = torch.arange(lanes) + o < lanes
        A, a = torch.where(inside, A + a * A2, A), torch.where(inside, a * a2, a)
        o *= 2
    carry = torch.cat([A[:, 1:], zero], 1)
    adv = torch.zeros(Bn, lanes, C)
    pw = c.expand(Bn, lanes).clone()
    for j in reversed(range(C)):
        on = j < L
        adv[:, :, j] = local[:, :, j] + pw * carry
        pw = torch.where(on, pw * c, pw)
    adv = adv.reshape(Bn, lanes * C)[:, :Rn]
    return adv, adv + ov


# every shape of this file and of the card's timed loss checks
_GAE_SHAPES = [(B, R), (3, 5), (16, 40), (32, 40), (32, 128), (13, 77), (2, 33)]


@pytest.mark.parametrize("gamma,lam", [(1.0, 0.95), (0.95, 0.9)])
@pytest.mark.parametrize("shape", _GAE_SHAPES + [(4, 1024)])
def test_chunked_gae_scan_matches_jax(shape, gamma, lam):
    """The kernel's reassociated GAE rounds within the card's loss
    tolerance of JAX's sequential scan: raw advantages and returns at
    1e-5 relative (1e-6 absolute), and the whitened advantages too."""
    ops = loss_case(*shape, seed=shape[0] * shape[1])
    ov, rw, mask = ops[3], ops[4], ops[5]
    jm = JaxPPOConfig(gamma=gamma, lam=lam)
    jadv, jret = jm.get_advantages_and_returns(jnp.asarray(ov), jnp.asarray(rw),
                                               use_whitening=False)
    adv, ret = chunked_gae(torch.tensor(ov), torch.tensor(rw), gamma, float(gamma * lam),
                           kernel_lanes(shape[1]))
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), rtol=1e-5, atol=1e-6)
    jw = jm.get_advantages_and_returns(jnp.asarray(ov), jnp.asarray(rw), jnp.asarray(mask))[0]
    np.testing.assert_allclose(whiten(adv, torch.tensor(mask)).numpy(), np.asarray(jw),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("use_iw,tie_values", [(False, False), (True, False), (False, True),
                                                (True, True)])
def test_residual_plain_versions_match_jax(use_iw, tie_values):
    """The plain forward returns the residuals the backward takes; loss and
    stats equal JAX ``fused_ppo_loss`` and the gradients ``jax.grad`` at
    1e-5 relative in f32, exact ties included."""
    jm, tm = _methods(iw_correction="clip" if use_iw else "off")
    ops, blp = _operands("allmasked_row", seed=9, tie_values=tie_values)
    jops = [jnp.asarray(x) for x in ops]
    jloss, jstats, jgrads = _jax_loss_and_grads(jm, jops, jnp.asarray(blp) if use_iw else None)
    p = loss_params_of(tm)
    tops = [torch.tensor(x) for x in ops] + ([torch.tensor(blp)] if use_iw else [])
    loss, scalars, hists, res = fused_loss_fwd_reference(p, tops)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL, atol=1e-7)
    keys = stat_keys(p, use_iw)[0]
    for i, k in enumerate(keys):
        np.testing.assert_allclose(float(scalars[i]), float(jstats[k]), rtol=RTOL, atol=1e-6,
                                   err_msg=k)
    # the residuals: JAX's raw GAE, its whitening moments and n
    adv, ret, moments = residual_views(res, B, R)
    jadv, jret = jm.get_advantages_and_returns(jops[3], jops[4], use_whitening=False)
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), rtol=RTOL, atol=1e-6)
    assert float(moments[2]) == max(float(ops[5].sum()), 1.0)
    white = (adv - moments[0]) * moments[1]
    jwhite = jm.get_advantages_and_returns(jops[3], jops[4], jops[5])[0]
    np.testing.assert_allclose(white.numpy(), np.asarray(jwhite), rtol=RTOL, atol=1e-6)
    g = torch.tensor(1.0)
    dlp, dv = fused_loss_bwd_reference(p, tops, res, g)
    np.testing.assert_allclose(dlp.numpy(), jgrads[0], rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(dv.numpy(), jgrads[1], rtol=RTOL, atol=1e-7)


def test_fused_loss_cuda_path_rejects_other_devices():
    """A device neither CPU nor CUDA raises in both wrappers, before any
    launch; the residuals pack (B, R), (B, R) and (3,) in one tensor."""
    p = LossParams(gamma=1.0, lam=0.95, cliprange=0.2, cliprange_value=0.2, vf_coef=1.0,
                   iw_correction="off", iw_clip=1.05, dist_sketches=True)
    tops = [torch.tensor(x) for x in loss_case(4, 6, seed=1)[:6]]
    res = fused_loss_fwd(p, tops)[3]
    assert tuple(res.shape) == (2 * 4 * 6 + 3,)
    assert [tuple(x.shape) for x in residual_views(res, 4, 6)] == [(4, 6), (4, 6), (3,)]
    meta = [x.to("meta") for x in tops]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_loss_bwd(p, meta, res, torch.tensor(1.0))


@pytest.mark.parametrize("use_iw", [False, True])
@pytest.mark.parametrize("dist_sketches", [False, True])
def test_stat_key_order_is_the_jax_discovery_order(use_iw, dist_sketches):
    jm, tm = _methods(iw_correction="clip" if use_iw else "off", dist_sketches=dist_sketches)
    p = loss_params_of(jm)
    sd = (((B, R), "float32"),) * 7
    want = jax_stat_keys(p, sd, use_iw)
    assert stat_keys(loss_params_of(tm), use_iw) == want


def test_fused_loss_wrappers_take_f32_only():
    _, tm = _methods()
    ops, _ = _operands("random", seed=1)
    tops = [torch.tensor(x) for x in ops]
    p = loss_params_of(tm)
    with pytest.raises(ValueError, match="float32"):
        fused_loss_fwd(p, [tops[0].double()] + tops[1:])
    res = fused_loss_fwd(p, tops)[3]
    with pytest.raises(ValueError, match="float32"):
        fused_loss_bwd(p, tops[:5] + [tops[5].to(torch.bfloat16)], res, torch.tensor(1.0))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_loss_fwd(p, [x.to("meta") for x in tops])


def test_staged_loss_matches_golden_and_jax():
    rng = np.random.default_rng(7)
    arrays = [_arr(rng, 3, 5, scale=0.3), _arr(rng, 3, 5, scale=0.3), _arr(rng, 3, 5),
              _arr(rng, 3, 5), _arr(rng, 3, 5), _arr(rng, 3, 5)]
    logprobs, old_logprobs, values, old_values, advantages, returns = arrays
    mask = np.array([[1, 1, 1, 1, 0], [1, 1, 0, 0, 0], [1, 1, 1, 1, 1]], np.float32)
    base = dict(gamma=0.95, lam=0.9, cliprange=0.2, cliprange_value=0.2, vf_coef=1.0)
    t = [torch.tensor(a) for a in (logprobs, values, old_logprobs, old_values,
                                   advantages, returns, mask)]
    loss, stats = PPOConfig(**base).loss(*t)
    assert np.isclose(float(loss), PPO_GOLD["total"], rtol=1e-5)
    assert np.isclose(float(stats["losses/policy_loss"]), PPO_GOLD["pg"], rtol=1e-5)
    assert np.isclose(float(stats["losses/value_loss"]), PPO_GOLD["vf"], rtol=1e-5)
    assert np.isclose(float(stats["policy/approx_kl"]), PPO_GOLD["approx_kl"], rtol=1e-4)
    assert np.isclose(float(stats["policy/clipfrac"]), PPO_GOLD["pg_clipfrac"], rtol=1e-6)
    assert np.isclose(float(stats["values/clipfrac"]), PPO_GOLD["vf_clipfrac"], rtol=1e-6)
    jloss, jstats = JaxPPOConfig(**base).loss(*(jnp.asarray(x.numpy()) for x in t))
    for k, jv in jstats.items():
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(jv), rtol=RTOL, atol=1e-6,
                                   err_msg=k)


def test_gae_and_whiten_match_golden():
    rng = np.random.default_rng(42)
    values = torch.tensor(_arr(rng, 3, 5))
    rewards = torch.tensor(_arr(rng, 3, 5, scale=0.5))
    cfg = PPOConfig(gamma=0.95, lam=0.9)
    adv, ret = cfg.get_advantages_and_returns(values, rewards, use_whitening=False)
    np.testing.assert_allclose(adv.numpy(), GAE_ADV, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ret.numpy(), GAE_RET, rtol=1e-5, atol=1e-5)
    adv_w, _ = cfg.get_advantages_and_returns(values, rewards, use_whitening=True)
    np.testing.assert_allclose(adv_w.numpy(), GAE_ADV_WHITE, rtol=1e-5, atol=1e-5)
    xs = torch.tensor(_arr(np.random.default_rng(5), 4, 6))
    np.testing.assert_allclose(whiten(xs).numpy(), WHITEN, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(whiten(xs, torch.ones(4, 6)).numpy(), WHITEN, rtol=1e-4,
                               atol=1e-5)


def test_kl_penalty_rewards_match_golden():
    rng = np.random.default_rng(11)
    lp = _arr(rng, 3, 5, scale=0.4)
    ref_lp = _arr(rng, 3, 5, scale=0.4)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 0, 0, 0, 0]], np.float32)
    scores = np.array([0.5, -1.0, 2.0], np.float32)
    rewards, (mean_kl, _) = kl_penalty_rewards_np(lp, ref_lp, mask, scores, 0.1)
    np.testing.assert_allclose(rewards, KL_REWARDS, rtol=1e-5, atol=1e-6)
    assert np.isclose(mean_kl, KL_MEAN_K3, rtol=1e-4)


def test_kl_controllers_and_running_moments_match_jax():
    ours, theirs = AdaptiveKLController(0.1, 6.0, 100), JaxAdaptiveKL(0.1, 6.0, 100)
    for kl in (1.0, 12.0, float("nan"), 6.5):
        ours.update(kl, 16)
        theirs.update(kl, 16)
        assert ours.value == theirs.value and ours.skipped == theirs.skipped
    fixed = FixedKLController(0.3)
    fixed.update(5.0, 16)
    assert fixed.value == 0.3
    assert dataclasses.replace(PPOConfig(target=None)).kl_controller().value == 0.05
    rm, jrm = RunningMoments(), JaxRunningMoments()
    rs = np.random.RandomState(4)
    for n in (5, 1, 9):
        xs = rs.randn(n)
        assert rm.update(xs) == jrm.update(xs)
        assert (rm.mean, rm.std, rm.var, rm.count) == (jrm.mean, jrm.std, jrm.var, jrm.count)
