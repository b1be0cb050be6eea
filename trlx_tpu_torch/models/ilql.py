"""ILQL method: config and loss (twin-Q TD, expectile V, CQL, AWAC).

Port of ``trlx_tpu/models/ilql.py``: :func:`topk_mask`,
:func:`batched_index_select` and :class:`ILQLConfig` with its ``loss`` and
the same flattened stats keys (``losses/*``, ``values/*``,
``qvalues/<i>/*``, ``awac_weight/*`` and the ``dist/*_hist`` sketches).
The heads live in ``models/heads.py``; the advantage-shaped sampling hook
in ``trainer/ilql.py``.
"""

from dataclasses import dataclass, field
from typing import Any, Dict, Sequence, Tuple

import torch

from trlx_tpu_torch.data.method_configs import MethodConfig, register_method
from trlx_tpu_torch.utils import flatten_dict
from trlx_tpu_torch.utils.stats import get_tensor_stats

__all__ = ["ILQLConfig", "topk_mask", "batched_index_select"]


def topk_mask(xs: torch.Tensor, k: int) -> torch.Tensor:
    """Set all but the top-k entries of the last axis to -inf."""
    if k >= xs.shape[-1]:
        return xs
    mintop = torch.topk(xs, k, dim=-1).values[..., -1:]
    return torch.where(xs < mintop, torch.full_like(xs, float("-inf")), xs)


def batched_index_select(x: torch.Tensor, idxs: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Gather rows at ``idxs`` along ``dim``: [B, T, H], [B, I] → [B, I, H]."""
    idxs = idxs.to(torch.int64)[..., None]
    return x.gather(dim, idxs.expand(*idxs.shape[:-1], x.shape[-1]))


def _take(x: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """``x[b, a, actions[b, a]]`` in f32: [B, A, V], [B, A, 1] → [B, A]."""
    return x.float().gather(-1, actions)[..., 0]


@dataclass
@register_method("ILQLConfig")
class ILQLConfig(MethodConfig):
    """ILQL hyperparameters (the JAX ``ILQLConfig``'s fields).

    :param tau: expectile of the V loss
    :param gamma: discount
    :param cql_scale: weight of the conservative (CQL) term
    :param awac_scale: weight of the AWAC-weighted cross-entropy
    :param alpha: Polyak rate of the target-Q sync
    :param beta: advantage scale of the AWAC weight exp(β(Q−V))
    :param steps_for_target_q_sync: optimizer steps between target syncs
    :param two_qs: twin Q heads (the min feeds the targets)
    :param gen_kwargs: sampling kwargs (with the inference-time ``beta``)
    """

    name: str = "ILQLConfig"
    tau: float = 0.7
    gamma: float = 0.99
    cql_scale: float = 0.1
    awac_scale: float = 1.0
    alpha: float = 0.001
    beta: float = 0.0
    steps_for_target_q_sync: int = 5
    two_qs: bool = True
    gen_kwargs: Dict[str, Any] = field(default_factory=dict)

    def loss(
        self,
        logits: torch.Tensor,  # [B, A, V] logits at action positions
        qs: Sequence[torch.Tensor],  # each [B, A, V]
        target_qs: Sequence[torch.Tensor],  # each [B, A, V]
        vs: torch.Tensor,  # [B, S, 1] values at state positions
        actions: torch.Tensor,  # [B, A] action token ids
        rewards: torch.Tensor,  # [B, A]
        dones: torch.Tensor,  # [B, S]
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """The ILQL objective, masked by ``dones[:, :-1]`` and averaged over
        the non-terminal steps:

        Σ_i mean (Q_i − (r + γ V'))² + expectile_τ(min Q' − V)
        + cql_scale Σ_i CE(q_i, a) + awac_scale exp(β(min Q' − V)) CE(logits, a)
        """
        logits = logits.float()
        vs = vs.float()
        terminal_mask = dones[:, :-1].float()
        n_nonterminal = torch.clamp(terminal_mask.sum(), min=1.0)
        actions_exp = actions.to(torch.int64)[..., None]

        Q = [_take(q, actions_exp) for q in qs]
        targetQs = [_take(q, actions_exp).detach() for q in target_qs]
        targetQ = targetQs[0]
        for tq in targetQs[1:]:
            targetQ = torch.minimum(targetQ, tq)

        V = vs[:, :-1, 0]
        Vnext = vs[:, 1:, 0] * dones[:, 1:].to(vs.dtype)
        Q_target = rewards + self.gamma * Vnext.detach()

        loss_q = sum(torch.sum(torch.square(Qi - Q_target) * terminal_mask) / n_nonterminal
                     for Qi in Q)

        # the expectile loss of V towards min target-Q
        diff = targetQ - V
        weight = torch.where(diff >= 0, torch.full_like(diff, self.tau),
                             torch.full_like(diff, 1.0 - self.tau))
        loss_v = torch.sum(weight * torch.square(diff) * terminal_mask) / n_nonterminal

        def ce(logit_like):  # [B, A, V] against actions → [B, A]
            return -torch.log_softmax(logit_like.float(), dim=-1).gather(-1, actions_exp)[..., 0]

        loss_cql = sum(torch.sum(ce(q) * terminal_mask) / n_nonterminal for q in qs)

        awac_weight = torch.exp(self.beta * (targetQ - V)).detach()
        loss_awac = torch.sum(ce(logits) * awac_weight * terminal_mask) / n_nonterminal

        loss = loss_q + loss_v + self.cql_scale * loss_cql + self.awac_scale * loss_awac

        dist = {}
        if self.dist_sketches:
            from trlx_tpu_torch.observability.dynamics import entropy_of_logits, loss_sketches

            # the first Q head's TD error as the value error, the expectile
            # gap (min Q' − V) as the advantage analogue
            dist = loss_sketches({
                "value_error": (Q[0] - Q_target, terminal_mask),
                "advantages": (diff, terminal_mask),
                "entropy": (entropy_of_logits(logits), terminal_mask),
            })
        stats = dict(
            **dist,
            losses=dict(loss=loss, loss_q=loss_q, loss_v=loss_v, loss_cql=loss_cql,
                        loss_awac=loss_awac),
            values=get_tensor_stats(V, terminal_mask, n_nonterminal),
            qvalues={str(ix): get_tensor_stats(Q[ix], terminal_mask, n_nonterminal)
                     for ix in range(len(Q))},
            awac_weight=get_tensor_stats(awac_weight, terminal_mask, n_nonterminal),
        )
        return loss, flatten_dict(stats)
