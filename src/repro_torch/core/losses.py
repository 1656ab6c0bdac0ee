"""IMPALA losses (policy gradient + baseline + entropy), over full logits
(the agent) or over per-token log-probs and entropies from the chunked
vocab head (the LLM policy).

Loss definitions match TorchBeast's polybeast.py:
  pg_loss       = sum_t  -log pi(a_t|s_t) * stop_grad(pg_advantage_t)
  baseline_loss = 0.5 * sum_t (vs_t - V(s_t))^2
  entropy_loss  = sum_t sum_a pi log pi          (i.e. negative entropy)
  total = pg + baseline_cost * baseline + entropy_cost * entropy
TorchBeast sums over (T, B); like the reference we keep SUM over T and
MEAN over B.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import vtrace as vtrace_lib
from repro_torch.models.common import (copy_to_model, max_over_model,
                                       reduce_from_model, remat, softcap)


class ImpalaLossOutput(NamedTuple):
    total: torch.Tensor
    pg_loss: torch.Tensor
    baseline_loss: torch.Tensor
    entropy_loss: torch.Tensor
    vs_mean: torch.Tensor
    rho_mean: torch.Tensor
    # per-column mean |pg_advantage| — the elite-replay priority signal
    priority: torch.Tensor
    # CLEAR cloning terms (zero without an is_replay mask and a cost)
    clear_policy_loss: torch.Tensor
    clear_value_loss: torch.Tensor


def _reduce(x):
    """SUM over T, MEAN over B."""
    return x.mean(dim=1).sum()


def _vtrace_fn(vtrace_impl):
    """The V-trace implementation: the fused CUDA kernel ('kernel'; its
    plain version only on CPU tensors) or the plain reverse loop ('scan'),
    the reference a caller picks by name — never taken in the kernel's
    place."""
    if vtrace_impl == "scan":
        return vtrace_lib.vtrace_from_importance_weights
    if vtrace_impl == "kernel":
        from repro_torch.kernels import ops
        return ops.vtrace_from_importance_weights_kernel
    raise ValueError(f"vtrace_impl must be 'scan' or 'kernel': "
                     f"{vtrace_impl!r}")


def clear_auxiliary_loss(target_lp_all, behavior_logits, values,
                         behavior_values, is_replay):
    """CLEAR-style behavioral + value cloning on replayed rows only
    (Rolnick et al. 2019, "Experience Replay for Continual Learning"):

      policy cloning  sum_t KL(mu || pi)         — keep pi close to the
                                                   behavior policy that
                                                   generated the replayed
                                                   data
      value cloning   0.5 * sum_t (V_mu - V)^2   — anchor V on the value
                                                   estimates RECORDED when
                                                   the data was generated
                                                   (behavior_values; None
                                                   disables the term)

    is_replay: (B,) bool column mask; fresh rows contribute nothing.
    target_lp_all/values carry gradients; behavior_logits/behavior_values
    are data.
    """
    behavior_lp = F.log_softmax(behavior_logits.float(), dim=-1)
    kl = torch.sum(torch.exp(behavior_lp) * (behavior_lp - target_lp_all),
                   dim=-1)                                  # (T, B)
    mask = is_replay.float()[None, :]                       # (1, B)
    policy_cloning = _reduce(kl * mask)
    value_cloning = torch.zeros((), device=values.device)
    if behavior_values is not None:
        value_cloning = 0.5 * _reduce(
            torch.square(behavior_values - values) * mask)
    return policy_cloning, value_cloning


def impala_loss_from_logits(target_logits, behavior_logits, actions,
                            rewards, discounts, values, bootstrap_value,
                            *, baseline_cost=0.5, entropy_cost=0.01,
                            clip_rho=1.0, clip_c=1.0, is_replay=None,
                            behavior_values=None, clear_policy_cost=0.0,
                            clear_value_cost=0.0, vtrace_impl="kernel"):
    """Paper-faithful path (full logits, small action spaces). All (T,B,...).

    target_logits/values carry gradients; behavior_* are data.
    is_replay: optional (B,) bool mask of replayed columns; when given
    together with nonzero clear_*_cost, the CLEAR cloning terms are added
    for those columns (core/replay.py). behavior_values (T,B): the acting
    network's value estimates recorded at generation time — the
    value-cloning anchor (without it only policy cloning is applied).
    """
    target_lp_all = F.log_softmax(target_logits.float(), dim=-1)
    target_lp = torch.gather(target_lp_all, -1,
                             actions.long()[..., None])[..., 0]
    behavior_lp = vtrace_lib._action_log_probs(behavior_logits, actions)

    log_rhos = (target_lp.detach() - behavior_lp).contiguous()
    vt = _vtrace_fn(vtrace_impl)(
        log_rhos, discounts.float().contiguous(),
        rewards.float().contiguous(), values.detach().float().contiguous(),
        bootstrap_value.detach().float().contiguous(),
        clip_rho_threshold=clip_rho, clip_c_threshold=clip_c)

    pg_loss = _reduce(-target_lp * vt.pg_advantages)
    baseline_loss = 0.5 * _reduce(torch.square(vt.vs - values))
    probs = torch.exp(target_lp_all)
    entropy_loss = _reduce(torch.sum(probs * target_lp_all, dim=-1))

    total = pg_loss + baseline_cost * baseline_loss \
        + entropy_cost * entropy_loss

    clear_pc = clear_vc = torch.zeros((), device=total.device)
    if is_replay is not None and (clear_policy_cost or clear_value_cost):
        clear_pc, clear_vc = clear_auxiliary_loss(
            target_lp_all, behavior_logits, values, behavior_values,
            is_replay)
        total = total + clear_policy_cost * clear_pc \
            + clear_value_cost * clear_vc

    rho = torch.exp(log_rhos)
    priority = torch.mean(torch.abs(vt.pg_advantages), dim=0)     # (B,)
    return ImpalaLossOutput(total, pg_loss, baseline_loss, entropy_loss,
                            vt.vs.mean(), rho.mean(), priority,
                            clear_pc, clear_vc)


def impala_loss_from_logprobs(target_logprobs, target_entropy,
                              behavior_logprobs, rewards, discounts, values,
                              bootstrap_value, *, baseline_cost=0.5,
                              entropy_cost=0.01, clip_rho=1.0, clip_c=1.0,
                              vtrace_impl="kernel"):
    """LLM-scale path: (T,B) chosen-action log-probs + per-step entropy
    (computed chunked by the caller, ``chunked_logprob_entropy``).
    target_logprobs/values/target_entropy carry gradients; the rest are
    data. vtrace_impl as in ``impala_loss_from_logits``. The CLEAR terms
    are zero here, as in the reference."""
    log_rhos = (target_logprobs.detach() - behavior_logprobs).contiguous()
    vt = _vtrace_fn(vtrace_impl)(
        log_rhos, discounts.float().contiguous(),
        rewards.float().contiguous(), values.detach().float().contiguous(),
        bootstrap_value.detach().float().contiguous(),
        clip_rho_threshold=clip_rho, clip_c_threshold=clip_c)
    pg_loss = _reduce(-target_logprobs * vt.pg_advantages)
    baseline_loss = 0.5 * _reduce(torch.square(vt.vs - values))
    entropy_loss = _reduce(-target_entropy)
    total = pg_loss + baseline_cost * baseline_loss \
        + entropy_cost * entropy_loss
    rho = torch.exp(log_rhos)
    priority = torch.mean(torch.abs(vt.pg_advantages), dim=0)     # (B,)
    zero = torch.zeros((), device=total.device)
    return ImpalaLossOutput(total, pg_loss, baseline_loss, entropy_loss,
                            vt.vs.mean(), rho.mean(), priority, zero, zero)


# ---------------------------------------------------------------------------
# chunked vocab head: per-token log-prob of chosen action + entropy
# ---------------------------------------------------------------------------

def _logprob_entropy_chunk(h, unembed, a, final_softcap,
                           vocab_start=None):
    """One chunk's (log p(a), entropy) under the reference's mixed
    precision: the unembedding rounded to the hidden's type, the product
    and everything after it in float32. With ``vocab_start`` the
    unembedding is this rank's vocabulary slice from there on: the max
    and the sum of exps are reduced over the model group, the taken
    token's logit is a masked gather summed over it, and the entropy
    comes from those reduced pieces (the softcap is elementwise)."""
    if vocab_start is not None:
        h = copy_to_model(h)
    logits = h.float() @ unembed.to(h.dtype).float()
    if final_softcap:
        logits = softcap(logits, final_softcap)
    if vocab_start is None:
        lp = F.log_softmax(logits, dim=-1)
        alp = torch.gather(lp, -1, a.long()[..., None])[..., 0]
        ent = -torch.sum(torch.exp(lp) * lp, dim=-1)
        return alp, ent
    m = max_over_model(logits.amax(dim=-1, keepdim=True))
    e = torch.exp(logits - m)
    sum_e = reduce_from_model(e.sum(dim=-1))
    lse = m[..., 0] + torch.log(sum_e)
    local = a.long() - vocab_start
    inside = (local >= 0) & (local < logits.shape[-1])
    taken = torch.gather(logits, -1,
                         local.clamp(0, logits.shape[-1] - 1)[..., None])
    taken = reduce_from_model(taken[..., 0] * inside)
    mean_logit = reduce_from_model(torch.sum(e * logits, dim=-1)) / sum_e
    return taken - lse, lse - mean_logit


def chunked_logprob_entropy(hidden, unembed, actions, *, chunk=512,
                            final_softcap=None, vocab_start=None):
    """hidden: (B,S,d); unembed: (d,V); actions: (B,S) int.

    Runs over S-chunks so the (B,chunk,V) logits stay transient: each
    chunk is a checkpoint region (the reference's ``@jax.checkpoint``),
    its logits and log-softmax recomputed in the backward pass instead of
    kept for every chunk. ``vocab_start``: the unembedding is this rank's
    vocabulary slice from that index (``models/model.py::vocab_start``),
    reduced over the model group.
    Returns (logprob (B,S), entropy (B,S)) — both differentiable.
    """
    s = hidden.shape[1]
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"the loss chunk {c} must divide the sequence {s}")
    lps, ents = [], []
    for i in range(0, s, c):
        args = (hidden[:, i:i + c], unembed, actions[:, i:i + c],
                final_softcap, vocab_start)
        alp, ent = remat(_logprob_entropy_chunk, *args)
        lps.append(alp)
        ents.append(ent)
    return torch.cat(lps, dim=1), torch.cat(ents, dim=1)


def chunked_softmax_xent(hidden, unembed, labels, *, chunk=512,
                         final_softcap=None, vocab_start=None):
    """Standard LM cross-entropy, chunked over S. Returns mean nats/token.
    ``vocab_start`` as in ``chunked_logprob_entropy``."""
    lp, _ = chunked_logprob_entropy(hidden, unembed, labels, chunk=chunk,
                                    final_softcap=final_softcap,
                                    vocab_start=vocab_start)
    return -lp.mean()
