"""V-trace off-policy correction (IMPALA, Espeholt et al. 2018, §4.1).

Faithful to DeepMind's scalable_agent/vtrace.py semantics:

  rho_t  = min(rho_clip, pi(a_t|s_t) / mu(a_t|s_t))
  c_t    = min(c_clip,  rho_t_unclipped)
  delta_t = rho_t (r_t + gamma_t V(s_{t+1}) - V(s_t))
  vs_t   = V(s_t) + delta_t + gamma_t c_t (vs_{t+1} - V(s_{t+1}))
  pg_adv = rho_t (r_t + gamma_t vs_{t+1} - V(s_t))

Everything is time-major (T, B), as in the paper's learner-input dict.
``vtrace_from_importance_weights`` here is the plain reverse loop over T
(the reference's ``lax.scan``); the fused CUDA kernel of the same function
is ``kernels.ops.vtrace_from_importance_weights_kernel``.

All outputs carry no gradient: V-trace targets are fixed regression
targets, exactly as in the reference implementation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref as _ref


class VTraceReturns(NamedTuple):
    vs: torch.Tensor              # (T, B) value targets
    pg_advantages: torch.Tensor   # (T, B) policy-gradient advantages


def vtrace_from_importance_weights(
        log_rhos, discounts, rewards, values, bootstrap_value,
        *, clip_rho_threshold=1.0, clip_c_threshold=1.0,
        clip_pg_rho_threshold=1.0):
    """log_rhos/discounts/rewards/values: (T, B); bootstrap_value: (B,).
    ``None`` thresholds mean no clipping."""
    return VTraceReturns(*_ref.ref_vtrace_from_importance_weights(
        log_rhos, discounts, rewards, values, bootstrap_value,
        clip_rho_threshold=clip_rho_threshold,
        clip_c_threshold=clip_c_threshold,
        clip_pg_rho_threshold=clip_pg_rho_threshold))


def vtrace_from_logits(behavior_logits, target_logits, actions, discounts,
                       rewards, values, bootstrap_value, **clip_kwargs):
    """Paper-faithful entry point: full behavior/target logits (T, B, A)."""
    behavior_lp = _action_log_probs(behavior_logits, actions)
    target_lp = _action_log_probs(target_logits, actions)
    return vtrace_from_importance_weights(
        target_lp - behavior_lp, discounts, rewards, values,
        bootstrap_value, **clip_kwargs)


def vtrace_from_logprobs(behavior_logprobs, target_logprobs, discounts,
                         rewards, values, bootstrap_value, **clip_kwargs):
    """Chosen-action log-prob entry point: (T, B) log-probs."""
    return vtrace_from_importance_weights(
        target_logprobs - behavior_logprobs, discounts, rewards, values,
        bootstrap_value, **clip_kwargs)


def _action_log_probs(logits, actions):
    lp = F.log_softmax(logits.float(), dim=-1)
    return torch.gather(lp, -1, actions.long()[..., None])[..., 0]
