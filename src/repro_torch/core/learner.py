"""IMPALA learner step (the paper-faithful agent path; TorchBeast
polybeast.py learner loop body).

``make_train_step`` returns a function with the reference's contract
  (params, opt_state, step, batch) -> (params, opt_state, metrics)
where ``params`` is the learner's agent ``nn.Module``, updated in place
and returned, ``step`` a host integer (it drives the LR schedule), and
``metrics`` a dict of device tensors: reading one is the caller's choice
of when to synchronise with the device.
"""

from __future__ import annotations

import torch

from repro_torch.core import losses
from repro_torch.optim.optimizers import apply_updates


def make_train_step(opt, train_cfg, *, vtrace_impl="kernel"):
    """IMPALA learner step over a rollout batch.

    batch: time-major dict (see core/rollout.py):
      obs (T+1,B,...), action (T,B), behavior_logits (T,B,A),
      reward (T,B), done (T,B) [, is_replay (B,), behavior_value (T,B) —
      ReplaySource batches]

    With an ``is_replay`` mask present, the CLEAR cloning terms
    (losses.clear_auxiliary_loss) are applied to the replayed columns at
    ``train_cfg.clear_policy_cost`` / ``clear_value_cost``, and the
    reported ``reward_per_step`` covers the fresh columns only (replayed
    rewards are not new environment signal).

    vtrace_impl: 'kernel' (the fused CUDA V-trace kernel) or 'scan' (the
    plain reverse loop).
    """

    def loss_fn(agent, batch):
        out = agent(batch["obs"])                      # (T+1, B, ...)
        target_logits = out.policy_logits[:-1]
        values = out.baseline[:-1]
        bootstrap = out.baseline[-1].detach()
        discounts = (~batch["done"]).float() * train_cfg.discount
        return losses.impala_loss_from_logits(
            target_logits, batch["behavior_logits"], batch["action"],
            batch["reward"], discounts, values, bootstrap,
            baseline_cost=train_cfg.baseline_cost,
            entropy_cost=train_cfg.entropy_cost,
            clip_rho=train_cfg.vtrace_rho_clip,
            clip_c=train_cfg.vtrace_c_clip,
            is_replay=batch.get("is_replay"),
            behavior_values=batch.get("behavior_value"),
            clear_policy_cost=train_cfg.clear_policy_cost,
            clear_value_cost=train_cfg.clear_value_cost,
            vtrace_impl=vtrace_impl)

    def train_step(params, opt_state, step, batch):
        plist = list(params.parameters())
        loss_out = loss_fn(params, batch)
        grads = torch.autograd.grad(loss_out.total, plist)
        updates, opt_state = opt.update(grads, opt_state, plist, step)
        apply_updates(plist, updates)
        if "is_replay" in batch:
            fresh = (~batch["is_replay"]).float()[None, :]
            reward_per_step = (batch["reward"] * fresh).sum() \
                / torch.clamp(fresh.sum() * batch["reward"].shape[0],
                              min=1.0)
        else:
            reward_per_step = batch["reward"].mean()
        metrics = {
            "loss": loss_out.total.detach(),
            "pg_loss": loss_out.pg_loss.detach(),
            "baseline_loss": loss_out.baseline_loss.detach(),
            "entropy_loss": loss_out.entropy_loss.detach(),
            "vs_mean": loss_out.vs_mean,
            "rho_mean": loss_out.rho_mean,
            "reward_per_step": reward_per_step,
            "priority": loss_out.priority,
        }
        if "is_replay" in batch:
            metrics["clear_policy_loss"] = loss_out.clear_policy_loss.detach()
            metrics["clear_value_loss"] = loss_out.clear_value_loss.detach()
        return params, opt_state, metrics

    return train_step
