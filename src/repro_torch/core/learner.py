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
      reward (T,B), done (T,B)

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
            vtrace_impl=vtrace_impl)

    def train_step(params, opt_state, step, batch):
        plist = list(params.parameters())
        loss_out = loss_fn(params, batch)
        grads = torch.autograd.grad(loss_out.total, plist)
        updates, opt_state = opt.update(grads, opt_state, plist, step)
        apply_updates(plist, updates)
        metrics = {
            "loss": loss_out.total.detach(),
            "pg_loss": loss_out.pg_loss.detach(),
            "baseline_loss": loss_out.baseline_loss.detach(),
            "entropy_loss": loss_out.entropy_loss.detach(),
            "vs_mean": loss_out.vs_mean,
            "rho_mean": loss_out.rho_mean,
            "reward_per_step": batch["reward"].mean(),
            "priority": loss_out.priority,
        }
        return params, opt_state, metrics

    return train_step
