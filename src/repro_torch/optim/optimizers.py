"""Optimizers over lists of parameter tensors, written out by hand.

Each optimizer is an (init, update) pair, as in the reference:
  state = opt.init(params)
  updates, state = opt.update(grads, state, params, step)
  params = apply_updates(params, updates)

``params`` and ``grads`` are sequences of tensors in one order (for an
agent, ``list(model.parameters())``). Unlike the reference's immutable
arrays, the state is updated in place and ``apply_updates`` adds the
updates into the parameters in place; both return what they were given.

``rmsprop`` with IMPALA Table G.1 defaults (eps=0.01, decay=0.99) is the
paper-faithful learner optimizer. It is TensorFlow-flavoured, with eps
INSIDE the root (``g * rsqrt(ms + eps)``); ``torch.optim.RMSprop`` puts it
outside and does not match. Gradient clipping is global-norm (IMPALA: 40).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params, step) -> (updates, state)


def apply_updates(params: Sequence[torch.Tensor], updates):
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u.to(p.dtype))
    return params


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors))


def clip_by_global_norm(grads, max_norm):
    """Scale grads so their global norm is at most ``max_norm``; returns
    (grads, norm). Stays on the device: no host sync."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return [g * scale for g in grads], norm


def _sched(lr, step) -> float:
    return lr(step) if callable(lr) else float(lr)


def _zeros(params) -> List[torch.Tensor]:
    return [torch.zeros_like(p, dtype=torch.float32) for p in params]


def sgd(lr, momentum=0.0, grad_clip=None):
    def init(params):
        return {"mom": _zeros(params)} if momentum else {}

    def update(grads, state, params, step):
        del params
        if grad_clip:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        lr_t = _sched(lr, step)
        if momentum:
            for m, g in zip(state["mom"], grads):
                m.mul_(momentum).add_(g)
            return [-lr_t * m for m in state["mom"]], state
        return [-lr_t * g for g in grads], state

    return Optimizer(init, update)


def rmsprop(lr, decay=0.99, eps=0.01, momentum=0.0, grad_clip=40.0):
    """TensorFlow-flavored RMSProp, as used by IMPALA/TorchBeast."""
    def init(params):
        state = {"ms": _zeros(params)}
        if momentum:
            state["mom"] = _zeros(params)
        return state

    def update(grads, state, params, step):
        del params
        if grad_clip:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        grads = [g.float() for g in grads]
        lr_t = _sched(lr, step)
        scaled = []
        for m, g in zip(state["ms"], grads):
            m.mul_(decay).add_((1 - decay) * g * g)
            scaled.append(g * torch.rsqrt(m + eps))
        if momentum:
            for mo, s in zip(state["mom"], scaled):
                mo.mul_(momentum).add_(s)
            scaled = state["mom"]
        return [-lr_t * s for s in scaled], state

    return Optimizer(init, update)


def adamw(lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0, grad_clip=1.0):
    def init(params):
        return {"mu": _zeros(params), "nu": _zeros(params)}

    def update(grads, state, params, step):
        if grad_clip:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        lr_t = _sched(lr, step)
        t = float(step) + 1.0
        updates = []
        for mu, nu, g, p in zip(state["mu"], state["nu"], grads, params):
            g = g.float()
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * g * g)
            mu_hat = mu / (1 - b1 ** t)
            nu_hat = nu / (1 - b2 ** t)
            updates.append(-lr_t * (mu_hat / (torch.sqrt(nu_hat) + eps)
                                    + weight_decay * p.detach().float()))
        return updates, state

    return Optimizer(init, update)


def make_optimizer(train_cfg):
    """Build the optimizer named in a TrainConfig (with its LR schedule)."""
    from repro_torch.optim.schedules import make_schedule
    sched = make_schedule(train_cfg)
    if train_cfg.optimizer == "rmsprop":
        return rmsprop(sched, decay=train_cfg.rmsprop_decay,
                       eps=train_cfg.rmsprop_eps,
                       momentum=train_cfg.rmsprop_momentum,
                       grad_clip=train_cfg.grad_clip)
    if train_cfg.optimizer == "adamw":
        return adamw(sched, b1=train_cfg.adam_b1, b2=train_cfg.adam_b2,
                     eps=train_cfg.adam_eps,
                     weight_decay=train_cfg.weight_decay,
                     grad_clip=train_cfg.grad_clip)
    if train_cfg.optimizer == "sgd":
        return sgd(sched, grad_clip=train_cfg.grad_clip)
    raise ValueError(train_cfg.optimizer)
