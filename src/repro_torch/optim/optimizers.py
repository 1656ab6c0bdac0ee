"""Optimizers over lists of parameter tensors, written out by hand.

Each optimizer is an (init, step, stage) triple:
  state = opt.init(params)
  state = opt.step(grads, state, params, step)
  scalars = opt.stage(step, device)

The scalars that change from step to step (the schedule's rate, AdamW's
bias corrections) are computed on the host in float32, as the schedules
give them, and enter the arithmetic as 0-dim float32 tensors on the
device, which ``stage`` writes (``step`` calls it): a CUDA graph of a
learner step (``core/compiled.py::TrainStep``) reads them by address, so
one graph serves every step whatever its rate, its owner staging them
before each replay.

``params`` and ``grads`` are lists of tensors in one order (for an agent,
``list(model.parameters())``). The reference's arrays are immutable, so
its ``update`` returns a tree of updates that ``apply_updates`` adds to a
new tree of params. Here ``step`` does the same arithmetic in place, one
leaf at a time: it clips the gradients in place (the list is the step's
to consume) and computes, applies and drops each leaf's update, and that
leaf's gradient, before it starts the next. So peak memory is the
parameters, their gradients and the optimizer state plus a few
temporaries of ONE leaf — never a second model-sized list of clipped
gradients or of updates. (For Qwen3-4B under AdamW that is the difference
between 64.4 GB and 96.5 GB.)

``rmsprop`` with IMPALA Table G.1 defaults (eps=0.01, decay=0.99) is the
paper-faithful learner optimizer. It is TensorFlow-flavoured, with eps
INSIDE the root (``g * rsqrt(ms + eps)``); ``torch.optim.RMSprop`` puts it
outside and does not match. Gradient clipping is global-norm (IMPALA: 40).

``zero1(opt, slices, mesh)`` keeps ``opt``'s state for this data rank's
slice of each leaf only (ZeRO-1, the reference's ``zero1_shardings`` in
``launch/specs.py::build_train``): the rank updates its slice of the
parameters from its slice of the gradients (ZeRO-2: the learner
reduce-scatters them, ``core/learner.py``), then gathers the updated
slices over the data group.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch


def _no_scalars(step, device) -> Dict[str, torch.Tensor]:
    del step, device
    return {}


class Optimizer(NamedTuple):
    init: Callable
    step: Callable    # (grads, state, params, step) -> state, in place
    # (step, device) -> the step's device scalars (none for a rule whose
    # step reads no changing scalar)
    stage: Callable = _no_scalars


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm,
                         norm_fn=global_norm):
    """Scale the gradients in the list ``grads`` so that their global norm
    is at most ``max_norm``, in place: each is scaled where it lies (one
    that shares memory between its elements, such as an expanded tensor,
    is replaced in the list instead). ``norm_fn``: the norm of a list (a
    model-parallel rank's covers the whole tree). Returns the norm. Stays
    on the device: no host sync."""
    norm = norm_fn(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for i, g in enumerate(grads):
        if g.is_contiguous():
            g.mul_(scale)
        else:
            grads[i] = g * scale
    return norm


def _sched(lr, step) -> np.float32:
    return np.float32(lr(step) if callable(lr) else lr)


def _zeros(params) -> List[torch.Tensor]:
    return [torch.zeros_like(p, dtype=torch.float32) for p in params]


def _capturing(device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _stager(scalars: Callable[[int], Dict[str, np.float32]]) -> Callable:
    """``stage(step, device)``: the 0-dim float32 tensors on ``device``
    that hold ``scalars(step)`` (a step's changing scalars, computed on
    the host in float32), written for ``step``. A CUDA graph of a step
    reads them by address, so they are written before its replay and
    never under its capture (which would bake the values in): under
    capture ``stage`` only returns them."""
    bufs: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def stage(step, device) -> Dict[str, torch.Tensor]:
        device = torch.device(device)
        held = bufs.get(device)
        if _capturing(device):
            if held is None:
                raise RuntimeError("optimizer scalars must be staged before "
                                   "a CUDA graph capture of the step")
            return held
        values = scalars(step)
        if held is None:
            held = bufs[device] = {
                name: torch.zeros((), dtype=torch.float32, device=device)
                for name in values}
        for name, v in values.items():
            held[name].fill_(float(v))
        return held

    return stage


def _optimizer(init, leaf_update, scalars, grad_clip) -> Optimizer:
    """An Optimizer from its per-leaf rule ``leaf_update(state, i, g, p,
    sc)``, which updates leaf ``i`` of the state in place and returns that
    leaf's update (a tensor it may own or a new one). ``sc``: the step's
    changing scalars (``scalars(step)``: name -> float32, computed on the
    host) as 0-dim device tensors, which ``stage`` writes."""
    stage = _stager(scalars)

    def step_(grads: List[torch.Tensor], state, params, step,
              norm_fn=global_norm):
        """Clip, then per leaf: compute the update, add it to the
        parameter, drop it and the leaf's gradient. ``grads`` must be a
        list the caller hands over: each entry is set to None once its
        leaf is applied. ``norm_fn`` as ``clip_by_global_norm_``'s."""
        if grad_clip:
            clip_by_global_norm_(grads, grad_clip, norm_fn)
        sc = stage(step, params[0].device) if params else {}
        with torch.no_grad():
            for i, p in enumerate(params):
                u = leaf_update(state, i, grads[i], p, sc)
                grads[i] = None
                p.add_(u.to(p.dtype))
                del u
        return state

    return Optimizer(init, step_, stage)


def _neg_lr(lr):
    """The scalars of a rule that scales by -lr_t."""
    return lambda step: {"neg_lr": -_sched(lr, step)}


def sgd(lr, momentum=0.0, grad_clip=None):
    def init(params):
        return {"mom": _zeros(params)} if momentum else {}

    def leaf_update(state, i, g, p, sc):
        del p
        if momentum:
            m = state["mom"][i]
            m.mul_(momentum).add_(g)
            return m * sc["neg_lr"]
        return g * sc["neg_lr"]

    return _optimizer(init, leaf_update, _neg_lr(lr), grad_clip)


def rmsprop(lr, decay=0.99, eps=0.01, momentum=0.0, grad_clip=40.0):
    """TensorFlow-flavored RMSProp, as used by IMPALA/TorchBeast."""
    def init(params):
        state = {"ms": _zeros(params)}
        if momentum:
            state["mom"] = _zeros(params)
        return state

    def leaf_update(state, i, g, p, sc):
        del p
        g = g.float()
        m = state["ms"][i]
        m.mul_(decay).add_((1 - decay) * g * g)
        s = torch.rsqrt(m + eps).mul_(g)          # g * rsqrt(ms + eps)
        if momentum:
            mo = state["mom"][i]
            mo.mul_(momentum).add_(s)
            return mo * sc["neg_lr"]
        return s.mul_(sc["neg_lr"])

    return _optimizer(init, leaf_update, _neg_lr(lr), grad_clip)


def adamw(lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0, grad_clip=1.0):
    def init(params):
        return {"mu": _zeros(params), "nu": _zeros(params)}

    def scalars(step):
        # the bias corrections c = 1 - b^t (t = step + 1) in float32, and
        # 1 / c taken in float64 and rounded: the CPU divides a float32
        # tensor by a Python float as by its float32 rounding, the card
        # multiplies by its reciprocal so taken, so each device's eager
        # arithmetic stays bitwise what a Python float gave
        t = float(step) + 1.0
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
        return {"neg_lr": -_sched(lr, step),
                "c1": np.float32(c1), "c2": np.float32(c2),
                "inv_c1": np.float32(1.0 / c1), "inv_c2": np.float32(1.0 / c2)}

    def leaf_update(state, i, g, p, sc):
        g = g.float()
        mu, nu = state["mu"][i], state["nu"][i]
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * g * g)
        # -lr * (mu_hat / (sqrt(nu_hat) + eps) + wd * p), in two buffers
        if mu.is_cuda:
            u, den = mu * sc["inv_c1"], nu * sc["inv_c2"]
        else:
            u, den = mu / sc["c1"], nu / sc["c2"]
        u.div_(den.sqrt_().add_(eps))
        del den
        u.add_(weight_decay * p.detach().float())
        return u.mul_(sc["neg_lr"])

    return _optimizer(init, leaf_update, scalars, grad_clip)


class ZeroSlice(NamedTuple):
    """This data rank's slice of a leaf it holds: ``length`` elements of
    dimension ``dim`` from ``start`` (0 elements where another rank keeps
    the whole leaf's state)."""
    dim: int
    start: int
    length: int


def zero_view(x: torch.Tensor, s: Optional[ZeroSlice]) -> torch.Tensor:
    """``x``'s slice ``s`` (``x`` itself for None), a view."""
    return x if s is None else x.narrow(s.dim, s.start, s.length)


def zero1(opt: Optimizer, slices: Sequence[Optional[ZeroSlice]],
          mesh) -> Optimizer:
    """``opt`` with its state kept for each leaf's ``slices`` entry only
    (None: the whole leaf, e.g. one already split over the data group).
    ``step`` takes the gradients of those slices, updates the slices of
    the parameters in place, then gathers each sliced leaf over ``mesh``'s
    data group (a zero-padded all-reduce, exact)."""
    from repro_torch.models.common import collective

    def views(params):
        return [zero_view(p, s) for p, s in zip(params, slices)]

    def init(params):
        return opt.init(views(params))

    def step_(grads, state, params, step, norm_fn=global_norm):
        state = opt.step(grads, state, views(params), step, norm_fn=norm_fn)
        with torch.no_grad():
            for p, s in zip(params, slices):
                if s is None:
                    continue
                buf = torch.zeros_like(p)
                zero_view(buf, s).copy_(zero_view(p, s))
                p.copy_(collective(buf, "data", "all_gather", mesh=mesh))
        return state

    return Optimizer(init, step_, opt.stage)


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
