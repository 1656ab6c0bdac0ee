"""Plain float32 pieces shared by the references: V-trace as the reverse
loop of DeepMind's ``vtrace.py``, the IMPALA losses as TorchBeast sums
them (over T, mean over B), RMSProp (TensorFlow's, eps inside the root)
and AdamW with global-norm clipping, the schedules, and the casts that
put a reference at a lower precision for the control.

Nothing here imports the port; it is written from the papers' equations
and kept frozen with the benchmark.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# precision of a reference: float32 (the reference), or the control's


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa, to nearest."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


class _Cast(torch.autograd.Function):
    """A rounding of the forward value and of the gradient that flows back
    through it (straight through otherwise)."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def _fp8(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float8_e4m3fn).to(x.dtype)


ROUNDINGS: Dict[str, Callable] = {"tf32": _round_tf32, "fp8": _fp8}


def make_cast(precision: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """``float32``: the identity. ``tf32``: operands of every product
    rounded to TF32 (the step below float32 with TF32 off). ``fp8``:
    activations rounded to float8 e4m3 where the program rounds them to
    bfloat16 (the step below bfloat16)."""
    if precision == "float32":
        return lambda x: x
    fn = ROUNDINGS[precision]
    return lambda x: _Cast.apply(x.float(), fn)


# ---------------------------------------------------------------------------
# V-trace and the IMPALA losses (time-major (T, B))


def vtrace(log_rhos, discounts, rewards, values, bootstrap, *, clip_rho=1.0,
           clip_c=1.0, clip_pg_rho=1.0):
    """(vs, pg_advantages), no gradient: the reverse loop over T."""
    with torch.no_grad():
        rhos = torch.exp(log_rhos)
        clipped = torch.clamp(rhos, max=clip_rho)
        cs = torch.clamp(rhos, max=clip_c)
        v_next = torch.cat([values[1:], bootstrap[None]], 0)
        deltas = clipped * (rewards + discounts * v_next - values)
        acc = torch.zeros_like(bootstrap)
        out = []
        for t in range(values.shape[0] - 1, -1, -1):
            acc = deltas[t] + discounts[t] * cs[t] * acc
            out.append(acc)
        vs = torch.stack(out[::-1]) + values
        vs_next = torch.cat([vs[1:], bootstrap[None]], 0)
        pg_adv = torch.clamp(rhos, max=clip_pg_rho) * (
            rewards + discounts * vs_next - values)
    return vs, pg_adv


def _sum_t_mean_b(x):
    return x.mean(dim=1).sum()


def impala_loss(target_lp, entropy, behavior_lp, rewards, discounts, values,
                bootstrap, train: dict):
    """The IMPALA loss from the taken actions' log-probs under the
    learner's policy (``target_lp``, with gradient), the policy's entropy
    per step, the behaviour policy's log-probs, and the values; returns
    (total, (pg, baseline, entropy))."""
    vs, pg_adv = vtrace(target_lp.detach() - behavior_lp, discounts,
                        rewards, values.detach(), bootstrap.detach(),
                        clip_rho=train["vtrace_rho_clip"],
                        clip_c=train["vtrace_c_clip"])
    pg = _sum_t_mean_b(-target_lp * pg_adv)
    base = 0.5 * _sum_t_mean_b(torch.square(vs - values))
    ent = _sum_t_mean_b(-entropy)
    total = pg + train["baseline_cost"] * base + train["entropy_cost"] * ent
    return total, (pg, base, ent)


def logprob_entropy(logits, actions):
    """float32 log p(action) and entropy of softmax(logits)."""
    lp = F.log_softmax(logits.float(), dim=-1)
    taken = torch.gather(lp, -1, actions.long()[..., None])[..., 0]
    return taken, -torch.sum(torch.exp(lp) * lp, dim=-1)


# ---------------------------------------------------------------------------
# schedules and optimizers


def learning_rate(train: dict, step: int) -> float:
    lr, kind = train["learning_rate"], train["lr_schedule"]
    total, warm = train.get("total_steps", 1), train.get("warmup_steps", 0)
    ramp = min(step / max(warm, 1), 1.0) if warm else 1.0
    if kind == "constant":
        return lr
    if kind == "linear":
        return lr * ramp * min(max(1.0 - step / total, 0.0), 1.0)
    if kind == "cosine":
        t = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
        return lr * ramp * (0.1 + 0.9 * 0.5 * (1.0 + math.cos(math.pi * t)))
    raise ValueError(kind)


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))


class Optimizer:
    """RMSProp (TensorFlow's: ``g / sqrt(ms + eps)``) or AdamW, after a
    global-norm clip, over a dict of leaves updated in place. ``step``
    returns the clipped gradients' norms by leaf."""

    def __init__(self, train: dict, leaves: Dict[str, torch.Tensor]):
        self.train = train
        self.state = {n: {k: torch.zeros_like(p) for k in self._slots()}
                      for n, p in leaves.items()}

    def _slots(self):
        return ("ms",) if self.train["optimizer"] == "rmsprop" \
            else ("mu", "nu")

    @torch.no_grad()
    def step(self, leaves: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], step: int,
             keep: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, float]:
        """One update; ``keep``, where given, receives each leaf's clipped
        gradient."""
        t = self.train
        clip = t["grad_clip"]
        norm = global_norm(list(grads.values()))
        scale = torch.clamp(clip / torch.clamp(norm, min=1e-9), max=1.0) \
            if clip else 1.0
        lr = learning_rate(t, step)
        norms = {}
        for n, p in leaves.items():
            g = grads[n] * scale
            norms[n] = float(torch.linalg.vector_norm(g))
            if keep is not None:
                keep[n] = g
            s = self.state[n]
            if t["optimizer"] == "rmsprop":
                s["ms"].mul_(t["rmsprop_decay"]).add_(
                    (1 - t["rmsprop_decay"]) * g * g)
                p.add_(-lr * g * torch.rsqrt(s["ms"] + t["rmsprop_eps"]))
            else:
                b1, b2 = t["adam_b1"], t["adam_b2"]
                s["mu"].mul_(b1).add_((1 - b1) * g)
                s["nu"].mul_(b2).add_((1 - b2) * g * g)
                mhat = s["mu"] / (1 - b1 ** (step + 1))
                vhat = s["nu"] / (1 - b2 ** (step + 1))
                p.add_(-lr * (mhat / (vhat.sqrt() + t["adam_eps"])
                              + t.get("weight_decay", 0.0) * p))
        return norms
