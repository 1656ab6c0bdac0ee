"""Plain reference of ``impala_deep_atari``: the IMPALA deep ResNet
(Espeholt et al. 2018, Fig. 3 right: three sections of a 3x3 convolution,
3x3 max-pool of stride 2 and two residual blocks, then ReLU, a 256-unit
linear layer and the policy and baseline heads) on time-major
observations (..., 84, 84, 4), and its IMPALA learner step (V-trace, the
losses, RMSProp after a global-norm clip of 40), in float32 with TF32 off.

``cast`` rounds the operands of every product: the identity for the
reference, TF32 for the control (``common.make_cast``).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from perfbench.reference import common


def forward(w: Dict[str, torch.Tensor], obs: torch.Tensor, config: dict,
            cast=lambda x: x):
    """(policy logits (..., A), baseline (...)) for obs (..., H, W, C)."""
    a = config["agent"]
    lead = obs.shape[:-3]
    x = obs.reshape((-1,) + tuple(obs.shape[-3:])).float().permute(0, 3, 1, 2)

    def conv(x, name):
        return F.conv2d(cast(x), cast(w[name + ".weight"]),
                        w[name + ".bias"], padding=1)

    def linear(x, name):
        return F.linear(cast(x), cast(w[name + ".weight"]), w[name + ".bias"])

    for i in range(len(a["channels"])):
        x = F.max_pool2d(conv(x, f"sections.{i}.conv"), 3, 2, padding=1)
        for j in range(a["residual_blocks"]):
            y = conv(F.relu(x), f"sections.{i}.res.{j}.c1")
            x = x + conv(F.relu(y), f"sections.{i}.res.{j}.c2")
    x = F.relu(x).permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(linear(x, "fc"))
    logits = linear(x, "policy")
    baseline = linear(x, "baseline")[..., 0]
    return (logits.reshape(tuple(lead) + (logits.shape[-1],)),
            baseline.reshape(lead))


def loss(w, batch, config: dict, cast=lambda x: x):
    """The IMPALA loss of one time-major rollout batch."""
    train = config["train"]
    logits, baseline = forward(w, batch["obs"], config, cast)
    target_lp, entropy = common.logprob_entropy(logits[:-1], batch["action"])
    behavior_lp, _ = common.logprob_entropy(batch["behavior_logits"],
                                            batch["action"])
    discounts = (~batch["done"]).float() * train["discount"]
    total, _ = common.impala_loss(target_lp, entropy, behavior_lp,
                                  batch["reward"].float(), discounts,
                                  baseline[:-1], baseline[-1], train)
    return total


def follow(w: Dict[str, torch.Tensor], batches: List[dict], config: dict,
           cast=lambda x: x) -> dict:
    """The learner steps 0, 1, ... on ``batches`` from the weights ``w``
    (updated in place). Returns each step's loss, the first step's clipped
    gradient norms by leaf, and the weights after each step (``after``,
    a list of detached copies of the leaves)."""
    leaves = {n: p.requires_grad_(True) for n, p in w.items()}
    opt = common.Optimizer(config["train"], leaves)
    losses, first, after = [], None, []
    for step, batch in enumerate(batches):
        total = loss(leaves, batch, config, cast)
        names = list(leaves)
        grads = torch.autograd.grad(total, [leaves[n] for n in names])
        norms = opt.step(leaves, dict(zip(names, grads)), step)
        losses.append(float(total.detach()))
        if first is None:
            first = norms
        after.append({n: p.detach().clone() for n, p in leaves.items()})
    for p in leaves.values():
        p.requires_grad_(False)
    return {"loss": losses, "grad": first, "after": after}


@torch.no_grad()
def behaviour_logits(w, obs, config, cast=lambda x: x):
    """The actors' policy logits for a rollout's observations (T, B)."""
    return forward(w, obs, config, cast)[0]
