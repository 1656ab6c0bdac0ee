"""Mixture-of-Experts FFN: token-choice top-k routing with GShard-style
grouped, capacity-based dispatch (one-hot dispatch/combine einsums).

Tokens are split into groups of ``min(MOE_GROUP_SIZE, n)``; each group
dispatches into per-expert capacity buffers of C = factor * g * k / E
(rounded up to a multiple of 4, at least 4). A token-slot past its
expert's capacity is dropped: its share of the output is zero.

Routing is the reference's index for index. Ties between router
probabilities go to the lower expert index, as ``jax.lax.top_k`` breaks
them (a stable descending sort; ``torch.topk`` promises no order). The
capacity count runs over the flattened (token, k-slot) order of each
group, k sorted by probability, so the same token-slots are dropped.

Casts follow the reference: the activation's type (bf16 on the serving
path) for the dispatched tokens and expert outputs, float32 accumulation
in every product, and the gate ``g_`` kept in float32 through ``silu``.
The dispatch mask and the cells tokens occupy are step functions of the
routing and carry no gradient; the router's gradient flows through the
renormalised top-k probabilities and the auxiliary losses. The combine
gathers each token's k expert outputs and sums them in slot order: the
same terms as the reference's combine einsum, whose other terms are
zero, summed so that a token's output is a function of its own routing
(a serving slot's stream is then bitwise independent of its neighbours).

Aux losses follow Switch/Mixtral: load-balance (mean routed fraction x
mean router probability per expert, scaled by E/k) and router z-loss.
The reference has no Pallas kernel here, so these are plain PyTorch ops.

Under a model axis of M (``common.use_rules``; the megatron rules keep
``expert`` whole) that divides ``moe_d_ff``, each expert's FFN is split
as ``mlp.py``'s: ``wi``/``wg`` on their hidden axis, ``wo`` on its first.
The router runs whole on every rank, so every rank routes, drops and
combines alike; each rank combines its partial expert outputs in float32
and the sum over the model group is the layer's output.

Under the expert rules (``expert`` -> "model", ``mlp`` whole) with M
dividing E, each rank holds E/M whole experts (``wi``/``wg``/``wo`` on
their expert axis) and the router's columns of its experts. Its router
logits are gathered over the model group before the softmax, so every
rank routes, drops and counts capacity as the reference does, index for
index; each rank dispatches the tokens it holds to its experts, and the
combine over its experts' token-slots (the others' weigh zero) is summed
over the model group.

Under a data axis (each rank routes its block of the batch), the
load-balance loss's two per-expert means are taken over the whole batch
(``common.data_mean``), as the reference computes them over its global
batch: the loss is a product of means, not a mean. Capacity is counted
per group of a rank's tokens; the groups are the reference's when each
data block holds whole groups of ``MOE_GROUP_SIZE`` tokens (else, with
capacity binding, other token-slots may be dropped).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (Params, copy_to_model, data_mean,
                                       full_size, gather_model, local_slice,
                                       model_mesh, model_split, operand,
                                       param, reduce_from_model, rule)

MOE_GROUP_SIZE = 512

# the reference's logical axes of each leaf (its ``moe_init``)
AXES = {"router": ("embed", "expert"), "wi": ("expert", "embed", "mlp"),
        "wg": ("expert", "embed", "mlp"), "wo": ("expert", "mlp", "embed")}


class MoEAux(NamedTuple):
    load_balance: torch.Tensor  # scalar
    z_loss: torch.Tensor        # scalar
    dropped_frac: torch.Tensor  # fraction of token-slots dropped by capacity


def moe_init(cfg, *, generator, device=None):
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    kw = dict(generator=generator, device=device)
    return Params(router=param((d, e), scale=d ** -0.5, **kw),
                  wi=param((e, d, f), **kw), wg=param((e, d, f), **kw),
                  wo=param((e, f, d), **kw))


def _capacity(cfg, group_size):
    c = int(cfg.capacity_factor * group_size * cfg.num_experts_per_tok
            / cfg.num_experts)
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def route(probs, k):
    """(top-k probabilities, their expert indices), largest first; equal
    probabilities in ascending index order, as ``jax.lax.top_k``."""
    values, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


@torch.no_grad()
def capacity_slots(onehot, cap):
    """Each token-slot's position in its expert's buffer, counted over the
    group's flattened (token, k-slot) order, and whether it fits in the
    capacity ``cap``: (pos_in_expert, keep), (g, n, k) float32 each.
    ``onehot``: the routing as (g, n, k, e) float32 one-hot rows."""
    ng, gs, k, e = onehot.shape
    flat = onehot.reshape(ng, gs * k, e)
    pos = torch.cumsum(flat, dim=1) - flat                     # (g, n*k, e)
    pos_in_expert = torch.sum(pos.reshape(ng, gs, k, e) * onehot, -1)
    return pos_in_expert, (pos_in_expert < cap).float()


def moe_apply(params, x, cfg):
    """x: (B, S, d) -> (out, MoEAux). Token-choice top-k over grouped
    tokens; B * S must be at most MOE_GROUP_SIZE or a multiple of it."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    dt = x.dtype
    n = b * s
    gs = min(MOE_GROUP_SIZE, n)
    if n % gs:
        raise ValueError(f"MoE routes {n} tokens in groups of {gs}: B * S "
                         f"must be at most {MOE_GROUP_SIZE} or a multiple "
                         "of it, as in the reference")
    ng = n // gs
    xt = x.reshape(ng, gs, d)
    experts = rule("expert") == "model" and model_split(e) > 1
    split = experts or model_split(full_size(params, "wi", 2)) > 1
    if experts:
        w = {name: operand(params, name, 0) for name in ("wi", "wg", "wo")}
        local = copy_to_model(xt).float() @ operand(params, "router", 1)
        logits = gather_model(local, -1)                       # (g, n, e)
    else:
        w = {"wi": operand(params, "wi", 2 if split else None),
             "wg": operand(params, "wg", 2 if split else None),
             "wo": operand(params, "wo", 1 if split else None)}
        logits = xt.float() @ operand(params, "router")        # (g, n, e)
    probs = torch.softmax(logits, dim=-1)
    topk_prob, topk_idx = route(probs, k)                      # (g, n, k)
    topk_prob = topk_prob / torch.clamp(
        topk_prob.sum(-1, keepdim=True), min=1e-9)

    # aux losses: from the probabilities before renormalisation, over all
    # tokens
    onehot = F.one_hot(topk_idx, e).float()                    # (g, n, k, e)
    me = data_mean(probs.mean(dim=(0, 1)))
    ce = data_mean(onehot.sum(2).mean(dim=(0, 1)))
    load_balance = e * torch.sum(me * ce) / k
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))

    # per-group capacity dispatch
    cap = _capacity(cfg, gs)
    pos_in_expert, keep = capacity_slots(onehot, cap)
    with torch.no_grad():
        dropped = 1.0 - keep.mean()
        # a slot index past the capacity matches no column: zero row
        cap_onehot = (pos_in_expert[..., None] == torch.arange(
            cap, device=x.device)).to(dt) * keep[..., None].to(dt)
        dispatch = torch.einsum("gnke,gnkc->gnec", onehot.to(dt),
                                cap_onehot)
        # the (e, cap) cell each token-slot occupies (a dropped one's
        # weight is zero below)
        cell = topk_idx * cap + torch.clamp(pos_in_expert.long(),
                                            max=cap - 1)

    xin = torch.einsum("gnec,gnd->gecd", dispatch.float(),
                       xt.float()).to(dt)
    if split:
        xin = copy_to_model(xin)
    if experts:
        # this rank's experts, their outputs whole: rounded as unsplit
        xin = local_slice(xin, 1)
        first = model_mesh().model_index * (e // model_mesh().model)
    h = torch.einsum("gecd,edf->gecf", xin.float(), w["wi"]).to(dt)
    g_ = torch.einsum("gecd,edf->gecf", xin.float(), w["wg"])
    h = h * F.silu(g_).to(dt)
    eo = torch.einsum("gecf,efd->gecd", h.float(), w["wo"])
    if experts or not split:
        eo = eo.to(dt)
    # combine: each token-slot's own routing weight (rounded to the
    # activation's type, as the reference's combine tensor) times the
    # expert output in its cell, summed over the k slots in their order.
    # This is the reference's combine einsum over (e, cap) cells, whose
    # only nonzero terms are these k; summed in slot order, a token's
    # output does not depend on which cells its neighbours pushed it to.
    # Split: each rank's expert outputs are partial sums, kept in float32;
    # the weights enter that rank-local work behind copy_to_model.
    weight = (topk_prob.to(dt) * keep.to(dt)).float()          # (g, n, k)
    if split:
        weight = copy_to_model(weight)
    if experts:
        with torch.no_grad():
            cell = cell - first * cap
            mine = (cell >= 0) & (cell < eo.shape[1] * cap)
            cell = cell.clamp(0, eo.shape[1] * cap - 1)
        weight = weight * mine
    picked = torch.gather(
        eo.reshape(ng, -1, d), 1,
        cell.reshape(ng, gs * k, 1).expand(ng, gs * k, d))
    out = torch.sum(weight[..., None]
                    * picked.reshape(ng, gs, k, d).float(), dim=2)
    if split:
        out = reduce_from_model(out)
    return out.to(dt).reshape(b, s, d), MoEAux(load_balance, z_loss,
                                                dropped)
