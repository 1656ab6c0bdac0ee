"""Plain reference of ``granite_3_0_1b_a400m``, float32 with TF32 off: the
decoder as the port computes it (pre-norm RMSNorm with ``1 + scale`` and
float32 statistics; GQA attention, 16 query and 8 kv heads of 64, rotary
on split halves, causal; token-choice top-8 of 32 SwiGLU experts with
capacity-bounded dispatch; the tied head and a value head), the IMPALA
learner step on its episodes (V-trace, the losses, the router's auxiliary
terms, AdamW after a global-norm clip of 1) and the pretraining step
(cross-entropy), and the log-probabilities the generation's sampling
read.

The experts' dispatch is computed as the port routes it: tokens in groups
(``rows``: the batch's tokens in row order, in groups of 512; or
``positions``: the rows' tokens at one position, as each prefill of a
one-token prompt and each decode step routes them), the experts of each
token by a stable descending sort of the router's softmax, renormalised
over the top 8; each expert takes at most ``capacity`` token-slots of a
group, counted over (token, slot) in order, the others dropped. Each
expert's FFN runs on the tokens routed to it (a loop over the experts).

``cast`` rounds the activations where the program rounds them to its
activation type: the identity for the reference, float8 for the control
(``common.make_cast``).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from perfbench.reference import common

MOE_GROUP = 512


def _ident(x):
    return x


def rmsnorm(x, scale, eps, cast):
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return cast(x * torch.rsqrt(var + eps) * (1.0 + scale))


def rope(x, positions, theta):
    """x (B, S, H, hd); the two halves of hd rotate together."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    angles = positions[:, None].float() * freqs
    cos, sin = torch.cos(angles)[:, None, :], torch.sin(angles)[:, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(w, p, x, m, cast):
    b, s, _ = x.shape
    q = cast(torch.einsum("bsd,dhe->bshe", x, w[p + "mixer.wq"]))
    k = cast(torch.einsum("bsd,dke->bske", x, w[p + "mixer.wk"]))
    v = cast(torch.einsum("bsd,dke->bske", x, w[p + "mixer.wv"]))
    pos = torch.arange(s, device=x.device)
    q = cast(rope(q, pos, m["rope_theta"]))
    k = cast(rope(k, pos, m["rope_theta"]))
    group = m["num_heads"] // m["num_kv_heads"]
    k = torch.repeat_interleave(k, group, dim=2)
    v = torch.repeat_interleave(v, group, dim=2)
    scores = torch.einsum("bqhe,bkhe->bhqk", q, k) * m["head_dim"] ** -0.5
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    o = cast(torch.einsum("bhqk,bkhe->bqhe", torch.softmax(scores, -1), v))
    return cast(torch.einsum("bshe,hed->bsd", o, w[p + "mixer.wo"]))


def capacity(m, group_size):
    c = int(m["capacity_factor"] * group_size * m["num_experts_per_tok"]
            / m["num_experts"])
    return max(4, -(-c // 4) * 4)


def moe(w, p, x, m, cast, groups):
    """(output (B, S, d), load-balance loss, z-loss)."""
    b, s, d = x.shape
    e, k = m["num_experts"], m["num_experts_per_tok"]
    if groups == "rows":
        n = b * s
        gs = min(MOE_GROUP, n)
        xg = x.reshape(n // gs, gs, d)
    else:
        xg = x.transpose(0, 1)                               # (S, B, d)
        gs = b
    logits = xg @ w[p + "ffn.router"]
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top, idx = top[..., :k], idx[..., :k]
    top = top / torch.clamp(top.sum(-1, keepdim=True), min=1e-9)
    onehot = F.one_hot(idx, e).float()                       # (g, n, k, e)
    load_balance = e * torch.sum(probs.mean(dim=(0, 1))
                                 * onehot.sum(2).mean(dim=(0, 1))) / k
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    with torch.no_grad():
        ng = onehot.shape[0]
        flat = onehot.reshape(ng, gs * k, e)
        before = (torch.cumsum(flat, 1) - flat).reshape(ng, gs, k, e)
        keep = (before * onehot).sum(-1) < capacity(m, gs)   # (g, n, k)
    weight = cast(top) * keep
    out = torch.zeros_like(xg)
    for ex in range(e):
        gi, ti, ki = torch.nonzero((idx == ex) & keep, as_tuple=True)
        if gi.numel() == 0:
            continue
        xe = xg[gi, ti]
        h = cast(xe @ w[p + "ffn.wi"][ex])
        gate = xe @ w[p + "ffn.wg"][ex]
        h = cast(h * cast(F.silu(gate)))
        eo = cast(h @ w[p + "ffn.wo"][ex])
        out = out.index_put((gi, ti), weight[gi, ti, ki][:, None] * eo,
                            accumulate=True)
    out = cast(out)
    out = out.reshape(b, s, d) if groups == "rows" else out.transpose(0, 1)
    return out, load_balance, z_loss


def forward(w, tokens, m, cast=_ident, groups="rows"):
    """Hidden states (B, S, d) after the final norm, and the summed
    load-balance and z-losses, for tokens (B, S)."""
    eps = m["norm_eps"]
    x = cast(w["embed"][tokens])
    lb = z = torch.zeros((), device=x.device)
    for g in range(m["num_groups"]):
        p = f"blocks.{g}.l0."
        h = rmsnorm(x, w[p + "pre_norm.scale"], eps, cast)
        x = cast(x + attention(w, p, h, m, cast))
        h = rmsnorm(x, w[p + "ffn_pre_norm.scale"], eps, cast)
        o, glb, gz = moe(w, p, h, m, cast, groups)
        x = cast(x + o)
        lb, z = lb + glb, z + gz
    return rmsnorm(x, w["final_norm.scale"], eps, cast), lb, z


def logits_of(w, h, cast):
    return h @ cast(w["embed"]).T


def lm_rl_loss(w, batch, config, cast=_ident):
    """(the learner's loss with the router terms, the reported loss) of a
    time-major episode batch: obs (T+1, B) tokens, behavior_logprob,
    reward, done (T, B)."""
    m, train = config["model"], config["train"]
    tokens = batch["obs"].T.long()
    h, lb, z = forward(w, tokens[:, :-1], m, cast)
    lp, ent = common.logprob_entropy(logits_of(w, h, cast), tokens[:, 1:])
    values = h @ w["baseline"]
    discounts = (~batch["done"]).float() * train["discount"]
    total, _ = common.impala_loss(
        lp.T, ent.T, batch["behavior_logprob"].float(),
        batch["reward"].float(), discounts, values.T,
        torch.zeros(tokens.shape[0], device=h.device), train)
    return total + m["router_aux_weight"] * lb + m["router_z_weight"] * z, \
        total


def lm_loss(w, batch, config, cast=_ident):
    """(the loss with the router terms, the mean cross-entropy) of rows
    {"tokens": (B, S+1)}."""
    m = config["model"]
    tokens = batch["tokens"].long()
    h, lb, z = forward(w, tokens[:, :-1], m, cast)
    lp, _ = common.logprob_entropy(logits_of(w, h, cast), tokens[:, 1:])
    xent = -lp.mean()
    return xent + m["router_aux_weight"] * lb + m["router_z_weight"] * z, \
        xent


@torch.no_grad()
def served_logprobs(w, batch, config, cast=_ident):
    """(T, B) log-probabilities of an episode's tokens under the policy
    that generated them, as its sampling read them: each position's rows
    routed together (``positions``), the logits at temperature 1."""
    tokens = batch["obs"].T.long()
    h, _, _ = forward(w, tokens[:, :-1], config["model"], cast,
                      groups="positions")
    lp, _ = common.logprob_entropy(logits_of(w, h, cast), tokens[:, 1:])
    return lp.T


def follow(w: Dict[str, torch.Tensor], batches: List[dict], config: dict,
           mode: str, cast=_ident) -> dict:
    """The learner steps 0, 1, ... on ``batches`` from the weights ``w``
    (updated in place); ``mode`` ``lm_rl`` or ``lm``. Returns each step's
    reported loss, the first step's clipped gradient norms by leaf, and
    for ``lm_rl`` the first step's clipped gradient itself (``grad_vec``)
    and each batch's served log-probabilities under the weights of its
    step (``served``)."""
    loss_fn = lm_rl_loss if mode == "lm_rl" else lm_loss
    names = list(w)
    for p in w.values():
        p.requires_grad_(True)
    opt = common.Optimizer(config["train"], w)
    losses, first, served = [], None, []
    first_vec: Dict[str, torch.Tensor] = {}
    for step, batch in enumerate(batches):
        if mode == "lm_rl":
            served.append(served_logprobs(w, batch, config, cast))
        total, reported = loss_fn(w, batch, config, cast)
        grads = torch.autograd.grad(total, [w[n] for n in names],
                                    allow_unused=True, materialize_grads=True)
        del total
        keep = first_vec if mode == "lm_rl" and step == 0 else None
        norms = opt.step(w, dict(zip(names, grads)), step, keep)
        del grads
        losses.append(float(reported.detach()))
        if first is None:
            first = norms
    for p in w.values():
        p.requires_grad_(False)
    del opt
    out = {"loss": losses, "grad": first, "served": served}
    if mode == "lm_rl":
        out["grad_vec"] = first_vec
    return out
