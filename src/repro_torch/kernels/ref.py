"""Plain PyTorch versions of the kernels (the allclose targets).

The tests hold them against the JAX reference, ``chip_smoke.py`` holds each
kernel against them on the card, and the wrappers in ``ops.py`` run them
for CPU tensors. On a CUDA tensor the main path never calls them.
"""

from __future__ import annotations

import torch


def ref_vtrace_scan(deltas, dcs):
    """Reverse first-order recurrence acc_t = deltas_t + dcs_t * acc_{t+1},
    acc_T = 0, as a Python loop over T (deltas, dcs: (T, B))."""
    deltas = deltas.float()
    dcs = dcs.float()
    acc = torch.zeros_like(deltas[0])
    out = torch.empty_like(deltas)
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + dcs[t] * acc
        out[t] = acc
    return out


def _clip(threshold, x):
    return x if threshold is None else torch.clamp(x, max=threshold)


def ref_vtrace_from_importance_weights(
        log_rhos, discounts, rewards, values, bootstrap_value, *,
        clip_rho_threshold=1.0, clip_c_threshold=1.0,
        clip_pg_rho_threshold=1.0):
    """The whole V-trace computation the fused kernel does, returning
    (vs, pg_advantages), both (T, B) float32 and carrying no gradient.
    ``None`` thresholds mean no clipping."""
    with torch.no_grad():
        log_rhos, discounts, rewards, values, bootstrap_value = (
            x.detach().float() for x in (log_rhos, discounts, rewards,
                                         values, bootstrap_value))
        rhos = torch.exp(log_rhos)
        clipped_rhos = _clip(clip_rho_threshold, rhos)
        cs = _clip(clip_c_threshold, rhos)
        values_tp1 = torch.cat([values[1:], bootstrap_value[None]], 0)
        deltas = clipped_rhos * (rewards + discounts * values_tp1 - values)
        vs = values + ref_vtrace_scan(deltas, discounts * cs)
        vs_tp1 = torch.cat([vs[1:], bootstrap_value[None]], 0)
        pg_rhos = _clip(clip_pg_rho_threshold, rhos)
        pg_advantages = pg_rhos * (rewards + discounts * vs_tp1 - values)
    return vs, pg_advantages
