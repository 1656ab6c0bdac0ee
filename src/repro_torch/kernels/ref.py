"""Plain PyTorch versions of the kernels (the allclose targets).

The tests hold them against the JAX reference, ``chip_smoke.py`` holds each
kernel against them on the card, and the wrappers in ``ops.py`` run them
for CPU tensors. On a CUDA tensor the main path never calls them.
"""

from __future__ import annotations

import math

import torch

# The float32 mask value shared by every masked-attention path: the model
# (models/attention.py), the plain versions below and the CUDA kernels. It
# is finite on purpose: a row whose every key is masked then gets p = 1
# until a live key arrives, where -inf would give exp(-inf - -inf) = NaN.
NEG_INF = -2.0e38


def ref_flash_attention(q, k, v, *, scale=None, causal=True, window=0,
                        softcap=0.0, q_offset=0):
    """q: (B,H,Sq,hd); k, v: (B,K,Sk,hd), H % K == 0 (query head h reads
    kv head h // (H/K)); query row i sits at position ``q_offset + i`` of
    the keys' sequence (the reference's function is q_offset 0, Sq = Sk).
    Dense softmax in float32; the output is in q's type."""
    b, h, s, hd = q.shape
    kheads, sk = k.shape[1], k.shape[2]
    group = h // kheads
    if scale is None:
        scale = hd ** -0.5
    qg = q.reshape(b, kheads, group, s, hd).float()
    logits = torch.einsum("bkgqh,bkth->bkgqt", qg, k.float()) * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = q_offset + torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((s, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= qpos - kpos < window
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgqt,bkth->bkgqh", p, v.float())
    return o.reshape(b, h, s, hd).to(q.dtype)


def ref_decode_attention(q, k, v, slot_pos, pos, *, scale=None, softcap=0.0,
                         window=0):
    """q: (B,H,hd); k, v: (B,K,S,hd); slot_pos: (S,) or (B,S) int, the
    position each cache slot holds (-1: empty); pos: scalar or (B,) int,
    each row's current position. A slot is valid when
    ``0 <= slot_pos <= pos`` (and ``pos - slot_pos < window``)."""
    b, h, hd = q.shape
    kheads, s = k.shape[1], k.shape[2]
    group = h // kheads
    if scale is None:
        scale = hd ** -0.5
    qg = q.reshape(b, kheads, group, hd).float()
    logits = torch.einsum("bkgh,bkth->bkgt", qg, k.float()) * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    slot_pos = torch.as_tensor(slot_pos, device=q.device).reshape(-1, s) \
        .expand(b, s)
    pos = torch.as_tensor(pos, device=q.device).reshape(-1).expand(b)
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    if window:
        valid &= pos[:, None] - slot_pos < window
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgt,bkth->bkgh", p, v.float())
    return o.reshape(b, h, hd).to(q.dtype)


def ref_ssd_chunk(c, b, xdt, da, h_prev):
    """One Mamba2 SSD chunk per (batch * head) slice. c, b: (BH,L,N); xdt:
    (BH,L,P); da: (BH,L,1) (<= 0); h_prev: (BH,P,N). In float32, or in
    float64 when xdt is float64 (the exact value ``ssd_tolerance`` takes).
    Returns y (BH,L,P) in xdt's type and h_new (BH,P,N):
        acs   = cumsum(da)
        y     = ((C B^T) * exp(acs_l - acs_s) [s <= l]) X + (C h^T) exp(acs)
        h_new = h exp(acs_L) + X^T (B exp(acs_L - acs))"""
    dt = torch.float64 if xdt.dtype == torch.float64 else torch.float32
    c, b, x, h = (t.to(dt) for t in (c, b, xdt, h_prev))
    acs = torch.cumsum(da.to(dt)[..., 0], dim=-1)              # (BH, L)
    seg = acs[:, :, None] - acs[:, None, :]
    l = c.shape[1]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=c.device))
    # masked BEFORE the exp (the same values as masking after it): above
    # the diagonal seg = acs_l - acs_s > 0 overflows exp once a chunk's
    # decay passes about 88.7, and exp's VJP there would be inf * 0 = NaN
    lmat = torch.exp(torch.where(mask, seg, -math.inf))
    scores = torch.einsum("gln,gsn->gls", c, b) * lmat
    y = torch.einsum("gls,gsp->glp", scores, x)
    y = y + torch.einsum("gln,gpn->glp", c, h) * torch.exp(acs)[..., None]
    w = torch.exp(acs[:, -1:] - acs)                           # (BH, L)
    h_new = h * torch.exp(acs[:, -1])[:, None, None] + \
        torch.einsum("glp,gln,gl->gpn", x, b, w)
    return y.to(xdt.dtype), h_new


def ssd_tolerance(want, exact):
    """rtol and atol that a float32 SSD chunk result is held to against
    ``want``, another float32 evaluation (the plain version, or the
    reference's), given ``exact``, the plain version in float64 on the same
    inputs: the reference's 3e-5 (tests/test_kernels.py), its absolute part
    widened by four times ``want``'s own float32 error. The decay
    exp(acs_l - acs_s) is a difference of two cumulative sums and carries
    the rounding of both, which grows with the chunk's length and |acs|,
    and y_l sums up to L terms, so two float32 evaluations in different
    orders differ by up to the sum of their errors; the factor lets the
    other evaluation be up to three times as far from exact as ``want``
    (the CUDA kernel's sums run sequentially over all L keys). The
    reference's Pallas kernel and plain version agree within 3e-5 only
    because both take XLA's cumsum and dot in the same order; up to 128
    positions of its draws the float32 error is far below 3e-5, at 256 it
    is not."""
    err = float(abs(want - exact).max())
    return dict(rtol=3e-5, atol=3e-5 + 4 * err)


def ref_ssd_chunk_heads(c, b, xdt, da, h_prev):
    """``ref_ssd_chunk`` in the model's layout, where the H heads of a batch
    row share one B/C group: c, b (B,L,N); xdt (B,L,H,P); da (B,L,H);
    h_prev (B,H,P,N). The group is repeated per head and the heads are
    flattened into slices, as the reference's ``mamba_apply`` does before
    it calls the kernel. Returns y (B,L,H,P) and h_new (B,H,P,N)."""
    bsz, l, heads, p = xdt.shape
    n = c.shape[-1]
    rows = bsz * heads

    def per_head(t):
        return t[:, None].expand(bsz, heads, l, n).reshape(rows, l, n)

    y, h_new = ref_ssd_chunk(per_head(c), per_head(b),
                             xdt.transpose(1, 2).reshape(rows, l, p),
                             da.transpose(1, 2).reshape(rows, l, 1),
                             h_prev.reshape(rows, p, n))
    return (y.reshape(bsz, heads, l, p).transpose(1, 2),
            h_new.reshape(bsz, heads, p, n))


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
