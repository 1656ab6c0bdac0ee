"""The arithmetic of the two attention kernels' designs, emulated in plain
PyTorch on the CPU, so that a fault of precision or of merging shows here
before it shows on the card:

* flash attention in bf16 (``csrc/flash_attention.cu``, tensor cores):
  bf16 q, k, v; float32 scores and online softmax over 64-key tiles (32
  at head_dim 256); P entering P V as three bf16 terms; float32 sums.
  Held to the bf16 bar of ``chip_smoke.py`` and
  ``tests/test_torch_attention_gpu.py``, where one bf16 term falls short;
* decode attention split over the cache (``csrc/decode_attention.cu``):
  a partial (m, l, acc) per slot range, merged as the combine kernel
  does, held to the float32 bar;
* ``ops.decode_splits``, the rule that picks the ranges.

The emulations live here; nothing on the port's path calls them."""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

NEG_INF = -2.0e38                       # the reference's finite mask
LOG2E = 1.4426950408889634
TOL = dict(rtol=2e-5, atol=2e-5)        # the float32 bar (ATTN_TOL)
BF16_TOL = dict(rtol=2 ** -7, atol=1e-6)  # the bf16 bar of the GPU tests
BQ = 64                                 # query rows of a flash block


def _bf16(x):
    """float32 values rounded to bf16 (nearest even) and widened back."""
    return x.to(torch.bfloat16).float()


def emulate_flash_tc(q, k, v, *, causal=True, window=0, softcap=0.0,
                     terms=3):
    """The bf16 tensor-core kernel's arithmetic: per 64-row query tile,
    key tiles from the window's first live tile to the causal diagonal,
    taken alternately by two halves of the block, each with its own online
    softmax, merged at the end; scores and softmax in float32, in log2
    units; keys past S left out of the max with p = 0, masked keys at
    NEG_INF; P as ``terms`` bf16 terms whose products with bf16 V are
    summed in float32. q (B,H,S,hd), k, v (B,K,S,hd), all bf16; returns
    bf16."""
    b, h, s, hd = q.shape
    group = h // k.shape[1]
    bk = 32 if hd == 256 else 64
    scale = hd ** -0.5
    kk = k.float().repeat_interleave(group, dim=1)
    vv = v.float().repeat_interleave(group, dim=1)
    qq = q.float()
    out = torch.empty_like(qq)
    n_tiles = -(-s // bk)
    for q0 in range(0, s, BQ):
        rows = torch.arange(q0, q0 + BQ)
        qt = torch.zeros((b, h, BQ, hd))
        qt[:, :, :min(BQ, s - q0)] = qq[:, :, q0:q0 + BQ]
        q_last = min(q0 + BQ, s) - 1
        hi = min(n_tiles, q_last // bk + 1) if causal else n_tiles
        lo = max(0, q0 - window + 1) // bk if window else 0
        states = [[torch.full((b, h, BQ), NEG_INF), torch.zeros((b, h, BQ)),
                   torch.zeros((b, h, BQ, hd))] for _ in range(2)]
        for kt in range(lo, hi):
            m, l, acc = states[(kt - lo) % 2]
            keys = torch.arange(kt * bk, (kt + 1) * bk)
            kt_ = torch.zeros((b, h, bk, hd))
            vt_ = torch.zeros((b, h, bk, hd))
            n = min(bk, s - kt * bk)
            kt_[:, :, :n] = kk[:, :, kt * bk:kt * bk + n]
            vt_[:, :, :n] = vv[:, :, kt * bk:kt * bk + n]
            x = qt @ kt_.transpose(-1, -2)
            if softcap:
                x = softcap * torch.tanh(x * scale / softcap) * LOG2E
            else:
                x = x * (scale * LOG2E)
            live = torch.ones((BQ, bk), dtype=torch.bool)
            if causal:
                live &= keys[None, :] <= rows[:, None]
            if window:
                live &= rows[:, None] - keys[None, :] < window
            x = torch.where(live, x, torch.tensor(NEG_INF))
            x = torch.where(keys[None, :] < s, x, torch.tensor(-math.inf))
            m_new = torch.maximum(m, x.amax(dim=-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            m = m_new
            acc = acc * corr[..., None]
            rest = p
            parts = []
            for _ in range(terms):
                part = _bf16(rest)
                parts.append(part)
                rest = rest - part
            for part in reversed(parts):     # lo, mid, hi, as the MMAs run
                acc = acc + part @ vt_
            states[(kt - lo) % 2] = [m, l, acc]
        (m0, l0, acc0), (m1, l1, acc1) = states
        m = torch.maximum(m0, m1)
        f0, f1 = torch.exp2(m0 - m), torch.exp2(m1 - m)
        l = l0 * f0 + l1 * f1
        acc = acc0 * f0[..., None] + acc1 * f1[..., None]
        o = acc / l.clamp(min=1e-30)[..., None]
        out[:, :, q0:q0 + BQ] = o[:, :, :min(BQ, s - q0)]
    return out.to(torch.bfloat16)


def _flash_inputs(b, h, kh, s, hd, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
            .to(torch.bfloat16)
            for shape in ((b, h, s, hd), (b, kh, s, hd), (b, kh, s, hd))]


def _bf16_want(q, k, v, **kw):
    """The bar's reference: the plain version in float32 on the same bf16
    inputs, rounded once to bf16."""
    return tref.ref_flash_attention(q.float(), k.float(), v.float(),
                                    **kw).to(torch.bfloat16)


# small cases of chip_smoke.py's FLASH_SHAPES: (B, H, K, S, hd, window,
# softcap, causal): GQA at the serving head_dim, ragged S, a windowed and
# softcapped case, the other head_dims, Zamba2's hd 80 without GQA, a
# non-causal case, then DeepSeek-Coder-33B's group of 7 and MusicGen-Large's
# MHA at hd 64
FLASH_DESIGN_CASES = [
    (1, 8, 2, 1, 128, 0, 0.0, True),
    (1, 8, 2, 65, 128, 0, 0.0, True),
    (1, 8, 2, 300, 128, 0, 0.0, True),
    (1, 8, 2, 512, 128, 0, 0.0, True),
    (1, 4, 2, 260, 128, 96, 50.0, True),
    (1, 8, 2, 256, 64, 0, 0.0, True),
    (1, 8, 2, 200, 256, 0, 0.0, True),
    (1, 4, 1, 77, 256, 24, 30.0, True),
    (1, 8, 8, 256, 80, 0, 0.0, True),
    (2, 4, 2, 100, 64, 0, 0.0, False),
    (1, 14, 2, 130, 128, 0, 0.0, True),
    (1, 4, 4, 100, 64, 0, 0.0, True),
]


@pytest.mark.parametrize("b,h,kh,s,hd,window,cap,causal",
                         FLASH_DESIGN_CASES)
def test_flash_three_bf16_terms_meet_the_bf16_bar(b, h, kh, s, hd, window,
                                                  cap, causal):
    q, k, v = _flash_inputs(b, h, kh, s, hd, seed=s * hd + h)
    kw = dict(causal=causal, window=window, softcap=cap)
    got = emulate_flash_tc(q, k, v, **kw)
    torch.testing.assert_close(got.float(), _bf16_want(q, k, v, **kw).float(),
                               **BF16_TOL)


def test_flash_one_bf16_term_misses_the_bf16_bar():
    """Why the kernel runs P V three times: at the serving widths P rounded
    once to bf16, as flash kernels usually round it, misses the bar the
    kernel is held to."""
    q, k, v = _flash_inputs(1, 8, 2, 512, 128, seed=7)
    got = emulate_flash_tc(q, k, v, terms=1)
    want = _bf16_want(q, k, v)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


def test_flash_emulation_tracks_float32_within_bf16_rounding():
    """The three-term emulation is the float32 function up to the rounding
    of bf16 outputs: a single ulp of bf16 at most, element by element."""
    q, k, v = _flash_inputs(1, 4, 2, 130, 80, seed=3)
    got = emulate_flash_tc(q, k, v).float()
    exact = tref.ref_flash_attention(q.float(), k.float(), v.float())
    ulp = torch.exp2(torch.floor(torch.log2(exact.abs().clamp(min=1e-30)))
                     - 7)
    assert bool(((got - exact).abs() <= ulp + 1e-6).all())


# ---------------------------------------------------------------------------
# decode attention: partial states per slot range, merged
# ---------------------------------------------------------------------------

def _valid(slot_pos, pos, b, s, window):
    sp = torch.as_tensor(slot_pos).reshape(-1, s).expand(b, s)
    p = torch.as_tensor(pos).reshape(-1).expand(b)[:, None]
    valid = (sp >= 0) & (sp <= p)
    if window:
        valid &= p - sp < window
    return valid


def emulate_decode_split(q, k, v, slot_pos, pos, *, splits, span,
                         softcap=0.0, window=0):
    """The split kernel's arithmetic in float32: each range of ``span``
    slots gives a partial (m, l, acc), empty (NEG_INF, 0, unwritten) when
    no slot of it is valid; invalid slots are never read (the kernel
    zero-fills them); the combine weights each non-empty range by exp(m_s -
    max m) and skips the empty ones; a row with no valid slot at all takes
    the mean of V. q (B,H,hd), k, v (B,K,S,hd)."""
    b, h, hd = q.shape
    s = k.shape[2]
    group = h // k.shape[1]
    valid = _valid(slot_pos, pos, b, s, window)[:, None, :].expand(b, h, s)
    mean_v = v.repeat_interleave(group, dim=1).mean(dim=2)
    kk = torch.where(valid[..., None], k.repeat_interleave(group, dim=1), 0)
    vv = torch.where(valid[..., None], v.repeat_interleave(group, dim=1), 0)
    x = torch.einsum("bhd,bhtd->bht", q, kk) * hd ** -0.5
    if softcap:
        x = softcap * torch.tanh(x / softcap)
    ms, ls, accs = [], [], []
    for i in range(splits):
        t0, t1 = i * span, min(s, (i + 1) * span)
        assert t0 < t1, "empty split"
        xv, ok = x[..., t0:t1], valid[..., t0:t1]
        m = torch.where(ok, xv, torch.tensor(NEG_INF)).amax(dim=-1)
        p = torch.where(ok, torch.exp(xv - m[..., None]), torch.tensor(0.0))
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bht,bhtd->bhd", p, vv[..., t0:t1, :]))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    f = torch.where(l > 0, torch.exp(m - m.amax(dim=0)), torch.tensor(0.0))
    den = (l * f).sum(dim=0)
    num = torch.where(l[..., None] > 0, acc * f[..., None], 0).sum(dim=0)
    return torch.where(den[..., None] > 0,
                       num / den.clamp(min=1e-30)[..., None], mean_v)


def _decode_case(b, h, kh, s, hd, pos_kind, window, seed):
    """q, k, v, slot_pos and pos as the server builds them: per-row
    positions (some early enough to leave whole ranges empty), one scalar
    position, or a ring buffer of s slots under a window."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
               for shape in ((b, h, hd), (b, kh, s, hd), (b, kh, s, hd)))
    idx = torch.arange(s, dtype=torch.int32)
    if pos_kind == "scalar":
        return q, k, v, idx, s // 3
    if pos_kind == "zero":
        return q, k, v, idx, 0
    if pos_kind == "ring":
        pos = torch.from_numpy(rng.integers(s, 4 * s, b).astype(np.int32))
        slot = pos[:, None] - torch.remainder(pos[:, None] - idx, s)
        return q, k, v, slot, pos
    pos = torch.from_numpy(rng.integers(0, s, b).astype(np.int32))
    pos[0] = 5                       # leaves every range past the first empty
    if pos_kind == "none_valid":
        slot = idx.expand(b, s).clone()
        slot[0] = -1                 # row 0 has no valid slot at all
        return q, k, v, slot, pos
    return q, k, v, idx.expand(b, s), pos


# (B, H, K, S, hd, pos, window): G = 4 (Qwen3-4B), 1 (Zamba2's shared
# block) and 8 (two groups of four query heads); S not a multiple of the
# range; ring buffers under a window; scalar pos and pos 0; a row with no
# valid slot; a group of 7 (DeepSeek-Coder-33B: two blocks of 4 and 3
# query heads) and a wrapped ring as long as its window (Gemma2-27B's
# local layers, group 2)
DECODE_DESIGN_CASES = [
    (3, 8, 2, 200, 64, "rows", 0),
    (3, 8, 2, 200, 64, "scalar", 0),
    (2, 8, 2, 96, 128, "zero", 0),
    (2, 8, 2, 64, 128, "ring", 24),
    (3, 4, 4, 150, 80, "rows", 0),
    (2, 16, 2, 230, 64, "rows", 0),
    (2, 16, 2, 230, 64, "ring", 100),
    (3, 8, 2, 200, 64, "none_valid", 0),
    (2, 14, 2, 230, 64, "rows", 0),
    (2, 4, 2, 160, 128, "ring", 160),
]


@pytest.mark.parametrize("b,h,kh,s,hd,pos_kind,window", DECODE_DESIGN_CASES)
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_decode_split_and_combine_match_the_plain_version(
        b, h, kh, s, hd, pos_kind, window, softcap):
    q, k, v, slot, pos = _decode_case(b, h, kh, s, hd, pos_kind, window,
                                      seed=s + h + hd)
    splits, span = tops.decode_splits(b, h, kh, s)
    assert splits > 1
    kw = dict(softcap=softcap, window=window)
    got = emulate_decode_split(q, k, v, slot, pos, splits=splits, span=span,
                               **kw)
    torch.testing.assert_close(
        got, tref.ref_decode_attention(q, k, v, slot, pos, **kw), **TOL)


def test_decode_split_keeps_ranges_with_no_valid_slot_out():
    """pos = 5 leaves every range but the first empty: the merge gives the
    one-range answer, whatever the other ranges' slots hold."""
    q, k, v, slot, pos = _decode_case(1, 4, 1, 160, 64, "rows", 0, seed=1)
    splits, span = tops.decode_splits(1, 4, 1, 160)
    assert (splits, span) == (5, 32)
    k_junk, v_junk = k.clone(), v.clone()
    k_junk[:, :, span:] = 1e30
    v_junk[:, :, span:] = float("nan")
    got = emulate_decode_split(q, k_junk, v_junk, slot, pos, splits=splits,
                               span=span)
    torch.testing.assert_close(
        got, tref.ref_decode_attention(q, k, v, slot, pos), **TOL)


# ---------------------------------------------------------------------------
# the split rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("blocks", [1, 8, 64, 100, 256, 264, 512])
@pytest.mark.parametrize("slots", [1, 31, 32, 33, 320, 576, 1000, 4096])
def test_decode_splits_cover_the_cache_and_fill_the_card(blocks, slots):
    # one query head per KV head: ``blocks`` rows give ``blocks`` blocks
    splits, span = tops.decode_splits(blocks, 1, 1, slots)
    assert span % 32 == 0 and splits >= 1
    assert (splits - 1) * span < slots <= splits * span   # none empty
    pieces = -(-slots // 32)
    if pieces * blocks >= 264:
        assert splits * blocks >= 264
    else:
        assert (splits, span) == (pieces, 32)


def test_decode_splits_at_the_serving_shapes():
    # Qwen3-4B: 8 rows x 8 KV heads, 576 slots; Zamba2's shared block: 8
    # rows x 32 KV heads, 320 slots; a ring of 32 slots
    assert tops.decode_splits(8, 32, 8, 576) == (6, 96)
    assert tops.decode_splits(8, 32, 32, 320) == (2, 160)
    assert tops.decode_splits(8, 32, 8, 32) == (1, 32)
    # G = 8 takes two blocks per (row, KV head), as twice the rows do
    assert tops.decode_splits(8, 64, 8, 576) \
        == tops.decode_splits(16, 32, 8, 576) == (3, 192)


def test_decode_splits_at_the_family_shapes():
    # Gemma2-27B's local ring (8 rows x 16 KV heads, 4,096 slots) and
    # global layer, Mixtral-8x7B's ring, DeepSeek-Coder-33B's group of 7
    # (two blocks per (row, KV head), as G = 8) and MusicGen-Large's MHA
    assert tops.decode_splits(8, 32, 16, 4096) == (4, 1344)
    assert tops.decode_splits(8, 32, 16, 576) == (3, 192)
    assert tops.decode_splits(8, 32, 8, 4096) == (6, 800)
    assert tops.decode_splits(8, 56, 8, 576) \
        == tops.decode_splits(8, 64, 8, 576) == (3, 192)
    assert tops.decode_splits(8, 32, 32, 576) == (2, 288)
