"""The arithmetic of the SSD chunk kernel's design (``csrc/ssd_chunk.cu``),
emulated in plain PyTorch on the CPU, so that a fault of precision shows
here before it shows on the card.

The kernel runs its four products on the tensor cores in TF32: every
float32 operand x is split into big = rna(x) and small = rna(x - big),
where rna rounds to TF32's 10-bit mantissa, to nearest with ties away from
zero (``cvt.rna.tf32.f32``), and each product is three MMAs, big.big +
big.small + small.big, summed in float32 ("3xTF32"). The scores C B^T are
weighted by exp(acs_l - acs_s) in float32 and split after weighting, as
they enter S X. The emulation is held to ``ssd_tolerance``, the bar
``chip_smoke.py`` and ``tests/test_torch_ssd_gpu.py`` hold the kernel to,
at the serving shape and the reference's sweep; one TF32 term misses it.

The emulation lives here; nothing on the port's path calls it."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as tref

torch.set_num_threads(1)


def rna_tf32(x):
    """float32 values rounded to TF32 (10-bit mantissa), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` rounds: add half of the
    last kept bit to the magnitude's bits and clear the 13 dropped bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x):
    big = rna_tf32(x)
    return big, rna_tf32(x - big)


def mm_tf32(a, b, terms=3):
    """a @ b (float32, batched) as the kernel's MMAs compute it: three TF32
    terms, the small ones first, or one (big.big) with ``terms=1``."""
    a_big, a_small = split_tf32(a)
    b_big, b_small = split_tf32(b)
    if terms == 1:
        return a_big @ b_big
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def emulate_ssd_tf32(c, b, x, da, h, terms=3):
    """The kernel's arithmetic in the reference's layout: c, b (BH,L,N); x
    (BH,L,P); da (BH,L,1); h (BH,P,N), float32. Returns y, h_new."""
    length = c.shape[1]
    acs = torch.cumsum(da[..., 0], dim=-1)                    # (BH, L)
    y = mm_tf32(c, h.transpose(1, 2), terms) * torch.exp(acs)[..., None]
    live = torch.tril(torch.ones((length, length), dtype=torch.bool))
    # exp only where the exponent is <= 0: above the diagonal it is never
    # computed, so it cannot overflow
    seg = torch.where(live, acs[:, :, None] - acs[:, None, :], 0.0)
    weights = torch.where(live, torch.exp(seg), 0.0)
    scores = mm_tf32(c, b.transpose(1, 2), terms) * weights
    y = y + mm_tf32(scores, x, terms)
    w_last = torch.exp(acs[:, -1:] - acs)                     # (BH, L)
    h_new = h * torch.exp(acs[:, -1])[:, None, None] + mm_tf32(
        x.transpose(1, 2), b * w_last[..., None], terms)
    return y, h_new


def _inputs(slices, length, n, p, decay, seed):
    """chip_smoke.py's draws: normal c, b, x, h; da = -U(0, decay)."""
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(0, 1, (slices, length, n)),
              rng.normal(0, 1, (slices, length, n)),
              rng.normal(0, 1, (slices, length, p)),
              -decay * rng.random((slices, length, 1)),
              rng.normal(0, 1, (slices, p, n)))
    return [torch.from_numpy(a.astype(np.float32)) for a in arrays]


def _misses(got, args):
    """For y and h_new: how far the worst element lies past the bar
    (``ssd_tolerance`` against the float32 plain version, given the plain
    version in float64); <= 0 inside it."""
    want = tref.ref_ssd_chunk(*args)
    exact = tref.ref_ssd_chunk(*(a.double() for a in args))
    out = []
    for g, w, e in zip(got, want, exact):
        tol = tref.ssd_tolerance(w, e)
        excess = (g - w).abs() - tol["rtol"] * w.abs()
        out.append(float(excess.max()) - tol["atol"])
    return out


# (slices, L, N, P, decay): a Zamba2-2.7B admission of a whole chunk (80
# heads, N = P = 64, decay 0.55 takes acs to about -70), ragged
# admissions, one token, the reference's sweep (tests/test_kernels.py),
# a state size whose k-tail the kernel zero-fills (N = 36), and decays
# that underflow to exactly 0
SSD_DESIGN_CASES = [(80, 256, 64, 64, 0.55), (80, 255, 64, 64, 0.55),
                    (80, 37, 64, 64, 0.55), (80, 1, 64, 64, 0.55),
                    (4, 64, 32, 32, 0.1), (2, 128, 64, 64, 0.1),
                    (1, 128, 128, 64, 0.1), (3, 96, 64, 32, 0.1),
                    (4, 100, 36, 16, 0.1), (2, 200, 64, 64, 2.0)]


@pytest.mark.parametrize("slices,length,n,p,decay", SSD_DESIGN_CASES)
def test_ssd_three_tf32_terms_meet_the_bar(slices, length, n, p, decay):
    args = _inputs(slices, length, n, p, decay, seed=length * 7 + n)
    got = emulate_ssd_tf32(*args)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    y_miss, h_miss = _misses(got, args)
    assert y_miss <= 0 and h_miss <= 0, (y_miss, h_miss)


def test_ssd_one_tf32_term_misses_the_bar():
    """Why every product is three MMAs: at the serving shape one TF32 term
    per product, as TF32 kernels usually run, misses the bar on y and on
    h_new."""
    args = _inputs(80, 256, 64, 64, 0.55, seed=256 * 7 + 64)
    y_miss, h_miss = _misses(emulate_ssd_tf32(*args, terms=1), args)
    assert y_miss > 0 and h_miss > 0, (y_miss, h_miss)


def test_rna_tf32_rounds_to_nearest_ties_away():
    """The rounding the kernel's split uses: 10 mantissa bits kept, ties
    away from zero in both signs, zero and powers of two unchanged."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + ulp / 2 - 2.0 ** -23,
                      -(1.0 + ulp / 2), 1.0 + 1.5 * ulp, 0.0, -0.0, 2.0 ** -20,
                      3.0 * 2.0 ** 100], dtype=torch.float32)
    want = [1.0, 1.0 + ulp, 1.0, -(1.0 + ulp), 1.0 + 2 * ulp, 0.0, -0.0,
            2.0 ** -20, 3.0 * 2.0 ** 100]
    assert rna_tf32(x).tolist() == want
    big, small = split_tf32(torch.tensor([1.0 + 2.0 ** -12 + 2.0 ** -22]))
    assert big.item() == 1.0 and small.item() == 2.0 ** -12 + 2.0 ** -22
