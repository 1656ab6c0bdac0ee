"""The order of operations of the V-trace kernel's design
(``csrc/vtrace.cu``), emulated in plain PyTorch float32 on the CPU, so that
a fault of precision shows here before it shows on the card.

The kernel is a chunked scan over T. With (W, L) from
``ops.vtrace_chunks``, each warp owns a chunk of L rows of a segment of
W L rows, and composes its chunk's affine map acc_start = Bc + A acc_after
(A = prod dc_t), last row first. The maps of a segment are combined from
the last chunk back to give each chunk its carry-in, segments are walked
from the last, and each chunk then walks its rows again from its carry; at
a chunk's last row, vs_{t+1} is values_{t+1} + carry. That reassociates
the products of dc = discount * c against the plain version's serial
order. The emulation is held to ``chip_smoke.py``'s VTRACE_TOL, the bar the
kernel is held to on the card, against V-trace in float64 and against the
JAX kernel ``vtrace_scan`` (interpret mode), on ``chip_smoke.py``'s inputs.

The emulation lives here; nothing on the port's path calls it."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import VTRACE_SHAPES, VTRACE_TOL, vtrace_inputs  # noqa: E402

torch.set_num_threads(1)

# chip_smoke.py's VTRACE_SHAPES (at its seeds), then a T that spans four
# segments, a T that is no multiple of its L (37: L 4), and T = 1 at a
# wider B
SHAPES = VTRACE_SHAPES + [(1000, 32), (37, 5), (1, 64)]
# Unclipped at T = 200, products of up to 200 unclipped rhos take vs to
# about 1e8 on these draws, and float32 itself cannot hold VTRACE_TOL there:
# the plain version's serial order (the JAX kernel's) misses it against
# float64 too. test_unclipped_t200_is_beyond_float32 pins that and holds the
# chunked order to the plain version's own error instead.
BEYOND_FLOAT32 = [(200, 4096), (200, 16384)]
CASES = [(t, b, clip) for t, b in SHAPES for clip in (1.0, None)
         if clip is not None or (t, b) not in BEYOND_FLOAT32]


def _clip(threshold, x):
    return x if threshold is None else np.minimum(threshold, x)


def vtrace_float64(log_rhos, discounts, rewards, values, bootstrap, clip):
    """The plain version's V-trace, serial over T, in float64."""
    log_rhos, discounts, rewards, values, bootstrap = (
        x.astype(np.float64)
        for x in (log_rhos, discounts, rewards, values, bootstrap))
    rhos = np.exp(log_rhos)
    values_tp1 = np.concatenate([values[1:], bootstrap[None]], 0)
    deltas = _clip(clip, rhos) * (rewards + discounts * values_tp1 - values)
    dcs = discounts * _clip(clip, rhos)
    acc = np.zeros_like(bootstrap)
    vs = np.empty_like(values)
    for t in range(values.shape[0] - 1, -1, -1):
        acc = deltas[t] + dcs[t] * acc
        vs[t] = values[t] + acc
    vs_tp1 = np.concatenate([vs[1:], bootstrap[None]], 0)
    return vs, _clip(clip, rhos) * (rewards + discounts * vs_tp1 - values)


def emulate_chunked(log_rhos, discounts, rewards, values, bootstrap, clip):
    """The kernel's arithmetic in float32 (torch tensors in, (vs, pg) out):
    chunk maps, carries over the chunks of each segment from the last,
    segments from the last, then each chunk's rows again from its carry."""
    t, b = values.shape
    warps, rows = tops.vtrace_chunks(t)
    segments = -(-t // (warps * rows))
    pad = segments * warps * rows - t
    live = torch.arange(t + pad) < t

    def padded(x, fill):
        return torch.cat([x, torch.full((pad, b), fill)], 0)

    # rows past T read values as the bootstrap and take the identity map
    val = torch.cat([values, bootstrap.expand(pad + 1, b)], 0)
    rho = torch.exp(padded(log_rhos, 0.0))
    disc, rew = padded(discounts, 0.0), padded(rewards, 0.0)
    inf = torch.tensor(float("inf"))
    clip_t = inf if clip is None else torch.tensor(clip)
    delta = torch.minimum(clip_t, rho) * (rew + disc * val[1:] - val[:-1])
    dc = disc * torch.minimum(clip_t, rho)
    delta = torch.where(live[:, None], delta, 0.0)
    dc = torch.where(live[:, None], dc, 1.0)

    shape = (segments, warps, rows, b)
    delta, dc = delta.reshape(shape), dc.reshape(shape)
    ca, cb = torch.ones(shape[:2] + (b,)), torch.zeros(shape[:2] + (b,))
    for i in range(rows - 1, -1, -1):
        cb = delta[:, :, i] + dc[:, :, i] * cb
        ca = dc[:, :, i] * ca

    acc_out = torch.empty(shape)
    carry = torch.empty(shape[:2] + (b,))
    seg_carry = torch.zeros(b)
    for s in range(segments - 1, -1, -1):
        x = seg_carry
        for w in range(warps - 1, -1, -1):
            carry[s, w] = x
            x = cb[s, w] + ca[s, w] * x
        seg_carry = x
        acc = carry[s]
        for i in range(rows - 1, -1, -1):
            acc = delta[s, :, i] + dc[s, :, i] * acc
            acc_out[s, :, i] = acc

    vs = (val[:-1] + acc_out.reshape(-1, b))[:t]
    # vs_{t+1}: the next row's vs inside a chunk; at a chunk's last row,
    # values after the chunk plus the carry
    vs_next = torch.cat([vs[1:], bootstrap[None]], 0)
    ends = torch.arange(rows - 1, t + pad, rows)
    chunk_next = (val[ends + 1].reshape(segments, warps, b) + carry)
    vs_next_pad = padded(vs_next, 0.0)
    vs_next_pad[ends] = chunk_next.reshape(-1, b)
    vs_next = vs_next_pad[:t]
    pg = torch.minimum(clip_t, rho[:t]) * (rewards + discounts * vs_next
                                           - values)
    return vs, pg


def jax_vtrace_kernel(args, clip):
    """The JAX kernel wrapper (Pallas ``vtrace_scan``, interpret mode here),
    float32. Its lane block is 128 wide, so a B above 128 that is no
    multiple of it is padded with zero columns, which are then dropped; an
    unclipped case passes inf thresholds (the wrapper takes no None)."""
    t, b = args[3].shape
    pad = (-b) % 128 if b > 128 else 0
    jargs = [jnp.asarray(np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)]))
             for a in args]
    c = np.inf if clip is None else clip
    out = jops.vtrace_from_importance_weights_kernel(
        *jargs, clip_rho_threshold=c, clip_c_threshold=c,
        clip_pg_rho_threshold=c)
    return [np.asarray(x)[:, :b] for x in out]


def _assert_close(got, want, what):
    for name, g, w in zip(("vs", "pg_advantages"), got, want):
        np.testing.assert_allclose(g, w, rtol=VTRACE_TOL, atol=VTRACE_TOL,
                                   err_msg=f"{name} against {what}")


def _emulated(t, b, clip):
    """chip_smoke.py's inputs for (t, b) (its seeds for its shapes), and
    the emulated kernel's (vs, pg) on them as numpy."""
    args = [x.numpy() for x in vtrace_inputs(
        t, b, seed=1000 + SHAPES.index((t, b)), device="cpu")]
    got = [x.numpy() for x in emulate_chunked(
        *map(torch.from_numpy, args), clip)]
    assert all(np.isfinite(g).all() for g in got)
    return args, got


@pytest.mark.parametrize(
    "t,b,clip", CASES,
    ids=[f"{t}x{b}-{'clip1' if c else 'unclipped'}" for t, b, c in CASES])
def test_chunked_scan_meets_the_kernel_bar(t, b, clip):
    """The kernel's order of operations against float64 V-trace and the
    JAX kernel, within VTRACE_TOL, clipped at 1.0 and unclipped."""
    args, got = _emulated(t, b, clip)
    _assert_close(got, vtrace_float64(*args, clip), "float64 V-trace")
    _assert_close(got, jax_vtrace_kernel(args, clip), "the JAX kernel")


@pytest.mark.parametrize("t,b", BEYOND_FLOAT32,
                         ids=[f"{t}x{b}" for t, b in BEYOND_FLOAT32])
def test_unclipped_t200_is_beyond_float32(t, b):
    """Unclipped at T = 200 the values reach 1e7 and more, and the plain
    version in float32 (serial, as the JAX kernel) misses VTRACE_TOL
    against float64. There the chunked order is held as two float32 orders
    are held in ``kernels.ref.ssd_tolerance``: its worst error against
    float64 at most four times the plain version's."""
    args, got = _emulated(t, b, None)
    exact = vtrace_float64(*args, None)
    plain = [x.numpy() for x in tref.ref_vtrace_from_importance_weights(
        *map(torch.from_numpy, args), clip_rho_threshold=None,
        clip_c_threshold=None, clip_pg_rho_threshold=None)]
    assert np.abs(exact[0]).max() > 1e7
    assert not all(np.allclose(p, e, rtol=VTRACE_TOL, atol=VTRACE_TOL)
                   for p, e in zip(plain, exact))
    for g, p, e in zip(got, plain, exact):
        assert np.abs(g - e).max() <= 4 * np.abs(p - e).max()


@pytest.mark.parametrize("t", [1, 2, 15, 16, 17, 20, 33, 37, 80, 127, 128,
                               129, 200, 255, 256, 257, 511, 1000])
def test_chunk_rule_covers_t_within_the_kernel_limits(t):
    """(W, L) within the kernel's limits (W <= 16; L a power of two <= 16,
    one of its template instances); one segment covers T up to 256 with no
    chunk left empty; a longer T takes full segments of 256 rows."""
    warps, rows = tops.vtrace_chunks(t)
    assert 1 <= warps <= 16 and rows in (1, 2, 4, 8, 16)
    if t <= 256:
        assert warps * rows >= t > (warps - 1) * rows
        assert rows == 1 or 16 * (rows // 2) < t
    else:
        assert (warps, rows) == (16, 16)


def test_chunk_rule_at_the_main_path_shapes():
    """The learner's T = 80 and the trainer's T = 20 fit one segment in ten
    warps; T = 200 takes chunks of 16 rows."""
    assert tops.vtrace_chunks(80) == (10, 8)
    assert tops.vtrace_chunks(20) == (10, 2)
    assert tops.vtrace_chunks(200) == (13, 16)
