"""Mamba2 in the PyTorch port against the JAX reference: the plain version
of the SSD chunk kernel against the JAX oracle (``repro.kernels.ref``) and
the Pallas kernel in interpret mode, in the reference's layout and the
model's; ``mamba_apply`` in both impls, ``mamba_decode`` and state
continuation against ``repro.models.mamba``; and the record of JAX outputs
that the CUDA kernel is held against on the GPU."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import mamba as JM
from repro.models.common import split_params
from repro_torch.configs import get_reduced_config
from repro_torch.convert import lm_state_dict_from_jax
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import mamba as TM

# The suite runs several test processes side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

SSD_TOL = dict(rtol=3e-5, atol=3e-5)    # tests/test_kernels.py's bar
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_attn_impl.py's bar


def ssd_tol(want, args):
    """tests/test_kernels.py's 3e-5, widened by ``want``'s own float32
    error (``ssd_tolerance`` says why and by how much) against the plain
    version in float64 on the same numpy ``args``."""
    exact = tref.ref_ssd_chunk(*(torch.from_numpy(a).double() for a in args))
    return [tref.ssd_tolerance(np.asarray(w), e.numpy())
            for w, e in zip(want, exact)]


def _ssd_inputs(rng, bh, l, n, p, decay=0.1):
    """The JAX sweep's draws: da = -U(0, decay) per position, non-zero
    h_prev."""
    return (rng.normal(0, 1, (bh, l, n)).astype(np.float32),
            rng.normal(0, 1, (bh, l, n)).astype(np.float32),
            rng.normal(0, 1, (bh, l, p)).astype(np.float32),
            (-rng.random((bh, l, 1)) * decay).astype(np.float32),
            rng.normal(0, 1, (bh, p, n)).astype(np.float32))


# tests/test_kernels.py's sweep (bh, L, N, P), then the lengths a serving
# admission gives a chunk: one token, an odd length, a whole 256 chunk;
# the last with decay up to 1 per step, so exp(segsum) underflows to 0
SSD_CASES = [(4, 64, 32, 32, 0.1), (2, 128, 64, 64, 0.1),
             (1, 128, 128, 64, 0.1), (3, 96, 64, 32, 0.1),
             (2, 1, 16, 32, 0.1), (2, 37, 16, 32, 0.1),
             (1, 256, 64, 64, 0.1), (1, 256, 64, 64, 1.0)]


@pytest.mark.parametrize("bh,l,n,p,decay", SSD_CASES)
def test_ssd_plain_matches_jax(bh, l, n, p, decay):
    args = _ssd_inputs(np.random.default_rng(l * 7 + n), bh, l, n, p, decay)
    y, h_new = tops.ssd_chunk(*map(torch.from_numpy, args))
    assert y.shape == (bh, l, p) and h_new.shape == (bh, p, n)
    assert torch.isfinite(y).all() and torch.isfinite(h_new).all()
    jargs = list(map(jnp.asarray, args))
    for want in (jref.ref_ssd_chunk(*jargs), jops.ssd_chunk(*jargs)):
        tol_y, tol_h = ssd_tol(want, args)
        np.testing.assert_allclose(y.numpy(), want[0], **tol_y)
        np.testing.assert_allclose(h_new.numpy(), want[1], **tol_h)


def test_ssd_heads_layout_matches_the_reference_repeat():
    """The model's layout (one B/C group per batch row, (B,L,H,P) x) gives
    what the reference computes after repeating the group per head and
    flattening the heads, as ``mamba_apply`` does before its kernel."""
    rng = np.random.default_rng(5)
    b, l, h, n, p = 2, 21, 3, 16, 32
    c = rng.normal(0, 1, (b, l, n)).astype(np.float32)
    bm = rng.normal(0, 1, (b, l, n)).astype(np.float32)
    x = rng.normal(0, 1, (b, l, h, p)).astype(np.float32)
    da = (-rng.random((b, l, h)) * 0.1).astype(np.float32)
    hp = rng.normal(0, 1, (b, h, p, n)).astype(np.float32)
    y, h_new = tops.ssd_chunk(*map(torch.from_numpy, (c, bm, x, da, hp)))
    assert y.shape == (b, l, h, p) and h_new.shape == (b, h, p, n)
    want_y, want_h = jref.ref_ssd_chunk(
        jnp.repeat(c[:, None], h, 1).reshape(b * h, l, n),
        jnp.repeat(bm[:, None], h, 1).reshape(b * h, l, n),
        x.transpose(0, 2, 1, 3).reshape(b * h, l, p),
        da.transpose(0, 2, 1).reshape(b * h, l, 1), hp.reshape(b * h, p, n))
    np.testing.assert_allclose(
        y.numpy(), np.asarray(want_y).reshape(b, h, l, p).transpose(0, 2, 1,
                                                                     3),
        **SSD_TOL)
    np.testing.assert_allclose(h_new.numpy(),
                               np.asarray(want_h).reshape(b, h, p, n),
                               **SSD_TOL)


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

def _setup(**over):
    jcfg = dataclasses.replace(jax_reduced_config("zamba2-2.7b"), **over)
    tcfg = dataclasses.replace(get_reduced_config("zamba2-2.7b"), **over)
    jparams = split_params(JM.mamba_init(jax.random.PRNGKey(0), jcfg))[0]
    tparams = TM.mamba_init(tcfg, generator=torch.Generator())
    tparams.load_state_dict(lm_state_dict_from_jax(jparams), strict=True)
    return jcfg, tcfg, jparams, tparams


def _x(cfg, b, s, seed):
    return (0.5 * np.random.default_rng(seed).normal(
        0, 1, (b, s, cfg.d_model))).astype(np.float32)


# (S, ssm_chunk): one whole chunk; five chunks with the state carried
# between them; a sequence shorter than the chunk (L = S)
APPLY_CASES = [(16, 16), (40, 8), (5, 16)]


@pytest.mark.parametrize("return_state", [True, False])
@pytest.mark.parametrize("impl", ["xla", "kernel"])
@pytest.mark.parametrize("s,chunk", APPLY_CASES)
def test_mamba_apply_matches_jax(s, chunk, impl, return_state):
    jcfg, tcfg, jparams, tparams = _setup(ssm_chunk=chunk)
    x = _x(tcfg, 2, s, seed=s)
    want, jst = JM.mamba_apply(jparams, jnp.asarray(x), jcfg,
                               return_state=return_state, impl=impl)
    with torch.no_grad():
        got, tst = TM.mamba_apply(tparams, torch.from_numpy(x), tcfg,
                                  return_state=return_state, impl=impl)
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)
    if not return_state:
        assert tst is None and jst is None
        return
    for leaf in ("conv", "ssm"):
        assert tst[leaf].dtype == torch.float32
        np.testing.assert_allclose(tst[leaf].numpy(), jst[leaf],
                                   **MODEL_TOL, err_msg=leaf)


def test_mamba_decode_matches_jax():
    """A 16-token prefill then 6 one-token steps, each against the
    reference's ``mamba_decode`` from the same state."""
    jcfg, tcfg, jparams, tparams = _setup()
    x = _x(tcfg, 2, 22, seed=3)
    _, jst = JM.mamba_apply(jparams, jnp.asarray(x[:, :16]), jcfg,
                            return_state=True)
    cache = TM.mamba_cache_init(tcfg, 2, torch.float32)
    with torch.no_grad():
        _, tst = TM.mamba_apply(tparams, torch.from_numpy(x[:, :16]), tcfg,
                                return_state=True)
        for leaf in cache:
            cache[leaf].copy_(tst[leaf])
        for t in range(16, 22):
            want, jst = JM.mamba_decode(jparams, jnp.asarray(x[:, t:t + 1]),
                                        jst, jcfg)
            got, same = TM.mamba_decode(tparams,
                                        torch.from_numpy(x[:, t:t + 1]),
                                        cache, tcfg)
            assert same is cache                       # written in place
            np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)
            for leaf in cache:
                np.testing.assert_allclose(cache[leaf].numpy(), jst[leaf],
                                           **MODEL_TOL, err_msg=leaf)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_mamba_chunked_matches_sequential(impl):
    """tests/test_recurrent.py's check inside the port: the chunked form
    (four chunks of 8) against 32 one-token decode steps."""
    _, tcfg, _, tparams = _setup(ssm_chunk=8)
    x = torch.from_numpy(_x(tcfg, 2, 32, seed=1))
    with torch.no_grad():
        y_chunk, st = TM.mamba_apply(tparams, x, tcfg, return_state=True,
                                     impl=impl)
        cache = TM.mamba_cache_init(tcfg, 2, x.dtype)
        y_seq = torch.cat([TM.mamba_decode(tparams, x[:, t:t + 1], cache,
                                           tcfg)[0] for t in range(32)], 1)
    torch.testing.assert_close(y_chunk, y_seq, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(st["ssm"], cache["ssm"], rtol=2e-4,
                               atol=2e-4)
    torch.testing.assert_close(st["conv"], cache["conv"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_mamba_state_continuation(impl):
    """tests/test_recurrent.py's check inside the port: apply(x1), then
    apply(x2, state) equals apply(x1 ++ x2); against JAX too."""
    jcfg, tcfg, jparams, tparams = _setup(ssm_chunk=8)
    x = _x(tcfg, 1, 32, seed=7)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        y_full, _ = TM.mamba_apply(tparams, xt, tcfg, impl=impl)
        y1, st = TM.mamba_apply(tparams, xt[:, :16], tcfg, return_state=True,
                                impl=impl)
        y2, _ = TM.mamba_apply(tparams, xt[:, 16:], tcfg, state=st,
                               impl=impl)
    torch.testing.assert_close(y_full, torch.cat([y1, y2], 1), rtol=2e-4,
                               atol=2e-4)
    _, jst = JM.mamba_apply(jparams, jnp.asarray(x[:, :16]), jcfg,
                            return_state=True, impl=impl)
    want, _ = JM.mamba_apply(jparams, jnp.asarray(x[:, 16:]), jcfg,
                             state=jst, impl=impl)
    np.testing.assert_allclose(y2.numpy(), want, **MODEL_TOL)


def test_unsupported_length_raises_like_the_reference():
    """A sequence longer than one chunk and not a multiple of it: the
    reference asserts, the port raises (the serving contract both keep)."""
    jcfg, tcfg, jparams, tparams = _setup()
    x = _x(tcfg, 1, 40, seed=0)
    with pytest.raises(AssertionError):
        JM.mamba_apply(jparams, jnp.asarray(x), jcfg)
    with pytest.raises(ValueError, match="chunk"):
        TM.mamba_apply(tparams, torch.from_numpy(x), tcfg)


def test_ssd_wrapper_refuses_non_cpu_non_cuda_tensors():
    args = [torch.empty(s, device="meta") for s in
            [(2, 8, 16), (2, 8, 16), (2, 8, 32), (2, 8, 1), (2, 32, 16)]]
    with pytest.raises(ValueError, match="CUDA"):
        tops.ssd_chunk(*args)


# ---------------------------------------------------------------------------
# The JAX reference's outputs on seeded inputs, recorded so that the CUDA
# kernel can be held against JAX on a machine without JAX
# (tests/test_torch_ssd_gpu.py). Rewrite the record with
#     PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_mamba.py
# ---------------------------------------------------------------------------

JAX_RECORD = Path(__file__).with_name("test_torch_ssd_jax.npz")
# name: (bh, L, N, P, decay)
SSD_RECORD = {"ssd_one_token": (3, 1, 16, 32, 0.1),
              "ssd_ragged": (3, 37, 16, 32, 0.1),
              "ssd_three_tiles": (1, 150, 16, 32, 0.1),
              "ssd_underflow": (1, 130, 8, 16, 2.0)}
SSD_INPUTS = ("c", "b", "xdt", "da", "h_prev")


def jax_record():
    """Seeded inputs and the JAX oracle's outputs, keyed
    ``"<case>/<name>"``."""
    out = {}
    for name, (bh, l, n, p, decay) in SSD_RECORD.items():
        args = _ssd_inputs(np.random.default_rng(l + n), bh, l, n, p, decay)
        y, h_new = jref.ref_ssd_chunk(*map(jnp.asarray, args))
        out.update({f"{name}/{k}": v for k, v in zip(SSD_INPUTS, args)})
        out.update({f"{name}/y": np.asarray(y),
                    f"{name}/h_new": np.asarray(h_new)})
    return out


def test_jax_record_is_current():
    """The recorded inputs are the seeded ones and the recorded outputs are
    what JAX computes from them now (1e-6); the port's plain version
    agrees with the record at the SSD bar."""
    fresh = jax_record()
    with np.load(JAX_RECORD) as rec:
        assert set(rec.files) == set(fresh)
        for key, want in fresh.items():
            np.testing.assert_allclose(rec[key], want, rtol=1e-6, atol=1e-6,
                                       err_msg=key)
        for name in SSD_RECORD:
            args = [rec[f"{name}/{k}"] for k in SSD_INPUTS]
            want = rec[f"{name}/y"], rec[f"{name}/h_new"]
            got = tref.ref_ssd_chunk(*map(torch.from_numpy, args))
            for g, w, tol in zip(got, want, ssd_tol(want, args)):
                np.testing.assert_allclose(g.numpy(), w, **tol)


if __name__ == "__main__":
    record = jax_record()
    np.savez_compressed(JAX_RECORD, **record)
    print(f"wrote {JAX_RECORD} ({len(record)} arrays, "
          f"{JAX_RECORD.stat().st_size} bytes)")
