"""V-trace in the PyTorch port against the JAX reference: the plain
recurrence, the whole V-trace computation through the kernel wrapper and
the plain loop, clipping, gradients, the wrapper's refusals, and the
record of JAX outputs that the CUDA kernel is held against on the GPU."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import vtrace as jvtrace
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import vtrace as tvtrace
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# The suite runs several test processes side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)


def _vtrace_args(rng, t, b):
    return (rng.normal(0, 1, (t, b)).astype(np.float32),
            ((rng.random((t, b)) > 0.2) * 0.97).astype(np.float32),
            rng.normal(0, 1, (t, b)).astype(np.float32),
            rng.normal(0, 1, (t, b)).astype(np.float32),
            rng.normal(0, 1, (b,)).astype(np.float32))


def _clips(clip):
    return dict(clip_rho_threshold=clip, clip_c_threshold=clip,
                clip_pg_rho_threshold=clip)


# the JAX kernel sweep's shapes (tests/test_kernels.py), at its 1e-6
@pytest.mark.parametrize("t,b", [(1, 128), (80, 256), (33, 384), (200, 128)])
def test_ref_scan_matches_jax_kernel_and_ref(t, b):
    rng = np.random.default_rng(t * 1000 + b)
    deltas = rng.normal(0, 1, (t, b)).astype(np.float32)
    dcs = (rng.random((t, b)) * 0.99).astype(np.float32)
    got = tref.ref_vtrace_scan(torch.from_numpy(deltas),
                               torch.from_numpy(dcs)).numpy()
    jax_kernel = jops.vtrace_acc(jnp.asarray(deltas), jnp.asarray(dcs))
    jax_ref = jref.ref_vtrace_scan(jnp.asarray(deltas), jnp.asarray(dcs))
    np.testing.assert_allclose(got, jax_kernel, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, jax_ref, rtol=1e-6, atol=1e-6)


# ragged B: the Pallas kernel asserts B divisible by its lane block, so
# these are held against the JAX scan only (the bar of tests/test_vtrace.py)
@pytest.mark.parametrize("t,b", [(80, 33), (20, 200)])
@pytest.mark.parametrize("impl", ["kernel", "scan"])
def test_ragged_shapes_match_jax_scan(t, b, impl):
    args = _vtrace_args(np.random.default_rng(t + b), t, b)
    fn = (tops.vtrace_from_importance_weights_kernel if impl == "kernel"
          else tvtrace.vtrace_from_importance_weights)
    got = fn(*map(torch.from_numpy, args))
    want = jvtrace.vtrace_from_importance_weights(*map(jnp.asarray, args))
    np.testing.assert_allclose(got.vs.numpy(), want.vs, rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got.pg_advantages.numpy(),
                               want.pg_advantages, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("clip", [1.0, 0.5, None])
@pytest.mark.parametrize("impl", ["kernel", "scan"])
def test_full_vtrace_matches_jax(clip, impl):
    """The port's whole V-trace against the JAX kernel wrapper and the JAX
    scan at 2e-5 (tests/test_vtrace.py:45). The JAX kernel wrapper takes
    no None thresholds, so the unclipped case is held to the scan only."""
    args = _vtrace_args(np.random.default_rng(7), 23, 64)
    args = (args[0] * 3.0,) + args[1:]      # rhos well past the clips
    fn = (tops.vtrace_from_importance_weights_kernel if impl == "kernel"
          else tvtrace.vtrace_from_importance_weights)
    got = fn(*map(torch.from_numpy, args), **_clips(clip))
    jargs = tuple(map(jnp.asarray, args))
    wants = [jvtrace.vtrace_from_importance_weights(*jargs, **_clips(clip))]
    if clip is not None:
        wants.append(jops.vtrace_from_importance_weights_kernel(
            *jargs, **_clips(clip)))
    for want in wants:
        np.testing.assert_allclose(got.vs.numpy(), want.vs, rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(got.pg_advantages.numpy(),
                                   want.pg_advantages, rtol=2e-5, atol=2e-5)


def test_from_logits_matches_jax():
    rng = np.random.default_rng(3)
    t, b, a = 9, 4, 6
    bl = rng.normal(0, 1, (t, b, a)).astype(np.float32)
    tl = rng.normal(0, 1, (t, b, a)).astype(np.float32)
    actions = rng.integers(0, a, (t, b)).astype(np.int32)
    _, disc, rew, val, boot = _vtrace_args(rng, t, b)
    np_args = (bl, tl, actions, disc, rew, val, boot)
    got = tvtrace.vtrace_from_logits(*map(torch.from_numpy, np_args))
    want = jvtrace.vtrace_from_logits(*map(jnp.asarray, np_args))
    np.testing.assert_allclose(got.vs.numpy(), want.vs, rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got.pg_advantages.numpy(),
                               want.pg_advantages, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("impl", ["kernel", "scan"])
def test_outputs_carry_no_gradient(impl):
    args = [torch.from_numpy(x) for x in
            _vtrace_args(np.random.default_rng(5), 5, 3)]
    args[3].requires_grad_(True)
    fn = (tops.vtrace_from_importance_weights_kernel if impl == "kernel"
          else tvtrace.vtrace_from_importance_weights)
    out = fn(*args)
    assert not out.vs.requires_grad
    assert not out.pg_advantages.requires_grad


def test_wrapper_refuses_non_cpu_non_cuda_tensors():
    """Only CPU tensors take the plain version; any other device must
    launch the kernel or raise — here a meta tensor raises."""
    args = [torch.empty((4, 3), device="meta") for _ in range(4)]
    args.append(torch.empty((3,), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        tops.vtrace_from_importance_weights_kernel(*args)


def test_missing_nvcc_is_an_error(tmp_path, monkeypatch):
    """A kernel that cannot be built raises; nothing falls back."""
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tbuild, "nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc"):
        tbuild.build("vtrace")


# The JAX V-trace's outputs on seeded inputs, recorded so that the CUDA
# kernel can be held against JAX on a machine without JAX
# (tests/test_torch_vtrace_gpu.py). Rewrite the record with
#     PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_vtrace.py
JAX_RECORD = Path(__file__).with_name("test_torch_vtrace_jax.npz")
RECORD_CASES = [(80, 32, 1.0), (20, 200, None), (1, 1, 1.0)]
INPUTS = ("log_rhos", "discounts", "rewards", "values", "bootstrap_value")


def jax_record(t, b, clip):
    """Seeded inputs, the clip (inf for none) and the JAX V-trace outputs of
    one recorded case, keyed ``"{t}x{b}/<name>"``."""
    args = _vtrace_args(np.random.default_rng(t * b), t, b)
    want = jvtrace.vtrace_from_importance_weights(*map(jnp.asarray, args),
                                                  **_clips(clip))
    key = f"{t}x{b}"
    out = {f"{key}/{name}": a for name, a in zip(INPUTS, args)}
    out[f"{key}/clip"] = np.float32(np.inf if clip is None else clip)
    out[f"{key}/vs"] = np.asarray(want.vs)
    out[f"{key}/pg_advantages"] = np.asarray(want.pg_advantages)
    return out


@pytest.mark.parametrize("t,b,clip", RECORD_CASES)
def test_jax_record_is_current(t, b, clip):
    """The recorded inputs are the seeded ones and the recorded outputs are
    what JAX computes from them now (1e-6); the port's CPU path agrees with
    the record at the 2e-5 bar."""
    fresh = jax_record(t, b, clip)
    with np.load(JAX_RECORD) as rec:
        assert {k for k in rec.files if k.startswith(f"{t}x{b}/")} \
            == set(fresh)
        for k, want in fresh.items():
            np.testing.assert_allclose(rec[k], want, rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        got = tops.vtrace_from_importance_weights_kernel(
            *(torch.from_numpy(rec[f"{t}x{b}/{n}"]) for n in INPUTS),
            **_clips(clip))
        np.testing.assert_allclose(got.vs.numpy(), rec[f"{t}x{b}/vs"],
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got.pg_advantages.numpy(),
                                   rec[f"{t}x{b}/pg_advantages"],
                                   rtol=2e-5, atol=2e-5)


if __name__ == "__main__":
    record = {}
    for case in RECORD_CASES:
        record.update(jax_record(*case))
    np.savez_compressed(JAX_RECORD, **record)
    print(f"wrote {JAX_RECORD} ({len(record)} arrays)")
