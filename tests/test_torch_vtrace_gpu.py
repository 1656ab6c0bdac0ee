"""The CUDA V-trace kernel on the card, held against its plain version and
against the JAX V-trace's outputs recorded in test_torch_vtrace_jax.npz
(test_torch_vtrace.py checks on the CPU that the record is what JAX
computes). This file imports no JAX, so it runs where only PyTorch for CUDA
is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_vtrace_gpu.py

Without a GPU every case skips."""

from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

JAX_RECORD = Path(__file__).with_name("test_torch_vtrace_jax.npz")
INPUTS = ("log_rhos", "discounts", "rewards", "values", "bootstrap_value")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["80x32", "20x200", "1x1"])
def test_cuda_kernel_matches_plain_and_jax(cuda_device, case):
    with np.load(JAX_RECORD) as rec:
        args = [torch.from_numpy(rec[f"{case}/{n}"]).to(cuda_device)
                for n in INPUTS]
        clip = float(rec[f"{case}/clip"])
        jax_out = [rec[f"{case}/vs"], rec[f"{case}/pg_advantages"]]
    kw = dict.fromkeys(("clip_rho_threshold", "clip_c_threshold",
                        "clip_pg_rho_threshold"),
                       None if np.isinf(clip) else clip)
    before = tops.stats()["vtrace"]
    got = tops.vtrace_from_importance_weights_kernel(*args, **kw)
    want = tref.ref_vtrace_from_importance_weights(*args, **kw)
    torch.cuda.synchronize()
    assert tops.stats()["vtrace"] == before + 1
    for g, w, j in zip(got, want, jax_out):
        # the plain version on the same card at 1e-5; JAX (CPU) at the
        # 2e-5 bar of tests/test_vtrace.py
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g.cpu().numpy(), j, rtol=2e-5, atol=2e-5)
