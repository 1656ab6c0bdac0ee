"""The CUDA V-trace kernel on the card, held against its plain version and
against the JAX V-trace's outputs recorded in test_torch_vtrace_jax.npz
(test_torch_vtrace.py checks on the CPU that the record is what JAX
computes), at the edges of its chunked scan over T (ops.vtrace_chunks),
and for bitwise-equal outputs across calls and CUDA-graph replays. This
file imports no JAX, so it runs where only PyTorch for CUDA is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_vtrace_gpu.py

Without a GPU every case skips."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import VTRACE_TOL, vtrace_inputs  # noqa: E402

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


CLIPS = ("clip_rho_threshold", "clip_c_threshold", "clip_pg_rho_threshold")
# (T, B, clip): B no multiple of 32 (33, 200 and others), B = 1, a T that
# is no multiple of its chunk length L (37: L 4; 83: L 8; 513: L 16), T
# over several segments of 256 rows (513, 1000), unclipped, and the
# learner's (80, 32) and the long unroll at B 4096
EDGE_CASES = [(33, 200, 1.0), (33, 200, None), (80, 1, 1.0), (1, 1, None),
              (37, 5, 1.0), (83, 32, None), (1000, 32, 1.0),
              (1000, 33, None), (513, 70, 1.0), (200, 4096, 1.0),
              (80, 32, None), (20, 32, None)]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "case", range(len(EDGE_CASES)),
    ids=[f"{t}x{b}-{'clip1' if c else 'unclipped'}"
         for t, b, c in EDGE_CASES])
def test_chunked_kernel_edges_match_plain(cuda_device, case):
    t, b, clip = EDGE_CASES[case]
    args = vtrace_inputs(t, b, 5000 + case, cuda_device)
    kw = dict.fromkeys(CLIPS, clip)
    before = tops.stats()["vtrace"]
    got = tops.vtrace_from_importance_weights_kernel(*args, **kw)
    want = tref.ref_vtrace_from_importance_weights(*args, **kw)
    torch.cuda.synchronize()
    assert tops.stats()["vtrace"] == before + 1
    assert tops.last_vtrace_chunks() == tops.vtrace_chunks(t)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=VTRACE_TOL, atol=VTRACE_TOL)


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("t,b", [(80, 32), (20, 32), (1000, 33),
                                 (200, 4096)])
def test_kernel_is_bitwise_deterministic(cuda_device, t, b):
    """Two calls, and two replays of a CUDA graph of a call, give the same
    bits: no atomics, nothing passed between blocks."""
    args = vtrace_inputs(t, b, 6000 + t + b, cuda_device)
    first = tops.vtrace_from_importance_weights_kernel(*args)
    second = tops.vtrace_from_importance_weights_kernel(*args)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        tops.vtrace_from_importance_weights_kernel(*args)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = tops.vtrace_from_importance_weights_kernel(*args)
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append([x.clone() for x in captured])
    for other in (second, *replays):
        for x, y in zip(first, other):
            assert torch.equal(_bits(x), _bits(y))
