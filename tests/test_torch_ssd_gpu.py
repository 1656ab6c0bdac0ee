"""The CUDA SSD chunk kernel on the card, held against its plain version and
against the JAX reference's outputs recorded in test_torch_ssd_jax.npz
(test_torch_mamba.py checks on the CPU that the record is what JAX
computes); and the reduced Zamba2 hybrid and its server on the card, whose
every SSD chunk and attention goes through the kernels. This file imports
no JAX, so it runs where only PyTorch for CUDA is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_ssd_gpu.py

Without a GPU every case skips."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_reduced_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch.serve import Server
from repro_torch.models import model as model_lib

JAX_RECORD = Path(__file__).with_name("test_torch_ssd_jax.npz")
SSD_INPUTS = ("c", "b", "xdt", "da", "h_prev")


def _assert_ssd_close(got, want, args, plain=tref.ref_ssd_chunk):
    """y and h_new against ``want`` (another float32 evaluation) at
    tests/test_kernels.py's 3e-5, widened by want's own float32 error
    against the plain version in float64 (``ssd_tolerance``)."""
    exact = plain(*(a.double() for a in args))
    for g, w, e in zip(got, want, exact):
        if isinstance(w, np.ndarray):
            g, e = g.cpu().numpy(), e.cpu().numpy()
            np.testing.assert_allclose(g, w, **tref.ssd_tolerance(w, e))
        else:
            torch.testing.assert_close(g, w, **tref.ssd_tolerance(w, e))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return resolve_device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ssd_one_token", "ssd_ragged",
                                  "ssd_three_tiles", "ssd_underflow"])
def test_ssd_kernel_matches_plain_and_jax(cuda_device, case):
    with np.load(JAX_RECORD) as rec:
        args = [torch.from_numpy(rec[f"{case}/{k}"]).to(cuda_device)
                for k in SSD_INPUTS]
        jax_y, jax_h = rec[f"{case}/y"], rec[f"{case}/h_new"]
    before = tops.stats()["ssd_chunk"]
    got = tops.ssd_chunk(*args)
    torch.cuda.synchronize()
    assert tops.stats()["ssd_chunk"] == before + 1
    _assert_ssd_close(got, tref.ref_ssd_chunk(*args), args)
    _assert_ssd_close(got, (jax_y, jax_h), args)


@pytest.mark.gpu
@pytest.mark.parametrize("n,p", [(16, 32), (64, 64)])
@pytest.mark.parametrize("length", [1, 37, 64, 65, 200, 256])
def test_ssd_kernel_reads_the_model_layout(cuda_device, length, n, p):
    """The model's call: B and C are column views of the convolution's
    output, shared by the heads of a batch row; x and da are one chunk of
    the (batch, sequence, head, ...) activations; h_prev is non-zero."""
    gen = torch.Generator(device=cuda_device).manual_seed(length * n)
    b, heads, d_in = 2, 3, 3 * p

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device)

    conv_out = rand(b, length + 8, d_in + 2 * n)
    c = conv_out[:, 4:4 + length, d_in + n:]
    bm = conv_out[:, 4:4 + length, d_in:d_in + n]
    x = rand(b, length + 8, heads, p)[:, 8:]
    da = -0.1 * torch.rand((b, length + 8, heads), generator=gen,
                           device=cuda_device)[:, :length]
    h = rand(b, heads, p, n)
    args = (c, bm, x, da, h)
    y, h_new = tops.ssd_chunk(*args)
    assert y.shape == (b, length, heads, p) and h_new.shape == h.shape
    _assert_ssd_close((y, h_new), tref.ref_ssd_chunk_heads(*args), args,
                      plain=tref.ref_ssd_chunk_heads)


@pytest.mark.gpu
def test_ssd_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    def args(bh=2, length=8, n=16, p=32, dtype=torch.float32):
        return [torch.zeros(s, device=cuda_device, dtype=dtype) for s in
                [(bh, length, n), (bh, length, n), (bh, length, p),
                 (bh, length, 1), (bh, p, n)]]
    with pytest.raises(TypeError, match="float32"):
        tops.ssd_chunk(*args(dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="head dim"):
        tops.ssd_chunk(*args(p=48))
    c, b, x, da, h = args()
    with pytest.raises(ValueError, match="contiguous"):
        tops.ssd_chunk(c, b, x, da, h.transpose(1, 2).contiguous()
                       .transpose(1, 2))
    with pytest.raises(ValueError, match="shapes"):
        tops.ssd_chunk(c, b[:, :4], x, da, h)


@pytest.mark.gpu
def test_reduced_zamba2_kernel_path_matches_plain_path(cuda_device):
    """The reduced hybrid on the card, float32: a 32-token prefill (two
    chunks, the state carried through the kernel) and 6 decode steps
    through the kernels track the plain path at 1e-5, with one SSD chunk
    launch per Mamba2 layer and chunk, one flash-attention launch per
    shared block and prefill and one decode-attention launch per shared
    block and step."""
    base = get_reduced_config("zamba2-2.7b")
    params = model_lib.init(base, seed=0, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    tokens = torch.randint(0, base.vocab_size, (2, 38), generator=gen,
                           device=cuda_device)
    out = {}
    with torch.no_grad():
        for impl in ("xla", "kernel"):
            cfg = dataclasses.replace(base, attn_impl=impl, ssd_impl=impl)
            before = tops.stats()
            h, _, cache = model_lib.prefill(params, tokens[:, :32], cfg=cfg,
                                         cache_seq_len=38)
            logits = [model_lib.logits_from_hidden(params, cfg, h)]
            for t in range(32, 38):
                lg, _, cache = model_lib.serve_step(
                    params, tokens[:, t:t + 1], cache,
                    torch.full((2,), t, dtype=torch.int32,
                               device=cuda_device), cfg=cfg)
                logits.append(lg)
            after = tops.stats()
            out[impl] = logits
            launches = {k: after[k] - before[k] for k in after}
            on = impl == "kernel"
            assert launches == {"vtrace": 0,
                                "ssd_chunk": on * cfg.num_layers * 2,
                                "flash_attention": on * cfg.num_groups,
                                "decode_attention": on * cfg.num_groups * 6}
    for a, b in zip(out["xla"], out["kernel"]):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_zamba2_server_on_the_card_counts_kernel_launches(cuda_device):
    """The reduced hybrid's server on the card, bf16 activations: every
    request served; one SSD chunk launch per Mamba2 layer and one
    flash-attention launch per group per admission, one decode-attention
    launch per group per step."""
    cfg = dataclasses.replace(get_reduced_config("zamba2-2.7b"),
                              attn_impl="kernel", ssd_impl="kernel",
                              dtype="bfloat16")
    params = model_lib.init(cfg, seed=0, device=cuda_device)
    before = tops.stats()
    server = Server(cfg, params, max_batch=3, max_len=32).start()
    try:
        rng = np.random.default_rng(0)
        handles = [server.submit(rng.integers(0, cfg.vocab_size, n),
                                 max_tokens=6, seed=i)
                   for i, n in enumerate([5, 16, 1, 9])]
        results = [h.result(timeout=300) for h in handles]
    finally:
        server.stop()
    after = tops.stats()
    assert [len(r) for r in results] == [11, 22, 7, 15]
    assert after["ssd_chunk"] - before["ssd_chunk"] \
        == cfg.num_layers * server.admissions
    assert after["flash_attention"] - before["flash_attention"] \
        == cfg.num_groups * server.admissions
    assert after["decode_attention"] - before["decode_attention"] \
        == cfg.num_groups * server.steps


# ---------------------------------------------------------------------------
# the tensor-core kernel's edges: a k-tail of N zero-filled to 8, ragged
# lengths, decays that underflow to exactly 0, strided views, 8 rows
# ---------------------------------------------------------------------------

def _model_inputs(device, rows, length, heads, n, p, decay, seed,
                  strided=False):
    """c, b, x, da, h_prev in the model's layout; with ``strided`` c and b
    are column views of one wider tensor and x, da row views of longer
    ones, as the model's convolution output and chunks hand them over."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device)

    if strided:
        conv = rand(rows, length + 4, 2 * n + 8)
        c, b = conv[:, 2:2 + length, 4:4 + n], conv[:, 2:2 + length,
                                                       n + 8:]
        x = rand(rows, length + 3, heads, p)[:, 3:]
        da = -decay * torch.rand((rows, length + 5, heads), generator=gen,
                                 device=device)[:, 5:]
    else:
        c, b = rand(rows, length, n), rand(rows, length, n)
        x = rand(rows, length, heads, p)
        da = -decay * torch.rand((rows, length, heads), generator=gen,
                                 device=device)
    return c, b, x, da, rand(rows, heads, p, n)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,length,heads,n,p,decay,strided", [
    (2, 100, 3, 36, 32, 0.1, False),     # N = 36: k-tail zero-filled to 40
    (2, 64, 2, 36, 16, 0.1, True),
    (1, 1, 80, 64, 64, 0.55, False),     # one token
    (1, 37, 80, 64, 64, 0.55, False),    # ragged
    (1, 255, 80, 64, 64, 0.55, False),   # one short of the chunk
    (2, 200, 4, 64, 64, 2.0, False),     # decays underflow to exactly 0
    (2, 256, 8, 64, 64, 0.55, True),     # strided views
    (8, 256, 10, 64, 64, 0.55, False),   # 8 rows
])
def test_ssd_tensor_core_kernel_edges(cuda_device, rows, length, heads, n, p,
                                      decay, strided):
    args = _model_inputs(cuda_device, rows, length, heads, n, p, decay,
                         seed=length * n + heads, strided=strided)
    y, h_new = tops.ssd_chunk(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(h_new).all()
    if decay >= 2.0:
        # the decay over the whole chunk underflows: h_prev's share is 0
        acs = torch.cumsum(args[3].double(), dim=1)
        assert float(acs[:, -1].max()) < -104.0
        assert (torch.exp(acs[:, -1].float()) == 0).all()
    _assert_ssd_close((y, h_new), tref.ref_ssd_chunk_heads(*args), args,
                      plain=tref.ref_ssd_chunk_heads)


@pytest.mark.gpu
def test_ssd_smem_need_comes_from_the_kernel(cuda_device):
    """The wrapper's shared-memory check reads the kernel's own formula,
    which grows with L, N and P and fits the card at the serving shape."""
    need = tops.ssd_chunk_smem_bytes
    assert 0 < need(256, 64, 64) <= 232448
    assert need(256, 64, 64) < need(512, 64, 64)
    assert need(256, 36, 64) == need(256, 40, 64) < need(256, 64, 64)
    assert need(256, 64, 32) < need(256, 64, 64)
