"""The CUDA flash- and decode-attention kernels on the card, held against
their plain versions and against the JAX reference's outputs recorded in
test_torch_attention_jax.npz (test_torch_attention.py checks on the CPU
that the record is what JAX computes); and the reduced decoder and server
on the card, whose every attention goes through the kernels. This file
imports no JAX, so it runs where only PyTorch for CUDA is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_attention_gpu.py

Without a GPU every case skips."""

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

JAX_RECORD = Path(__file__).with_name("test_torch_attention_jax.npz")
TOL = dict(rtol=2e-5, atol=2e-5)   # tests/test_kernels.py's float32 bar


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return resolve_device("cuda")


def _record(case, names, device):
    with np.load(JAX_RECORD) as rec:
        args = [torch.from_numpy(rec[f"{case}/{n}"]).to(device)
                for n in names]
        opts = dict(window=int(rec[f"{case}/window"]),
                    softcap=float(rec[f"{case}/softcap"]))
        return args, opts, rec[f"{case}/out"]


def _assert_bf16_close(got, q, k, v, plain, **kw):
    """bf16: the plain version run in float32 on the same bf16 inputs, then
    rounded once to bf16; the kernel may differ by one bf16 ulp (2^-7
    relative) where its float32 sums, taken in another order, straddle a
    rounding boundary."""
    want = plain(q.float(), k.float(), v.float(), **kw).to(torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["flash_gqa_ragged",
                                  "flash_window_softcap"])
def test_flash_kernel_matches_plain_and_jax(cuda_device, case):
    (q, k, v), opts, jax_out = _record(case, "qkv", cuda_device)
    before = tops.stats()["flash_attention"]
    got = tops.flash_attention(q, k, v, **opts)
    want = tref.ref_flash_attention(q, k, v, **opts)
    torch.cuda.synchronize()
    assert tops.stats()["flash_attention"] == before + 1
    torch.testing.assert_close(got, want, **TOL)
    np.testing.assert_allclose(got.cpu().numpy(), jax_out, **TOL)
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    _assert_bf16_close(tops.flash_attention(qb, kb, vb, **opts), qb, kb, vb,
                       tref.ref_flash_attention, **opts)


@pytest.mark.gpu
def test_decode_kernel_matches_plain_and_jax(cuda_device):
    names = ("q", "k", "v", "slot_pos", "pos")
    (q, k, v, slot, pos), opts, jax_out = _record("decode_ring_per_row",
                                                  names, cuda_device)
    before = tops.stats()["decode_attention"]
    got = tops.decode_attention(q, k, v, slot, pos, **opts)
    want = tref.ref_decode_attention(q, k, v, slot, pos, **opts)
    torch.cuda.synchronize()
    assert tops.stats()["decode_attention"] == before + 1
    torch.testing.assert_close(got, want, **TOL)
    np.testing.assert_allclose(got.cpu().numpy(), jax_out, **TOL)
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    got_b = tops.decode_attention(qb, kb, vb, slot, pos, **opts)
    _assert_bf16_close(got_b, qb, kb, vb,
                       lambda q, k, v, **kw: tref.ref_decode_attention(
                           q, k, v, slot, pos, **kw), **opts)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 80, 128, 256])
@pytest.mark.parametrize("s", [1, 63, 65, 200])
def test_kernels_read_strided_model_layouts(cuda_device, hd, s):
    """Both kernels take the model's layouts as transposed views, with no
    copy: activations (B,S,H,hd) for flash attention, the (B,cap,K,hd)
    cache for decode attention; ragged S and every head_dim."""
    gen = torch.Generator(device=cuda_device).manual_seed(s * hd)
    q = torch.randn((2, s, 8, hd), generator=gen, device=cuda_device)
    k = torch.randn((2, s, 2, hd), generator=gen, device=cuda_device)
    v = torch.randn((2, s, 2, hd), generator=gen, device=cuda_device)
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    got = tops.flash_attention(*args, window=40, softcap=20.0)
    assert got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(
        got, tref.ref_flash_attention(*args, window=40, softcap=20.0), **TOL)
    pos = torch.tensor([s - 1, s // 2], dtype=torch.int32,
                       device=cuda_device)
    slot = torch.arange(s, dtype=torch.int32, device=cuda_device)
    got = tops.decode_attention(q[:, -1], *args[1:], slot, pos)
    torch.testing.assert_close(
        got, tref.ref_decode_attention(q[:, -1], *args[1:], slot, pos),
        **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_80_without_gqa(cuda_device, dtype):
    """Zamba2's shared block: head_dim 80, as many KV heads as query heads
    (one query row per decode block), a ragged prompt, per-row pos."""
    gen = torch.Generator(device=cuda_device).manual_seed(80)
    q, k, v = (torch.randn((2, 8, 70, 80), generator=gen, device=cuda_device)
               .to(dtype) for _ in range(3))
    got = tops.flash_attention(q, k, v)
    if dtype == torch.float32:
        torch.testing.assert_close(got, tref.ref_flash_attention(q, k, v),
                                   **TOL)
    else:
        _assert_bf16_close(got, q, k, v, tref.ref_flash_attention)
    pos = torch.tensor([69, 30], dtype=torch.int32, device=cuda_device)
    slot = torch.arange(70, dtype=torch.int32, device=cuda_device)
    got = tops.decode_attention(q[:, :, -1], k, v, slot, pos)
    if dtype == torch.float32:
        torch.testing.assert_close(
            got, tref.ref_decode_attention(q[:, :, -1], k, v, slot, pos),
            **TOL)
    else:
        _assert_bf16_close(
            got, q[:, :, -1], k, v,
            lambda q, k, v: tref.ref_decode_attention(q, k, v, slot, pos))


def _launches_of(name, fn):
    """fn()'s result, checked to add exactly one launch of ``name``."""
    before = tops.stats()[name]
    out = fn()
    assert tops.stats()[name] == before + 1
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 80, 128, 256])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 200, 512])
def test_flash_bf16_tensor_core_kernel_on_strided_views(cuda_device, hd, s):
    """bf16 takes the tensor-core kernel: the model's (B,S,H,hd)
    activations as transposed views, GQA, ragged and whole 64-key tiles,
    plain and windowed with a softcap; one launch per call."""
    gen = torch.Generator(device=cuda_device).manual_seed(1000 + s * hd)
    q = torch.randn((2, s, 8, hd), generator=gen, device=cuda_device)
    k = torch.randn((2, s, 2, hd), generator=gen, device=cuda_device)
    v = torch.randn((2, s, 2, hd), generator=gen, device=cuda_device)
    args = [x.bfloat16().transpose(1, 2) for x in (q, k, v)]
    for kw in (dict(), dict(window=40, softcap=20.0)):
        got = _launches_of("flash_attention",
                           lambda: tops.flash_attention(*args, **kw))
        assert got.dtype == torch.bfloat16
        assert got.transpose(1, 2).is_contiguous()
        _assert_bf16_close(got, *args, tref.ref_flash_attention, **kw)


def _decode_split_case(b, h, kh, s, hd, pos_kind, device):
    """q, the (B,S,K,hd) cache as (B,K,S,hd) views, slot_pos and pos:
    per-row positions with row 0 at 5 (every range past the first empty),
    pos 0, an (S,) slot_pos row with a scalar pos, a ring buffer, or row 0
    with no valid slot at all."""
    gen = torch.Generator(device=device).manual_seed(s * hd + h)
    q = torch.randn((b, h, hd), generator=gen, device=device)
    k = torch.randn((b, s, kh, hd), generator=gen, device=device)
    v = torch.randn((b, s, kh, hd), generator=gen, device=device)
    k, v = k.transpose(1, 2), v.transpose(1, 2)
    idx = torch.arange(s, dtype=torch.int32, device=device)
    pos = torch.randint(0, s, (b,), generator=gen, device=device,
                        dtype=torch.int32)
    pos[0] = 5
    if pos_kind == "zero":
        return q, k, v, idx.expand(b, s), torch.zeros_like(pos)
    if pos_kind == "scalar":
        return q, k, v, idx, s // 3
    if pos_kind == "ring":
        pos = pos + 2 * s
        return q, k, v, pos[:, None] - torch.remainder(pos[:, None] - idx,
                                                       s), pos
    slot = idx.expand(b, s)
    if pos_kind == "none_valid":
        slot = slot.clone()
        slot[0] = -1
    return q, k, v, slot, pos


# (B, H, K, S, hd, pos, window): the Qwen3-4B serving shape with empty
# ranges, with pos 0, with an (S,) slot_pos row; a ring buffer under a
# window; Zamba2's shared block (G = 1, hd 80); G = 8 (two groups of four
# query heads per KV head) with S not a multiple of the range; hd 256; a
# row with no valid slot
DECODE_SPLIT_CASES = [
    (8, 32, 8, 576, 128, "rows", 0),
    (8, 32, 8, 576, 128, "zero", 0),
    (8, 32, 8, 576, 128, "scalar", 0),
    (8, 32, 8, 256, 128, "ring", 100),
    (8, 32, 32, 320, 80, "rows", 0),
    (4, 64, 8, 300, 64, "rows", 0),
    (4, 32, 8, 200, 256, "rows", 0),
    (4, 8, 2, 130, 128, "none_valid", 0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kh,s,hd,pos_kind,window", DECODE_SPLIT_CASES)
def test_decode_kernel_split_over_the_cache(cuda_device, b, h, kh, s, hd,
                                            pos_kind, window, dtype):
    """Decode attention with the cache cut into several ranges and their
    partial states merged by the combine kernel, all in one call and one
    counted launch."""
    q, k, v, slot, pos = _decode_split_case(b, h, kh, s, hd, pos_kind,
                                            cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    split = tops.decode_splits(b, h, kh, s, sms)
    assert split[0] > 1
    q, k, v = (x.to(dtype) for x in (q, k, v))
    got = _launches_of("decode_attention", lambda: tops.decode_attention(
        q, k, v, slot, pos, window=window))
    assert tops.last_decode_split() == split
    if dtype == torch.float32:
        torch.testing.assert_close(
            got, tref.ref_decode_attention(q, k, v, slot, pos,
                                           window=window), **TOL)
    else:
        _assert_bf16_close(
            got, q, k, v, lambda q, k, v, **kw: tref.ref_decode_attention(
                q, k, v, slot, pos, **kw), window=window)


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros((1, 4, 8, 96), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        tops.flash_attention(q, q[:, :2], q[:, :2])
    q = torch.zeros((1, 4, 8, 64), device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16"):
        tops.flash_attention(q, q[:, :2], q[:, :2])
    q = torch.zeros((2, 4, 64), device=cuda_device)
    kv = torch.zeros((2, 2, 8, 64), device=cuda_device)
    with pytest.raises(ValueError, match="slot_pos"):
        tops.decode_attention(q, kv, kv, torch.arange(8, device=cuda_device),
                              3)


@pytest.mark.gpu
def test_reduced_decoder_kernel_path_matches_plain_path(cuda_device):
    """The reduced decoder on the card: prefill and decode through the
    kernels track the dense path at 1e-5 (float32, TF32 off), with one
    kernel launch per layer and call."""
    cfg = get_reduced_config("gemma2-27b")
    params = model_lib.init(cfg, seed=0, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 44), generator=gen,
                           device=cuda_device)
    out = {}
    with torch.no_grad():
        for impl in ("xla", "kernel"):
            before = tops.stats()
            h, _, cache = model_lib.prefill(params, tokens[:, :36], cfg=cfg,
                                         impl=impl, cache_seq_len=44)
            logits = [model_lib.logits_from_hidden(params, cfg, h)]
            for t in range(36, 44):
                lg, _, cache = model_lib.serve_step(
                    params, tokens[:, t:t + 1], cache,
                    torch.full((2,), t, dtype=torch.int32,
                               device=cuda_device), cfg=cfg, impl=impl)
                logits.append(lg)
            after = tops.stats()
            out[impl] = logits
            launches = {n: after[n] - before[n] for n in after}
            layers = cfg.num_layers
            assert launches["flash_attention"] == (layers if impl == "kernel"
                                                   else 0)
            assert launches["decode_attention"] == (8 * layers
                                                    if impl == "kernel"
                                                    else 0)
    for a, b in zip(out["xla"], out["kernel"]):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_server_on_the_card_counts_kernel_launches(cuda_device):
    """The reduced server on the card with the kernel impl: every request
    served, flash attention once per layer per admission and decode
    attention once per layer per step."""
    import dataclasses
    cfg = dataclasses.replace(get_reduced_config("qwen3-4b"),
                              attn_impl="kernel", dtype="bfloat16")
    params = model_lib.init(cfg, seed=0, device=cuda_device)
    before = tops.stats()
    server = Server(cfg, params, max_batch=3, max_len=40).start()
    try:
        rng = np.random.default_rng(0)
        handles = [server.submit(rng.integers(0, cfg.vocab_size, n),
                                 max_tokens=6, seed=i)
                   for i, n in enumerate([5, 17, 30, 2, 9])]
        results = [h.result(timeout=300) for h in handles]
    finally:
        server.stop()
    after = tops.stats()
    assert [len(r) for r in results] == [11, 23, 36, 8, 15]
    assert after["flash_attention"] - before["flash_attention"] \
        == cfg.num_layers * server.admissions
    assert after["decode_attention"] - before["decode_attention"] \
        == cfg.num_layers * server.steps
