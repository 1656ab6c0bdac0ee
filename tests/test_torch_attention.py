"""Attention in the PyTorch port against the JAX reference: the plain
versions of the flash- and decode-attention kernels against the JAX
oracles (``repro.kernels.ref``) and the Pallas kernels in interpret mode,
``attn_apply`` in every impl and ``attn_decode`` against the reference's,
the wrappers' refusals, and the record of JAX outputs that the CUDA
kernels are held against on the GPU."""

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
from repro.models import attention as JA
from repro.models.common import split_params
from repro_torch.configs import get_reduced_config
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as TA
from repro_torch.models.common import Params

# The suite runs several test processes side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)       # tests/test_kernels.py's bar
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_attn_impl.py's bar


def _qkv(rng, b, h, kh, s, hd):
    return (rng.normal(0, 1, (b, h, s, hd)).astype(np.float32),
            rng.normal(0, 1, (b, kh, s, hd)).astype(np.float32),
            rng.normal(0, 1, (b, kh, s, hd)).astype(np.float32))


def _divisor_block(s, want=64):
    b = min(want, s)
    while s % b:
        b -= 1
    return b


# tests/test_kernels.py's sweep, plus ragged S that no 64-row tile divides
FLASH_CASES = [
    # b, h, kh, s, hd, window, softcap, causal
    (2, 4, 2, 256, 64, 0, 0.0, True),
    (1, 8, 8, 128, 128, 0, 0.0, True),      # MHA
    (2, 4, 1, 256, 64, 0, 0.0, True),       # MQA
    (1, 4, 2, 256, 64, 64, 0.0, True),      # sliding window
    (1, 4, 2, 128, 64, 0, 50.0, True),      # softcap (gemma)
    (1, 4, 2, 192, 64, 0, 0.0, True),       # non-pow2 seq
    (1, 4, 2, 128, 64, 0, 0.0, False),      # non-causal
    (1, 4, 2, 100, 64, 0, 0.0, True),       # ragged
    (1, 8, 2, 300, 128, 0, 0.0, True),      # ragged, the serving widths
    (1, 4, 2, 77, 256, 24, 30.0, True),     # ragged, window and softcap
]


@pytest.mark.parametrize("b,h,kh,s,hd,win,cap,causal", FLASH_CASES)
def test_flash_plain_matches_jax(b, h, kh, s, hd, win, cap, causal):
    q, k, v = _qkv(np.random.default_rng(s * 31 + hd), b, h, kh, s, hd)
    kw = dict(window=win, softcap=cap, causal=causal)
    got = tops.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    assert got.dtype == torch.float32 and got.shape == (b, h, s, hd)
    np.testing.assert_allclose(
        got.numpy(), jref.ref_flash_attention(*map(jnp.asarray, (q, k, v)),
                                              **kw), **TOL)
    blk = _divisor_block(s)
    pallas = jops.flash_attention(*map(jnp.asarray, (q, k, v)), **kw,
                                  block_q=blk, block_k=blk)
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)


def test_flash_plain_bf16_matches_jax():
    """bf16 inputs: arithmetic in float32 and the output rounded to bf16 in
    both packages; the JAX sweep's bf16 bar (2e-2) for the Pallas kernel,
    and at most one bf16 ulp (2^-7 relative) against the JAX oracle, which
    computes the same float32 values and rounds once."""
    q, k, v = _qkv(np.random.default_rng(2), 2, 4, 2, 256, 64)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = tops.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x.float().numpy(), jnp.bfloat16)
                  for x in (tq, tk, tv))
    want = np.asarray(jref.ref_flash_attention(jq, jk, jv), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)
    pallas = np.asarray(jops.flash_attention(jq, jk, jv, block_q=64,
                                             block_k=64), np.float32)
    np.testing.assert_allclose(got.float().numpy(), pallas, rtol=2e-2,
                               atol=2e-2)


DECODE_CASES = [
    # b, h, kh, s, hd, window, pos_frac  (tests/test_kernels.py)
    (2, 8, 2, 256, 64, 0, 0.6),
    (1, 4, 4, 128, 128, 0, 0.99),
    (1, 8, 1, 256, 64, 0, 0.2),
    (2, 4, 2, 128, 64, 64, 0.9),
    (3, 8, 2, 100, 256, 0, 0.5),    # ragged cache, hd 256
]


@pytest.mark.parametrize("b,h,kh,s,hd,win,pf", DECODE_CASES)
def test_decode_plain_matches_jax(b, h, kh, s, hd, win, pf):
    rng = np.random.default_rng(b * 1000 + s)
    q = rng.normal(0, 1, (b, h, hd)).astype(np.float32)
    k = rng.normal(0, 1, (b, kh, s, hd)).astype(np.float32)
    v = rng.normal(0, 1, (b, kh, s, hd)).astype(np.float32)
    pos = int(pf * (s - 1))
    slot = np.arange(s, dtype=np.int32)
    got = tops.decode_attention(*map(torch.from_numpy, (q, k, v, slot)),
                                pos, window=win)
    args = (*map(jnp.asarray, (q, k, v, slot)), jnp.int32(pos))
    np.testing.assert_allclose(got.numpy(),
                               jref.ref_decode_attention(*args, window=win),
                               **TOL)
    pallas = jops.decode_attention(*args, window=win,
                                   block_k=_divisor_block(s))
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)


def _ring(pos, s):
    idx = np.arange(s)
    return (np.asarray(pos)[..., None] - np.mod(np.asarray(pos)[..., None]
                                                - idx, s)).astype(np.int32)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_decode_plain_ring_buffer_and_per_row_pos(per_row, softcap):
    """Ring-buffer slot positions (non-monotonic, (S,) or per-row (B,S))
    and per-row pos, against the JAX oracle and the Pallas kernel."""
    rng = np.random.default_rng(1)
    b, h, kh, s, hd = 3, 4, 2, 64, 64
    q = rng.normal(0, 1, (b, h, hd)).astype(np.float32)
    k = rng.normal(0, 1, (b, kh, s, hd)).astype(np.float32)
    v = rng.normal(0, 1, (b, kh, s, hd)).astype(np.float32)
    if per_row:
        pos = np.array([100, 7, 63], np.int32)
        slot = _ring(pos, s)                       # (B, S)
    else:
        pos = np.int32(100)
        slot = _ring(pos, s)                       # (S,)
    kw = dict(window=s, softcap=softcap)
    got = tops.decode_attention(*map(torch.from_numpy, (q, k, v, slot)),
                                torch.from_numpy(np.asarray(pos)), **kw)
    args = (*map(jnp.asarray, (q, k, v, slot)), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(),
                               jref.ref_decode_attention(*args, **kw), **TOL)
    np.testing.assert_allclose(
        got.numpy(), jops.decode_attention(*args, **kw, block_k=32), **TOL)


def test_fully_masked_rows_keep_the_finite_mask():
    """A row with no valid slot averages v uniformly (p = 1 everywhere
    under the finite NEG_INF), never NaN, in both packages."""
    rng = np.random.default_rng(4)
    q = rng.normal(0, 1, (2, 2, 64)).astype(np.float32)
    k = rng.normal(0, 1, (2, 1, 8, 64)).astype(np.float32)
    v = rng.normal(0, 1, (2, 1, 8, 64)).astype(np.float32)
    slot = np.full((8,), -1, np.int32)
    got = tops.decode_attention(*map(torch.from_numpy, (q, k, v, slot)), 3)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(
        got.numpy(), jref.ref_decode_attention(
            *map(jnp.asarray, (q, k, v, slot)), jnp.int32(3)), **TOL)
    np.testing.assert_allclose(got.numpy()[:, 0], v.mean(axis=2)[:, 0],
                               **TOL)


# ---------------------------------------------------------------------------
# attn_apply / attn_decode against the reference's
# ---------------------------------------------------------------------------

def _configs(**over):
    jcfg = dataclasses.replace(jax_reduced_config("qwen3-32b"), **over)
    tcfg = dataclasses.replace(get_reduced_config("qwen3-32b"), **over)
    return jcfg, tcfg


def _both_params(jcfg, kind, seed=0):
    jp = split_params(JA.attn_init(jax.random.PRNGKey(seed), jcfg, kind))[0]
    tp = Params(**{name: torch.from_numpy(np.array(a))
                   for name, a in jp.items()})
    return jp, tp


ATTN_VARIANTS = [
    ("attn", None, 2),        # GQA
    ("attn", None, 1),        # MQA
    ("attn", 30.0, 2),        # softcap
    ("swa_attn", None, 2),    # sliding window
]


@pytest.mark.parametrize("impl", ["xla", "xla_chunked", "xla_chunked_skip",
                                  "kernel", "auto"])
@pytest.mark.parametrize("kind,softcap,kv_heads", ATTN_VARIANTS)
def test_attn_apply_matches_jax(kind, softcap, kv_heads, impl):
    jcfg, tcfg = _configs(attn_logit_softcap=softcap, sliding_window=48,
                          attn_chunk=32, num_kv_heads=kv_heads)
    jp, tp = _both_params(jcfg, kind)
    x = np.random.default_rng(kv_heads).normal(
        0, 1, (2, 96, jcfg.d_model)).astype(np.float32)
    pos = np.arange(96)
    want, (jk, jv) = JA.attn_apply(jp, jnp.asarray(x), cfg=jcfg, kind=kind,
                                   positions=jnp.asarray(pos), impl=impl)
    got, (tk, tv) = TA.attn_apply(tp, torch.from_numpy(x), cfg=tcfg,
                                  kind=kind, positions=torch.from_numpy(pos),
                                  impl=impl)
    np.testing.assert_allclose(got.detach().numpy(), want, **MODEL_TOL)
    np.testing.assert_allclose(tk.detach().numpy(), jk, **MODEL_TOL)
    np.testing.assert_allclose(tv.detach().numpy(), jv, **MODEL_TOL)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
@pytest.mark.parametrize("kind", ["swa_attn", "attn"])
def test_attn_decode_matches_jax_through_the_ring(kind, impl):
    """Scalar pos, one token at a time through the ring-buffer wrap of a
    window-sized cache: outputs and caches track the reference's."""
    jcfg, tcfg = _configs(sliding_window=16, attn_chunk=16)
    jp, tp = _both_params(jcfg, kind)
    x = np.random.default_rng(3).normal(
        0, 1, (1, 40, jcfg.d_model)).astype(np.float32)
    jc = JA.attn_cache_init(jcfg, kind, 1, 40, jnp.float32)
    tc = TA.attn_cache_init(tcfg, kind, 1, 40, torch.float32)
    with torch.no_grad():
        for t in range(40):
            want, jc = JA.attn_decode(jp, jnp.asarray(x[:, t:t + 1]), jc,
                                      cfg=jcfg, kind=kind, pos=jnp.int32(t),
                                      impl=impl)
            got, tc = TA.attn_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                     tc, cfg=tcfg, kind=kind, pos=t,
                                     impl=impl)
            np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)
    np.testing.assert_allclose(tc["k"].numpy(), jc["k"], **MODEL_TOL)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
@pytest.mark.parametrize("kind", ["swa_attn", "attn"])
def test_attn_decode_per_row_pos_matches_jax(kind, impl):
    """Per-row pos (continuous batching): each row writes and attends at
    its own position, as in the reference."""
    jcfg, tcfg = _configs(sliding_window=8)
    jp, tp = _both_params(jcfg, kind, seed=1)
    rng = np.random.default_rng(5)
    b, cap = 3, 24
    jc = JA.attn_cache_init(jcfg, kind, b, cap, jnp.float32)
    tc = TA.attn_cache_init(tcfg, kind, b, cap, torch.float32)
    prefill = rng.normal(0, 1, jc["k"].shape).astype(np.float32)
    jc = {"k": jnp.asarray(prefill), "v": jnp.asarray(prefill[::-1].copy())}
    tc = {"k": torch.from_numpy(prefill.copy()),
          "v": torch.from_numpy(prefill[::-1].copy())}
    pos = np.array([3, 11, 20], np.int32)
    with torch.no_grad():
        for step in range(4):
            x = rng.normal(0, 1, (b, 1, jcfg.d_model)).astype(np.float32)
            want, jc = JA.attn_decode(jp, jnp.asarray(x), jc, cfg=jcfg,
                                      kind=kind, pos=jnp.asarray(pos + step),
                                      impl=impl)
            got, tc = TA.attn_decode(tp, torch.from_numpy(x), tc, cfg=tcfg,
                                     kind=kind,
                                     pos=torch.from_numpy(pos + step),
                                     impl=impl)
            np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)
    np.testing.assert_allclose(tc["v"].numpy(), jc["v"], **MODEL_TOL)


def test_prefill_cache_rolls_like_the_reference():
    """A prompt longer than the window's ring: the cache keeps the last
    `cap` positions at slot pos % cap."""
    jcfg, tcfg = _configs(sliding_window=16)
    rng = np.random.default_rng(6)
    k = rng.normal(0, 1, (2, 37, 2, 64)).astype(np.float32)
    v = rng.normal(0, 1, (2, 37, 2, 64)).astype(np.float32)
    want = JA.attn_prefill_cache(jcfg, "swa_attn", (jnp.asarray(k),
                                                    jnp.asarray(v)), 64,
                                 jnp.float32)
    got = TA.attn_prefill_cache(tcfg, "swa_attn", (torch.from_numpy(k),
                                                   torch.from_numpy(v)), 64,
                                torch.float32)
    np.testing.assert_array_equal(got["k"].numpy(), want["k"])
    np.testing.assert_array_equal(got["v"].numpy(), want["v"])


def test_xattn_init_has_the_reference_leaves_and_shapes():
    """Cross-attention builds the same leaves as self-attention, at the
    reference's shapes (the VLM path: tests/test_torch_vlm.py)."""
    jcfg = jax_reduced_config("llama-3.2-vision-90b")
    jp = split_params(JA.attn_init(jax.random.PRNGKey(0), jcfg, "xattn"))[0]
    tp = TA.attn_init(get_reduced_config("llama-3.2-vision-90b"), "xattn",
                      generator=torch.Generator())
    assert {k: tuple(v.shape) for k, v in tp.named_parameters()} == \
        {k: tuple(v.shape) for k, v in jp.items()}


# ---------------------------------------------------------------------------
# the wrappers' refusals
# ---------------------------------------------------------------------------

def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """Only CPU tensors take the plain versions; any other device must
    launch the kernel or raise — here meta tensors raise."""
    q = torch.empty((1, 4, 8, 64), device="meta")
    kv = torch.empty((1, 2, 8, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="CUDA"):
        tops.decode_attention(q[:, :, 0], kv, kv,
                              torch.empty((8,), dtype=torch.int32,
                                          device="meta"), 3)


# ---------------------------------------------------------------------------
# The JAX reference's outputs on seeded inputs, recorded so that the CUDA
# kernels can be held against JAX on a machine without JAX
# (tests/test_torch_attention_gpu.py). Rewrite the record with
#     PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_attention.py
# ---------------------------------------------------------------------------

JAX_RECORD = Path(__file__).with_name("test_torch_attention_jax.npz")
# name: (b, h, kh, s, hd, window, softcap)
FLASH_RECORD = {"flash_gqa_ragged": (1, 4, 2, 24, 64, 0, 0.0),
                "flash_window_softcap": (1, 2, 1, 24, 64, 8, 30.0)}
DECODE_RECORD = {"decode_ring_per_row": (2, 4, 2, 32, 64, 32, 30.0)}


def jax_record():
    """Seeded inputs, their options and the JAX oracles' outputs, keyed
    ``"<case>/<name>"``."""
    out = {}
    for name, (b, h, kh, s, hd, win, cap) in FLASH_RECORD.items():
        q, k, v = _qkv(np.random.default_rng(s + win), b, h, kh, s, hd)
        o = jref.ref_flash_attention(*map(jnp.asarray, (q, k, v)),
                                     window=win, softcap=cap)
        out.update({f"{name}/q": q, f"{name}/k": k, f"{name}/v": v,
                    f"{name}/window": np.int32(win),
                    f"{name}/softcap": np.float32(cap),
                    f"{name}/out": np.asarray(o)})
    for name, (b, h, kh, s, hd, win, cap) in DECODE_RECORD.items():
        rng = np.random.default_rng(s)
        q = rng.normal(0, 1, (b, h, hd)).astype(np.float32)
        k = rng.normal(0, 1, (b, kh, s, hd)).astype(np.float32)
        v = rng.normal(0, 1, (b, kh, s, hd)).astype(np.float32)
        pos = np.array([45, 9], np.int32)[:b]
        slot = _ring(pos, s)
        o = jref.ref_decode_attention(*map(jnp.asarray, (q, k, v, slot, pos)),
                                      window=win, softcap=cap)
        out.update({f"{name}/q": q, f"{name}/k": k, f"{name}/v": v,
                    f"{name}/slot_pos": slot, f"{name}/pos": pos,
                    f"{name}/window": np.int32(win),
                    f"{name}/softcap": np.float32(cap),
                    f"{name}/out": np.asarray(o)})
    return out


def test_jax_record_is_current():
    """The recorded inputs are the seeded ones and the recorded outputs are
    what JAX computes from them now (1e-6); the port's CPU path agrees
    with the record at the 2e-5 bar."""
    fresh = jax_record()
    with np.load(JAX_RECORD) as rec:
        assert set(rec.files) == set(fresh)
        for key, want in fresh.items():
            np.testing.assert_allclose(rec[key], want, rtol=1e-6, atol=1e-6,
                                       err_msg=key)
        for name in FLASH_RECORD:
            got = tops.flash_attention(
                *(torch.from_numpy(rec[f"{name}/{n}"]) for n in "qkv"),
                window=int(rec[f"{name}/window"]),
                softcap=float(rec[f"{name}/softcap"]))
            np.testing.assert_allclose(got.numpy(), rec[f"{name}/out"],
                                       **TOL)
        for name in DECODE_RECORD:
            got = tops.decode_attention(
                *(torch.from_numpy(rec[f"{name}/{n}"])
                  for n in ("q", "k", "v", "slot_pos", "pos")),
                window=int(rec[f"{name}/window"]),
                softcap=float(rec[f"{name}/softcap"]))
            np.testing.assert_allclose(got.numpy(), rec[f"{name}/out"],
                                       **TOL)


if __name__ == "__main__":
    record = jax_record()
    np.savez_compressed(JAX_RECORD, **record)
    print(f"wrote {JAX_RECORD} ({len(record)} arrays, "
          f"{JAX_RECORD.stat().st_size} bytes)")
