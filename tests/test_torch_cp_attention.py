"""Flash attention (K2) with queries offset from their keys, on the CPU:
the ``q_offset`` of ``kernels/ops.py::flash_attention``, its plain version
``kernels/ref.py::ref_flash_attention`` and the differentiable kernel path
``models/attention.py::_attend_flash_kernel``, which context-parallel
attention (``cp_fsdp_seqpar``) runs on each rank's share of the queries.

* Each split of the queries over M ranks, at offset rank·S/M against
  every key, equals the matching rows of the whole attention, for causal,
  windowed and softcapped attention and ragged lengths, and the whole
  attention equals the reference's JAX function (``repro.kernels.ref``)
  and its Pallas kernel in interpret mode, at the reference's bar.
* Under autograd, the splits' gradients sum to the whole attention's:
  dq row for row, dk and dv summed over the splits.
* The chunked plain path with ``skip`` visits only live key chunks of an
  offset query chunk, and agrees with the dense path.
* ``attn_apply(seq_shard=True)`` on two gloo ranks under
  ``cp_fsdp_seqpar``, with positions that start at 0 or later, gives each
  rank the rows of the whole layer's output, on every impl.
"""

import dataclasses


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs import get_reduced_config
from repro_torch.distributed import sharding
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import attention as TA
from repro_torch.models.common import use_rules

TOL = dict(rtol=2e-5, atol=2e-5)      # tests/test_kernels.py's float32 bar
SPLIT_TOL = dict(rtol=1e-6, atol=1e-6)

# b, h, kh, s, hd, window, softcap, causal
CASES = [
    (2, 4, 2, 128, 64, 0, 0.0, True),
    (1, 4, 2, 128, 64, 48, 0.0, True),       # window across the split
    (1, 4, 2, 96, 128, 0, 30.0, True),       # softcap
    (1, 8, 2, 192, 64, 0, 0.0, False),       # non-causal
    (1, 4, 4, 100, 80, 0, 0.0, True),        # ragged halves of 50
]


def _qkv(rng, b, h, kh, s, hd):
    return [rng.normal(0, 1, shape).astype(np.float32)
            for shape in ((b, h, s, hd), (b, kh, s, hd), (b, kh, s, hd))]


@pytest.mark.parametrize("b,h,kh,s,hd,win,cap,causal", CASES)
@pytest.mark.parametrize("parts", [2, 4])
def test_query_splits_equal_the_whole_attention(b, h, kh, s, hd, win, cap,
                                                causal, parts):
    q, k, v = map(torch.from_numpy,
                  _qkv(np.random.default_rng(s + hd), b, h, kh, s, hd))
    kw = dict(window=win, softcap=cap, causal=causal)
    whole = ops.flash_attention(q, k, v, **kw)
    np.testing.assert_allclose(
        whole.numpy(), jref.ref_flash_attention(
            *map(jnp.asarray, (q.numpy(), k.numpy(), v.numpy())), **kw),
        **TOL)
    rows = s // parts
    for rank in range(parts):
        off = rank * rows
        got = ops.flash_attention(q[:, :, off:off + rows], k, v, **kw,
                                  q_offset=off)
        assert got.shape == (b, h, rows, hd)
        np.testing.assert_allclose(got.numpy(),
                                   whole[:, :, off:off + rows].numpy(),
                                   **SPLIT_TOL, err_msg=f"rank {rank}")


def test_whole_attention_equals_the_pallas_kernel():
    q, k, v = _qkv(np.random.default_rng(7), 1, 4, 2, 128, 64)
    got = ref.ref_flash_attention(*map(torch.from_numpy, (q, k, v)),
                                  q_offset=0)
    pallas = jops.flash_attention(*map(jnp.asarray, (q, k, v)), block_q=64,
                                  block_k=64)
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)


@pytest.mark.parametrize("window", [0, 40])
def test_split_gradients_sum_to_the_whole(window):
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, 2, 4, 2, 64, 64))
    # the model's (B, S, H, hd) layout
    q, k, v = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    g = torch.from_numpy(rng.normal(0, 1, q.shape).astype(np.float32))
    kw = dict(scale=0.125, window=window, cap=0.0, chunk=16)

    def grads(splits):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        rows = q.shape[1] // splits
        outs = [TA._attend_flash_kernel(
            leaves[0][:, r * rows:(r + 1) * rows], leaves[1], leaves[2],
            q_offset=r * rows, **kw) for r in range(splits)]
        out = torch.cat(outs, dim=1)
        (out * g).sum().backward()
        return out.detach(), [x.grad for x in leaves]

    want_out, want = grads(1)
    for splits in (2, 4):
        out, got = grads(splits)
        np.testing.assert_allclose(out.numpy(), want_out.numpy(),
                                   **SPLIT_TOL)
        for name, a, b in zip("qkv", got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=f"d{name}")


def test_chunked_skip_at_an_offset_matches_dense():
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, 1, 4, 4, 128, 64))
    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    k_pos = torch.arange(128)
    for off, window in ((64, 0), (32, 0), (64, 24)):
        qs = q[:, off:off + 32]
        q_pos = off + torch.arange(32)
        dense = TA._attend_dense(qs, k, v, q_pos, k_pos, 0.125, window, 0.0,
                                 True)
        for skip in (False, True):
            got = TA._attend_chunked(qs, k, v, q_pos, k_pos, 0.125, window,
                                     0.0, True, 16, skip=skip, q_offset=off)
            np.testing.assert_allclose(got.numpy(), dense.numpy(),
                                       **SPLIT_TOL)



# ---------------------------------------------------------------------------
# the layer under cp_fsdp_seqpar, two ranks

CP_IMPLS = ("xla", "xla_chunked_skip", "kernel")
CP_KINDS = ("attn", "local_attn")
CP_STARTS = (0, 5)
CP_S = 16


def _cp_layer_rank(mesh):
    """Every (impl, kind, start)'s largest gap between this rank's
    sequence-sharded output and its rows of the whole layer's at positions
    ``arange(S)``: rotary attention reads only position differences, so
    a later start changes nothing beyond rounding, while a mask that read
    the keys at other positions than the queries would."""
    torch.set_num_threads(1)
    cfg = dataclasses.replace(get_reduced_config("qwen3-4b"),
                              sliding_window=6, attn_chunk=4)
    rows = CP_S // mesh.model
    off = mesh.model_index * rows
    gaps = {}
    for kind in CP_KINDS:
        params = TA.attn_init(cfg, kind, generator=torch.Generator()
                              .manual_seed(11))
        x = torch.from_numpy(np.random.default_rng(4).normal(
            0, 1, (2, CP_S, cfg.d_model)).astype(np.float32))
        for impl in CP_IMPLS:
            kw = dict(cfg=cfg, kind=kind, impl=impl)
            with torch.no_grad():
                whole, _ = TA.attn_apply(params, x, **kw,
                                         positions=torch.arange(CP_S))
            for start in CP_STARTS:
                with torch.no_grad(), use_rules(
                        mesh, sharding.rules_named("cp_fsdp_seqpar")):
                    part, _ = TA.attn_apply(
                        params, x[:, off:off + rows], seq_shard=True, **kw,
                        positions=start + torch.arange(CP_S))
                gaps[(impl, kind, start)] = float(
                    (part - whole[:, off:off + rows]).abs().max())
    return sharding.gather_to_main(gaps, mesh)


@pytest.fixture(scope="module")
def cp_layer_gaps():
    from conftest import free_port
    return mesh_lib.launch(_cp_layer_rank, 2, device="cpu", model=2,
                           port=free_port(), timeout_s=120.0)


@pytest.mark.parametrize("start", CP_STARTS)
@pytest.mark.parametrize("kind", CP_KINDS)
@pytest.mark.parametrize("impl", CP_IMPLS)
def test_seq_shard_layer_gives_the_whole_layers_rows(cp_layer_gaps, impl,
                                                     kind, start):
    for rank, gaps in enumerate(cp_layer_gaps):
        assert gaps[(impl, kind, start)] <= 1e-5, f"rank {rank}"
