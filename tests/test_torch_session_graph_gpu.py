"""The compiled decode step on the card (``core/generate.py::session_fns``)
against the eager ``_session_step`` from the same state, at reduced width
on the kernel paths: logits, baseline, every cache leaf, tokens,
log-probs and entropies bitwise for the dense, hybrid, MoE and xLSTM
decoders; one capture per key; decode-attention launches per replay
equal to an eager step's; weights updated in place read by the next
replay, another params module captured anew; ``generate`` (the VLM's
too) bitwise its eager loop, with one capture for two calls. This file
imports no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_session_graph_gpu.py

Without a GPU every case skips."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.core import generate as G
from repro_torch.kernels import ops
from repro_torch.models import model as model_lib
from repro_torch.tree import leaves

DECODERS = ["qwen3-4b", "zamba2-2.7b", "granite-moe-1b-a400m", "xlstm-125m"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda")


def _cfg(arch):
    return dataclasses.replace(get_reduced_config(arch), attn_impl="kernel",
                               ssd_impl="kernel")


def _clone(state):
    """A copy of a session state that shares nothing with it: tensors
    cloned, each generator at the same place of its stream."""
    def gen(g):
        out = torch.Generator(device=g.device)
        out.set_state(g.get_state())
        return out
    return {"cache": G.tree_map(torch.clone, state["cache"]),
            "pos": state["pos"].clone(), "last": state["last"].clone(),
            "temp": state["temp"].clone(),
            "gens": [gen(g) for g in state["gens"]],
            "active": state["active"].copy()}


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.uint8) if a.dtype.is_floating_point else a,
        b.view(torch.uint8) if b.dtype.is_floating_point else b)


def _admitted(cfg, params, slots=4, max_len=32):
    sess = G.DecodeSession(params, cfg, max_batch=slots, max_len=max_len)
    rng = np.random.default_rng(1)
    sess.prefill_many(range(slots), [rng.integers(0, cfg.vocab_size, n)
                                     for n in (3, 5, 8, 12)][:slots],
                      seeds=list(range(slots)))
    return sess


def _held_to_eager(fns, params, state, ref, cfg, steps):
    """``steps`` compiled steps of ``state`` against eager steps of
    ``ref``, bitwise; the decode-attention launches of each equal."""
    for _ in range(steps):
        before = ops.stats()["decode_attention"]
        lg, bg = fns.decode(params, state)
        lg = lg.clone()
        got = ops.stats()["decode_attention"] - before
        le, be = G._session_decode(params, ref, cfg=cfg)
        assert ops.stats()["decode_attention"] - before - got == got
        assert _same(lg, le)
        assert (bg is None and be is None) or _same(bg, be)
        for x, y in zip(leaves(state["cache"]), leaves(ref["cache"])):
            assert _same(x, y)
        _, og = G._session_advance(state, lg, bg)
        _, oe = G._session_advance(ref, le, be)
        for k in og:
            assert _same(og[k], oe[k]), k
        assert _same(state["pos"], ref["pos"])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", DECODERS)
def test_graph_step_is_bitwise_the_eager_step(cuda_device, arch):
    cfg = _cfg(arch)
    params = model_lib.init(cfg, seed=0, device="cuda")
    sess = _admitted(cfg, params)
    assert sess.compiled
    fns = G.session_fns(cfg)
    captures = fns.captures
    sess.evict(1)                    # an idle slot computes, frozen
    _held_to_eager(fns, params, sess._state, _clone(sess._state), cfg, 5)
    assert fns.captures == captures + 1
    # through the session's own entry point too
    ref = _clone(sess._state)
    got = sess.step()
    _, want = G._session_step(params, ref, cfg=cfg)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k].cpu().numpy())
    assert fns.captures == captures + 1


@pytest.mark.gpu
def test_replays_read_weights_updated_in_place_and_rekey_on_a_swap(
        cuda_device):
    cfg = _cfg("qwen3-4b")
    params = model_lib.init(cfg, seed=0, device="cuda")
    sess = _admitted(cfg, params)
    fns = G.session_fns(cfg)
    captures = fns.captures
    for _ in range(3):
        sess.step()
    assert fns.captures == captures + 1
    with torch.no_grad():
        for p in params.parameters():
            p.mul_(0.75)
    _held_to_eager(fns, params, sess._state, _clone(sess._state), cfg, 2)
    assert fns.captures == captures + 1
    other = model_lib.init(cfg, seed=1, device="cuda")
    sess.params = other
    _held_to_eager(fns, other, sess._state, _clone(sess._state), cfg, 3)
    assert fns.captures == captures + 2


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-4b", "llama-3.2-vision-90b"])
def test_generate_replays_one_graph_and_keeps_each_baseline(cuda_device,
                                                            arch):
    cfg = _cfg(arch)
    params = model_lib.init(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab_size, (2, 6))
    vision = (torch.from_numpy(rng.normal(0, 1, (
        2, cfg.vision_seq, cfg.d_model)).astype(np.float32)).cuda()
        if cfg.vision_seq else None)
    fns = G.session_fns(cfg)
    captures = fns.captures
    ops.reset_stats()
    outs = [G.generate(params, prompt, 4, cfg=cfg, num_steps=7,
                       vision=vision) for _ in range(2)]
    graph_launches = ops.stats()["decode_attention"]
    assert fns.captures == captures + 1
    # the eager loop from the prefill's own state
    gens = [torch.Generator(device="cuda").manual_seed(4 + i)
            for i in range(2)]
    temp = torch.ones((2,), device="cuda")
    ops.reset_stats()
    state, out = G._session_prefill(params, torch.as_tensor(prompt).cuda(),
                                    gens, temp, cfg=cfg, cache_seq_len=13,
                                    vision=vision)
    want = [out]
    for _ in range(6):
        state, out = G._session_step(params, state, cfg=cfg)
        want.append(out)
    assert graph_launches == 2 * ops.stats()["decode_attention"]
    for k in ("logprob", "entropy", "baseline"):
        stacked = torch.stack([o[k] for o in want], 1)
        for got in outs:
            assert _same(got[k], stacked), k
    assert len(set(outs[0]["baseline"][0].tolist())) > 1
