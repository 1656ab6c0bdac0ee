"""The reduced xLSTM and the reduced VLM on the card against their CPU
runs, from the same seed-0 weights, in float32: the forward's logits and
baseline, a prefill and decode steps (the xLSTM's float32 states in the
cache; the VLM's vision k/v), and for the VLM the kernel path (flash
attention in its self-attention layer, decode attention at every step,
the cross-attention layer plain) with its launches counted; then one
xLSTM lm-rl learner step on the V-trace kernel against the CPU step's
gradients. Tolerance 1e-4: float32 sums in another order on the card.
This file imports no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_xlstm_gpu.py

Without a GPU every case skips."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.configs.base import TrainConfig
from repro_torch.core import generate, learner, sources
from repro_torch.kernels import ops
from repro_torch.models import model as tmodel
from repro_torch.optim import sgd

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda")


def _both(arch, **over):
    cfg = dataclasses.replace(tconfigs.get_reduced_config(arch), **over)
    cpu = tmodel.init(cfg, seed=0)
    gpu = tmodel.init(cfg, seed=0, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    return cfg, cpu, gpu


def _inputs(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
    vision = (torch.from_numpy(rng.normal(
        0, 1, (b, cfg.vision_seq, cfg.d_model)).astype(np.float32))
        if cfg.vision_seq else None)
    return tokens, vision


def _cuda(x):
    return None if x is None else x.cuda()


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL,
                               err_msg=msg)


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["xla", "kernel"])
@pytest.mark.parametrize("arch", ["xlstm-125m", "llama-3.2-vision-90b"])
def test_forward_prefill_decode_on_the_card_match_the_cpu(cuda_device,
                                                          arch, impl):
    cfg, cpu, gpu = _both(arch, attn_impl=impl)
    p, n = 32, 6
    tokens, vision = _inputs(cfg, 2, p + n)
    runs = {}
    ops.reset_stats()
    for name, params, dev in (("cpu", cpu, lambda x: x), ("gpu", gpu, _cuda)):
        with torch.no_grad():
            logits, base, _ = tmodel.apply_lm(params, dev(tokens[:, :p]),
                                              cfg=cfg, vision=dev(vision))
            _, _, cache = tmodel.prefill(params, dev(tokens[:, :p]), cfg=cfg,
                                         vision=dev(vision),
                                         cache_seq_len=p + n)
            steps = []
            for t in range(p, p + n):
                lg, _, cache = tmodel.serve_step(
                    params, dev(tokens[:, t:t + 1]), cache, t, cfg=cfg)
                steps.append(lg)
        runs[name] = (logits, base, cache, torch.cat(steps, 1))
    torch.cuda.synchronize()
    launches = ops.stats()
    (cl, cb, cc, cs), (gl, gb, gc, gs) = runs["cpu"], runs["gpu"]
    _close(gl, cl, "logits")
    _close(gb, cb, "baseline")
    _close(gs, cs, "decode logits")
    for layer, leaves in cc["block"].items():
        for key, want in leaves.items():
            got = gc["block"][layer][key]
            assert got.dtype == want.dtype, (layer, key)
            _close(got, want, f"{layer}/{key}")
    attn = sum(m == "attn" for m, _ in cfg.block_pattern) * cfg.num_groups
    on = impl == "kernel"
    assert launches == {"vtrace": 0, "ssd_chunk": 0,
                        "flash_attention": 2 * attn if on else 0,
                        "decode_attention": n * attn if on else 0}


@pytest.mark.gpu
def test_vlm_generate_on_the_card(cuda_device):
    """``generate(vision=)`` on the kernel path: finite outputs of the
    reference's shapes, one flash-attention launch per self-attention
    layer (the prefill) and one decode-attention launch per such layer a
    step; the cross-attention layer launches neither."""
    cfg, _, gpu = _both("llama-3.2-vision-90b", attn_impl="kernel")
    prompt, vision = _inputs(cfg, 2, 12, seed=1)
    ops.reset_stats()
    out = generate.generate(gpu, prompt, 3, cfg=cfg, num_steps=8,
                            vision=vision.cuda())
    torch.cuda.synchronize()
    attn = sum(m == "attn" for m, _ in cfg.block_pattern) * cfg.num_groups
    assert ops.stats() == {"vtrace": 0, "ssd_chunk": 0,
                           "flash_attention": attn,
                           "decode_attention": 7 * attn}
    assert out["tokens"].shape == (2, 20)
    for key in ("logprob", "entropy", "baseline"):
        assert out[key].shape == (2, 8)
        assert bool(torch.isfinite(out[key]).all()), key


@pytest.mark.gpu
def test_xlstm_lm_rl_step_on_the_card_matches_the_cpu(cuda_device):
    """One lm-rl learner step (SGD at lr 1: a parameter's change is its
    gradient), V-trace on the kernel on the card and the plain loop on
    the CPU: metrics and every gradient within 1e-4, one K1 launch."""
    train_cfg = TrainConfig(entropy_cost=0.003)
    cfg, cpu, gpu = _both("xlstm-125m", remat=True)
    t, b = 16, 4
    tokens, _ = _inputs(cfg, b, t + 1, seed=2)
    rng = np.random.default_rng(3)
    rollout = {"obs": tokens.T.int(), "action": tokens.T[1:].int(),
               "behavior_logprob": torch.from_numpy(
                   (-np.log(cfg.vocab_size)
                    + rng.normal(0, 0.1, (t, b))).astype(np.float32)),
               "reward": sources.token_task_reward(tokens,
                                                   cfg.vocab_size).T,
               "done": torch.zeros((t, b), dtype=torch.bool)}
    rollout["done"][-1] = True
    runs = {}
    for name, params, vtrace, dev in (
            ("cpu", cpu, "scan", lambda x: x),
            ("gpu", gpu, "kernel", lambda x: x.cuda())):
        before = {k: p.detach().clone() for k, p in params.named_parameters()}
        opt = sgd(1.0)
        step = sources.lm_rl_step_from_rollout(learner.make_lm_train_step(
            cfg, opt, train_cfg, loss_chunk=t, vtrace_impl=vtrace))
        ops.reset_stats()
        _, _, metrics = step(params, opt.init([]), 0,
                             {k: dev(v) for k, v in rollout.items()})
        runs[name] = (metrics, {k: before[k] - p.detach()
                                for k, p in params.named_parameters()},
                      ops.stats())
    (cm, cg, _), (gm, gg, launches) = runs["cpu"], runs["gpu"]
    assert launches["vtrace"] == 1 and not launches["flash_attention"]
    for key in cm:
        _close(gm[key], cm[key], key)
    for key in cg:
        scale = max(float(cg[key].abs().max()), 1.0)
        np.testing.assert_allclose(gg[key].cpu().numpy(), cg[key].numpy(),
                                   rtol=1e-4, atol=1e-4 * scale, err_msg=key)
