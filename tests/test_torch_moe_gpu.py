"""The MoE decoder and the recurrent agent on the card, in float32:

* ``moe_apply`` on CUDA tensors against the same call on the CPU, from
  the same weights: the routing identical, output and aux within 1e-5 of
  the output's scale (tests/test_torch_moe.py's bar), dropless and
  dropping, at Granite's 32 experts top-8 on a narrow width;
* the reduced ``granite-moe-1b-a400m`` forward through the attention
  kernel against the plain path on the card, logits and aux within 1e-5,
  and one flash-attention launch per layer;
* the recurrent learner step (``make_recurrent_train_step``) on the card
  through the V-trace kernel against the plain loop: loss and metrics
  within 1e-5, one launch.

This file imports no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_moe_gpu.py

Without a GPU every case skips."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.configs.atari_impala import small_train
from repro_torch.core import learner
from repro_torch.core import rollout
from repro_torch.envs import catch
from repro_torch.kernels import ops
from repro_torch.models import model as tmodel
from repro_torch.models import moe
from repro_torch.models.convnet import minatar_lstm_net
from repro_torch.optim import make_optimizer

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda")


def _granite(**over):
    return dataclasses.replace(get_reduced_config("granite-moe-1b-a400m"),
                               **over)


@pytest.mark.gpu
@pytest.mark.parametrize("capacity", [4.0, 1.25])
def test_moe_apply_on_the_card_matches_the_cpu(cuda_device, capacity):
    cfg = _granite(num_experts=32, num_experts_per_tok=8, d_model=64,
                   moe_d_ff=32, capacity_factor=capacity)
    params = moe.moe_init(cfg, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    x = torch.from_numpy((0.25 * (rng.standard_normal((4, 256, 64))
                                  + rng.standard_normal(64))).astype(
        np.float32))
    routes = {}
    for device in ("cpu", cuda_device):
        p = params.to(device)
        with torch.no_grad():
            probs = torch.softmax(x.to(device).reshape(2, 512, 64)
                                  @ p["router"], dim=-1)
            routes[str(device)] = moe.route(probs, 8)[1].cpu()
            out, aux = moe.moe_apply(p, x.to(device), cfg)
        routes[str(device) + "_out"] = (out.cpu(), [a.cpu() for a in aux])
    assert torch.equal(routes["cpu"], routes[str(cuda_device)])
    (want, want_aux), (got, got_aux) = (routes["cpu_out"],
                                        routes[str(cuda_device) + "_out"])
    atol = TOL["atol"] * max(1.0, want.abs().max().item())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=atol)
    for g, w in zip(got_aux, want_aux):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


@pytest.mark.gpu
def test_granite_forward_kernel_path_matches_plain(cuda_device):
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, 512, (2, 64))).to(cuda_device)
    out = {}
    for impl in ("xla", "kernel"):
        cfg = _granite(attn_impl=impl)
        params = tmodel.init(cfg, seed=0, device=cuda_device)
        ops.reset_stats()
        with torch.no_grad():
            out[impl] = tmodel.apply_lm(params, tokens, cfg=cfg)
        torch.cuda.synchronize()
        out[impl + "_launches"] = ops.stats()["flash_attention"]
    assert out["kernel_launches"] == _granite().num_layers
    assert out["xla_launches"] == 0
    (kl, kb, kaux), (pl, pb, paux) = out["kernel"], out["xla"]
    np.testing.assert_allclose(kl.cpu().numpy(), pl.cpu().numpy(), **TOL)
    for g, w in zip(kaux, paux):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), **TOL)


@pytest.mark.gpu
def test_recurrent_learner_kernel_matches_scan_on_the_card(cuda_device):
    env = catch.make()
    tc = small_train(unroll_length=20, batch_size=32, total_steps=3)
    agent = minatar_lstm_net(env.obs_shape, env.num_actions).to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    env_state, obs = rollout.env_reset_batch(env, gen, 32, cuda_device)
    unroll = rollout.make_recurrent_unroll(env, 20)
    _, ro = unroll(agent, unroll.initial_carry(agent, env_state, obs), gen)
    metrics = {}
    for impl in ("scan", "kernel"):
        a = minatar_lstm_net(env.obs_shape, env.num_actions).to(cuda_device)
        opt = make_optimizer(tc)
        ops.reset_stats()
        _, _, metrics[impl] = learner.make_recurrent_train_step(
            opt, tc, vtrace_impl=impl)(a, opt.init(list(a.parameters())), 0,
                                       ro)
        torch.cuda.synchronize()
        assert ops.stats()["vtrace"] == (impl == "kernel")
    for k, v in metrics["scan"].items():
        np.testing.assert_allclose(metrics["kernel"][k].item(), v.item(),
                                   err_msg=k, **TOL)
