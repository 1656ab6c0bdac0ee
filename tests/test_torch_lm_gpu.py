"""The LM learner steps on the card: one step of the reduced ``qwen3-4b``
IMPALA learner (``make_lm_train_step``) and of the reduced
``zamba2-2.7b`` pretraining step (S = 32: two SSD chunks, the state
carried between them) through the kernel paths — flash attention and
the SSD chunk kernel under autograd, the V-trace kernel — against the same
step through the plain paths, from the same weights, in float32: the loss,
every metric and every parameter's gradient within 1e-5 (the step runs
SGD at lr 1, so a parameter's change is its gradient), with remat on as
in the published configs. Then ``--mode lm-rl`` through the entry point,
whose episodes decode on the decode-attention kernel. This file imports
no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_lm_gpu.py

Without a GPU every case skips."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.configs.base import TrainConfig
from repro_torch.core import learner, sources
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.models import model as tmodel
from repro_torch.optim import sgd

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda")


def _run(arch, impls, make_step, batch, device):
    """One step from seed-0 weights; returns (metrics, {name: grad},
    kernel launches)."""
    cfg = dataclasses.replace(tconfigs.get_reduced_config(arch),
                              remat=True, **impls)
    params = tmodel.init(cfg, seed=0, device=device)
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    opt = sgd(1.0)
    ops.reset_stats()
    _, _, metrics = make_step(cfg, opt)(params, opt.init([]), 0, batch)
    torch.cuda.synchronize()
    grads = {n: before[n] - p.detach() for n, p in params.named_parameters()}
    return metrics, grads, ops.stats()


def _assert_close(kernel, plain):
    (km, kg, _), (pm, pg, _) = kernel, plain
    assert set(km) == set(pm)
    for k in pm:
        np.testing.assert_allclose(km[k].cpu().numpy(), pm[k].cpu().numpy(),
                                   err_msg=k, **TOL)
    for n in pg:
        assert torch.isfinite(kg[n]).all(), n
        np.testing.assert_allclose(kg[n].cpu().numpy(), pg[n].cpu().numpy(),
                                   err_msg=n, **TOL)


@pytest.mark.gpu
def test_lm_rl_learner_step_kernel_paths_match_plain(cuda_device):
    t, b = 16, 4
    rng = np.random.default_rng(0)
    obs = torch.tensor(rng.integers(0, 512, (t + 1, b)), dtype=torch.int32,
                       device=cuda_device)
    done = torch.zeros((t, b), dtype=torch.bool, device=cuda_device)
    done[-1] = True
    rollout = {"obs": obs, "action": obs[1:], "done": done,
               "reward": sources.token_task_reward(obs.T, 512).T,
               "behavior_logprob": torch.tensor(
                   -np.log(512) + rng.normal(0, 0.1, (t, b)),
                   dtype=torch.float32, device=cuda_device)}
    tc = TrainConfig(entropy_cost=0.003)

    def make_step(vtrace):
        return lambda cfg, opt: sources.lm_rl_step_from_rollout(
            learner.make_lm_train_step(cfg, opt, tc, loss_chunk=8,
                                       vtrace_impl=vtrace))

    kernel = _run("qwen3-4b", dict(attn_impl="kernel"), make_step("kernel"),
                  rollout, cuda_device)
    plain = _run("qwen3-4b", dict(attn_impl="xla"), make_step("scan"),
                 rollout, cuda_device)
    _assert_close(kernel, plain)
    # two layers, each forward and remat's recomputation; one V-trace
    assert kernel[2]["flash_attention"] == 4 and kernel[2]["vtrace"] == 1
    assert sum(plain[2].values()) == 0


@pytest.mark.gpu
def test_lm_pretrain_step_kernel_paths_match_plain(cuda_device):
    tokens = torch.tensor(np.random.default_rng(1).integers(0, 512, (2, 33)),
                          device=cuda_device)

    def make_step(cfg, opt):
        return learner.make_lm_pretrain_step(cfg, opt, loss_chunk=16)

    kernel = _run("zamba2-2.7b", dict(attn_impl="kernel", ssd_impl="kernel"),
                  make_step, {"tokens": tokens}, cuda_device)
    plain = _run("zamba2-2.7b", dict(attn_impl="xla", ssd_impl="xla"),
                 make_step, {"tokens": tokens}, cuda_device)
    _assert_close(kernel, plain)
    assert kernel[2]["ssd_chunk"] > 0 and kernel[2]["flash_attention"] > 0
    assert sum(plain[2].values()) == 0


@pytest.mark.gpu
def test_lm_rl_entry_point_runs_every_kernel(cuda_device):
    del cuda_device
    ops.reset_stats()
    runtime = train.main(["--mode", "lm-rl", "--arch", "qwen3-4b",
                          "--reduced", "--attn-impl", "kernel", "--steps",
                          "2", "--batch", "4", "--seq", "16"])
    launches = ops.stats()
    assert all(np.isfinite(float(v)) for v in runtime.metrics.values())
    assert launches["vtrace"] == 2
    # two layers, in each episode's prefill and each learner step
    assert launches["flash_attention"] == 2 * 2 * 2
    assert launches["decode_attention"] == 2 * 2 * 15
