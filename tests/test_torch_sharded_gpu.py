"""Data-parallel learning on the card: at world size 1 through NCCL the
data-parallel learner is bitwise the plain learner (losses, params and
optimizer state) with one V-trace kernel launch a step, at a small width
(Catch, the minatar agent, T 10, B 8, cuDNN pinned deterministic); and
``--mesh-data 1`` trains through the entry point with a launch a step.
This file imports no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_sharded_gpu.py

Without a GPU every case skips."""

import numpy as np
import pytest
import torch

from repro_torch.configs.atari_impala import small_train
from repro_torch.core import learner as learner_lib
from repro_torch.envs import catch
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train
from repro_torch.models.convnet import minatar_net
from repro_torch.optim import make_optimizer

pytestmark = pytest.mark.gpu

T, B, STEPS = 10, 8, 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    yield torch.device("cuda", 0)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        flags


def _batches(device):
    env = catch.make()
    rng = np.random.default_rng(0)
    return [{k: torch.from_numpy(v).to(device) for k, v in {
        "obs": rng.random((T + 1, B) + env.obs_shape, dtype=np.float32),
        "action": rng.integers(0, env.num_actions, (T, B)).astype(np.int32),
        "behavior_logits": rng.normal(
            0, 1, (T, B, env.num_actions)).astype(np.float32),
        "reward": rng.normal(0, 1, (T, B)).astype(np.float32),
        "done": rng.random((T, B)) > 0.9}.items()} for _ in range(STEPS)]


def _run(device, mesh):
    env = catch.make()
    agent = minatar_net(env.obs_shape, env.num_actions,
                        generator=torch.Generator().manual_seed(0)).to(device)
    # a clip that engages: its global norm is a reduction over the
    # all-reduced gradients, which must sum as the plain path's do
    tc = small_train(unroll_length=T, batch_size=B, total_steps=50,
                     grad_clip=0.5)
    opt = make_optimizer(tc)
    step = learner_lib.make_train_step(opt, tc, mesh=mesh)
    opt_state = opt.init(list(agent.parameters()))
    losses = []
    for s, batch in enumerate(_batches(device)):
        agent, opt_state, m = step(agent, opt_state, s, batch)
        losses.append(float(m["loss"]))
    return losses, agent.state_dict(), opt_state


def test_world1_nccl_step_bitwise_plain_step(cuda_device):
    plain = _run(cuda_device, None)
    with mesh_lib.make_data_mesh(1, cuda_device, port=mesh_lib.free_port(),
                                 timeout_s=60) as mesh:
        assert mesh.backend == "nccl"
        before = ops.stats()["vtrace"]
        dp = _run(cuda_device, mesh)
        launches = ops.stats()["vtrace"] - before
    assert launches == STEPS
    assert dp[0] == plain[0]
    for k in plain[1]:
        assert torch.equal(dp[1][k], plain[1][k]), k
    for key in plain[2]:
        for a, b in zip(dp[2][key], plain[2][key]):
            assert torch.equal(a, b), key


def test_cli_mesh_data_1_trains_through_the_kernel(cuda_device):
    before = ops.stats()["vtrace"]
    runtime = train.main(["--mesh-data", "1", "--steps", "3", "--batch",
                          "8"])
    assert ops.stats()["vtrace"] - before == 3
    assert runtime.mesh.size == 1 and runtime.mesh.backend == "nccl"
    assert np.isfinite(float(runtime.metrics["loss"]))
