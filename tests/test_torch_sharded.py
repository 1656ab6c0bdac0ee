"""Data-parallel learning (``--mesh-data``) against the reference's sharded
learner (``tests/test_sharded.py``): Catch, the minatar agent from the JAX
params (``repro_torch.convert``), T 10, B 8.

* World size 1 (one in-process gloo rank): ``ShardedDeviceSource`` emits
  bitwise ``DeviceSource``'s stream, and 4 steps of sources + the
  data-parallel learner give bitwise the plain path's losses and params
  (the analogues of ``tests/test_sharded.py:81`` and ``:99``).
* Two gloo ranks on the CPU: per-step losses on seeded numpy batches
  match the reference's ``make_train_step(mesh=make_data_mesh(2))`` (run
  in a forced-2-device subprocess) at rtol 1e-5, atol 1e-6, and the
  ranks end with bitwise equal params.
* The host actors' split, the launcher's failure path and the CLI's
  errors.

Every multi-process case takes its port from ``conftest.free_port`` and
bounds every wait at ``JOIN_S``; the launcher destroys each rank's group.
This module's top level imports no JAX: spawned ranks import it to find
their worker functions.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.atari_impala import small_train
from repro_torch.core import learner as learner_lib
from repro_torch.core.sources import (DeviceSource, HostLoopSource,
                                      ShardedDeviceSource, check_rollout)
from repro_torch.distributed import sharding
from repro_torch.envs import catch
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train
from repro_torch.models.convnet import minatar_net
from repro_torch.optim import make_optimizer

torch.set_num_threads(1)

T, B = 10, 8
STEPS = 4
JOIN_S = 60.0     # every rendezvous, collective and join of a test
TC = dict(unroll_length=T, batch_size=B, total_steps=50)


def _port():
    from conftest import free_port
    return free_port()


def _jax_params():
    import jax

    from repro.models.convnet import init_agent
    from repro.models.convnet import minatar_net as jminatar
    env = catch.make()
    init_fn, _ = jminatar(env.obs_shape, env.num_actions)
    params, _ = init_agent(init_fn, jax.random.PRNGKey(0))
    return convert.state_dict_from_jax(params)


def _agent(state_dict):
    env = catch.make()
    agent = minatar_net(env.obs_shape, env.num_actions)
    agent.load_state_dict(state_dict)
    return env, agent


def _batches(seed=0, b=B):
    """Seeded numpy batches, the reference test's ``_fixed_batch``."""
    env = catch.make()
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        out.append({
            "obs": rng.random((T + 1, b) + env.obs_shape).astype(np.float32),
            "action": rng.integers(0, env.num_actions, (T, b)).astype(
                np.int32),
            "behavior_logits": rng.normal(
                0, 1, (T, b, env.num_actions)).astype(np.float32),
            "reward": rng.normal(0, 1, (T, b)).astype(np.float32),
            "done": rng.random((T, b)) > 0.9,
        })
    return out


@pytest.fixture
def mesh1():
    with mesh_lib.make_data_mesh(1, "cpu", port=_port(),
                                 timeout_s=JOIN_S) as mesh:
        yield mesh


# ---------------------------------------------------------------------------
# world size 1: bitwise the single-device path


def test_sharded_source_world1_bitwise_device_source(mesh1):
    env, agent = _agent(_jax_params())
    a = DeviceSource.for_env(env, agent, unroll_length=T, batch_size=B,
                             seed=3)
    b = ShardedDeviceSource.for_env(env, agent, unroll_length=T,
                                    batch_size=B, seed=3, mesh=mesh1)
    assert b.frames_per_batch == a.frames_per_batch == T * B
    for _ in range(3):
        ra, rb = a.next_batch(agent), b.next_batch(agent)
        check_rollout(rb, T, B)
        assert ra.keys() == rb.keys()
        for k in ra:
            assert torch.equal(ra[k], rb[k]), k


def test_world1_training_bitwise_plain_path(mesh1):
    """Sources + learner, 4 steps: the data-parallel path at world size 1
    == the plain path, bit for bit (losses and final params)."""
    params0 = _jax_params()
    # a clip that engages: its global norm is a reduction over the
    # all-reduced gradients, which must sum as the plain path's do
    tc = small_train(**TC, grad_clip=0.5)
    opt = make_optimizer(tc)

    def run(mesh):
        env, agent = _agent(params0)
        kw = dict(unroll_length=T, batch_size=B, seed=1, pipelined=True)
        source = DeviceSource.for_env(env, agent, **kw) if mesh is None \
            else ShardedDeviceSource.for_env(env, agent, mesh=mesh, **kw)
        step = learner_lib.make_train_step(opt, tc, mesh=mesh)
        opt_state = opt.init(list(agent.parameters()))
        losses = []
        for s in range(STEPS):
            agent, opt_state, m = step(agent, opt_state, s,
                                       source.next_batch(agent))
            losses.append(float(m["loss"]))
        source.stop()
        return losses, agent.state_dict()

    losses_a, params_a = run(None)
    losses_b, params_b = run(mesh1)
    assert losses_a == losses_b
    for k in params_a:
        assert torch.equal(params_a[k], params_b[k]), k


def test_world1_collectives_are_exact(mesh1):
    x = [torch.randn(3, 4), torch.randn(5)]
    for got, want in zip(sharding.replicate([t.clone() for t in x], mesh1),
                         x):
        assert torch.equal(got, want)
    m = sharding.mean_scalars({"a": torch.tensor(1.25), "p": torch.ones(3)},
                              mesh1, skip=("p",))
    assert float(m["a"]) == 1.25 and torch.equal(m["p"], torch.ones(3))
    batch = {"obs": torch.arange(24.).reshape(2, 4, 3),
             "is_replay": torch.arange(4) >= 2}
    assert all(torch.equal(v, batch[k])
               for k, v in sharding.shard_rollout(batch, mesh1).items())


# ---------------------------------------------------------------------------
# two ranks against the reference's mesh of two devices


_JAX_MESH2 = r"""
import json, sys
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec

from repro.configs.atari_impala import small_train
from repro.core import learner as L
from repro.envs import catch
from repro.launch.mesh import make_data_mesh
from repro.models.convnet import init_agent, minatar_net
from repro.optim import make_optimizer

jax.config.update("jax_default_matmul_precision", "highest")
data = np.load(sys.argv[1])
steps, T, B = int(data["steps"]), int(data["T"]), int(data["B"])
env = catch.make()
tc = small_train(unroll_length=T, batch_size=B, total_steps=50)
init_fn, apply_fn = minatar_net(env.obs_shape, env.num_actions)
params, _ = init_agent(init_fn, jax.random.PRNGKey(0))
opt = make_optimizer(tc)
mesh = make_data_mesh(2)
step = jax.jit(L.make_train_step(apply_fn, opt, tc, mesh=mesh))
params = jax.device_put(params, NamedSharding(mesh, PartitionSpec()))
opt_state = opt.init(params)
spec = lambda nd: NamedSharding(  # noqa: E731
    mesh, PartitionSpec(*([None, "data"] + [None] * (nd - 2))))
losses = []
for s in range(steps):
    batch = {k: jax.device_put(jnp.asarray(data[f"{s}/{k}"]),
                               spec(data[f"{s}/{k}"].ndim))
             for k in ("obs", "action", "behavior_logits", "reward", "done")}
    params, opt_state, m = step(params, opt_state, jnp.int32(s), batch)
    losses.append(float(m["loss"]))
print("LOSSES " + json.dumps(losses))
"""


def _parity_rank(mesh, params0, batches):
    _, agent = _agent(params0)
    tc = small_train(**TC)
    opt = make_optimizer(tc)
    step = learner_lib.make_train_step(opt, tc, mesh=mesh)
    opt_state = opt.init(list(agent.parameters()))
    losses = []
    for s, batch in enumerate(batches):
        agent, opt_state, m = step(agent, opt_state, s,
                                   sharding.shard_rollout(batch, mesh))
        losses.append(float(m["loss"]))
    return losses, sharding.gather_to_main(agent.state_dict(), mesh)


def test_two_ranks_match_jax_mesh2(tmp_path):
    from conftest import run_forced
    batches = _batches()
    path = tmp_path / "batches.npz"
    np.savez(path, steps=STEPS, T=T, B=B, **{
        f"{s}/{k}": v for s, b in enumerate(batches) for k, v in b.items()})
    proc = run_forced(["-c", _JAX_MESH2, str(path)], devices=2,
                      timeout=120)
    want = json.loads(proc.stdout.split("LOSSES ")[1])

    losses, params = mesh_lib.launch(
        _parity_rank, 2, device="cpu", args=(_jax_params(), batches),
        port=_port(), timeout_s=JOIN_S)
    np.testing.assert_allclose(losses, want, rtol=1e-5, atol=1e-6)
    for k in params[0]:
        assert torch.equal(params[0][k], params[1][k]), k


# ---------------------------------------------------------------------------
# the host actors' split, the launcher's failure path


def _host_rank(mesh):
    env = catch.make()
    agent = minatar_net(env.obs_shape, env.num_actions,
                        generator=torch.Generator().manual_seed(0))
    source = HostLoopSource(env, agent, num_actors=4, unroll_length=T,
                            batch_size=B, seed=5, mesh=mesh)
    try:
        for _ in range(2):
            check_rollout(source.next_batch(agent), T, B // mesh.size)
    finally:
        source.stop()
    return sharding.gather_to_main(
        (source.seed, source.frames_per_batch), mesh)


def test_host_actors_split_over_ranks():
    seeds = mesh_lib.launch(_host_rank, 2, device="cpu", port=_port(),
                            timeout_s=JOIN_S)
    assert seeds == [(5, T * B), (sharding.rank_seed(5, 1), T * B)]
    assert sharding.rank_seed(5, 1) != 5


def _failing_rank(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails")
    sharding.replicate([torch.ones(4)], mesh)   # never completes


def test_rank_failure_fails_the_launch():
    with pytest.raises(RuntimeError):
        mesh_lib.launch(_failing_rank, 2, device="cpu", port=_port(),
                        timeout_s=JOIN_S)


# ---------------------------------------------------------------------------
# the CLI


def test_cli_mesh2_runs_and_prints_from_rank0_only():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--mesh-data",
         "2", "--device", "cpu", "--steps", "6", "--batch", "8"],
        capture_output=True, text=True, timeout=JOIN_S,
        env={**os.environ, "PYTHONPATH": os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "src")})
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("step")]
    assert [int(ln.split()[1]) for ln in lines] == list(range(6))
    # frames are global: T x B = 20 x 8 a step
    assert lines[-1].split()[3] == str(6 * 20 * 8)


def test_cli_batch_not_divisible_by_mesh_raises():
    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        train.main(["--mesh-data", "3", "--device", "cpu", "--batch", "8",
                    "--steps", "2"])


def test_cli_mesh_errors():
    # CUDA is the default: without a GPU it raises, nothing falls back
    with pytest.raises(RuntimeError, match="CUDA requested"):
        train.main(["--mesh-data", "1", "--steps", "1"])
    with pytest.raises(ValueError, match="devices visible"):
        mesh_lib.rank_devices(torch.cuda.device_count() + 1, "cuda")
    # (the xLSTM under --mesh-model 2, once refused, trains now;
    # a model axis below 1 is what the LM modes refuse)
    with pytest.raises(SystemExit):
        train.main(["--mode", "lm", "--arch", "xlstm-125m", "--reduced",
                    "--mesh-data", "2", "--mesh-model", "-1", "--device",
                    "cpu"])
    with pytest.raises(SystemExit):
        train.main(["--mesh-model", "2", "--device", "cpu"])
