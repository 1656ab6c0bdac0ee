"""The slice as a whole: the port's learner step against the JAX learner
step on rollouts made by the JAX DeviceSource (minatar net, Catch, T=8,
B=4), from the same weights. Loss, every metric and the updated params
must agree at 1e-5 after 1 step and after 3 steps on a fixed batch
sequence, for both V-trace implementations. Also the IMPALA loss itself,
with its gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.atari_impala import small_train as jsmall_train
from repro.core import learner as jlearner
from repro.core import losses as jlosses
from repro.core.sources import DeviceSource as JDeviceSource
from repro.envs import catch as jcatch
from repro.models.convnet import init_agent, minatar_net as jminatar
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch import convert
from repro_torch.configs.atari_impala import small_train as tsmall_train
from repro_torch.core import learner as tlearner
from repro_torch.core import losses as tlosses
from repro_torch.models.convnet import minatar_net as tminatar
from repro_torch.optim import make_optimizer as tmake_optimizer

# The suite runs several test processes side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

T, B = 8, 4
CFG = dict(unroll_length=T, batch_size=B, learning_rate=5e-3,
           total_steps=10)


@pytest.fixture(scope="module")
def jax_setup():
    env = jcatch.make()
    init_fn, apply_fn = jminatar(env.obs_shape, env.num_actions)
    params, _ = init_agent(init_fn, jax.random.PRNGKey(0))
    source = JDeviceSource.for_env(env, apply_fn, unroll_length=T,
                                   batch_size=B, key=jax.random.PRNGKey(1),
                                   pipelined=False)
    batches = [source.next_batch(params) for _ in range(3)]
    return env, apply_fn, params, batches


def _to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _assert_metrics_close(tm, jm, step):
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"{k} after step {step}")


@pytest.mark.parametrize("impl", ["kernel", "scan"])
def test_train_steps_match_jax(jax_setup, impl):
    env, apply_fn, params, batches = jax_setup
    jcfg, tcfg = jsmall_train(**CFG), tsmall_train(**CFG)
    jopt, topt = jmake_optimizer(jcfg), tmake_optimizer(tcfg)
    jstep = jax.jit(jlearner.make_train_step(apply_fn, jopt, jcfg,
                                             vtrace_impl=impl))
    tstep = tlearner.make_train_step(topt, tcfg, vtrace_impl=impl)

    model = tminatar(env.obs_shape, env.num_actions)
    model.load_state_dict(convert.state_dict_from_jax(params))
    jparams, jstate = params, jopt.init(params)
    tstate = topt.init(list(model.parameters()))
    for step, batch in enumerate(batches):
        jparams, jstate, jm = jstep(jparams, jstate, jnp.int32(step), batch)
        model, tstate, tm = tstep(model, tstate, step, _to_torch(batch))
        if step in (0, 2):          # after 1 step and after 3 steps
            _assert_metrics_close(tm, jm, step + 1)
            got = convert.state_dict_to_jax(model.state_dict())
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jparams)):
                np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                           atol=1e-5)
    # the step moved the weights (the comparison is not of the init)
    moved = convert.state_dict_to_jax(model.state_dict())
    assert not np.allclose(moved["policy"]["w"],
                           np.asarray(params["policy"]["w"]))


@pytest.mark.parametrize("impl", ["kernel", "scan"])
def test_impala_loss_and_grads_match_jax(impl):
    rng = np.random.default_rng(2)
    t, b, a = 7, 5, 4
    target = rng.normal(0, 1, (t, b, a)).astype(np.float32)
    behavior = rng.normal(0, 1, (t, b, a)).astype(np.float32)
    actions = rng.integers(0, a, (t, b)).astype(np.int32)
    rewards = rng.normal(0, 1, (t, b)).astype(np.float32)
    discounts = ((rng.random((t, b)) > 0.1) * 0.99).astype(np.float32)
    values = rng.normal(0, 1, (t, b)).astype(np.float32)
    boot = rng.normal(0, 1, (b,)).astype(np.float32)
    kw = dict(baseline_cost=0.5, entropy_cost=0.01, vtrace_impl=impl)

    def jloss(tl, v):
        out = jlosses.impala_loss_from_logits(
            tl, jnp.asarray(behavior), jnp.asarray(actions),
            jnp.asarray(rewards), jnp.asarray(discounts), v,
            jnp.asarray(boot), **kw)
        return out.total, out

    (jg_t, jg_v), jout = jax.grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(target), jnp.asarray(values))
    tl = torch.tensor(target, requires_grad=True)
    tv = torch.tensor(values, requires_grad=True)
    tout = tlosses.impala_loss_from_logits(
        tl, torch.from_numpy(behavior), torch.from_numpy(actions),
        torch.from_numpy(rewards), torch.from_numpy(discounts), tv,
        torch.from_numpy(boot), **kw)
    tout.total.backward()
    for name in tlosses.ImpalaLossOutput._fields:
        np.testing.assert_allclose(
            getattr(tout, name).detach().numpy(),
            np.asarray(getattr(jout, name)), rtol=1e-5, atol=1e-5,
            err_msg=name)
    np.testing.assert_allclose(tl.grad.numpy(), jg_t, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.grad.numpy(), jg_v, rtol=1e-5, atol=1e-5)
