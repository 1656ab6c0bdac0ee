"""The port's hand-written optimizers, clip and schedules against the JAX
reference: N=5 update steps on identical gradients at 1e-6."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch.configs.base import TrainConfig as TTrainConfig
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched

# The suite runs several test processes side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

SHAPES = {"conv": (3, 3, 2, 4), "fc": (6, 5), "bias": (5,)}
N_STEPS = 5


def _opts(name):
    sched_j = jsched.linear_anneal(1e-2, 8)
    sched_t = tsched.linear_anneal(1e-2, 8)
    return {
        "rmsprop": (jopt.rmsprop(sched_j, grad_clip=3.0),
                    topt.rmsprop(sched_t, grad_clip=3.0)),
        "rmsprop_momentum": (
            jopt.rmsprop(sched_j, momentum=0.9, grad_clip=3.0),
            topt.rmsprop(sched_t, momentum=0.9, grad_clip=3.0)),
        "adamw": (jopt.adamw(sched_j, weight_decay=0.1, grad_clip=3.0),
                  topt.adamw(sched_t, weight_decay=0.1, grad_clip=3.0)),
        "sgd": (jopt.sgd(1e-2, grad_clip=3.0), topt.sgd(1e-2, grad_clip=3.0)),
        "sgd_momentum": (jopt.sgd(1e-2, momentum=0.9),
                         topt.sgd(1e-2, momentum=0.9)),
    }[name]


@pytest.mark.parametrize("name", ["rmsprop", "rmsprop_momentum", "adamw",
                                  "sgd", "sgd_momentum"])
def test_updates_match_jax(name):
    jo, to = _opts(name)
    rng = np.random.default_rng(0)
    init = {k: rng.normal(0, 1, s).astype(np.float32)
            for k, s in SHAPES.items()}
    keys = sorted(init)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    tparams = [torch.tensor(init[k]) for k in keys]
    jstate, tstate = jo.init(jparams), to.init(tparams)
    for step in range(N_STEPS):
        # some steps exceed the clip norm, some do not
        scale = 2.0 if step % 2 else 0.3
        grads = {k: (scale * rng.normal(0, 1, s)).astype(np.float32)
                 for k, s in SHAPES.items()}
        jup, jstate = jo.update({k: jnp.asarray(v) for k, v in grads.items()},
                                jstate, jparams, jnp.int32(step))
        jparams = jopt.apply_updates(jparams, jup)
        tup, tstate = to.update([torch.tensor(grads[k]) for k in keys],
                                tstate, tparams, step)
        topt.apply_updates(tparams, tup)
        for k, p in zip(keys, tparams):
            np.testing.assert_allclose(p.numpy(), jparams[k], rtol=1e-6,
                                       atol=1e-6, err_msg=f"{k} step {step}")


def test_rmsprop_eps_inside_the_root():
    """One RMSProp step is -lr * g / sqrt(0.01 g^2 + eps), eps inside."""
    opt = topt.rmsprop(0.5, decay=0.99, eps=0.01, grad_clip=None)
    p = [torch.zeros(1)]
    g = torch.tensor([2.0])
    upd, _ = opt.update([g], opt.init(p), p, 0)
    want = -0.5 * 2.0 / np.sqrt(0.01 * 4.0 + 0.01)
    np.testing.assert_allclose(upd[0].numpy(), [want], rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(1)
    grads = {k: rng.normal(0, 1, s).astype(np.float32)
             for k, s in SHAPES.items()}
    keys = sorted(grads)
    jclipped, jnorm = jopt.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in grads.items()}, max_norm)
    tclipped, tnorm = topt.clip_by_global_norm(
        [torch.tensor(grads[k]) for k in keys], max_norm)
    np.testing.assert_allclose(tnorm.item(), float(jnorm), rtol=1e-6)
    for k, g in zip(keys, tclipped):
        np.testing.assert_allclose(g.numpy(), jclipped[k], rtol=1e-6,
                                   atol=1e-7)
    zeros, _ = topt.clip_by_global_norm([torch.zeros(3)], 1.0)
    assert torch.isfinite(zeros[0]).all()    # max(norm, 1e-9) guard


@pytest.mark.parametrize("kind,kwargs", [
    ("linear", dict(total_steps=100)),
    ("linear", dict(total_steps=100, warmup_steps=10)),
    ("cosine", dict(total_steps=100, warmup_steps=10)),
    ("constant", dict()),
])
def test_schedules_match_jax(kind, kwargs):
    jcfg = JTrainConfig(learning_rate=3e-3, lr_schedule=kind, **kwargs)
    tcfg = TTrainConfig(learning_rate=3e-3, lr_schedule=kind, **kwargs)
    jf, tf = jsched.make_schedule(jcfg), tsched.make_schedule(tcfg)
    for step in (0, 1, 5, 10, 37, 99, 100, 150):
        np.testing.assert_allclose(tf(step), float(jf(jnp.int32(step))),
                                   rtol=1e-6, atol=1e-12)


def test_train_configs_match_jax():
    """Field for field, the port's TrainConfig and Atari config are the
    reference's."""
    from repro.configs import atari_impala as jatari
    from repro_torch.configs import atari_impala as tatari
    assert [f.name for f in dataclasses.fields(TTrainConfig)] == \
        [f.name for f in dataclasses.fields(JTrainConfig)]
    assert dataclasses.asdict(tatari.TRAIN) == dataclasses.asdict(jatari.TRAIN)
    assert dataclasses.asdict(tatari.small_train(batch_size=4)) == \
        dataclasses.asdict(jatari.small_train(batch_size=4))
    assert (tatari.OBS_SHAPE, tatari.NUM_ACTIONS) == (jatari.OBS_SHAPE,
                                                      jatari.NUM_ACTIONS)
