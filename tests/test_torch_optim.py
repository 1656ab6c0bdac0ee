"""The port's hand-written optimizers, clip and schedules against the JAX
reference: N=5 steps on identical gradients at 1e-6; and the per-leaf
``step`` bitwise against the update rules as first written."""

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
        tstate = to.step([torch.tensor(grads[k]) for k in keys], tstate,
                         tparams, step)
        for k, p in zip(keys, tparams):
            np.testing.assert_allclose(p.numpy(), jparams[k], rtol=1e-6,
                                       atol=1e-6, err_msg=f"{k} step {step}")


# The optimizers' update rules as they were written before ``step``
# existed (a model-sized list of clipped gradients, then one of updates,
# then ``apply_updates``): the oracle the per-leaf path is held to,
# bitwise.
def _before_update(name, lr, grad_clip, decay=0.99, eps=0.01, momentum=0.0,
                   b1=0.9, b2=0.95, adam_eps=1e-8, weight_decay=0.0):
    def update(grads, state, params, step):
        if grad_clip:
            norm = topt.global_norm(grads)
            scale = torch.clamp(grad_clip / torch.clamp(norm, min=1e-9),
                                max=1.0)
            grads = [g * scale for g in grads]
        lr_t = lr(step)
        if name == "rmsprop":
            grads = [g.float() for g in grads]
            scaled = []
            for m, g in zip(state["ms"], grads):
                m.mul_(decay).add_((1 - decay) * g * g)
                scaled.append(g * torch.rsqrt(m + eps))
            if momentum:
                for mo, s in zip(state["mom"], scaled):
                    mo.mul_(momentum).add_(s)
                scaled = state["mom"]
            return [-lr_t * s for s in scaled]
        if name == "adamw":
            t = float(step) + 1.0
            updates = []
            for mu, nu, g, p in zip(state["mu"], state["nu"], grads, params):
                g = g.float()
                mu.mul_(b1).add_((1 - b1) * g)
                nu.mul_(b2).add_((1 - b2) * g * g)
                mu_hat = mu / (1 - b1 ** t)
                nu_hat = nu / (1 - b2 ** t)
                updates.append(-lr_t * (mu_hat / (torch.sqrt(nu_hat)
                                                  + adam_eps)
                                        + weight_decay * p.detach().float()))
            return updates
        if momentum:
            for m, g in zip(state["mom"], grads):
                m.mul_(momentum).add_(g)
            return [-lr_t * m for m in state["mom"]]
        return [-lr_t * g for g in grads]

    def apply(grads, state, params, step):
        with torch.no_grad():
            for p, u in zip(params, update(grads, state, params, step)):
                p.add_(u.to(p.dtype))

    return apply


@pytest.mark.parametrize("name,kwargs", [
    ("rmsprop", dict(grad_clip=3.0)),
    ("rmsprop", dict(momentum=0.9, grad_clip=3.0)),
    ("adamw", dict(weight_decay=0.1, grad_clip=3.0)),
    ("adamw", dict(grad_clip=1.0)),
    ("sgd", dict(momentum=0.9, grad_clip=3.0)),
])
def test_per_leaf_step_is_bitwise_the_update_before_it(name, kwargs):
    """``opt.step`` (clip in place, each leaf's update computed, applied
    and dropped before the next) ends bitwise where the rules as first
    written end (``update`` + ``apply_updates``): the learners' arithmetic
    did not change when their peak memory did."""
    sched = tsched.linear_anneal(1e-2, 8)
    opt = {"rmsprop": topt.rmsprop, "adamw": topt.adamw,
           "sgd": topt.sgd}[name](sched, **kwargs)
    oracle = _before_update(name, sched, **kwargs)
    rng = np.random.default_rng(3)
    init = [rng.normal(0, 1, s).astype(np.float32)
            for s in SHAPES.values()]
    runs = {k: [torch.tensor(v) for v in init] for k in ("before", "step")}
    states = {k: opt.init(runs[k]) for k in runs}
    for step in range(N_STEPS):
        scale = 2.0 if step % 2 else 0.3      # some steps clip, some not
        grads = [(scale * rng.normal(0, 1, s)).astype(np.float32)
                 for s in SHAPES.values()]
        # the last leaf's gradient is a broadcast (as a bias's can be): the
        # clip replaces it in the list instead of writing through it
        grads[-1] = np.broadcast_to(grads[-1][:1], grads[-1].shape)
        oracle([torch.tensor(g) for g in grads], states["before"],
               runs["before"], step)
        owned = [torch.tensor(g) for g in grads[:-1]] + [
            torch.tensor(grads[-1][:1]).expand(grads[-1].shape)]
        opt.step(owned, states["step"], runs["step"], step)
        assert all(g is None for g in owned)
        for a, b in zip(runs["step"], runs["before"]):
            assert torch.equal(a, b), step
        for key in states["before"]:
            for a, b in zip(states["step"][key], states["before"][key]):
                assert torch.equal(a, b), (key, step)


def test_rmsprop_eps_inside_the_root():
    """One RMSProp step is -lr * g / sqrt(0.01 g^2 + eps), eps inside."""
    opt = topt.rmsprop(0.5, decay=0.99, eps=0.01, grad_clip=None)
    p = [torch.zeros(1)]
    opt.step([torch.tensor([2.0])], opt.init(p), p, 0)
    want = -0.5 * 2.0 / np.sqrt(0.01 * 4.0 + 0.01)
    np.testing.assert_allclose(p[0].numpy(), [want], rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(1)
    grads = {k: rng.normal(0, 1, s).astype(np.float32)
             for k, s in SHAPES.items()}
    keys = sorted(grads)
    jclipped, jnorm = jopt.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in grads.items()}, max_norm)
    tclipped = [torch.tensor(grads[k]) for k in keys]
    tnorm = topt.clip_by_global_norm_(tclipped, max_norm)
    np.testing.assert_allclose(tnorm.item(), float(jnorm), rtol=1e-6)
    for k, g in zip(keys, tclipped):
        np.testing.assert_allclose(g.numpy(), jclipped[k], rtol=1e-6,
                                   atol=1e-7)
    zeros = [torch.zeros(3)]
    topt.clip_by_global_norm_(zeros, 1.0)
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
