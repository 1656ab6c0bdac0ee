"""CLEAR (policy and value cloning on replayed columns) in the port against
the JAX reference, on the CPU, inputs from a numpy seed:

* ``clear_auxiliary_loss`` values and gradients against ``jax.grad``;
* ``impala_loss_from_logits`` with ``is_replay``, ``behavior_values`` and
  the CLEAR costs, every output and both gradients, for both V-trace
  implementations;
* one ``make_train_step`` on a mixed batch made by the reference's
  ``ReplaySource`` (with recorded ``behavior_value``), from the same
  weights: every metric — the fresh-only ``reward_per_step``, the 2B
  ``priority`` and the two CLEAR terms included — and the updated
  parameters, after 1 and after 3 steps.

All at 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.atari_impala import small_train as jsmall_train
from repro.core import learner as jlearner
from repro.core import losses as jlosses
from repro.core import replay as jreplay
from repro.core.sources import DeviceSource as JDeviceSource
from repro.core.sources import ReplaySource as JReplaySource
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

TOL = dict(rtol=1e-5, atol=1e-5)
T, B, A = 7, 6, 4


def _inputs(seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        target=rng.normal(0, 1, (T, B, A)).astype(f32),
        behavior=rng.normal(0, 1, (T, B, A)).astype(f32),
        actions=rng.integers(0, A, (T, B)).astype(np.int32),
        rewards=rng.normal(0, 1, (T, B)).astype(f32),
        discounts=((rng.random((T, B)) > 0.1) * 0.99).astype(f32),
        values=rng.normal(0, 1, (T, B)).astype(f32),
        behavior_values=rng.normal(0, 1, (T, B)).astype(f32),
        boot=rng.normal(0, 1, (B,)).astype(f32),
        is_replay=np.arange(B) >= B // 2)


MASKS = {"mixed": lambda m: m, "all_fresh": np.zeros_like,
         "all_replayed": np.ones_like}


@pytest.mark.parametrize("with_values", [True, False])
@pytest.mark.parametrize("mask", list(MASKS))
def test_clear_auxiliary_loss_matches_reference(mask, with_values):
    x = _inputs(1)
    is_replay = MASKS[mask](x["is_replay"]).astype(bool)
    bv = x["behavior_values"] if with_values else None

    def jfn(target, values):
        lp = jax.nn.log_softmax(target, -1)
        pc, vc = jlosses.clear_auxiliary_loss(
            lp, jnp.asarray(x["behavior"]), values,
            None if bv is None else jnp.asarray(bv), jnp.asarray(is_replay))
        return pc + 2.0 * vc, (pc, vc)

    (jg_t, jg_v), (jpc, jvc) = jax.grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x["target"]), jnp.asarray(x["values"]))
    tt = torch.tensor(x["target"], requires_grad=True)
    tv = torch.tensor(x["values"], requires_grad=True)
    pc, vc = tlosses.clear_auxiliary_loss(
        torch.log_softmax(tt, -1), torch.from_numpy(x["behavior"]), tv,
        None if bv is None else torch.from_numpy(bv),
        torch.from_numpy(is_replay))
    (pc + 2.0 * vc).backward()
    np.testing.assert_allclose(pc.item(), float(jpc), **TOL)
    np.testing.assert_allclose(vc.item(), float(jvc), **TOL)
    np.testing.assert_allclose(tt.grad.numpy(), jg_t, **TOL)
    # without recorded values the term ignores V: no gradient reaches it
    gv = tv.grad if with_values else torch.zeros_like(tv)
    assert with_values or tv.grad is None
    np.testing.assert_allclose(gv.numpy(), jg_v, **TOL)
    if mask == "all_fresh":                    # fresh rows contribute 0
        assert pc.item() == vc.item() == 0.0
    else:
        assert pc.item() > 0 and (vc.item() > 0) == with_values


def test_clear_loss_vanishes_where_the_policies_and_values_agree():
    x = _inputs(2)
    lp = torch.log_softmax(torch.from_numpy(x["target"]), -1)
    values = torch.from_numpy(x["values"])
    mask = torch.ones(B, dtype=torch.bool)
    # mu == pi -> policy cloning vanishes even on replayed rows
    pc, _ = tlosses.clear_auxiliary_loss(
        lp, torch.from_numpy(x["target"]), values, values, mask)
    assert pc.item() == pytest.approx(0.0, abs=1e-5)
    # value cloning is anchored on the RECORDED values
    _, vc = tlosses.clear_auxiliary_loss(
        lp, torch.from_numpy(x["behavior"]), values, values, mask)
    assert vc.item() == 0.0


@pytest.mark.parametrize("costs", [(0.01, 0.005), (0.5, 0.0), (0.0, 0.0)])
@pytest.mark.parametrize("impl", ["kernel", "scan"])
def test_impala_loss_with_clear_matches_reference(impl, costs):
    x = _inputs(3)
    kw = dict(baseline_cost=0.5, entropy_cost=0.01, vtrace_impl=impl,
              clear_policy_cost=costs[0], clear_value_cost=costs[1])

    def jloss(tl, v):
        out = jlosses.impala_loss_from_logits(
            tl, jnp.asarray(x["behavior"]), jnp.asarray(x["actions"]),
            jnp.asarray(x["rewards"]), jnp.asarray(x["discounts"]), v,
            jnp.asarray(x["boot"]), is_replay=jnp.asarray(x["is_replay"]),
            behavior_values=jnp.asarray(x["behavior_values"]), **kw)
        return out.total, out

    (jg_t, jg_v), jout = jax.grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x["target"]), jnp.asarray(x["values"]))
    tl = torch.tensor(x["target"], requires_grad=True)
    tv = torch.tensor(x["values"], requires_grad=True)
    tout = tlosses.impala_loss_from_logits(
        tl, torch.from_numpy(x["behavior"]), torch.from_numpy(x["actions"]),
        torch.from_numpy(x["rewards"]), torch.from_numpy(x["discounts"]),
        tv, torch.from_numpy(x["boot"]),
        is_replay=torch.from_numpy(x["is_replay"]),
        behavior_values=torch.from_numpy(x["behavior_values"]), **kw)
    tout.total.backward()
    assert tlosses.ImpalaLossOutput._fields == jout._fields
    for name in jout._fields:
        np.testing.assert_allclose(
            getattr(tout, name).detach().numpy(),
            np.asarray(getattr(jout, name)), err_msg=name, **TOL)
    np.testing.assert_allclose(tl.grad.numpy(), jg_t, **TOL)
    np.testing.assert_allclose(tv.grad.numpy(), jg_v, **TOL)
    if any(costs):
        assert tout.clear_policy_loss.item() > 0


# ---------------------------------------------------------------------------
# the learner step on a mixed batch

RT, RB = 8, 4
CFG = dict(unroll_length=RT, batch_size=RB, learning_rate=5e-3,
           total_steps=10, clear_policy_cost=0.01, clear_value_cost=0.005)


@pytest.fixture(scope="module")
def mixed_batches():
    """Three mixed batches (4 fresh + 4 replayed columns, elite replay,
    recorded behavior values) from the reference's ReplaySource over its
    DeviceSource on Catch."""
    env = jcatch.make()
    init_fn, apply_fn = jminatar(env.obs_shape, env.num_actions)
    params, _ = init_agent(init_fn, jax.random.PRNGKey(0))
    source = JReplaySource(
        JDeviceSource.for_env(env, apply_fn, unroll_length=RT,
                              batch_size=RB, key=jax.random.PRNGKey(1),
                              pipelined=False),
        jreplay.EliteReplay(16), replay_ratio=1.0, seed=0,
        value_fn=jax.jit(lambda p, obs: apply_fn(p, obs).baseline))
    batches = [dict(source.next_batch(params)) for _ in range(3)]
    for batch in batches:
        assert batch["is_replay"].shape == (2 * RB,)
        assert "behavior_value" in batch
    return env, apply_fn, params, batches


@pytest.mark.parametrize("impl", ["kernel", "scan"])
def test_mixed_batch_train_steps_match_reference(mixed_batches, impl):
    env, apply_fn, params, batches = mixed_batches
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
        tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
        model, tstate, tm = tstep(model, tstate, step, tbatch)
        assert set(tm) == set(jm)
        assert {"clear_policy_loss", "clear_value_loss"} <= set(tm)
        assert tm["priority"].shape == (2 * RB,)
        fresh = np.asarray(batch["reward"])[:, :RB].mean()
        np.testing.assert_allclose(tm["reward_per_step"].item(), fresh,
                                   **TOL)
        if step in (0, 2):          # after 1 step and after 3 steps
            for k in jm:
                np.testing.assert_allclose(
                    tm[k].numpy(), np.asarray(jm[k]),
                    err_msg=f"{k} after step {step + 1}", **TOL)
            got = convert.state_dict_to_jax(model.state_dict())
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jparams)):
                np.testing.assert_allclose(a, np.asarray(b), **TOL)
