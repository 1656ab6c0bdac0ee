"""The port's compiled entries (``core/compiled.py``, and the admissions of
``core/generate.py::_SessionFns``) on the CPU, where each runs its plain
function, held to the JAX reference at the existing tolerances:

  * the wrapped rl-agent learner step (``compiled.TrainStep``, what
    ``launch/train.py::build_rl_agent`` builds) against
    ``jax.jit(make_train_step(...))`` over three steps of a linear anneal,
    and the recurrent step likewise, at 1e-5, the optimizer's device
    scalars holding the reference's rate at each step in one storage;
  * the device-scalar RMSProp and AdamW against the reference's
    optimizers over steps whose rate changes, at 1e-6;
  * ``DecodeSession.prefill_many`` over two prefill buckets against the
    reference's ``admit_many`` (its ``DecodeSession.prefill_many``) at
    reduced Qwen3-4B and Zamba2-2.7B, teacher-forced on the reference's
    tokens: logits and every cache leaf at 1e-5, log-probs, entropies
    and baselines at 1e-4;
  * what the CUDA graphs need of the plain side: the unroll's carry
    updated in place with each rollout's initial core_state kept, the
    learner's static batch buffers, the run's summary line.

The card's side (capture, replay, bitwise against eager) is
tests/test_torch_compiled_gpu.py and chip_smoke.py phase 30."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.atari_impala import small_train as jsmall_train
from repro.core import generate as jgen
from repro.core import learner as jlearner
from repro.envs import catch as jcatch
from repro.models import model as jmodel
from repro.models.convnet import minatar_lstm_net as jlstm
from repro.models.convnet import minatar_net as jminatar
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch import convert
from repro_torch.configs import get_reduced_config
from repro_torch.configs.atari_impala import small_train as tsmall_train
from repro_torch.convert import lm_state_dict_to_jax
from repro_torch.core import compiled
from repro_torch.core import generate as G
from repro_torch.core import learner as tlearner
from repro_torch.core import rollout as trollout
from repro_torch.envs import catch as tcatch
from repro_torch.launch import train
from repro_torch.models import model as tmodel
from repro_torch.models.convnet import minatar_lstm_net as tlstm
from repro_torch.models.convnet import minatar_net as tminatar
from repro_torch.optim import make_optimizer as tmake_optimizer
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.tree import leaves

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
T, B = 8, 4
# three steps of a linear anneal over three: the rate changes every step
CFG = dict(unroll_length=T, batch_size=B, learning_rate=5e-3, total_steps=3)


def _to_torch(batch):
    out = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()
           if k != "core_state"}
    if "core_state" in batch:
        out["core_state"] = tuple(torch.from_numpy(np.array(x))
                                  for x in batch["core_state"])
    return out


def _batches(recurrent):
    """(the reference's apply_fn, the port's agent, three of its rollouts
    on Catch as numpy): the port's unroll makes them, both learners take
    them."""
    env = tcatch.make()
    gen = torch.Generator().manual_seed(1)
    agent = (tlstm if recurrent else tminatar)(
        env.obs_shape, env.num_actions,
        generator=torch.Generator().manual_seed(0))
    unroll = (trollout.make_recurrent_unroll(env, T) if recurrent
              else trollout.make_unroll(env, T))
    env_state, obs = env.reset(B, gen, "cpu")
    carry = (unroll.initial_carry(agent, env_state, obs) if recurrent
             else (env_state, obs))
    batches = []
    for _ in range(3):
        carry, ro = unroll(agent, carry, gen)
        batches.append({k: (tuple(x.numpy() for x in v)
                            if isinstance(v, tuple) else v.numpy())
                        for k, v in ro.items()})
    jenv = jcatch.make()
    apply_fn = (jlstm(jenv.obs_shape, jenv.num_actions)[1] if recurrent
                else jminatar(jenv.obs_shape, jenv.num_actions)[1])
    return apply_fn, agent, batches


@pytest.mark.parametrize("recurrent", [False, True],
                         ids=["plain", "recurrent"])
def test_compiled_learner_step_matches_jax(recurrent):
    apply_fn, agent, batches = _batches(recurrent)
    # copies: the port's step updates in place what .numpy() would share
    params = jax.tree.map(lambda x: jnp.asarray(np.array(x)),
                          convert.state_dict_to_jax(agent.state_dict()))
    jcfg, tcfg = jsmall_train(**CFG), tsmall_train(**CFG)
    jo, to = jmake_optimizer(jcfg), tmake_optimizer(tcfg)
    jfactory = (jlearner.make_recurrent_train_step if recurrent
                else jlearner.make_train_step)
    tfactory = (tlearner.make_recurrent_train_step if recurrent
                else tlearner.make_train_step)
    jstep = jax.jit(jfactory(apply_fn, jo, jcfg))
    tstep = compiled.TrainStep(tfactory(to, tcfg), to)
    jstate, tstate = jo.init(params), to.init(list(agent.parameters()))
    rate = jsched.make_schedule(jcfg)
    held = None
    for step, batch in enumerate(batches):
        params, jstate, jm = jstep(params, jstate, jnp.int32(step),
                                   jax.tree.map(jnp.asarray, batch))
        agent, tstate, tm = tstep(agent, tstate, step, _to_torch(batch))
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                       err_msg=f"{k} after step {step}",
                                       **TOL)
        got = convert.state_dict_to_jax(agent.state_dict())
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)
        # the rate the step used, in the device scalar the graph reads
        scalars = to.stage(step, "cpu")
        assert float(scalars["neg_lr"]) == -float(rate(step))
        ptrs = [x.data_ptr() for x in scalars.values()]
        assert held is None or ptrs == held
        held = ptrs
    assert not tstep.compiled or tstep.captures == 0     # none on the CPU


@pytest.mark.parametrize("name", ["rmsprop", "adamw"])
def test_device_scalar_optimizers_match_jax(name):
    sched_j, sched_t = jsched.linear_anneal(1e-2, 6), tsched.linear_anneal(
        1e-2, 6)
    jo, to = {"rmsprop": (jopt.rmsprop(sched_j, grad_clip=3.0),
                          topt.rmsprop(sched_t, grad_clip=3.0)),
              "adamw": (jopt.adamw(sched_j, weight_decay=0.1, grad_clip=3.0),
                        topt.adamw(sched_t, weight_decay=0.1,
                                   grad_clip=3.0))}[name]
    rng = np.random.default_rng(7)
    shapes = [(6, 5), (3, 3, 2, 4), (5,)]
    init = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    jparams = [jnp.asarray(x) for x in init]
    tparams = [torch.tensor(x) for x in init]
    jstate, tstate = jo.init(jparams), to.init(tparams)
    rates = set()
    for step in range(5):
        grads = [(2.0 if step % 2 else 0.3) * rng.normal(0, 1, s).astype(
            np.float32) for s in shapes]
        jup, jstate = jo.update([jnp.asarray(g) for g in grads], jstate,
                                jparams, jnp.int32(step))
        jparams = jopt.apply_updates(jparams, jup)
        to.step([torch.tensor(g) for g in grads], tstate, tparams, step)
        rates.add(float(to.stage(step, "cpu")["neg_lr"]))
        for a, b in zip(tparams, jparams):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6, err_msg=f"step {step}")
    assert len(rates) == 5


# admissions: two prefill buckets in one prefill_many (the hybrid
# prefills exact lengths, so two lengths)
ADMIT_LENS = {"qwen3-4b": [5, 7, 12, 16], "zamba2-2.7b": [6, 6, 16, 16]}


@pytest.mark.parametrize("arch", sorted(ADMIT_LENS))
def test_prefill_many_matches_jax_admit_many(monkeypatch, arch):
    jcfg, cfg = jconfigs.get_reduced_config(arch), get_reduced_config(arch)
    params = tmodel.init(cfg, seed=0)
    jparams = jax.tree.map(lambda x: jnp.asarray(np.array(x)),
                           lm_state_dict_to_jax(params.state_dict()))
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in ADMIT_LENS[arch]]
    slots = [3, 0, 2, 1]
    jsess = jgen.DecodeSession(jparams, jcfg, max_batch=4, max_len=32)
    want = jsess.prefill_many(slots, prompts, keys=[
        jax.random.PRNGKey(i) for i in range(4)], temperature=0.8)
    # the port's groups, in its order: forced onto the reference's tokens
    groups = {}
    for i, p in enumerate(prompts):
        groups.setdefault(G.prefill_len(cfg, len(p), 32), []).append(i)
    order, seen = iter(groups.items()), []

    def teacher(logits, temp, gens, active):
        pb, idxs = next(order)
        seen.append((pb, idxs, logits.clone()))
        tok = torch.as_tensor(np.array([want[i]["token"] for i in idxs]),
                              dtype=torch.int64)
        lp, ent = G.logprob_entropy(logits / temp[:, None], tok)
        return tok, lp, ent

    monkeypatch.setattr(G, "_sample", teacher)
    sess = G.DecodeSession(params, cfg, max_batch=4, max_len=32)
    got = sess.prefill_many(slots, prompts, seeds=[0, 1, 2, 3],
                            temperature=0.8)
    assert len(seen) == 2
    for g, w in zip(got, want):
        assert g["token"] == w["token"]
        for key in ("logprob", "entropy", "baseline"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4, atol=1e-4,
                                       err_msg=key)
    # each group's logits against the reference's prefill and heads
    for pb, idxs, logits in seen:
        padded = np.zeros((len(idxs), pb), np.int32)
        for row, i in enumerate(idxs):
            padded[row, :len(prompts[i])] = prompts[i]
        hidden, _, _ = jmodel.prefill(jparams, jnp.asarray(padded), cfg=jcfg,
                                      cache_seq_len=32)
        li = jnp.asarray([len(prompts[i]) - 1 for i in idxs])
        h_last = jnp.take_along_axis(hidden, li[:, None, None], axis=1)
        jlogits = jmodel.logits_from_hidden(jparams, jcfg, h_last)[:, 0]
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
    jstate, state = jsess._state, sess._state
    assert [k for k, _ in _paths(state["cache"])] == [
        k for k, _ in _paths(jstate["cache"])]
    for (path, x), (_, y) in zip(_paths(state["cache"]),
                                 _paths(jstate["cache"])):
        np.testing.assert_allclose(x.float().numpy(), np.asarray(
            y, np.float32), err_msg=path, **TOL)
    np.testing.assert_array_equal(state["pos"].numpy(),
                                  np.asarray(jstate["pos"]))
    np.testing.assert_array_equal(state["last"].numpy(),
                                  np.asarray(jstate["last"]))


def _paths(tree, prefix=""):
    out = []
    for key, child in tree.items():
        if isinstance(child, dict):
            out += _paths(child, f"{prefix}{key}/")
        else:
            out.append((f"{prefix}{key}", child))
    return out


def test_unroll_updates_its_carry_in_place_and_keeps_each_initial_core():
    """``compiled.Unroll`` on the CPU: the plain unroll, its carry
    written into the same storages, and a rollout's core_state (a carry
    buffer when the unroll starts) the eager unroll's, not the state the
    carry moved on to."""
    env = tcatch.make()
    agent = tlstm(env.obs_shape, env.num_actions,
                  generator=torch.Generator().manual_seed(0))
    unroll = trollout.make_recurrent_unroll(env, T)
    gens = [torch.Generator().manual_seed(3) for _ in range(2)]
    carries = [unroll.initial_carry(agent, *env.reset(B, g, "cpu"))
               for g in gens]
    entry = compiled.Unroll(unroll, carries[0], gens[0])
    ptrs = [x.data_ptr() for x in leaves(entry.carry)]
    carry = carries[1]
    for _ in range(3):
        got = entry(agent)
        carry, want = unroll(agent, carry, gens[1])
        for a, b in zip(leaves(got), leaves(want)):
            assert torch.equal(a, b)
        for a, b in zip(leaves(entry.carry), leaves(carry)):
            assert torch.equal(a, b)
        assert [x.data_ptr() for x in leaves(entry.carry)] == ptrs
        assert not any(x.data_ptr() in ptrs for x in leaves(got))


def test_train_step_static_inputs():
    """The static batch buffers: one set per batch structure, a batch
    copied in, a batch already in them left as it is; replay's mixed
    batches are another structure."""
    opt = topt.rmsprop(1e-3)
    step = compiled.TrainStep(lambda *a: a, opt)
    batch = {"reward": torch.arange(6.0).view(3, 2),
             "core_state": (torch.ones(2, 4), torch.zeros(2, 4))}
    static = step.inputs(batch)
    assert static is not batch and torch.equal(static["reward"],
                                               batch["reward"])
    assert step.inputs(static) is static
    batch["reward"] += 1
    assert torch.equal(step.inputs(batch)["reward"], batch["reward"])
    mixed = dict(batch, is_replay=torch.zeros(2, dtype=torch.bool))
    assert step.inputs(mixed) is not static
    assert len(step._static) == 2


def test_rl_agent_summary_line():
    opt = tmake_optimizer(tsmall_train())
    plain = compiled.TrainStep(None, opt)
    meshed = compiled.TrainStep(None, opt, mesh=object())
    assert "CPU" in train.compiled_summary(plain, "cpu")
    assert train.compiled_summary(plain, "cuda") == (
        "compiled: the learner step and the unroll as CUDA graphs")
    assert train.compiled_summary(plain, "cuda", device_actors=False) == (
        "compiled: the learner step and the host actors' policy as CUDA "
        "graphs")
    line = train.compiled_summary(meshed, "cuda")
    assert line.startswith("compiled: the unroll as CUDA graphs; the "
                           "learner step eager by rule under --mesh-data")


def test_build_rl_agent_wraps_the_learner_step():
    args = train._parser().parse_args(["--device", "cpu", "--steps", "2",
                                       "--batch", "4"])
    _, step_fn, _, _, _ = train.build_rl_agent(args)
    assert isinstance(step_fn, compiled.TrainStep) and step_fn.compiled
