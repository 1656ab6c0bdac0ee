"""The compiled rl-agent entries and admissions on the card
(``core/compiled.py``, ``core/generate.py::_SessionFns.admit``) against
the plain functions run eagerly from the same state, bitwise:

  * the learner steps (plain, recurrent, a replay batch) over three steps
    whose rate changes (linear anneal): metrics, every parameter and every
    optimizer leaf; one capture; K1 once a step;
  * the pipelined unroll (Catch, gridworld) across parameter syncs and a
    ``state_dict`` / ``load_state_dict`` round trip: rollouts, the carry
    and the generator's state after every call; one capture;
  * admissions at reduced Qwen3-4B and Zamba2-2.7B on the kernel paths:
    first tokens, log-probs, baselines and every written cache row; one
    capture per (rows, bucket); K2 / K4 launches of a replay equal to an
    eager admission's;
  * the LM learner steps (lm-rl at reduced Qwen3-4B, lm at reduced
    Zamba2-2.7B, the kernel paths under remat) through the
    ``compiled.TrainStep`` that ``launch/train.py`` builds, over three
    steps: metrics, every parameter and AdamW leaf; one capture; each
    step's K1 / K2 / K4 launches those of the eager step;
  * the host actors' policy (``compiled.Forward``) at each bucket of the
    ladder, one capture a bucket, and a replay after ``_sync`` reading
    the new weights; replay's value function; the VLM's prefill with
    ``vision=`` through ``generate``'s admission graph.

cuDNN is pinned deterministic for the learner cases. This file imports no
JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_compiled_gpu.py

Without a GPU every case skips."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.configs.atari_impala import small_train
from repro_torch.configs.base import TrainConfig
from repro_torch.core import compiled
from repro_torch.core import generate as G
from repro_torch.core import learner, rollout
from repro_torch.core.sources import (DeviceSource, HostLoopSource,
                                     lm_rl_step_from_rollout)
from repro_torch.envs import catch, gridworld
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.models import model as model_lib
from repro_torch.models.convnet import minatar_lstm_net, minatar_net
from repro_torch.optim import make_optimizer
from repro_torch.tree import flatten, leaves, map_leaves

T, B = 20, 16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda")


@pytest.fixture
def deterministic_cudnn(cuda_device):
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    yield cuda_device
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        saved


def _same(a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        return torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))
    return torch.equal(a, b)


def _assert_trees_equal(got, want, what):
    for (path, a), (_, b) in zip(flatten(got), flatten(want), strict=True):
        assert _same(a, b), f"{what}: {path}"


def _batch(kind, agent, gen):
    env = catch.make()
    state, obs = rollout.env_reset_batch(env, gen, B, "cuda")
    if kind == "recurrent":
        unroll = rollout.make_recurrent_unroll(env, T)
        _, ro = unroll(agent, unroll.initial_carry(agent, state, obs), gen)
        return ro
    _, ro = rollout.make_unroll(env, T)(agent, (state, obs), gen)
    if kind == "replay":
        ro = {k: torch.cat([v, v.flip(1)], 1) for k, v in ro.items()}
        ro["behavior_value"] = torch.randn((T, 2 * B), generator=gen,
                                           device="cuda")
        ro["is_replay"] = torch.arange(2 * B, device="cuda") >= B
    return ro


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["plain", "recurrent", "replay"])
def test_learner_graph_is_bitwise_eager(deterministic_cudnn, kind):
    env = catch.make()
    tc = small_train(unroll_length=T, batch_size=B, total_steps=3,
                     learning_rate=2e-3)
    if kind == "replay":
        tc = dataclasses.replace(tc, clear_policy_cost=0.01,
                                 clear_value_cost=0.005)
    net = minatar_lstm_net if kind == "recurrent" else minatar_net
    agent = net(env.obs_shape, env.num_actions,
                generator=torch.Generator().manual_seed(0)).cuda()
    batch = _batch(kind, agent, torch.Generator("cuda").manual_seed(1))
    make = (learner.make_recurrent_train_step if kind == "recurrent"
            else learner.make_train_step)
    opt = make_optimizer(tc)
    step_fn = make(opt, tc)
    graph = compiled.TrainStep(step_fn, opt)
    eager_agent = copy.deepcopy(agent)
    states = [opt.init(list(a.parameters())) for a in (agent, eager_agent)]
    for step in range(3):
        ops.reset_stats()
        _, _, got = graph(agent, states[0], step, batch)
        k1 = ops.stats()["vtrace"]
        _, _, want = step_fn(eager_agent, states[1], step, batch)
        assert k1 == 1 and ops.stats()["vtrace"] == 2
        _assert_trees_equal(got, want, f"metrics, step {step}")
        _assert_trees_equal(dict(agent.named_parameters()),
                            dict(eager_agent.named_parameters()),
                            f"params, step {step}")
        _assert_trees_equal(states[0], states[1], f"opt_state, step {step}")
    assert graph.captures == 1


def _host_copy(tree):
    return map_leaves(lambda x: x.detach().cpu().clone()
                      if isinstance(x, torch.Tensor) else x, tree)


@pytest.mark.gpu
@pytest.mark.parametrize("env_mod", [catch, gridworld])
def test_pipelined_unroll_graph_is_bitwise_eager(cuda_device, env_mod):
    env = env_mod.make()
    learner_agent = minatar_net(env.obs_shape, env.num_actions,
                                generator=torch.Generator().manual_seed(0))
    learner_agent = learner_agent.cuda()
    source = DeviceSource.for_env(env, learner_agent, unroll_length=T,
                                  batch_size=B, seed=3, param_sync_every=2)
    # the eager reference: the plain unroll on its own carry, generator
    # and actor copy, dispatched as the source dispatches
    gen = torch.Generator("cuda").manual_seed(3)
    carry = rollout.env_reset_batch(env, gen, B, "cuda")
    actor = copy.deepcopy(learner_agent).requires_grad_(False)
    unroll = rollout.make_unroll(env, T)
    dispatched = []

    def eager_dispatch(params):
        nonlocal carry
        if len(dispatched) % 2 == 0:
            actor.load_state_dict(params.state_dict())
        carry, ro = unroll(actor, carry, gen)
        dispatched.append(ro)

    def check(call, got):
        _assert_trees_equal(got, dispatched[call], f"rollout {call}")
        _assert_trees_equal(source._carry, carry, f"carry {call}")
        assert torch.equal(source._gen.get_state(), gen.get_state())

    for call in range(4):
        if call == 0:
            eager_dispatch(learner_agent)
        eager_dispatch(learner_agent)
        check(call, source.next_batch(learner_agent))
        with torch.no_grad():                 # the learner's update
            for p in learner_agent.parameters():
                p.mul_(0.9)
    assert source.captures == 1
    # a checkpoint round trip into a fresh source, as --resume makes it
    saved = _host_copy(source.state_dict())
    source.stop()
    resumed = DeviceSource.for_env(env, learner_agent, unroll_length=T,
                                   batch_size=B, seed=99, param_sync_every=2)
    resumed.load_state_dict(saved)
    source = resumed
    for call in range(4, 7):
        eager_dispatch(learner_agent)
        check(call, source.next_batch(learner_agent))
    assert source.captures == 1


@pytest.mark.gpu
def test_recurrent_unroll_graph_keeps_each_initial_core_state(cuda_device):
    """The recurrent unroll's rollout holds the core_state it started
    from, a carry buffer the graph then moves on: each rollout's copy is
    the eager one's, bitwise, as are the carry and the generator."""
    env = catch.make()
    agent = minatar_lstm_net(env.obs_shape, env.num_actions,
                             generator=torch.Generator().manual_seed(0))
    agent = agent.cuda().requires_grad_(False)
    unroll = rollout.make_recurrent_unroll(env, T)
    gens = [torch.Generator("cuda").manual_seed(4) for _ in range(2)]
    carries = [unroll.initial_carry(agent, *rollout.env_reset_batch(
        env, g, B, "cuda")) for g in gens]
    graph = compiled.Unroll(unroll, carries[0], gens[0])
    carry = carries[1]
    for call in range(4):
        got = graph(agent)
        carry, want = unroll(agent, carry, gens[1])
        _assert_trees_equal(got, want, f"rollout {call}")
        _assert_trees_equal(graph.carry, carry, f"carry {call}")
        assert torch.equal(gens[0].get_state(), gens[1].get_state())
    assert graph.captures == 1


def _cfg(arch):
    return dataclasses.replace(get_reduced_config(arch), attn_impl="kernel",
                               ssd_impl="kernel")


def _clone_state(state):
    def gen(g):
        out = torch.Generator(device=g.device)
        out.set_state(g.get_state())
        return out
    return {"cache": G.tree_map(torch.clone, state["cache"]),
            "pos": state["pos"].clone(), "last": state["last"].clone(),
            "temp": state["temp"].clone(),
            "gens": [gen(g) for g in state["gens"]],
            "active": state["active"].copy()}


def _eager_admit(cfg, params, state, slots, prompts, seeds, cap):
    """``_SessionFns.admit``'s eager branch from the plain functions."""
    n = len(slots)
    pb = G.prefill_len(cfg, len(prompts[0]), cap)
    padded = np.zeros((n, pb), np.int64)
    for row, p in enumerate(prompts):
        padded[row, :len(p)] = p
    lengths = np.array([len(p) for p in prompts])
    inputs = torch.from_numpy(np.concatenate(
        [padded.reshape(-1), lengths, slots]).astype(np.int64)).cuda()
    logits0, base0 = G._session_admit(params, state, inputs, n, pb, cfg=cfg,
                                      cache_seq_len=cap)
    idx = inputs[n * pb + n:]
    gens = [state["gens"][s].manual_seed(seed) for s, seed in
            zip(slots, seeds)]
    temp = torch.ones((n,), device="cuda")
    tok, lp, ent = G._sample(logits0[:, 0], temp, gens, np.ones(n, bool))
    state["last"][idx] = tok
    state["temp"][idx] = temp
    state["active"][slots] = True
    return {k: v.cpu().numpy() for k, v in G._out(tok, lp, ent,
                                                   base0).items()}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-2.7b"])
def test_admission_graph_is_bitwise_eager(cuda_device, arch):
    cfg, cap = _cfg(arch), 32
    params = model_lib.init(cfg, seed=0, device="cuda")
    sess = G.DecodeSession(params, cfg, max_batch=4, max_len=cap)
    fns = G.session_fns(cfg)
    captures = fns.admissions.captures
    ref = _clone_state(sess._state)
    rng = np.random.default_rng(5)
    # two prefill buckets, each admitted 3 times (the hybrid prefills
    # exact lengths: one length a bucket)
    lens = ([6, 6], [16, 16]) if cfg.is_recurrent else ([5, 7], [12, 16])
    rounds = [([0, 1], lens[0]), ([2, 3], lens[1])] * 3
    kernel = "ssd_chunk" if arch == "zamba2-2.7b" else "flash_attention"
    for n, (slots, lens) in enumerate(rounds):
        for s in slots:
            sess.evict(s)
        prompts = [rng.integers(0, cfg.vocab_size, k) for k in lens]
        seeds = [10 * n + s for s in slots]
        before = ops.stats()[kernel]
        got = sess.prefill_many(slots, prompts, seeds=seeds)
        graph_launches = ops.stats()[kernel] - before
        want = _eager_admit(cfg, params, ref, slots, prompts, seeds, cap)
        assert ops.stats()[kernel] - before == 2 * graph_launches > 0
        for row, out in enumerate(got):
            for k in out:
                np.testing.assert_array_equal(out[k], want[k][row])
        for (path, x), (_, y) in zip(flatten(sess._state["cache"]),
                                     flatten(ref["cache"])):
            assert _same(x, y), path
        for k in ("pos", "last", "temp"):
            assert _same(sess._state[k], ref[k]), k
    # two keys: each warmed once, captured once, replayed after
    assert fns.admissions.captures == captures + 2
    assert all(x.is_cuda for x in leaves(sess._state["cache"]))


def _lm_batch(kind, cfg, gen):
    """Three batches of the LM trainers' structure: lm-rl's time-major
    rollout (``GeneratorSource``'s), lm's tokens."""
    t, b = 16, 4
    out = []
    for _ in range(3):
        tokens = torch.randint(0, cfg.vocab_size, (t + 1, b), generator=gen,
                               device="cuda", dtype=torch.int32)
        if kind == "lm":
            out.append({"tokens": tokens.T.contiguous()})
            continue
        done = torch.zeros((t, b), dtype=torch.bool, device="cuda")
        done[-1] = True
        out.append({"obs": tokens, "action": tokens[1:],
                    "behavior_logprob": -torch.rand((t, b), generator=gen,
                                                    device="cuda") - 5.0,
                    "reward": torch.rand((t, b), generator=gen,
                                         device="cuda"),
                    "done": done})
    return out


def _lm_step(mode, cfg, opt):
    """The trainers' learner step (``launch/train.py``'s settings)."""
    if mode == "lm":
        return learner.make_lm_pretrain_step(cfg, opt, loss_chunk=16)
    tc = TrainConfig(optimizer="adamw", learning_rate=3e-4, grad_clip=1.0,
                     total_steps=3, lr_schedule="constant",
                     entropy_cost=0.003)
    return lm_rl_step_from_rollout(learner.make_lm_train_step(
        cfg, opt, tc, loss_chunk=16))


@pytest.mark.gpu
@pytest.mark.parametrize("arch,mode", [("qwen3-4b", "lm-rl"),
                                       ("zamba2-2.7b", "lm")])
def test_lm_learner_graph_is_bitwise_eager(cuda_device, arch, mode):
    """The builder's TrainStep, then the same on the config with remat on
    (the published configs' setting; the reduced ones turn it off), so
    that the checkpoint regions' recomputation runs under the capture."""
    args = train._parser().parse_args(
        ["--mode", mode, "--arch", arch, "--reduced", "--attn-impl",
         "kernel", "--ssd-impl", "kernel", "--batch", "4", "--seq", "16",
         "--steps", "3"])
    build = train.build_lm_rl if mode == "lm-rl" else train.build_lm
    cfg = dataclasses.replace(train._lm_config(args), remat=True)
    _, built, params, opt_state, _ = build(args)
    assert isinstance(built, compiled.TrainStep) and built.compiled
    step_fn = _lm_step(mode, cfg, built.opt)
    graph = compiled.TrainStep(step_fn, built.opt)
    eager_params = copy.deepcopy(params)
    eager_state = built.opt.init(list(eager_params.parameters()))
    batches = _lm_batch(mode, cfg, torch.Generator("cuda").manual_seed(3))
    for step, batch in enumerate(batches):
        ops.reset_stats()
        _, _, got = graph(params, opt_state, step, batch)
        launched = ops.stats()
        ops.reset_stats()
        _, _, want = step_fn(eager_params, eager_state, step, batch)
        assert launched == ops.stats() and launched["flash_attention"] > 0
        _assert_trees_equal(got, want, f"metrics, step {step}")
        _assert_trees_equal(dict(params.named_parameters()),
                            dict(eager_params.named_parameters()),
                            f"params, step {step}")
        _assert_trees_equal(opt_state, eager_state, f"opt_state, {step}")
    assert graph.captures == 1


@pytest.mark.gpu
def test_policy_graph_is_bitwise_eager_at_each_bucket(cuda_device):
    env = catch.make()
    agent = minatar_net(env.obs_shape, env.num_actions,
                        generator=torch.Generator().manual_seed(0)).cuda()
    source = HostLoopSource(env, agent, num_actors=8, unroll_length=T,
                            batch_size=B)
    source._sync(agent)
    rng = np.random.default_rng(0)

    def eager(obs):
        with torch.no_grad():
            return source._actor(torch.from_numpy(obs).cuda()) \
                .policy_logits.float().cpu().numpy()

    for n in (1, 2, 4, 8):
        for _ in range(3):
            obs = rng.random((n,) + env.obs_shape, dtype=np.float32)
            np.testing.assert_array_equal(source._policy(obs), eager(obs))
    assert source.policy.captures == 4
    old = source._policy(obs)
    with torch.no_grad():
        for p in agent.parameters():
            p.add_(0.01)
    source._sync(agent)
    new = source._policy(obs)
    np.testing.assert_array_equal(new, eager(obs))
    assert not np.array_equal(new, old) and source.policy.captures == 4


@pytest.mark.gpu
def test_value_fn_graph_is_bitwise_eager(cuda_device):
    args = train._parser().parse_args(["--replay", "uniform", "--batch",
                                       str(B)])
    source, _, agent, _, _ = train.build_rl_agent(args)
    value_fn = source._value_fn
    gen = torch.Generator("cuda").manual_seed(0)
    for call in range(4):
        if call == 3:
            with torch.no_grad():
                for p in agent.parameters():
                    p.mul_(0.9)
        obs = torch.rand((T, B) + catch.make().obs_shape, generator=gen,
                         device="cuda")
        with torch.no_grad():
            want = agent(obs).baseline
        assert _same(value_fn(agent, obs), want)
    assert value_fn.captures == 1


@pytest.mark.gpu
def test_vlm_prefill_graph_is_bitwise_eager(cuda_device):
    cfg = _cfg("llama-3.2-vision-90b")
    params = model_lib.init(cfg, seed=0, device="cuda")
    b, p, steps = 2, 8, 4
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, p))
    vision = torch.randn((b, cfg.vision_seq, cfg.d_model),
                         generator=torch.Generator("cuda").manual_seed(1),
                         device="cuda")
    fns = G.session_fns(cfg)
    captures = fns.admissions.captures
    gens = [torch.Generator("cuda").manual_seed(7 + i) for i in range(b)]
    state, out = G._session_prefill(
        params, torch.as_tensor(prompt, device="cuda"), gens,
        torch.ones((b,), device="cuda"), cfg=cfg, cache_seq_len=p + steps,
        vision=vision)
    outs = [out]
    for _ in range(steps - 1):
        state, out = G._session_step(params, state, cfg=cfg)
        outs.append(out)
    want = {k: torch.stack([o[k] for o in outs], 1) for k in outs[0]}
    for _ in range(3):
        before = ops.stats()["flash_attention"]
        got = G.generate(params, prompt, 7, cfg=cfg, num_steps=steps,
                         vision=vision)
        assert ops.stats()["flash_attention"] - before == 1
        assert _same(got["tokens"][:, p:], want["token"])
        for k in ("logprob", "entropy", "baseline"):
            assert _same(got[k], want[k]), k
    assert fns.admissions.captures == captures + 1
