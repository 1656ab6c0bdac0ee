"""Slice 18's compiled entries on the CPU, where each runs its plain
function, held to the JAX reference on numpy inputs made from a seed:

  * the LM learner steps that ``launch/train.py``'s ``build_lm_rl`` and
    ``build_lm`` wrap in ``compiled.TrainStep`` (the reference's jitted
    ``lm_rl_step_from_rollout(make_lm_train_step(...))`` and
    ``make_lm_pretrain_step(...)``, ``src/repro/launch/train.py:177,
    :200``), two steps each from the same converted weights, at
    tests/test_torch_lm_learner.py's float32 tolerance and its rule for
    AdamW's few near-eps elements (``STEP_ATOL``): reduced Qwen3-4B lm-rl
    (the K1 and K2 paths), Zamba2-2.7B lm (K2, K4), Granite-3.0-1B-A400M
    lm-rl, xLSTM-125M lm and the VLM's lm (with the builder's vision
    stub);
  * ``remat`` stashes no RNG state (a CUDA graph capture refuses to read
    the generator's), with gradients bitwise those of the old setting;
  * ``compiled.Forward``, which calls through on the CPU: the host
    actors' policy at each bucket of the inference queue's ladder, and
    replay's value function, against the reference's jitted
    ``policy_logits`` and ``baseline`` (``src/repro/core/sources.py:696``,
    ``src/repro/launch/train.py:111``);
  * the run's ``compiled:`` line for the LM modes and the host actors.

The card's side (capture, replay, bitwise against eager) is
tests/test_torch_compiled_gpu.py and chip_smoke.py phase 31."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import learner as jlearner
from repro.core import sources as jsources
from repro.envs import catch as jcatch
from repro.models import model as jmodel
from repro.models.convnet import minatar_net as jminatar
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch import convert
from repro_torch.configs import get_reduced_config
from repro_torch.convert import lm_state_dict_from_jax, lm_state_dict_to_jax
from repro_torch.core import compiled
from repro_torch.core.sources import HostLoopSource, ReplaySource
from repro_torch.launch import train
from repro_torch.models import model as tmodel
from repro_torch.models import common

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
LR = 3e-4
STEP_ATOL = LR / 2        # tests/test_torch_lm_learner.py's rule
STEPS = 2
# (arch, mode, --attn-impl, --ssd-impl, batch, seq): the kernel paths
# where the reduced config has K2 / K4 layers, the plain ones elsewhere
CASES = [
    ("qwen3-4b", "lm-rl", "kernel", "xla", 4, 16),
    ("zamba2-2.7b", "lm", "kernel", "kernel", 2, 16),
    ("granite-moe-1b-a400m", "lm-rl", "xla", "xla", 4, 16),
    ("xlstm-125m", "lm", "xla", "xla", 2, 16),
    ("llama-3.2-vision-90b", "lm", "xla", "xla", 2, 16),
]


def _leaves(tree, prefix=""):
    for key, child in tree.items():
        if isinstance(child, dict):
            yield from _leaves(child, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", child


def _assert_params_close(tparams, jparams, what):
    """Every parameter within TOL, but at most one element in 10,000 of
    a leaf, which must lie within STEP_ATOL."""
    got = dict(_leaves(lm_state_dict_to_jax(tparams.state_dict())))
    want = dict(_leaves(jax.tree.map(np.asarray, jparams)))
    assert set(got) == set(want)
    for path, w in want.items():
        g = np.asarray(got[path])
        np.testing.assert_allclose(g, w, rtol=TOL["rtol"],
                                   atol=max(TOL["atol"], STEP_ATOL),
                                   err_msg=f"{path} {what}")
        outside = int((~np.isclose(g, w, **TOL)).sum())
        assert outside <= max(1, w.size // 10_000), (
            f"{path} {what}: {outside} of {w.size} elements beyond {TOL}")


def _batches(mode, cfg, b, s):
    """STEPS batches in the trainers' structure: lm-rl's time-major
    rollout (``GeneratorSource``'s), lm's tokens (``DataSource``'s)."""
    rng = np.random.default_rng(11)
    out = []
    for _ in range(STEPS):
        if mode == "lm":
            out.append({"tokens": rng.integers(
                0, cfg.vocab_size, (b, s + 1)).astype(np.int32)})
            continue
        obs = rng.integers(0, cfg.vocab_size, (s + 1, b)).astype(np.int32)
        reward = np.asarray(jsources.token_task_reward(
            jnp.asarray(obs.T), cfg.vocab_size)).T
        done = np.zeros((s, b), bool)
        done[-1] = True
        out.append({"obs": obs, "action": obs[1:],
                    "behavior_logprob": (-np.log(cfg.vocab_size)
                                         + rng.normal(0, 0.1, (s, b))
                                         ).astype(np.float32),
                    "reward": np.ascontiguousarray(reward), "done": done})
    return out


def _reference_step(mode, jcfg, args):
    """The reference builder's jitted step and its optimizer."""
    if mode == "lm-rl":
        tc = JTrainConfig(optimizer="adamw", learning_rate=LR,
                          grad_clip=1.0, total_steps=args.steps,
                          lr_schedule="constant", entropy_cost=0.003)
        opt = jmake_optimizer(tc)
        return opt, jax.jit(jsources.lm_rl_step_from_rollout(
            jlearner.make_lm_train_step(jcfg, opt, tc, loss_chunk=args.seq,
                                        vtrace_impl=args.vtrace_impl)))
    tc = JTrainConfig(optimizer="adamw", learning_rate=LR, grad_clip=1.0,
                      total_steps=args.steps, lr_schedule="cosine",
                      warmup_steps=10)
    opt = jmake_optimizer(tc)
    return opt, jax.jit(jlearner.make_lm_pretrain_step(
        jcfg, opt, loss_chunk=min(512, args.seq)))


@pytest.mark.parametrize("arch,mode,attn,ssd,b,s", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_compiled_lm_steps_match_jax(arch, mode, attn, ssd, b, s):
    args = train._parser().parse_args(
        ["--mode", mode, "--arch", arch, "--reduced", "--attn-impl", attn,
         "--ssd-impl", ssd, "--batch", str(b), "--seq", str(s),
         "--steps", str(STEPS), "--device", "cpu"])
    build = train.build_lm_rl if mode == "lm-rl" else train.build_lm
    _, step_fn, tparams, tstate, _ = build(args)
    assert isinstance(step_fn, compiled.TrainStep) and step_fn.compiled
    jcfg = dataclasses.replace(jconfigs.get_reduced_config(arch),
                               attn_impl=attn, ssd_impl=ssd)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tparams.load_state_dict(lm_state_dict_from_jax(jparams), strict=True)
    jopt, jstep = _reference_step(mode, jcfg, args)
    jstate = jopt.init(jparams)
    vision = None
    if jcfg.vision_seq:
        # the reference builder's stub, as the port's builder adds it
        vision = jnp.zeros((b, jcfg.vision_seq, jcfg.d_model),
                           jnp.dtype(jcfg.dtype))
    for step, batch in enumerate(_batches(mode, jcfg, b, s)):
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        if vision is not None:
            jbatch["vision"] = vision
        jparams, jstate, jm = jstep(jparams, jstate, jnp.int32(step), jbatch)
        tparams, tstate, tm = step_fn(
            tparams, tstate, step,
            {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                       err_msg=f"{k} step {step}", **TOL)
        _assert_params_close(tparams, jparams, f"after step {step}")
    assert step_fn.captures == 0                      # none on the CPU


def test_remat_stashes_no_rng_state(monkeypatch):
    """A reduced Qwen3-4B pretraining loss under remat (its checkpoint
    regions per group) runs with both RNG state getters raising, and its
    gradients are bitwise those with the state stashed (the old
    setting): no region draws a random number."""
    cfg = dataclasses.replace(get_reduced_config("qwen3-4b"), remat=True)
    params = tmodel.init(cfg, seed=0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 17)))

    def grads():
        hidden, _, _ = tmodel.forward(params, tokens[:, :-1], cfg=cfg)
        logits = hidden @ tmodel.unembed_matrix(params, cfg)
        loss = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))
        return torch.autograd.grad(loss, list(params.parameters()),
                                   allow_unused=True,
                                   materialize_grads=True)

    checkpoint = torch.utils.checkpoint.checkpoint
    with monkeypatch.context() as m:
        # the old setting: checkpoint's default, which stashes the state
        m.setattr(torch.utils.checkpoint, "checkpoint",
                  lambda fn, *a, **kw: checkpoint(
                      fn, *a, **dict(kw, preserve_rng_state=True)))
        stashed = grads()

    def refuse():
        raise RuntimeError("RNG state read")
    monkeypatch.setattr(torch, "get_rng_state", refuse)
    monkeypatch.setattr(torch.cuda, "get_rng_state", refuse)
    with pytest.raises(RuntimeError, match="RNG state read"):
        checkpoint(lambda x: x * 2, torch.ones(2, requires_grad=True),
                   use_reentrant=False)
    got = grads()
    assert common.remat_active(cfg) and len(got) == len(stashed)
    for g, w in zip(got, stashed):
        assert torch.equal(g, w)


def _jax_agent(agent):
    env = jcatch.make()
    apply_fn = jminatar(env.obs_shape, env.num_actions)[1]
    params = jax.tree.map(lambda x: jnp.asarray(np.array(x)),
                          convert.state_dict_to_jax(agent.state_dict()))
    return apply_fn, params


def test_host_policy_matches_jax_at_each_bucket():
    """``HostLoopSource._policy`` (through ``compiled.Forward``, called
    through on the CPU) at the batches the inference queue pads to."""
    args = train._parser().parse_args(["--actors", "host", "--device",
                                       "cpu", "--batch", "8"])
    source, _, agent, _, _ = train.build_rl_agent(args)
    assert isinstance(source, HostLoopSource)
    assert isinstance(source.policy, compiled.Forward)
    source._sync(agent)
    apply_fn, params = _jax_agent(agent)
    policy = jax.jit(lambda p, obs: apply_fn(p, obs).policy_logits)
    rng = np.random.default_rng(2)
    for n in (1, 2, 4, 8):
        obs = rng.random((n,) + jcatch.make().obs_shape, dtype=np.float32)
        np.testing.assert_allclose(source._policy(obs),
                                   np.asarray(policy(params, obs)), **TOL)
    assert source.policy.captures == 0 and not source.policy._static


def test_value_fn_matches_jax():
    """Replay's ``value_fn`` as ``build_rl_agent`` builds it, on a
    rollout's observations less the bootstrap row."""
    args = train._parser().parse_args(["--replay", "uniform", "--device",
                                       "cpu", "--batch", "4"])
    source, _, agent, _, _ = train.build_rl_agent(args)
    assert isinstance(source, ReplaySource)
    value_fn = source._value_fn
    assert isinstance(value_fn, compiled.Forward)
    apply_fn, params = _jax_agent(agent)
    baseline = jax.jit(lambda p, obs: apply_fn(p, obs).baseline)
    obs = np.random.default_rng(3).random(
        (5, 4) + jcatch.make().obs_shape, dtype=np.float32)
    got = value_fn(agent, torch.from_numpy(obs))
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(baseline(params, obs)), **TOL)
    assert value_fn.captures == 0


def test_lm_and_host_summary_lines():
    plain = compiled.TrainStep(None, None)
    meshed = compiled.TrainStep(None, None, mesh=object())
    assert train.compiled_summary(plain, "cpu", mode="lm").startswith(
        "compiled: nothing on the CPU")
    assert train.compiled_summary(plain, "cuda", mode="lm-rl") == (
        "compiled: the learner step and the generation (decode step, "
        "admissions) as CUDA graphs")
    assert train.compiled_summary(plain, "cuda", mode="lm") == (
        "compiled: the learner step as CUDA graphs")
    assert train.compiled_summary(meshed, "cuda", mode="lm-rl") == (
        "compiled: nothing as CUDA graphs; the learner step and the "
        "generation eager by rule under --mesh-data / --mesh-model (the "
        "mesh's collectives, which no graph captures)")
    assert train.compiled_summary(plain, "cuda", False, replay=True) == (
        "compiled: the learner step, the host actors' policy and replay's "
        "value function as CUDA graphs")
    assert train.compiled_summary(meshed, "cuda", False).startswith(
        "compiled: the host actors' policy as CUDA graphs; the learner "
        "step eager by rule under --mesh-data")


@pytest.mark.parametrize("mode", ["lm-rl", "lm"])
def test_lm_cli_prints_its_compiled_line(mode, capsys):
    train.main(["--mode", mode, "--arch", "qwen3-4b", "--reduced",
                "--steps", "1", "--batch", "2", "--seq", "16", "--device",
                "cpu"])
    out = capsys.readouterr().out
    assert "compiled: nothing on the CPU (the plain functions run)" in out
