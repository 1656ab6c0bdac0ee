"""The LM learner steps against the JAX reference, from the same weights
(converted with ``repro_torch.convert``), on fixed numpy inputs made from
a seed:

* ``make_lm_train_step`` on the reduced ``qwen3-4b``, through
  ``lm_rl_step_from_rollout`` on a time-major token rollout: loss, every
  metric and every parameter after each of two AdamW steps;
* ``make_lm_pretrain_step`` on the reduced ``zamba2-2.7b`` (two Mamba2
  layers and the shared attention block, S = 32: two SSD chunks, the
  state carried between them): loss and every parameter after each of two
  AdamW steps;
* both steps on the reduced ``granite-moe-1b-a400m`` (two MoE layers,
  dropless at capacity 4.0), whose router losses enter the gradient;
* both steps on the reduced ``xlstm-125m`` (an mLSTM and an sLSTM layer,
  no kernel but V-trace's: the lm-rl step's 16 tokens are one mLSTM
  chunk, the pretraining step's 32 two).

Each through the kernel paths (the JAX Pallas kernels in interpret mode;
the port's kernel wrappers, which on CPU tensors run their plain versions)
and through the plain paths, with ``remat`` on as in the published
configs (the port's checkpoint regions: per group, and per layer of the
two-layer Zamba2 group); float32 at 1e-5, bf16 activations at the
known 6e-2 limit (ROADMAP.md §3: XLA keeps float32 between fused ops).

AdamW runs with the reference CLI's settings (eps 1e-8). Its first update
of an element is -lr * g / (|g| + eps): where |g| is near eps, a float32
difference of summation order in g (about 3e-9) moves that element by up
to lr / eps times it. So the loss and every metric are held at the
tolerance, and so is every parameter but at most one element in 10,000
of each leaf, which must lie within half a step (``STEP_ATOL``, lr / 2).
In the float32 lm-rl cases 1 to 3 elements of six of the reduced qwen3's
leaves land there (``ffn/wg``, ``ffn/wo``, ``mixer/wk``, ``mixer/wo``,
``embed``), at most 5.7e-5 apart (0.19 lr); the pretraining cases have
none. The optimizer's own arithmetic is held against the reference in
tests/test_torch_optim.py.

The xLSTM's losses are more sensitive to those few elements: in its
float32 lm-rl case three ``mixer/wk`` elements 5.5e-5 apart after the
first step move the second step's pg_loss by 2.3e-4, while the second
step from the reference's own weights agrees within 1.3e-5. So its lm-rl
cases restart each step from the reference's parameters (``_resync``): every
step's metrics are held at the tolerance from the same weights, and every
update as above; the optimizer state carries over. One float32 case
carries the port's own weights into the second step instead, so that a
drift in what a step leaves behind still fails: its first step's metrics
at the tolerance, the second's at ``CARRIED_TOL`` (the reading there: loss
2.21e-4 apart at 0.538, pg_loss 2.31e-4 at 1.51), every update as above."""

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
from repro.models import model as jmodel
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch import configs as tconfigs
from repro_torch.configs.base import TrainConfig as TTrainConfig
from repro_torch.convert import lm_state_dict_from_jax, lm_state_dict_to_jax
from repro_torch.core import learner as tlearner
from repro_torch.core import sources as tsources
from repro_torch.models import model as tmodel
from repro_torch.optim import make_optimizer as tmake_optimizer

# The suite runs several test processes side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

TOLS = {"float32": dict(rtol=1e-5, atol=1e-5),
        "bfloat16": dict(rtol=6e-2, atol=6e-2)}
# the reference's --mode lm-rl / --mode lm optimizer settings
LR = 3e-4
RL_TRAIN = dict(optimizer="adamw", learning_rate=LR, grad_clip=1.0,
                total_steps=2, lr_schedule="constant", entropy_cost=0.003)
LM_TRAIN = dict(optimizer="adamw", learning_rate=LR, grad_clip=1.0,
                total_steps=2, lr_schedule="cosine", warmup_steps=10)
# half of AdamW's largest first step of an element (module docstring)
STEP_ATOL = LR / 2
# the xLSTM lm-rl step after a carried first update (module docstring)
CARRIED_TOL = dict(rtol=5e-4, atol=5e-4)


def _setup(arch, dtype, attn, ssd="xla", config=None):
    """``config``: further overrides of the reduced config, applied to
    both packages alike."""
    over = dict(dtype=dtype, attn_impl=attn, ssd_impl=ssd, remat=True,
                **(config or {}))
    jcfg = dataclasses.replace(jconfigs.get_reduced_config(arch), **over)
    tcfg = dataclasses.replace(tconfigs.get_reduced_config(arch), **over)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tparams = tmodel.init(tcfg, seed=0)
    tparams.load_state_dict(lm_state_dict_from_jax(jparams), strict=True)
    return jcfg, tcfg, jparams, tparams


def _leaves(tree, prefix=""):
    for key, child in tree.items():
        if isinstance(child, dict):
            yield from _leaves(child, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", child


def _assert_params_close(tparams, jparams, tol, what):
    """Every parameter within ``tol``, but at most one element in 10,000
    of a leaf, which must lie within STEP_ATOL (module docstring)."""
    got = dict(_leaves(lm_state_dict_to_jax(tparams.state_dict())))
    want = dict(_leaves(jax.tree.map(np.asarray, jparams)))
    assert set(got) == set(want)
    for path, w in want.items():
        g = np.asarray(got[path])
        np.testing.assert_allclose(
            g, w, rtol=tol["rtol"], atol=max(tol["atol"], STEP_ATOL),
            err_msg=f"{path} {what}")
        outside = int((~np.isclose(g, w, **tol)).sum())
        assert outside <= max(1, w.size // 10_000), (
            f"{path} {what}: {outside} of {w.size} elements beyond {tol}")


def _rollout(vocab, t, b, seed):
    """A time-major token rollout: obs (T+1, B), behavior log-probs near
    the uniform policy's, the token task's reward, done at the end."""
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, vocab, (t + 1, b)).astype(np.int32)
    reward = np.asarray(jsources.token_task_reward(jnp.asarray(obs.T),
                                                   vocab)).T
    done = np.zeros((t, b), bool)
    done[-1] = True
    return {"obs": obs, "action": obs[1:],
            "behavior_logprob": (-np.log(vocab) + rng.normal(
                0, 0.1, (t, b))).astype(np.float32),
            "reward": np.ascontiguousarray(reward), "done": done}


def _resync(tparams, jparams):
    """The reference's parameters into the port's tree: the next step
    starts from the same weights (module docstring, xLSTM)."""
    with torch.no_grad():
        tparams.load_state_dict(lm_state_dict_from_jax(jparams),
                                strict=True)


def _compiled(jitted, **compiler_options):
    """``jitted``, compiled at its first call's arguments with XLA's
    ``compiler_options``; later calls take arguments of the same shapes."""
    cache = []

    def call(*args):
        if not cache:
            cache.append(jitted.lower(*args).compile(
                compiler_options=compiler_options))
        return cache[0](*args)
    return call


def _lm_rl_steps(arch, dtype, attn, vtrace, resync=False, later_tol=None,
                 t=16, b=4, config=None, excess_precision=True):
    """``excess_precision=False``: compile the reference's step with XLA's
    ``xla_allow_excess_precision`` off, so that every operation rounds to
    its output type, as the port's do, also inside a fusion."""
    jcfg, tcfg, jparams, tparams = _setup(arch, dtype, attn, config=config)
    jtc, ttc = JTrainConfig(**RL_TRAIN), TTrainConfig(**RL_TRAIN)
    jopt, topt = jmake_optimizer(jtc), tmake_optimizer(ttc)
    jstep = jax.jit(jsources.lm_rl_step_from_rollout(
        jlearner.make_lm_train_step(jcfg, jopt, jtc, loss_chunk=8,
                                    vtrace_impl=vtrace)))
    if not excess_precision:
        jstep = _compiled(jstep, xla_allow_excess_precision=False)
    tstep = tsources.lm_rl_step_from_rollout(
        tlearner.make_lm_train_step(tcfg, topt, ttc, loss_chunk=8,
                                    vtrace_impl=vtrace))
    jstate = jopt.init(jparams)
    tstate = topt.init(list(tparams.parameters()))
    tol = TOLS[dtype]
    for step in range(2):
        rollout = _rollout(tcfg.vocab_size, t, b, seed=10 + step)
        jparams, jstate, jm = jstep(
            jparams, jstate, jnp.int32(step),
            {k: jnp.asarray(v) for k, v in rollout.items()})
        tparams, tstate, tm = tstep(
            tparams, tstate, step,
            {k: torch.from_numpy(v) for k, v in rollout.items()})
        assert set(tm) == set(jm)
        step_tol = later_tol if step and later_tol else tol
        for k in jm:
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                       err_msg=f"{k} step {step}",
                                       **step_tol)
        _assert_params_close(tparams, jparams, tol, f"after step {step}")
        if resync:
            _resync(tparams, jparams)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn,vtrace", [("kernel", "kernel"),
                                         ("xla", "scan")])
def test_lm_rl_train_step_matches_jax(dtype, attn, vtrace):
    _lm_rl_steps("qwen3-4b", dtype, attn, vtrace)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn,vtrace", [("kernel", "kernel"),
                                         ("xla", "scan")])
def test_granite_lm_rl_train_step_matches_jax(dtype, attn, vtrace):
    """Granite's MoE layers under remat: the router's load-balance and
    z-loss terms enter the gradient, as in the reference."""
    _lm_rl_steps("granite-moe-1b-a400m", dtype, attn, vtrace)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vtrace", ["kernel", "scan"])
def test_xlstm_lm_rl_train_step_matches_jax(dtype, vtrace):
    _lm_rl_steps("xlstm-125m", dtype, "xla", vtrace, resync=True)


def test_xlstm_lm_rl_carried_steps_match_jax():
    """Two steps on the port's own weights: the second at CARRIED_TOL."""
    _lm_rl_steps("xlstm-125m", "float32", "xla", "kernel",
                 later_tol=CARRIED_TOL)


def _pretrain_steps(arch, dtype, impl, b=2, s=32, config=None):
    jcfg, tcfg, jparams, tparams = _setup(arch, dtype, impl, impl,
                                          config=config)
    jtc, ttc = JTrainConfig(**LM_TRAIN), TTrainConfig(**LM_TRAIN)
    jopt, topt = jmake_optimizer(jtc), tmake_optimizer(ttc)
    jstep = jax.jit(jlearner.make_lm_pretrain_step(jcfg, jopt,
                                                   loss_chunk=16))
    tstep = tlearner.make_lm_pretrain_step(tcfg, topt, loss_chunk=16)
    jstate = jopt.init(jparams)
    tstate = topt.init(list(tparams.parameters()))
    tol = TOLS[dtype]
    rng = np.random.default_rng(5)
    for step in range(2):
        tokens = rng.integers(0, tcfg.vocab_size, (b, s + 1)).astype(
            np.int32)
        jparams, jstate, jm = jstep(jparams, jstate, jnp.int32(step),
                                    {"tokens": jnp.asarray(tokens)})
        tparams, tstate, tm = tstep(tparams, tstate, step,
                                    {"tokens": torch.from_numpy(tokens)})
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   err_msg=f"loss step {step}", **tol)
        _assert_params_close(tparams, jparams, tol, f"after step {step}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["kernel", "xla"])
def test_lm_pretrain_step_matches_jax(dtype, impl):
    _pretrain_steps("zamba2-2.7b", dtype, impl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["kernel", "xla"])
def test_granite_lm_pretrain_step_matches_jax(dtype, impl):
    """As the lm-rl case: the router's terms in the pretraining gradient,
    through remat's per-group checkpoint regions."""
    _pretrain_steps("granite-moe-1b-a400m", dtype, impl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlstm_lm_pretrain_step_matches_jax(dtype):
    """The sLSTM's 32-step loop and two mLSTM chunks under autograd, with
    remat's per-layer and per-group regions."""
    _pretrain_steps("xlstm-125m", dtype, "xla")
