"""The LM learner steps against the JAX reference for the four families
``tests/test_torch_lm_learner.py`` does not train: ``gemma2-27b`` (softcap
50 on the scores and 30 on the logits, a local and a global layer with the
reduced window of 32, sandwich norms, the tied and scaled embedding),
``mixtral-8x7b`` (top-2 of 4 experts under remat, the window of 32),
``deepseek-coder-33b`` (also at its published group of 7 query heads per KV
head, which the reduced 4 over 2 hides) and ``musicgen-large`` (LayerNorm,
sinusoidal positions, GELU, MHA).

Each case is two AdamW steps from the same converted weights, on that
file's fixed numpy inputs and at its bars (``TOLS``, ``_assert_params_close``
with ``STEP_ATOL``): ``make_lm_train_step`` through
``lm_rl_step_from_rollout`` (T 16, B 4) and ``make_lm_pretrain_step``
(B 2, S 32). Gemma2 and Mixtral pretrain at S 48, past the window, so that
it binds in the attention's forward and in its backward's recompute.

Two gaps are the reference's own arithmetic, each shown by a named test:

* AdamW's first update of an element is -lr * g / (|g| + eps). After the
  first float32 lm-rl step, the few elements beyond the bar (1 to 4 in a
  leaf) all have a gradient within ten eps of zero
  (``test_step_outliers_sit_where_adamw_divides_by_eps``), where a float32
  difference of summation order moves the update by a good part of lr.
  Carried into the second step, they move Mixtral's loss by 6.4e-5 (at
  5.10) and one element of DeepSeek's (group of 7) embedding by 2.8e-4. So
  those lm-rl cases restart each step from the reference's parameters, as
  ``test_torch_lm_learner.py`` does for the xLSTM (``_resync``).
* Mixtral's router picks its top 2 of 4 experts from float32 logits of
  bf16 activations. The reference's jitted program lets XLA keep float32
  inside a fusion (``xla_allow_excess_precision``, on by default), so its
  activations round otherwise than the port's, and tokens at a near tie
  take other experts: on the lm-rl tokens the jitted forward and the same
  program compiled with that option off differ by 2.1 in a logit, while
  the port is within the bf16 bar of the latter
  (``test_mixtral_bf16_routing_gap_is_xla_excess_precision``). So
  Mixtral's bf16 lm-rl case holds the port to the reference's step
  compiled with the option off (``excess_precision=False``), and restarts
  its second step from the reference's parameters too: carried, the
  first update's bf16 gaps move the second step's routing (loss 6.18
  against 5.72).

Beside them, ``chip_smoke.py``'s count of a learner step's kernel
launches under remat (``remat_step_launches``, which its phases hold the
card's runs to) is held to the wrappers' calls in reduced steps: torch's
checkpoint does not rerun the last layer of a Gemma2 group in the group's
recomputation."""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro_torch import configs as tconfigs
from repro.core import learner as jlearner
from repro.core import sources as jsources
from repro.models import model as jmodel
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch.configs.base import TrainConfig as TTrainConfig
from repro_torch.convert import lm_state_dict_to_jax
from repro_torch.core import learner as tlearner
from repro_torch.core import sources as tsources
from repro_torch.kernels import ops as kops
from repro_torch.models import model as tmodel
from repro_torch.optim import make_optimizer as tmake_optimizer
from test_torch_lm_learner import (LM_TRAIN, RL_TRAIN, TOLS, _compiled,
                                   _leaves, _lm_rl_steps, _pretrain_steps,
                                   _rollout, _setup)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import remat_step_launches  # noqa: E402

# The suite runs several test processes side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

FAMILIES = ["gemma2-27b", "mixtral-8x7b", "deepseek-coder-33b",
            "musicgen-large"]
# sequence lengths past the reduced sliding window of 32
PRETRAIN_S = {"gemma2-27b": 48, "mixtral-8x7b": 48}
# reduced DeepSeek-Coder with the published group of 7 query heads per KV
# head (56 over 8 at full width)
GROUP_OF_7 = dict(num_heads=14, num_kv_heads=2)
# the lm-rl cases whose second step restarts from the reference's
# parameters (module docstring; also DeepSeek's group of 7)
RESYNC = {"mixtral-8x7b"}
# ten times AdamW's eps (1e-8): the gradients whose update a float32
# difference of summation order moves by a good part of lr
NEAR_EPS = 1e-7


@pytest.mark.parametrize("dtype,attn,vtrace", [
    ("float32", "kernel", "kernel"), ("float32", "xla", "scan"),
    ("bfloat16", "kernel", "kernel")])
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_lm_rl_train_step_matches_jax(arch, dtype, attn, vtrace):
    bf16_mixtral = arch == "mixtral-8x7b" and dtype == "bfloat16"
    _lm_rl_steps(arch, dtype, attn, vtrace,
                 resync=arch in RESYNC,
                 excess_precision=not bf16_mixtral)


@pytest.mark.parametrize("dtype,impl", [
    ("float32", "kernel"), ("float32", "xla"), ("bfloat16", "kernel")])
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_lm_pretrain_step_matches_jax(arch, dtype, impl):
    _pretrain_steps(arch, dtype, impl, s=PRETRAIN_S.get(arch, 32))


def test_group_of_7_lm_rl_train_step_matches_jax():
    _lm_rl_steps("deepseek-coder-33b", "float32", "kernel", "kernel",
                 resync=True, config=GROUP_OF_7)


def test_group_of_7_lm_pretrain_step_matches_jax():
    _pretrain_steps("deepseek-coder-33b", "float32", "kernel",
                    config=GROUP_OF_7)


@pytest.mark.parametrize("arch,attn,vtrace,config", [
    ("mixtral-8x7b", "xla", "scan", None),
    ("deepseek-coder-33b", "kernel", "kernel", GROUP_OF_7)])
def test_step_outliers_sit_where_adamw_divides_by_eps(arch, attn, vtrace,
                                                      config):
    """One float32 lm-rl step from the same weights: every parameter
    element beyond the bar has a reference gradient (AdamW's first moment
    over 1 - b1) below NEAR_EPS, while the median gradient is more than a
    hundred times larger."""
    jcfg, tcfg, jparams, tparams = _setup(arch, "float32", attn,
                                          config=config)
    jtc, ttc = JTrainConfig(**RL_TRAIN), TTrainConfig(**RL_TRAIN)
    jopt, topt = jmake_optimizer(jtc), tmake_optimizer(ttc)
    jstep = jax.jit(jsources.lm_rl_step_from_rollout(
        jlearner.make_lm_train_step(jcfg, jopt, jtc, loss_chunk=8,
                                    vtrace_impl=vtrace)))
    tstep = tsources.lm_rl_step_from_rollout(
        tlearner.make_lm_train_step(tcfg, topt, ttc, loss_chunk=8,
                                    vtrace_impl=vtrace))
    rollout = _rollout(tcfg.vocab_size, 16, 4, seed=10)
    jparams, jstate, _ = jstep(
        jparams, jopt.init(jparams), jnp.int32(0),
        {k: jnp.asarray(v) for k, v in rollout.items()})
    tparams, _, _ = tstep(
        tparams, topt.init(list(tparams.parameters())), 0,
        {k: torch.from_numpy(v) for k, v in rollout.items()})
    got = dict(_leaves(lm_state_dict_to_jax(tparams.state_dict())))
    want = dict(_leaves(jax.tree.map(np.asarray, jparams)))
    grad = {path: np.abs(mu) / (1 - jtc.adam_b1) for path, mu in
            _leaves(jax.tree.map(np.asarray, jstate["mu"]))}
    median = np.median(np.concatenate([g.ravel() for g in grad.values()]))
    assert median > 100 * NEAR_EPS
    for path, w in want.items():
        beyond = ~np.isclose(np.asarray(got[path]), w, **TOLS["float32"])
        assert np.all(grad[path][beyond] < NEAR_EPS), (
            f"{path}: gradients {grad[path][beyond]} beyond the bar")


def test_mixtral_bf16_routing_gap_is_xla_excess_precision():
    """Mixtral's bf16 forward on the lm-rl step's tokens: the reference's
    jitted program, and the same program compiled with XLA's
    ``xla_allow_excess_precision`` off, disagree beyond the bf16 bar (a
    token at a near tie routed to other experts); the port agrees with the
    latter within it."""
    jcfg, tcfg, jparams, tparams = _setup("mixtral-8x7b", "bfloat16",
                                          "kernel")
    rollout = _rollout(tcfg.vocab_size, 16, 4, seed=10)
    tokens = np.ascontiguousarray(rollout["obs"].T)
    apply = jax.jit(lambda p, t: jmodel.apply_lm(p, t, cfg=jcfg)[:2])
    jitted = apply(jparams, jnp.asarray(tokens))
    exact = _compiled(apply, xla_allow_excess_precision=False)(
        jparams, jnp.asarray(tokens))
    with torch.no_grad():
        port = tmodel.apply_lm(tparams, torch.from_numpy(tokens),
                               cfg=tcfg)[:2]
    bar = TOLS["bfloat16"]
    as_np = lambda x: np.asarray(x, np.float32)   # noqa: E731
    assert not np.allclose(as_np(jitted[0]), as_np(exact[0]), **bar)
    for got, want, what in zip(port, exact, ("logits", "baseline")):
        np.testing.assert_allclose(got.float().numpy(), as_np(want),
                                   err_msg=what, **bar)


@pytest.mark.parametrize("arch,groups", [
    ("gemma2-27b", 2), ("mixtral-8x7b", 2), ("zamba2-2.7b", 1),
    ("llama-3.2-vision-90b", 1)])
def test_remat_step_launches_counts_the_checkpoint_early_stop(
        monkeypatch, arch, groups):
    """One reduced pretraining step under remat on the kernel paths calls
    the flash-attention and SSD-chunk wrappers as often as
    ``remat_step_launches`` counts: Gemma2's global layer, last in its
    group's region, twice (not rerun in the group's recomputation);
    Zamba2's Mamba2 layers, followed by the shared block, thrice a chunk;
    the VLM's self-attention layer, first of its pair, thrice."""
    cfg = dataclasses.replace(tconfigs.get_reduced_config(arch),
                              attn_impl="kernel", ssd_impl="kernel",
                              remat=True, num_groups=groups)
    calls = {"flash_attention": 0, "ssd_chunk": 0}
    for name, wrapper in (("flash_attention", "flash_attention"),
                          ("ssd_chunk", "ssd_chunk_trainable")):
        def counted(*args, _fn=getattr(kops, wrapper), _name=name,
                    **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(kops, wrapper, counted)
    params = tmodel.init(cfg, seed=0)
    opt = tmake_optimizer(TTrainConfig(**LM_TRAIN))
    step = tlearner.make_lm_pretrain_step(cfg, opt, loss_chunk=16)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 33))
    batch = {"tokens": torch.from_numpy(tokens)}
    if cfg.vision_seq:
        batch["vision"] = torch.zeros((2, cfg.vision_seq, cfg.d_model))
    step(params, opt.init(list(params.parameters())), 0, batch)
    assert calls == remat_step_launches(cfg, 32)
