"""The xLSTM mixers and the VLM's cross-attention under a model axis
(ROADMAP item 26), gloo ranks on the CPU, against the reference's
UNMESHED functions on the same JAX weights (``repro_torch.convert``) and
the same numpy-seeded inputs:

* reduced ``xlstm-125m`` (mLSTM + sLSTM) at (1, 2) and (2, 2): both LM
  steps from the initial weights (losses within 1e-5, the bar of
  ``tests/test_torch_mesh2d_parity.py``, taken relative as well as
  absolute as ``tests/test_torch_lm_learner.py`` holds float32: the
  xLSTM's lm-rl losses are 5.6 and 13.0, and the port's unmeshed step
  already lies 1.6e-5 from the reference's there), a two-step AdamW
  trajectory (losses within 1e-4), and a prefill of 8 tokens followed by
  4 teacher-forced decode steps (logits within 1e-5);
* reduced ``llama-3.2-vision-90b`` (self- and cross-attention) at
  (1, 2): the same, with the vision input feeding the ``xattn`` layers in
  the steps and the prefill.

Each mesh is one spawned group whose ranks run every case of it. This
module's top level imports no JAX: spawned ranks import it to find their
worker functions.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import TrainConfig, get_reduced_config
from repro_torch.convert import lm_state_dict_from_jax
from repro_torch.core import learner
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as model_lib
from repro_torch.models.common import use_rules
from repro_torch.optim import make_optimizer

torch.set_num_threads(1)

B, S, PROMPT, DECODE = 4, 16, 8, 4
LR = 1e-3
STEP_TOL, TRAJ_TOL, LOGIT_TOL = 1e-5, 1e-4, 1e-5
RULES = sharding.MEGATRON_RULES
CASES = {(1, 2): ("xlstm-125m", "llama-3.2-vision-90b"),
         (2, 2): ("xlstm-125m",)}
MODES = ("lm", "lm-rl")


def _train_cfg():
    return dict(optimizer="adamw", learning_rate=LR, grad_clip=1.0,
                lr_schedule="constant", total_steps=2)


def _inputs(cfg):
    rng = np.random.default_rng(0)
    out = {}
    for mode in MODES:
        steps = []
        for _ in range(2):
            tokens = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(
                np.int32)
            b = {"tokens": tokens}
            if mode == "lm-rl":        # the reference test's episodes
                target = (5 * tokens[:, :-1] + 3) % cfg.vocab_size
                b["behavior_logprob"] = np.full(
                    (B, S), -np.log(cfg.vocab_size), np.float32)
                b["reward"] = (tokens[:, 1:] == target).astype(np.float32)
                b["done"] = np.zeros((B, S), bool)
                b["done"][:, -1] = True
            if cfg.vision_seq:
                b["vision"] = rng.normal(0, 1, (B, cfg.vision_seq,
                                                cfg.d_model)).astype(
                    np.float32)
            steps.append(b)
        out[mode] = steps
    out["decode"] = rng.integers(0, cfg.vocab_size,
                                 (B, PROMPT + DECODE)).astype(np.int32)
    if cfg.vision_seq:
        out["vision"] = rng.normal(0, 1, (B, cfg.vision_seq,
                                          cfg.d_model)).astype(np.float32)
    return out


def _make_step(cfg, mode, mesh):
    train_cfg = TrainConfig(entropy_cost=0.003, **_train_cfg())
    opt = make_optimizer(train_cfg)
    if mode == "lm":
        return opt, learner.make_lm_pretrain_step(
            cfg, opt, loss_chunk=S, mesh=mesh, rules=RULES)
    return opt, learner.make_lm_train_step(
        cfg, opt, train_cfg, loss_chunk=S, vtrace_impl="scan", mesh=mesh,
        rules=RULES)


def _port_case(mesh, arch, state_dict, inputs):
    """Per-step losses, the trajectory's losses and the decode logits of
    one arch on this rank."""
    cfg = get_reduced_config(arch)

    def fresh():
        params = model_lib.init(cfg, seed=0)
        params.load_state_dict(state_dict)
        return model_lib.shard_model(params, cfg, mesh, RULES)

    def local(batch):
        return sharding.shard_lm_batch(
            {k: torch.as_tensor(v) for k, v in batch.items()}, mesh, RULES)

    out = {}
    for mode in MODES:
        opt, step = _make_step(cfg, mode, mesh)
        per_step = []
        for batch in inputs[mode]:
            params = fresh()
            _, _, m = step(params, opt.init(list(params.parameters())), 0,
                           local(batch))
            per_step.append(float(m["loss"]))
        params = fresh()
        opt_state, trajectory = opt.init(list(params.parameters())), []
        for s, batch in enumerate(inputs[mode]):
            params, opt_state, m = step(params, opt_state, s, local(batch))
            trajectory.append(float(m["loss"]))
        out[mode] = (per_step, trajectory)
    params = fresh()
    tokens = torch.as_tensor(inputs["decode"])
    vision = torch.as_tensor(inputs["vision"]) if cfg.vision_seq else None
    with torch.no_grad(), use_rules(mesh, RULES):
        h, _, cache = model_lib.prefill(params, tokens[:, :PROMPT], cfg=cfg,
                                        vision=vision,
                                        cache_seq_len=PROMPT + DECODE)
        logits = [model_lib.logits_from_hidden(params, cfg, h[:, -1:])]
        for t in range(PROMPT, PROMPT + DECODE - 1):
            lg, _, cache = model_lib.serve_step(
                params, tokens[:, t:t + 1], cache, t, cfg=cfg)
            logits.append(lg)
    out["logits"] = torch.cat(logits, dim=1).numpy()
    return out


def _rank(mesh, cases):
    return sharding.gather_to_main(
        {arch: _port_case(mesh, arch, sd, inputs)
         for arch, (sd, inputs) in cases.items()}, mesh)


def _reference(arch):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced_config as jreduced
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.core import learner as jlearner
    from repro.models import model as jmodel
    from repro.optim import make_optimizer as jmake_optimizer

    cfg = jreduced(arch)
    inputs = _inputs(cfg)
    tc = JTrainConfig(**_train_cfg())
    opt = jmake_optimizer(tc)
    params0, _ = jmodel.init(jax.random.PRNGKey(0), cfg)
    out = {}
    for mode in MODES:
        if mode == "lm":
            fn = jlearner.make_lm_pretrain_step(cfg, opt, loss_chunk=S)
        else:
            fn = jlearner.make_lm_train_step(
                cfg, opt, JTrainConfig(entropy_cost=0.003, **_train_cfg()),
                loss_chunk=S)
        step = jax.jit(fn)
        batches = [{k: jnp.asarray(v) for k, v in b.items()}
                   for b in inputs[mode]]
        per_step = [float(step(params0, opt.init(params0), jnp.int32(0),
                               b)[2]["loss"]) for b in batches]
        params, opt_state, trajectory = params0, opt.init(params0), []
        for s, b in enumerate(batches):
            params, opt_state, m = step(params, opt_state, jnp.int32(s), b)
            trajectory.append(float(m["loss"]))
        out[mode] = (per_step, trajectory)
    tokens = jnp.asarray(inputs["decode"])
    vision = jnp.asarray(inputs["vision"]) if cfg.vision_seq else None
    h, _, cache = jmodel.prefill(params0, tokens[:, :PROMPT], cfg=cfg,
                                 vision=vision,
                                 cache_seq_len=PROMPT + DECODE)
    logits = [jmodel.logits_from_hidden(params0, cfg, h[:, -1:])]
    for t in range(PROMPT, PROMPT + DECODE - 1):
        lg, _, cache = jmodel.serve_step(params0, tokens[:, t:t + 1], cache,
                                         jnp.int32(t), cfg=cfg)
        logits.append(lg)
    out["logits"] = np.concatenate([np.asarray(x) for x in logits], axis=1)
    return lm_state_dict_from_jax(params0), inputs, out


@pytest.fixture(scope="module")
def runs():
    from conftest import free_port
    refs = {arch: _reference(arch) for arch in CASES[(1, 2)]}
    got = {}
    for (data, model), archs in CASES.items():
        cases = {a: refs[a][:2] for a in archs}
        got[(data, model)] = mesh_lib.launch(
            _rank, data * model, device="cpu", model=model,
            args=(cases,), port=free_port(), timeout_s=120.0)
    return refs, got


CASE_IDS = [(m, a) for m, archs in CASES.items() for a in archs]


@pytest.mark.parametrize("mesh,arch", CASE_IDS)
@pytest.mark.parametrize("mode", MODES)
def test_lm_steps_match_reference_unmeshed(runs, mesh, arch, mode):
    refs, got = runs
    want_step, want_traj = refs[arch][2][mode]
    for rank, out in enumerate(got[mesh]):
        per_step, trajectory = out[arch][mode]
        np.testing.assert_allclose(per_step, want_step, rtol=STEP_TOL,
                                   atol=STEP_TOL, err_msg=f"rank {rank}")
        np.testing.assert_allclose(trajectory, want_traj, rtol=TRAJ_TOL,
                                   atol=TRAJ_TOL, err_msg=f"rank {rank}")


@pytest.mark.parametrize("mesh,arch", CASE_IDS)
def test_prefill_and_decode_match_reference_unmeshed(runs, mesh, arch):
    refs, got = runs
    want = refs[arch][2]["logits"]
    for rank, out in enumerate(got[mesh]):
        np.testing.assert_allclose(out[arch]["logits"], want, rtol=0,
                                   atol=LOGIT_TOL, err_msg=f"rank {rank}")
