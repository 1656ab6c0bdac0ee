"""Each configuration's plain reference against the port, at a tiny size
on the CPU, from the same weights and inputs: the forward passes, the
generation's log-probabilities and the learner steps. Both sides run in
float32 here (the decoder's activation type set to float32), so they
agree to rounding. CPU only; imports no JAX."""

import copy
import dataclasses
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[:0] = [p for p in (ROOT, os.path.join(ROOT, "src"))
                if p not in sys.path]

from perfbench import bench  # noqa: E402
from perfbench.configs import granite_3_0_1b_a400m as granite_w  # noqa: E402
from perfbench.configs import impala_deep_atari as atari_w  # noqa: E402
from perfbench.reference import common  # noqa: E402
from perfbench.reference import granite_3_0_1b_a400m as granite_ref  # noqa: E402
from perfbench.reference import impala_deep_atari as atari_ref  # noqa: E402

ATARI = bench.merged(bench.read_json("configs", "impala_deep_atari.json"),
                     {"agent": {"obs_shape": [20, 20, 4], "num_actions": 6}})
GRANITE = bench.merged(
    bench.read_json("configs", "granite_3_0_1b_a400m.json"),
    {"model": {"d_model": 64, "num_heads": 4, "num_kv_heads": 2,
               "head_dim": 16, "num_experts": 8, "num_experts_per_tok": 2,
               "moe_d_ff": 32, "vocab_size": 128, "num_groups": 2,
               "dtype": "float32", "attn_impl": "xla"},
     "train": {"lr_schedule": "constant"}})


def _agent(w):
    from repro_torch.models.convnet import impala_deep
    a = ATARI["agent"]
    agent = impala_deep(tuple(a["obs_shape"]), a["num_actions"],
                        channels=tuple(a["channels"]), fc=a["fc"])
    agent.load_state_dict(w)
    return agent


def _rollout(gen, t=4, b=3):
    a = ATARI["agent"]
    return {"obs": torch.rand((t + 1, b) + tuple(a["obs_shape"]),
                              generator=gen),
            "action": torch.randint(0, a["num_actions"], (t, b),
                                    generator=gen, dtype=torch.int32),
            "behavior_logits": 0.5 * torch.randn((t, b, a["num_actions"]),
                                                 generator=gen),
            "reward": (torch.rand((t, b), generator=gen) < 0.3).float(),
            "done": torch.rand((t, b), generator=gen) < 0.2}


def test_atari_forward_matches_the_port():
    w = atari_w.make_weights(ATARI, 3, "cpu")
    obs = torch.rand((3, 2, 20, 20, 4), generator=torch.Generator()
                     .manual_seed(1))
    logits, baseline = atari_ref.forward(w, obs, ATARI)
    out = _agent(w)(obs)
    torch.testing.assert_close(logits, out.policy_logits, rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(baseline, out.baseline, rtol=1e-5, atol=1e-6)


def test_atari_learner_steps_match_the_port():
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import learner
    from repro_torch.optim import make_optimizer
    w = atari_w.make_weights(ATARI, 4, "cpu")
    gen = torch.Generator().manual_seed(2)
    batches = [_rollout(gen) for _ in range(3)]
    train_cfg = TrainConfig(**ATARI["train"])
    agent = _agent(w)
    opt = make_optimizer(train_cfg)
    step = learner.make_train_step(opt, train_cfg, vtrace_impl="scan")
    state = opt.init(list(agent.parameters()))
    losses = []
    for i, b in enumerate(batches):
        agent, state, metrics = step(agent, state, i, b)
        losses.append(float(metrics["loss"]))
    ref = atari_ref.follow(copy.deepcopy(w), batches, ATARI)
    assert losses == pytest.approx(ref["loss"], rel=1e-5)
    for name, p in agent.named_parameters():
        torch.testing.assert_close(p.detach(), ref["after"][-1][name],
                                   rtol=1e-4, atol=1e-6)


def _granite_params(w):
    from perfbench.families.decoder import model_config
    from repro_torch.models import model as model_lib
    cfg = model_config(GRANITE)
    params = model_lib.init(cfg, seed=0, device="cpu")
    with torch.no_grad():
        for name, p in params.named_parameters():
            p.copy_(w[name])
    return cfg, params


@pytest.mark.parametrize("rows", [2, 32])   # one MoE group; two, with drops
def test_granite_forward_matches_the_port(rows):
    from repro_torch.models import model as model_lib
    w = granite_w.make_weights(GRANITE, 5, "cpu")
    cfg, params = _granite_params(w)
    cfg = dataclasses.replace(cfg, capacity_factor=1.0)
    tokens = torch.randint(0, 128, (rows, 32),
                           generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        hidden, aux, _ = model_lib.forward(params, tokens, cfg=cfg)
        m = dict(GRANITE["model"], capacity_factor=1.0)
        ref, lb, z = granite_ref.forward(w, tokens, m)
    torch.testing.assert_close(ref, hidden, rtol=1e-4, atol=1e-5)
    assert float(lb) == pytest.approx(float(aux[0]), rel=1e-5)
    assert float(z) == pytest.approx(float(aux[1]), rel=1e-5)


def test_granite_served_logprobs_match_the_generation():
    from repro_torch.core.sources import GeneratorSource
    w = granite_w.make_weights(GRANITE, 6, "cpu")
    cfg, params = _granite_params(w)
    source = GeneratorSource(cfg, batch_size=6, episode_length=10, seed=9)
    batch = source.next_batch(params)
    served = granite_ref.served_logprobs(w, batch, GRANITE)
    torch.testing.assert_close(served, batch["behavior_logprob"],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["lm_rl", "lm"])
def test_granite_learner_steps_match_the_port(mode):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import learner, sources
    from repro_torch.optim import make_optimizer
    w = granite_w.make_weights(GRANITE, 7, "cpu")
    cfg, params = _granite_params(w)
    train = {k: v for k, v in GRANITE["train"].items()
             if k in {f.name for f in dataclasses.fields(TrainConfig)}}
    train_cfg = TrainConfig(**train)
    opt = make_optimizer(train_cfg)
    gen = torch.Generator().manual_seed(4)
    if mode == "lm_rl":
        step = sources.lm_rl_step_from_rollout(learner.make_lm_train_step(
            cfg, opt, train_cfg, loss_chunk=8, vtrace_impl="scan"))
        source = sources.GeneratorSource(cfg, batch_size=4,
                                         episode_length=8, seed=3)
    else:
        step = learner.make_lm_pretrain_step(cfg, opt, loss_chunk=16)
    state = opt.init(list(params.parameters()))
    batches, losses = [], []
    for i in range(3):
        batch = source.next_batch(params) if mode == "lm_rl" else {
            "tokens": torch.randint(0, 128, (4, 17), generator=gen)}
        batches.append({k: v.clone() for k, v in batch.items()})
        params, state, metrics = step(params, state, i, batch)
        losses.append(float(metrics["loss"]))
    ref_w = granite_w.make_weights(GRANITE, 7, "cpu")
    ref = granite_ref.follow(ref_w, batches, GRANITE, mode)
    assert losses == pytest.approx(ref["loss"], rel=1e-4, abs=1e-6)
    for name, p in params.named_parameters():
        torch.testing.assert_close(p.detach(), ref_w[name], rtol=1e-3,
                                   atol=1e-5)


def test_casts_round_as_named():
    x = torch.tensor([1.0 + 2 ** -12, 3.0, 1.0 + 2 ** -20])
    tf32 = common.make_cast("tf32")(x)
    assert tf32.tolist() == [1.0, 3.0, 1.0]
    assert common.make_cast("float32")(x) is x
    fp8 = common.make_cast("fp8")(torch.tensor([1.06, 448.0, 1000.0]))
    assert fp8.tolist()[:2] == [1.0, 448.0]
