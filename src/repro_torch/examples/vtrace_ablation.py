"""V-trace off-policy-correction ablation (the paper's section 2
motivation, quantified): actors run a LAGGED copy of the policy, as they
do in any asynchronous IMPALA deployment
(``DeviceSource(param_sync_every=lag)``); the learner either

  * corrected:   V-trace with the true behaviour logits (TorchBeast), or
  * uncorrected: pretends the data is on-policy (rho forced to 1), a
                 learner step written around ``make_train_step`` by the
                 user, captured as a CUDA graph on the card as the
                 reference jits it.

With no lag both match A2C; with lag the uncorrected learner trains on a
biased policy gradient.

  PYTHONPATH=src python -m repro_torch.examples.vtrace_ablation \\
      [--steps 700 --lag 10]
  PYTHONPATH=src python -m repro_torch.examples.vtrace_ablation \\
      --steps 6 --lag 2 --seeds 1 --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.atari_impala import small_train
from repro_torch.core import compiled
from repro_torch.core import learner as learner_lib
from repro_torch.core import vtrace as vtrace_lib
from repro_torch.core.runtime import Runtime
from repro_torch.core.sources import DeviceSource
from repro_torch.envs import catch
from repro_torch.models.convnet import minatar_net
from repro_torch.optim import make_optimizer


def uncorrected(train_step):
    """The uncorrected arm's learner step: the behaviour logits
    overwritten with the learner's own (rho == 1 identically), then
    ``train_step``. The logits are the first T rows of a forward over the
    batch's T+1 observations, the very call the learner's loss makes, so
    the two sides' log-probabilities agree to the bit (a forward over T
    rows alone may take other convolution and GEMM algorithms on the
    card)."""

    def uncorrected_step(params, opt_state, step, batch):
        with torch.no_grad():
            logits = params(batch["obs"]).policy_logits[:-1]
        batch = dict(batch, behavior_logits=logits)
        return train_step(params, opt_state, step, batch)

    return uncorrected_step


def log_rhos(agent, batch):
    """The log importance weights (T, B) that the learner's loss takes of
    ``batch`` under ``agent``'s weights: 0 everywhere, to the bit, in an
    uncorrected batch."""
    with torch.no_grad():
        target = agent(batch["obs"]).policy_logits[:-1]
    return (vtrace_lib._action_log_probs(target, batch["action"])
            - vtrace_lib._action_log_probs(batch["behavior_logits"],
                                           batch["action"]))


def build(corrected: bool, lag: int, steps: int, seed: int = 0,
          lr: float = 2e-3, device="cuda"):
    """(source, step_fn, agent, opt): one arm, its weights from ``seed``,
    its actors' generator from ``seed + 1``, the actors' weights synced
    every ``lag`` learner steps (lag 0: every step)."""
    device = resolve_device(device)
    env = catch.make()
    tc = small_train(unroll_length=20, batch_size=32, learning_rate=lr,
                     total_steps=steps + 1000)
    agent = minatar_net(
        env.obs_shape, env.num_actions,
        generator=torch.Generator().manual_seed(seed)).to(device)
    opt = make_optimizer(tc)
    source = DeviceSource.for_env(
        env, agent, unroll_length=tc.unroll_length,
        batch_size=tc.batch_size, seed=seed + 1, pipelined=False,
        param_sync_every=max(1, lag))
    train_step = learner_lib.make_train_step(opt, tc)
    step_fn = compiled.TrainStep(
        train_step if corrected else uncorrected(train_step), opt)
    return source, step_fn, agent, opt


def run(corrected: bool, lag: int, steps: int, seed: int = 0,
        lr: float = 2e-3, device="cuda"):
    """One arm's mean reward a step over its last 100 steps."""
    source, step_fn, agent, opt = build(corrected, lag, steps, seed, lr,
                                        device)
    rewards = []
    Runtime(source, step_fn, agent, opt.init(list(agent.parameters())),
            total_steps=steps, log_every=0,
            on_metrics=lambda s, m: rewards.append(
                m["reward_per_step"])).run()
    return float(np.mean(torch.stack(rewards[-100:]).double().cpu()
                         .numpy()))


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=700)
    p.add_argument("--lag", type=int, default=40)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to run; cuda raises when there is no GPU")
    return p


def main(argv=None) -> list:
    """Print the four arms' CSV lines; returns a row each: arm, lag, the
    seeds' final rewards and the arm's host seconds (all seeds)."""
    args = _parser().parse_args(argv)
    resolve_device(args.device)
    print(f"arm,lag,mean_final_reward_over_{args.seeds}_seeds "
          f"(optimal +0.100)")
    rows = []
    for corrected in (True, False):
        for lag in (0, args.lag):
            t0 = time.perf_counter()
            rs = [run(corrected, lag, args.steps, seed=s, lr=args.lr,
                      device=args.device) for s in range(args.seeds)]
            seconds = time.perf_counter() - t0
            arm = "vtrace" if corrected else "uncorrected"
            print(f"{arm},{lag},{np.mean(rs):+.3f} (min {min(rs):+.3f})",
                  flush=True)
            rows.append({"arm": arm, "lag": lag, "rewards": rs,
                         "seconds": seconds})
    return rows


if __name__ == "__main__":
    main()
