"""Quickstart: MonoBeast-style IMPALA on Catch, end to end, both actor
architectures running through the same ``Runtime`` (core/runtime.py):

  1. ``HostLoopSource``: actor threads stepping the envs on the CPU, the
     inference queue (DynamicBatcher) and the learner queue
     (BatchingQueue), the paper's MonoBeast/PolyBeast design, for a few
     learner steps;
  2. ``DeviceSource``: the on-device unroll with double-buffered
     dispatch, for the training run, to the optimum (+0.1 a step).

On the card the learner step and the unroll replay CUDA graphs
(``core/compiled.py``), as the reference jits them.

Off-policy replay (core/replay.py) composes over the device source:
``--replay {uniform,elite,attentive}`` mixes ``--replay-ratio`` replayed
rollouts into every learner batch (stored behaviour logits keep V-trace
correct; CLEAR cloning terms regularise the replayed columns), its value
function a CUDA graph of the agent's baseline on the card.

  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.quickstart --replay elite \\
      --replay-ratio 1.0 --steps 800
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.atari_impala import small_train
from repro_torch.core import compiled
from repro_torch.core import learner as learner_lib
from repro_torch.core import replay as replay_lib
from repro_torch.core.runtime import Runtime
from repro_torch.core.sources import DeviceSource, HostLoopSource, ReplaySource
from repro_torch.envs import catch
from repro_torch.models.convnet import minatar_net
from repro_torch.optim import make_optimizer


def _baseline(agent, obs):
    return agent(obs).baseline


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=1500,
                   help="on-device training steps")
    p.add_argument("--replay", default="off",
                   choices=["off", "uniform", "elite", "attentive"])
    p.add_argument("--replay-capacity", type=int, default=512)
    p.add_argument("--replay-ratio", type=float, default=1.0,
                   help="replayed:fresh columns per batch (1.0 = 1:1)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to run; cuda raises when there is no GPU")
    return p


def main(argv=None) -> dict:
    """Run both parts; returns the final reward a step, whether it solved
    Catch, the two Runtimes (``host``, ``device``) and each part's host
    seconds (``host_seconds``; ``device_seconds``: to the final reward
    read)."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    env = catch.make()
    train_cfg = small_train(unroll_length=20, batch_size=32,
                            learning_rate=2e-3, total_steps=2500)
    if args.replay != "off":
        train_cfg = dataclasses.replace(train_cfg, clear_policy_cost=0.01,
                                        clear_value_cost=0.005)
    agent = minatar_net(env.obs_shape, env.num_actions,
                        generator=torch.Generator().manual_seed(0)).to(device)
    opt = make_optimizer(train_cfg)
    # the reference's jax.jit(make_train_step(...)): a CUDA graph per
    # batch structure on the card
    train_step = compiled.TrainStep(
        learner_lib.make_train_step(opt, train_cfg), opt)

    # --- 1. host loop smoke: actors -> inference queue -> learner queue ---
    # The reference's learner state is immutable, so its device run
    # starts again from the initial weights: the host run trains a copy.
    print("== host-loop (MonoBeast) actors: a few learner steps ==")
    host_agent = copy.deepcopy(agent)
    host = HostLoopSource(env, host_agent, num_actors=8,
                          unroll_length=train_cfg.unroll_length,
                          batch_size=8)
    host_runtime = Runtime(
        host, train_step, host_agent,
        opt.init(list(host_agent.parameters())), total_steps=3, log_every=1,
        log_keys=("reward_per_step", "loss"))
    t0 = time.perf_counter()
    host_runtime.run()
    host_seconds = time.perf_counter() - t0

    # --- 2. on-device training to convergence (double-buffered) ---
    print(f"== on-device (compiled, double-buffered) IMPALA training "
          f"(replay={args.replay}) ==")
    source = DeviceSource.for_env(
        env, agent, unroll_length=train_cfg.unroll_length,
        batch_size=train_cfg.batch_size, seed=1, pipelined=True)
    if args.replay != "off":
        source = ReplaySource(
            source, replay_lib.make_buffer(args.replay,
                                           args.replay_capacity),
            replay_ratio=args.replay_ratio,
            value_fn=compiled.Forward(_baseline))
    runtime = Runtime(source, train_step, agent,
                      opt.init(list(agent.parameters())),
                      total_steps=args.steps,
                      log_every=max(args.steps // 10, 1),
                      log_keys=("reward_per_step",))
    t0 = time.perf_counter()
    runtime.run()
    final = float(runtime.metrics["reward_per_step"])
    device_seconds = time.perf_counter() - t0
    solved = final > 0.05
    print(f"done: reward/step={final:+.3f} (optimal +0.100) "
          f"({'SOLVED' if solved else 'not solved'})")
    return {"reward_per_step": final, "solved": solved,
            "host": host_runtime, "device": runtime,
            "host_seconds": host_seconds, "device_seconds": device_seconds}


if __name__ == "__main__":
    main()
