"""The paper's canonical adaptation (Figs. 1-2): swap the environment for a
MinAtar-style task and the agent for the small MinAtar ConvNet: two
changes, exactly as TorchBeast prescribes.

The unroll and the learner step run as one program, as the reference jits
them together: on the card one CUDA graph of both
(``compiled.UnrollTrainStep``), the env carry in static buffers updated
in place.

  PYTHONPATH=src python -m repro_torch.examples.minatar_gridworld \\
      [--steps 800]
  PYTHONPATH=src python -m repro_torch.examples.minatar_gridworld \\
      --steps 3 --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.atari_impala import small_train
from repro_torch.core import compiled
from repro_torch.core import learner as learner_lib
from repro_torch.core import rollout as rollout_lib
from repro_torch.envs import gridworld  # <- the create_env swap (Fig. 1)
from repro_torch.models.convnet import minatar_net  # <- Fig. 2 model
from repro_torch.optim import make_optimizer


def build(steps: int, device="cuda"):
    """(combined, agent, opt_state, train_cfg): the weights from seed 0,
    the envs reset and the unroll drawing from a generator seeded 1, the
    unroll and the learner step as one ``compiled.UnrollTrainStep``."""
    device = resolve_device(device)
    env = gridworld.make()
    train_cfg = small_train(unroll_length=20, batch_size=32,
                            learning_rate=1e-3, total_steps=steps + 1000)
    agent = minatar_net(env.obs_shape, env.num_actions,
                        generator=torch.Generator().manual_seed(0)).to(device)
    opt = make_optimizer(train_cfg)
    opt_state = opt.init(list(agent.parameters()))
    gen = torch.Generator(device=device).manual_seed(1)
    carry = rollout_lib.env_reset_batch(env, gen, train_cfg.batch_size,
                                        device)
    unroll = rollout_lib.make_unroll(env, train_cfg.unroll_length)
    train_step = learner_lib.make_train_step(opt, train_cfg)
    combined = compiled.UnrollTrainStep(
        compiled.Unroll(unroll, carry, gen),
        compiled.TrainStep(train_step, opt))
    return combined, agent, opt_state, train_cfg


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to run; cuda raises when there is no GPU")
    return p


def main(argv=None) -> dict:
    """Train and print the reference's lines; returns the printed steps'
    reward a step and fps, the last metrics and the run's seconds."""
    args = _parser().parse_args(argv)
    combined, agent, opt_state, cfg = build(args.steps, args.device)
    frames = cfg.batch_size * cfg.unroll_length
    lines = []
    t0 = time.time()
    for step in range(args.steps):
        agent, opt_state, m = combined(agent, opt_state, step)
        if step % max(1, args.steps // 15) == 0 or step == args.steps - 1:
            reward = float(m["reward_per_step"])
            fps = (step + 1) * frames / (time.time() - t0)
            print(f"step {step:5d} reward/step={reward:+.3f} fps={fps:.0f}")
            lines.append({"step": step, "reward_per_step": reward,
                          "fps": fps})
    return {"lines": lines, "metrics": m, "seconds": time.time() - t0,
            "captures": combined.captures}


if __name__ == "__main__":
    main()
