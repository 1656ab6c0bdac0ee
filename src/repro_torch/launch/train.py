"""Training entry point, ``--mode rl-agent``: config -> Runtime assembly.

Paper-faithful IMPALA: on-device rollouts (catch/gridworld envs) + conv
agent + V-trace learner, double-buffered by default (``--sync`` to
disable). The V-trace recursion runs in the fused CUDA kernel by default
(``--vtrace-impl kernel``); ``scan`` selects the plain reverse loop.

Runs on CUDA unless ``--device cpu`` is given; without a GPU and without
``--device cpu`` it raises. The other modes and flags of the reference's
``repro.launch.train`` are not ported yet and exit with an error that says
so.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --mode rl-agent \
      --env catch --steps 1500 --batch 32 --lr 2e-3
  PYTHONPATH=src python -m repro_torch.launch.train --env gridworld \
      --agent deep --steps 20 --device cpu
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs.atari_impala import small_train
from repro_torch.core import learner as learner_lib
from repro_torch.core import sources as sources_lib
from repro_torch.core.runtime import Runtime
from repro_torch.models.convnet import impala_deep, minatar_net
from repro_torch.optim import make_optimizer

# Modes and flags of repro.launch.train that this package does not have.
_NOT_PORTED_MODES = ("lm-rl", "lm")
_NOT_PORTED_FLAGS = (
    "--actors", "--mesh-data", "--mesh-model", "--coordinator",
    "--num-processes", "--process-id", "--attn-impl", "--ssd-impl",
    "--resume", "--checkpoint-every", "--checkpoint-dir", "--replay",
    "--replay-capacity", "--replay-ratio", "--arch", "--reduced", "--seq")


def build_rl_agent(args):
    from repro_torch.envs import catch, gridworld
    device = resolve_device(args.device)
    env = {"catch": catch, "gridworld": gridworld}[args.env].make()
    train_cfg = small_train(total_steps=args.steps,
                            learning_rate=args.lr or 2e-3,
                            batch_size=args.batch or 32)
    net = impala_deep if args.agent == "deep" else minatar_net
    agent = net(env.obs_shape, env.num_actions,
                generator=torch.Generator().manual_seed(train_cfg.seed))
    agent = agent.to(device)
    opt = make_optimizer(train_cfg)
    source = sources_lib.DeviceSource.for_env(
        env, agent, unroll_length=train_cfg.unroll_length,
        batch_size=train_cfg.batch_size, seed=train_cfg.seed + 1,
        pipelined=not args.sync)
    step_fn = learner_lib.make_train_step(opt, train_cfg,
                                          vtrace_impl=args.vtrace_impl)
    opt_state = opt.init(list(agent.parameters()))
    extras = {"log_keys": ("reward_per_step", "loss")}
    return source, step_fn, agent, opt_state, extras


def _parser():
    p = argparse.ArgumentParser(
        description="IMPALA trainer (PyTorch port; --mode rl-agent only)")
    p.add_argument("--mode", default="rl-agent",
                   choices=["rl-agent", *_NOT_PORTED_MODES])
    p.add_argument("--env", choices=["catch", "gridworld"], default="catch")
    p.add_argument("--agent", choices=["minatar", "deep"], default="minatar")
    p.add_argument("--sync", action="store_true",
                   help="disable double-buffered rollout dispatch")
    p.add_argument("--vtrace-impl", choices=["kernel", "scan"],
                   default="kernel",
                   help="V-trace: the fused CUDA kernel (its plain version "
                        "on the CPU) or the plain reverse loop")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to run; cuda raises when there is no GPU")
    return p


def main(argv=None) -> Runtime:
    """Parse ``argv``, train, and return the finished Runtime (its
    ``params`` are the trained agent, ``metrics`` the last step's)."""
    p = _parser()
    args, unknown = p.parse_known_args(argv)
    not_ported = sorted({a.split("=")[0] for a in unknown
                         if a.split("=")[0] in _NOT_PORTED_FLAGS})
    if not_ported:
        p.error(f"not ported yet: {' '.join(not_ported)}")
    if unknown:
        p.error(f"unrecognized arguments: {' '.join(unknown)}")
    if args.mode != "rl-agent":
        p.error(f"--mode {args.mode} is not ported yet (rl-agent only)")

    source, step_fn, params, opt_state, extras = build_rl_agent(args)
    runtime = Runtime(source, step_fn, params, opt_state,
                      total_steps=args.steps, **extras)
    runtime.run()
    return runtime


if __name__ == "__main__":
    main()
