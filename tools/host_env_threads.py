#!/usr/bin/env python3
"""Host-clock cost of stepping B = 1 torch envs from several threads.

    PYTHONPATH=src python3 tools/host_env_threads.py [--threads 8]
        [--steps 100] [--env gridworld]

The host actors (``--actors host``) step one ``HostEnv`` per actor
thread. A step at B = 1 is some sixty tiny torch ops, each of which
releases and retakes the interpreter lock. This script prints one JSON
line of microseconds per env step, in aggregate over the threads:

  one_thread       one thread stepping one env alone
  free             ``--threads`` threads, each stepping its own env at
                   B = 1 with nothing between them
  free_1_intra_op  the same with ``torch.set_num_threads(1)``
  host_env         the same threads through ``HostEnv``, whose steps take
                   one lock for the process (as the host actors step)

and the host's core count, torch's intra-op thread count, and the card's
``nvidia-smi`` name and power limit when there is one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.envs import catch, gridworld  # noqa: E402
from repro_torch.envs.base import HostEnv  # noqa: E402

ENVS = {"catch": catch, "gridworld": gridworld}


def _free_stepper(env, seed):
    """A step function over the batched Env at B = 1, the ops of
    ``HostEnv.step`` without its lock."""
    gen = torch.Generator().manual_seed(seed)
    state = env.reset(1, gen, "cpu")[0]

    def step(action):
        nonlocal state
        state, obs, reward, done = env.step(state, torch.tensor([action]),
                                            gen)
        return obs[0].numpy(), float(reward[0]), bool(done[0])
    return step


def _host_stepper(env, seed):
    host = HostEnv(env, seed)
    host.reset()
    return host.step


def us_per_step(make_stepper, env, threads, steps):
    """Microseconds per env step, in aggregate, of ``threads`` threads
    each stepping its own env ``steps`` times, started together."""
    steppers = [make_stepper(env, seed) for seed in range(threads)]
    start = threading.Barrier(threads + 1)

    def work(step):
        start.wait()
        for i in range(steps):
            step(i % env.num_actions)

    workers = [threading.Thread(target=work, args=(s,)) for s in steppers]
    for w in workers:
        w.start()
    start.wait()
    t0 = time.perf_counter()
    for w in workers:
        w.join()
    return (time.perf_counter() - t0) / (threads * steps) * 1e6


def smi_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--threads", type=int, default=8)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--env", choices=sorted(ENVS), default="gridworld")
    args = p.parse_args(argv)
    env = ENVS[args.env].make()
    intra_op = torch.get_num_threads()
    row = {"env": args.env, "threads": args.threads, "steps": args.steps,
           "cpu_count": os.cpu_count(), "torch_threads": intra_op,
           "torch": torch.__version__}
    row["one_thread"] = us_per_step(_free_stepper, env, 1, 5 * args.steps)
    row["free"] = us_per_step(_free_stepper, env, args.threads, args.steps)
    torch.set_num_threads(1)
    try:
        row["free_1_intra_op"] = us_per_step(_free_stepper, env,
                                             args.threads, args.steps)
    finally:
        torch.set_num_threads(intra_op)
    row["host_env"] = us_per_step(_host_stepper, env, args.threads,
                                  args.steps)
    row["free_over_host_env"] = row["free"] / row["host_env"]
    row["nvidia_smi"] = smi_line()
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
