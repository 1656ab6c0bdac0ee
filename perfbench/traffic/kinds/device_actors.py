"""``device_actors``: the program's ``DeviceSource``, its unroll a CUDA
graph pipelined with the learner's (the actors act with the parameters of
the step before), over the Atari-shaped environment of ``atari_env.py``
(``env``: its parameters); ``unroll_length``, ``batch_size``."""

from __future__ import annotations

from perfbench.seeds import derive
from perfbench.traffic import atari_env
from perfbench.traffic.generator import Feed


def make(traffic, *, seed, device, agent, obs_shape, num_actions, **_):
    from repro_torch.core.sources import DeviceSource
    env, bank = atari_env.make(traffic["env"], obs_shape, num_actions,
                               derive(seed, "frames"), device)
    source = DeviceSource.for_env(
        env, agent, unroll_length=traffic["unroll_length"],
        batch_size=traffic["batch_size"], seed=derive(seed, "actors"),
        pipelined=True)
    return Feed(source, bank, actor_lag=1)
