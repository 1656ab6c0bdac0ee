"""``generated_episodes``: the program's ``GeneratorSource``, token-MDP
episodes of ``episode_length`` tokens after a one-token prompt, sampled
at ``temperature`` from its decode session, ``batch_size`` at a time."""

from __future__ import annotations

from perfbench.seeds import derive
from perfbench.traffic.generator import Feed


def make(traffic, *, seed, device, model_cfg, **_):
    from repro_torch.core.sources import GeneratorSource
    del device                      # the session runs where the weights are
    return Feed(GeneratorSource(
        model_cfg, batch_size=traffic["batch_size"],
        episode_length=traffic["episode_length"],
        seed=derive(seed, "episodes"),
        temperature=float(traffic["temperature"])))
