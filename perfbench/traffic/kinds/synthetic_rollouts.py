"""``synthetic_rollouts``: time-major rollout batches drawn on the device
from the seed, a fresh one for every step (the learner fed by remote
actors, with no actors here): observations uniform in [0, 1), actions
uniform, behaviour logits ``logit_scale`` times a normal draw, rewards 1
with ``reward_p``, done with ``done_p``; ``unroll_length``,
``batch_size``."""

from __future__ import annotations

import torch

from perfbench.seeds import derive
from perfbench.traffic.generator import Feed


def make(traffic, *, seed, device, obs_shape, num_actions, **_):
    return Feed(SyntheticRollouts(traffic, obs_shape, num_actions,
                                  derive(seed, "rollouts"), device))


class SyntheticRollouts:
    def __init__(self, traffic, obs_shape, num_actions, seed, device):
        self.t, self.b = traffic["unroll_length"], traffic["batch_size"]
        self.obs_shape = tuple(obs_shape)
        self.num_actions = num_actions
        self.reward_p = float(traffic["reward_p"])
        self.done_p = float(traffic["done_p"])
        self.logit_scale = float(traffic["logit_scale"])
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.device = device
        self.frames_per_batch = self.t * self.b

    def start(self, params) -> None:
        del params

    def stop(self) -> None:
        pass

    def next_batch(self, params):
        del params
        t, b, g, dev = self.t, self.b, self.gen, self.device
        return {
            "obs": torch.rand((t + 1, b) + self.obs_shape, generator=g,
                              device=dev),
            "action": torch.randint(0, self.num_actions, (t, b), generator=g,
                                    device=dev, dtype=torch.int32),
            "behavior_logits": self.logit_scale * torch.randn(
                (t, b, self.num_actions), generator=g, device=dev),
            "reward": (torch.rand((t, b), generator=g, device=dev)
                       < self.reward_p).float(),
            "done": torch.rand((t, b), generator=g, device=dev)
            < self.done_p,
        }
