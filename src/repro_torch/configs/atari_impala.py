"""The paper's own experimental config (§4): IMPALA deep ResNet agent,
Atari preprocessing shapes (84x84, 4-frame stack, 18 actions), and the
IMPALA Table G.1 hyperparameters used by TorchBeast."""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import TrainConfig

OBS_SHAPE = (84, 84, 4)   # warped, 4-frame-stacked Atari
NUM_ACTIONS = 18          # full ALE action set

TRAIN = TrainConfig(
    optimizer="rmsprop",
    learning_rate=6e-4,      # IMPALA Table G.1 (0.0006)
    rmsprop_eps=0.01,
    rmsprop_decay=0.99,
    rmsprop_momentum=0.0,
    grad_clip=40.0,
    lr_schedule="linear",
    baseline_cost=0.5,
    entropy_cost=0.01,
    discount=0.99,
    unroll_length=80,
    batch_size=32,
    num_actors=48,           # paper: 48 environments
    total_steps=50_000_000 // (80 * 32),  # 200M frames / action-rep 4
)


def small_train(**overrides) -> TrainConfig:
    """Small variant for tests, examples and the Catch/gridworld trainer."""
    base = dataclasses.replace(
        TRAIN, unroll_length=20, batch_size=8, num_actors=8,
        total_steps=2000, learning_rate=1e-3)
    return dataclasses.replace(base, **overrides)
