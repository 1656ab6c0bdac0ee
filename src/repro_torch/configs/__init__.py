"""Learner configs: ``TrainConfig`` and the paper's Atari IMPALA setup."""
from repro_torch.configs.base import TrainConfig  # noqa: F401
