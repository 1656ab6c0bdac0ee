"""IMPALA learner hyperparameters (the ``TrainConfig`` of ``repro``,
field for field; the LM ``ModelConfig`` is not ported yet)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """IMPALA learner/optimizer hyperparameters (defaults: IMPALA Table G.1)."""
    optimizer: str = "rmsprop"
    learning_rate: float = 6e-4
    rmsprop_eps: float = 0.01
    rmsprop_decay: float = 0.99
    rmsprop_momentum: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    adam_eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 40.0             # global-norm clip, IMPALA default
    lr_schedule: str = "linear"         # linear anneal to 0, IMPALA default
    total_steps: int = 100_000
    warmup_steps: int = 0

    # IMPALA loss weights (Table G.1)
    baseline_cost: float = 0.5
    entropy_cost: float = 0.01
    discount: float = 0.99
    vtrace_rho_clip: float = 1.0
    vtrace_c_clip: float = 1.0

    # CLEAR cloning costs on replayed rows (read once replay is ported)
    clear_policy_cost: float = 0.0
    clear_value_cost: float = 0.0

    unroll_length: int = 80
    batch_size: int = 32
    num_actors: int = 48

    seed: int = 0
