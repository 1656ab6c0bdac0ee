"""IMPALA core: V-trace, losses, rollouts, sources, learner, and the
actor/learner runtime."""
from repro_torch.core import (vtrace, losses, rollout, learner,  # noqa: F401
                              sources, runtime)
