"""IMPALA core: V-trace, losses, rollouts, sources, learner, and the
actor/learner runtime; decoding sessions (``generate``) and the bucket
ladder (``batcher``) for serving."""
from repro_torch.core import (vtrace, losses, rollout, learner,  # noqa: F401
                              sources, runtime)
