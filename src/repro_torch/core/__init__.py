"""IMPALA core: V-trace, losses, rollouts, sources, learner, the
actor/learner runtime, and the host actors' queueing (``batcher``,
``actor_pool``, ``rollout_buffers``); decoding sessions (``generate``)
for serving."""
from repro_torch.core import (vtrace, losses, rollout, batcher,  # noqa: F401
                              actor_pool, rollout_buffers, learner, sources,
                              runtime)
