"""IMPALA core: V-trace, losses, rollouts, sources, learner, the
actor/learner runtime, the host actors' queueing (``batcher``,
``actor_pool``, ``rollout_buffers``) and off-policy replay (``replay``);
decoding sessions (``generate``) for serving."""
from repro_torch.core import (vtrace, losses, rollout, batcher,  # noqa: F401
                              actor_pool, rollout_buffers, replay, learner,
                              sources, runtime)
