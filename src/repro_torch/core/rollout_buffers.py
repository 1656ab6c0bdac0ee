"""MonoBeast's shared rollout-buffer scheme (paper §5.1):

* ``num_buffers`` preallocated rollout slots (numpy arrays standing in for
  the paper's shared-memory torch tensors — same recycling semantics),
* a ``free_queue`` and a ``full_queue`` communicating integer indices,
* actors dequeue a free index, fill ``buffers[index]`` in place, enqueue it
  to ``full_queue``;
* the learner dequeues ``batch_size`` indices, stacks them into a batch,
  and returns the indices to ``free_queue``.

This is the zero-copy alternative to core/batcher.py's BatchingQueue (which
stacks fresh arrays per rollout); with ``num_buffers`` bounded it also
provides the paper's implicit back-pressure. Pure numpy and threading.
"""

from __future__ import annotations

import queue
from typing import Dict, List, Sequence

import numpy as np


class RolloutBuffers:
    def __init__(self, specs: Dict[str, tuple], num_buffers: int):
        """specs: name -> (shape, dtype) WITHOUT a batch dimension, e.g.
        {"obs": ((T+1, 84, 84, 4), np.float32), "action": ((T,), np.int32)}.
        """
        self.specs = specs
        self.num_buffers = num_buffers
        self.buffers: List[Dict[str, np.ndarray]] = [
            {k: np.empty(shape, dtype) for k, (shape, dtype) in specs.items()}
            for _ in range(num_buffers)
        ]
        self.free_queue: "queue.Queue[int]" = queue.Queue()
        self.full_queue: "queue.Queue[int]" = queue.Queue()
        for i in range(num_buffers):
            self.free_queue.put(i)

    # --- actor side ---------------------------------------------------------

    def acquire(self, timeout=None) -> int:
        """Dequeue a free buffer index (blocks — the paper's back-pressure)."""
        return self.free_queue.get(timeout=timeout)

    def commit(self, index: int) -> None:
        self.full_queue.put(index)

    def write(self, index: int, data: Dict[str, np.ndarray]) -> None:
        """In-place fill of buffers[index] (shared-memory write analogue)."""
        buf = self.buffers[index]
        for k, v in data.items():
            buf[k][...] = v

    # --- learner side --------------------------------------------------------

    def get_batch(self, batch_size: int, timeout=None,
                  batch_dim: int = 1) -> Dict[str, np.ndarray]:
        """Dequeue batch_size indices, stack, recycle the indices.

        The stack COPIES (as MonoBeast's torch.stack onto the GPU does), so
        recycling the indices immediately afterwards is safe — exactly the
        paper's ordering (stack, then put indices back, then learn).

        If the learner dies mid-batch (timeout waiting for the remaining
        indices, or an exception while stacking), every index already
        dequeued is returned to the free list — slots must never leak, or
        the bounded-buffer back-pressure eventually deadlocks the actors.
        """
        idxs: List[int] = []
        try:
            for _ in range(batch_size):
                idxs.append(self.full_queue.get(timeout=timeout))
            batch = {k: np.stack([self.buffers[i][k] for i in idxs],
                                 axis=batch_dim)
                     for k in self.specs}
        finally:
            for i in idxs:
                self.free_queue.put(i)
        return batch

    def qsizes(self):
        return {"free": self.free_queue.qsize(),
                "full": self.full_queue.qsize()}


def rollout_specs(obs_shape: Sequence[int], num_actions: int,
                  unroll_length: int) -> Dict[str, tuple]:
    """The §2 learner-input dict layout, per single rollout (no batch dim)."""
    t = unroll_length
    return {
        "obs": ((t + 1,) + tuple(obs_shape), np.float32),
        "action": ((t,), np.int32),
        "behavior_logits": ((t, num_actions), np.float32),
        "reward": ((t,), np.float32),
        "done": ((t,), np.bool_),
    }
