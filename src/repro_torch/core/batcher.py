"""Host-side queueing/batching — the Python form of PolyBeast's C++
batcher (batcher.cc semantics), over trees of numpy arrays.

``DynamicBatcher``: actor threads call ``compute(inputs)`` and block; a
consumer thread repeatedly calls ``get_batch()``, which gathers up to
``max_batch_size`` pending requests (waiting at most ``timeout_ms`` after
the first arrival), stacks them along ``batch_dim``, and later scatters
the consumer's reply back to each waiting actor. This is the paper's
*inference queue*, which keeps the policy's evaluations batched.

``BatchingQueue``: producers ``put`` single rollouts; the consumer takes
fixed-size stacked batches — the paper's *learner queue*.

Batch sizes are padded to a bucket ladder (``bucket_size``), which bounds
the distinct shapes a compiled or captured step has to serve.

Trees are dicts, lists and tuples of numpy arrays.
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional, Sequence

import numpy as np

from repro_torch.tree import leaves, map_leaves, rebuild


class Closed(Exception):
    """Raised by blocked calls when the queue/batcher is closed."""


def stack_trees(trees: Sequence[Any], axis: int = 0):
    columns = zip(*(leaves(t) for t in trees))
    return rebuild(trees[0], iter([np.stack(xs, axis=axis)
                                    for xs in columns]))


def unstack_tree(tree, n: int, axis: int = 0):
    split = [np.split(np.asarray(leaf), n, axis=axis)
             for leaf in leaves(tree)]
    return [rebuild(tree, iter([np.squeeze(s[i], axis=axis)
                                 for s in split]))
            for i in range(n)]


def bucket_size(n: int, ladder=(1, 2, 4, 8, 16, 32, 64, 128, 256)) -> int:
    """The smallest ladder size that holds ``n``, or ``n`` itself past the
    ladder's top: padding to a few sizes bounds the distinct shapes a
    compiled or captured step has to serve."""
    for b in ladder:
        if n <= b:
            return b
    return n


class _Pending:
    __slots__ = ("inputs", "event", "output")

    def __init__(self, inputs):
        self.inputs = inputs
        self.event = threading.Event()
        self.output = None


class DynamicBatcher:
    def __init__(self, max_batch_size: int = 32, timeout_ms: float = 10.0,
                 batch_dim: int = 0, pad_to_bucket: bool = True):
        self.max_batch_size = max_batch_size
        self.timeout_s = timeout_ms / 1000.0
        self.batch_dim = batch_dim
        self.pad_to_bucket = pad_to_bucket
        self._pending: List[_Pending] = []
        self._cond = threading.Condition()
        self._closed = False

    def close(self):
        # Snapshot-and-clear under the lock: compute() checks _closed under
        # the same lock, so no request can slip in after the snapshot, and
        # a concurrent get_batch() can't pop entries we are about to wake.
        with self._cond:
            self._closed = True
            pending, self._pending = self._pending, []
            self._cond.notify_all()
        for p in pending:
            p.event.set()  # output stays None -> compute() raises Closed

    def compute(self, inputs):
        """Called by actor threads; blocks until the consumer responds."""
        p = _Pending(inputs)
        with self._cond:
            if self._closed:
                raise Closed
            self._pending.append(p)
            self._cond.notify_all()
        p.event.wait()
        if p.output is None:
            raise Closed
        return p.output

    def get_batch(self, timeout: Optional[float] = None):
        """Called by the consumer. Returns (batched_inputs, respond, size) or
        None on timeout / raises Closed when closed and drained."""
        with self._cond:
            while not self._pending:
                if self._closed:
                    raise Closed
                if not self._cond.wait(timeout=timeout):
                    return None
            # first request arrived; give stragglers timeout_s to join
            if self.timeout_s > 0 and len(self._pending) < self.max_batch_size:
                self._cond.wait_for(
                    lambda: len(self._pending) >= self.max_batch_size
                    or self._closed,
                    timeout=self.timeout_s)
            if not self._pending:  # close() snapshotted it mid-wait
                raise Closed
            batch = self._pending[:self.max_batch_size]
            self._pending = self._pending[self.max_batch_size:]

        n = len(batch)
        stacked = stack_trees([p.inputs for p in batch], self.batch_dim)
        if self.pad_to_bucket:
            target = bucket_size(n)
            if target > n:
                stacked = map_leaves(
                    lambda x: np.concatenate(
                        [x] + [x[-1:]] * (target - n), axis=self.batch_dim),
                    stacked)

        def respond(outputs):
            lead = np.asarray(leaves(outputs)[0]).shape[self.batch_dim]
            parts = unstack_tree(outputs, lead, self.batch_dim)
            for p, out in zip(batch, parts[:n]):
                p.output = out
                p.event.set()

        return stacked, respond, n


class BatchingQueue:
    """Producers put single items; the consumer iterates stacked batches of
    exactly ``batch_size`` along ``batch_dim`` (the learner queue)."""

    def __init__(self, batch_size: int, batch_dim: int = 1,
                 max_items: int = 128):
        self.batch_size = batch_size
        self.batch_dim = batch_dim
        self.max_items = max_items
        self._items: List[Any] = []
        self._cond = threading.Condition()
        self._closed = False

    def put(self, item):
        with self._cond:
            while len(self._items) >= self.max_items and not self._closed:
                self._cond.wait()
            if self._closed:
                raise Closed
            self._items.append(item)
            self._cond.notify_all()

    def get(self, timeout: Optional[float] = None):
        with self._cond:
            self._cond.wait_for(
                lambda: len(self._items) >= self.batch_size or self._closed,
                timeout=timeout)
            if len(self._items) >= self.batch_size:
                items = self._items[:self.batch_size]
                self._items = self._items[self.batch_size:]
                self._cond.notify_all()
            elif self._closed:
                raise Closed
            else:
                return None  # timeout
        return stack_trees(items, self.batch_dim)

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def __iter__(self):
        while True:
            try:
                batch = self.get()
            except Closed:
                return
            if batch is not None:
                yield batch

    def size(self):
        with self._cond:
            return len(self._items)
