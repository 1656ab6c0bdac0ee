"""Synthetic token data pipeline (no external datasets).

Provides deterministic, seedable streams for the LM/RL drivers:

* ``markov_corpus`` — tokens from a random sparse Markov chain (low-entropy,
  so LM training loss visibly decreases; used by examples and tests).
* ``PackedBatchIterator`` — documents packed into fixed (B, S+1) batches
  with host-side prefetch, the shape consumed by the learner steps.
* ``rl_episode_batch`` — token-MDP episode batches with behavior log-probs,
  rewards and dones (the LLM-IMPALA learner-queue format).

This module is numpy only, as the reference's ``repro.data.synthetic`` is;
the port keeps its own copy (it imports nothing of ``repro``), and the
batch stream is bitwise the reference's for the same seeds.
"""

from __future__ import annotations

import bisect
import queue
import threading
from typing import Iterator

import numpy as np


def markov_corpus(vocab_size: int, length: int, seed: int = 0,
                  branching: int = 4) -> np.ndarray:
    """Random sparse Markov chain: each token has ``branching`` successors.

    The reference's tokens, bitwise: its ``rng.choice(branching,
    p=probs[tok])`` a token draws one uniform double and takes the first
    entry of the row's normalised cdf above it. Here the doubles are drawn
    in one call (the same stream) and each token bisects its row of plain
    lists: a numpy call a token took seconds at 200,000 tokens."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab_size, size=(vocab_size, branching))
    probs = rng.dirichlet(np.ones(branching), size=vocab_size)
    tok = int(rng.integers(vocab_size))
    cdf = np.cumsum(probs, axis=1)
    cdf /= cdf[:, -1:]
    # analysis: ignore[host-sync] (numpy arrays on the host, no card)
    succ, cdf, uniform = (a.tolist() for a in (succ, cdf, rng.random(length)))
    out = [0] * length
    for i in range(length):
        out[i] = tok
        tok = succ[tok][bisect.bisect_right(cdf[tok], uniform[i])]
    return np.asarray(out, np.int32)


class PackedBatchIterator:
    """Yields {"tokens": (B, S+1) int32} batches from a corpus, with a
    background prefetch thread (the host data-pipeline substrate).

    Checkpointable: batch ``i`` is derived from ``(seed, i)`` alone (an
    independent per-batch Generator), so the stream position is just a
    (seed, offset) pair — ``state_dict``/``load_state_dict`` let a resumed
    ``--mode lm`` run replay the EXACT batch sequence of an uninterrupted
    one (prefetched-but-unconsumed batches are regenerated, not lost).
    ``close`` stops the thread; a later ``next`` reopens the stream at
    its offset.
    """

    def __init__(self, corpus: np.ndarray, batch_size: int, seq_len: int,
                 seed: int = 0, prefetch: int = 4):
        self.corpus = np.asarray(corpus, np.int32)
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.seed = int(seed)
        self._prefetch = prefetch
        self._emitted = 0   # index of the next batch __next__ hands out
        self._start_thread()

    def _start_thread(self):
        self._q: queue.Queue = queue.Queue(maxsize=self._prefetch)
        self._stop = threading.Event()
        self._produced = self._emitted  # next index the thread generates
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _batch_at(self, index: int) -> dict:
        rng = np.random.default_rng([self.seed, index])
        n = len(self.corpus) - self.seq_len - 1
        starts = rng.integers(0, n, size=self.batch_size)
        toks = np.stack([self.corpus[s:s + self.seq_len + 1]
                         for s in starts])
        return {"tokens": toks}

    def _fill(self):
        while not self._stop.is_set():
            item = (self._produced, self._batch_at(self._produced))
            placed = False
            while not self._stop.is_set() and not placed:
                try:
                    self._q.put(item, timeout=0.5)
                    placed = True
                except queue.Full:
                    pass
            if placed:
                self._produced += 1

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        if self._stop.is_set():        # closed: reopen at the offset
            self._start_thread()
        index, batch = self._q.get()
        self._emitted = index + 1
        return batch

    def _teardown(self):
        """Stop AND join the prefetch thread (a lingering thread would keep
        filling the dead queue), draining so a blocked put wakes up."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def close(self):
        self._teardown()

    # -- SourceState protocol (via DataSource.state_dict) --------------------

    def state_dict(self) -> dict:
        return {"kind": type(self).__name__, "seed": self.seed,
                "offset": self._emitted}

    def load_state_dict(self, state: dict) -> None:
        if state.get("kind") != type(self).__name__:
            raise ValueError(
                f"iterator state is {state.get('kind')!r} but this run "
                f"built {type(self).__name__} — resume with the same data "
                "pipeline")
        self._teardown()
        self.seed = int(state["seed"])
        self._emitted = int(state["offset"])
        self._start_thread()


def rl_episode_batch(rng: np.random.Generator, batch_size: int, seq_len: int,
                     vocab_size: int, a: int = 5, b: int = 3) -> dict:
    """Random-behavior token-MDP episodes in the LLM-IMPALA batch layout
    (used to bootstrap training and for shape tests; the real driver
    generates these with the serving path)."""
    tokens = rng.integers(0, vocab_size,
                          size=(batch_size, seq_len + 1)).astype(np.int32)
    target = (a * tokens[:, :-1] + b) % vocab_size
    rewards = (tokens[:, 1:] == target).astype(np.float32)
    done = np.zeros((batch_size, seq_len), bool)
    done[:, -1] = True
    behavior_logprob = np.full((batch_size, seq_len),
                               -np.log(vocab_size), np.float32)
    return {"tokens": tokens, "behavior_logprob": behavior_logprob,
            "reward": rewards, "done": done}
