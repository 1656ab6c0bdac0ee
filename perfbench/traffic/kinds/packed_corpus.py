"""``packed_corpus``: the program's ``DataSource`` over (B, S+1) rows of a
random sparse Markov chain drawn from the seed: the packed documents of
LM pretraining; ``batch_size``, ``seq_len``, ``branching`` successors a
token, documents of ``doc_len`` tokens."""

from __future__ import annotations

import numpy as np

from perfbench.seeds import derive
from perfbench.traffic.generator import Feed


def make(traffic, *, seed, device, model_cfg, **_):
    from repro_torch.core.sources import DataSource
    rows = MarkovRows(traffic, model_cfg.vocab_size, derive(seed, "corpus"))
    return Feed(DataSource(rows, frames_per_batch=traffic["batch_size"]
                           * traffic["seq_len"], device=device))


class MarkovRows:
    """An iterator of {"tokens": (B, S+1) int32} rows from a random sparse
    Markov chain over the vocabulary (``branching`` successors a token,
    Dirichlet weights), drawn from the seed on the host. A batch's B (S+1)
    tokens are one stretch of the chain, restarted from a random token
    every ``doc_len`` tokens (a document's start)."""

    def __init__(self, traffic, vocab: int, seed: int):
        self.b, self.s = traffic["batch_size"], traffic["seq_len"]
        self.doc_len = int(traffic["doc_len"])
        self.vocab = vocab
        rng = np.random.default_rng(seed)
        k = int(traffic["branching"])
        self.succ = rng.integers(0, vocab, size=(vocab, k))
        cdf = np.cumsum(rng.dirichlet(np.ones(k), size=vocab), axis=1)
        self.cdf = cdf / cdf[:, -1:]
        self.rng = rng

    def __iter__(self):
        return self

    def __next__(self):
        n = self.b * (self.s + 1)
        out = np.empty(n, np.int64)
        u = self.rng.random(n)
        tok = 0
        for i in range(n):
            if i % self.doc_len == 0:
                tok = self.rng.integers(self.vocab)
            out[i] = tok
            row = self.cdf[tok]
            tok = self.succ[tok, min(int(np.searchsorted(row, u[i],
                                                          side="right")),
                                     row.shape[0] - 1)]
        return {"tokens": out.reshape(self.b, self.s + 1).astype(np.int32)}

    def close(self) -> None:
        pass
