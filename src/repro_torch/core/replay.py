"""Off-policy replay buffers over canonical time-major rollouts.

A ``ReplayBuffer`` stores *individual rollouts* (one batch column of the
canonical time-major layout in core/sources.py) in preallocated numpy
slots with free-list recycling — the same scheme as
``core/rollout_buffers.py`` — and hands back stacked ``(T, k, ...)``
batches whose stored ``behavior_logits`` keep V-trace importance weights
correct for replayed data. Storage is host numpy, not device tensors: the
same seed then gives bitwise the same tickets, evictions and sample
indices on the CPU and on the card.

Three strategies:

  ``UniformReplay``    — FIFO eviction, uniform sampling (vanilla ER).
  ``EliteReplay``      — priority = per-rollout V-trace advantage magnitude
                         (fed back from the learner step), sampling ∝
                         priority and evicting the LOWEST-priority rollout
                         first (the elite-buffer V-trace variant).
  ``AttentiveReplay``  — FIFO eviction, but sampling returns the rollouts
                         whose observations are *closest* to the current
                         fresh batch (mean-observation feature distance),
                         so replayed data stays near the learner's current
                         state distribution.

The learner feeds priorities back through
``ReplaySource.on_learner_metrics`` (core/sources.py): the train step
emits a per-column ``priority`` metric (mean |pg_advantage|), and the
source routes it to ``update_priorities`` for every slot that contributed
to the batch.

Buffers are stateful, checkpointable objects: ``state_dict()`` /
``load_state_dict()`` capture slots, priorities, tickets and counters, so
a resumed run replays exactly what the uninterrupted run would have
(the SourceState protocol of core/sources.py).

``ShardedReplay`` is the data-parallel learner's buffer (``--mesh-data
N``): each rank of the mesh holds its own partition of capacity / N and
mixes its own batch, with ``(rank, ticket)`` slot ids.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Protocol, Tuple, \
    runtime_checkable

import numpy as np

from repro_torch.distributed import sharding


@runtime_checkable
class ReplayBuffer(Protocol):
    """The strategy contract ``ReplaySource`` composes over.

    ``insert`` splits a canonical time-major rollout batch into its B
    columns and stores each in a recycled slot (evicting per strategy when
    full), returning the slot ids in column order. ``sample`` returns a
    stacked ``(T, k, ...)`` rollout plus the slot ids it was drawn from.
    ``update_priorities`` is the learner feedback path.
    ``state_dict``/``load_state_dict`` checkpoint the buffer (slots,
    priorities, tickets) for the SourceState resume protocol.
    """

    capacity: int

    def insert(self, rollout: Rollout,
               priorities: Optional[np.ndarray] = None) -> List[int]: ...

    def sample(self, k: int, rng: np.random.Generator, *,
               query: Optional[Any] = None) -> Tuple[Rollout, List[int]]: ...

    def update_priorities(self, slot_ids, priorities) -> None: ...

    def __len__(self) -> int: ...

    def stats(self) -> Dict[str, float]: ...

    def clear(self) -> None: ...

    def state_dict(self) -> Dict[str, Any]: ...

    def load_state_dict(self, state: Dict[str, Any]) -> None: ...


def _obs_feature(obs_col: np.ndarray) -> np.ndarray:
    """Mean-over-time flattened observation — the similarity feature the
    attentive strategy matches on. obs_col: (T+1, *obs_shape)."""
    x = np.asarray(obs_col, np.float32)
    return x.reshape(x.shape[0], -1).mean(axis=0)


class _SlotReplay:
    """Shared slot machinery: preallocated per-key arrays, a free list, and
    per-slot metadata (priority, insertion sequence, obs feature)."""

    # set on strategies whose sampling consumes the fresh-batch query;
    # ReplaySource skips the host-side obs copy for the others.
    needs_query = False

    def __init__(self, capacity: int):
        assert capacity > 0
        self.capacity = capacity
        self._arrays: Optional[Dict[str, np.ndarray]] = None
        self._free: List[int] = list(range(capacity))
        self._live = np.zeros(capacity, bool)
        self._prio = np.zeros(capacity, np.float64)
        self._seq = np.zeros(capacity, np.int64)
        self._feat: Optional[np.ndarray] = None
        self._next_seq = 0
        # insert/sample hand out *tickets* (the insertion sequence number),
        # not raw slot indices: a slot recycled between sample and the
        # learner's priority feedback must not have the new occupant's
        # priority clobbered by a stale update.
        self._slot_of_ticket: Dict[int, int] = {}
        self.inserted = 0
        self.evicted = 0
        self.sampled = 0

    # -- allocation ----------------------------------------------------------

    def _allocate(self, rollout: Rollout) -> None:
        """Lazily size the slot arrays from the first rollout batch: key ->
        (capacity, T(+1), *feature_shape) — column i of the batch is
        ``x[:, i]`` (batch dim is axis 1 in the canonical layout)."""
        self._arrays = {}
        for k, v in rollout.items():
            v = np.asarray(v)
            col_shape = (v.shape[0],) + v.shape[2:]
            self._arrays[k] = np.empty((self.capacity,) + col_shape, v.dtype)
        obs = np.asarray(rollout["obs"])
        self._feat = np.zeros(
            (self.capacity, int(np.prod(obs.shape[2:]) or 1)), np.float32)

    # -- eviction (strategy hook) -------------------------------------------

    def _victim(self) -> int:
        """Pick the slot to evict when full. Default: oldest (FIFO)."""
        live = np.flatnonzero(self._live)
        return int(live[np.argmin(self._seq[live])])

    def _evict(self) -> None:
        slot = self._victim()
        self._live[slot] = False
        self._slot_of_ticket.pop(int(self._seq[slot]), None)
        self._free.append(slot)
        self.evicted += 1

    # -- actor side ----------------------------------------------------------

    def insert(self, rollout: Rollout,
               priorities: Optional[np.ndarray] = None) -> List[int]:
        if self._arrays is None:
            self._allocate(rollout)
        host = {k: np.asarray(v) for k, v in rollout.items()}
        b = host["action"].shape[1]
        # Optimistic default: fresh rollouts enter at the current max
        # priority so elite sampling visits them at least once before the
        # learner has scored them (the standard PER initialisation).
        default_prio = float(self._prio[self._live].max()) \
            if self._live.any() else 1.0
        ids: List[int] = []
        for i in range(b):
            if not self._free:
                self._evict()
            slot = self._free.pop()
            try:
                for k, arr in self._arrays.items():
                    arr[slot][...] = host[k][:, i]
                self._feat[slot] = _obs_feature(host["obs"][:, i])
            except Exception:
                # Never leak the slot if a malformed rollout dies mid-write.
                self._free.append(slot)
                raise
            self._live[slot] = True
            self._prio[slot] = (default_prio if priorities is None
                                else float(priorities[i]))
            self._seq[slot] = self._next_seq
            self._slot_of_ticket[self._next_seq] = slot
            ids.append(self._next_seq)
            self._next_seq += 1
            self.inserted += 1
        return ids

    # -- learner side ---------------------------------------------------------

    def _choose(self, live: np.ndarray, k: int,
                rng: np.random.Generator,
                query: Optional[Any]) -> np.ndarray:
        """Strategy hook: pick k slot ids from the live set."""
        return rng.choice(live, size=k, replace=len(live) < k)

    def sample(self, k: int, rng: np.random.Generator, *,
               query: Optional[Any] = None) -> Tuple[Rollout, List[int]]:
        live = np.flatnonzero(self._live)
        if len(live) == 0:
            raise ValueError("sample() from an empty replay buffer")
        slots = self._choose(live, k, rng, query)
        batch = {key: np.stack([arr[i] for i in slots], axis=1)
                 for key, arr in self._arrays.items()}
        self.sampled += k
        return batch, [int(self._seq[i]) for i in slots]

    def update_priorities(self, slot_ids, priorities) -> None:
        priorities = np.asarray(priorities, np.float64)
        for i, ticket in enumerate(slot_ids):
            slot = self._slot_of_ticket.get(int(ticket))
            if slot is not None:  # evicted/recycled since sampling: ignore
                self._prio[slot] = priorities[i]

    # -- introspection ---------------------------------------------------------

    def __len__(self) -> int:
        return int(self._live.sum())

    def stats(self) -> Dict[str, float]:
        n = len(self)
        return {
            "occupancy": n / self.capacity,
            "mean_priority": float(self._prio[self._live].mean()) if n else 0.0,
            "inserted": float(self.inserted),
            "evicted": float(self.evicted),
            "sampled": float(self.sampled),
        }

    def clear(self) -> None:
        """Return every slot to the free list (drops contents)."""
        self._live[:] = False
        self._slot_of_ticket.clear()
        self._free = list(range(self.capacity))

    # -- checkpoint/restore (SourceState protocol) -----------------------------

    def state_dict(self) -> Dict[str, Any]:
        """Everything a resumed run needs to sample/evict/score exactly as
        the uninterrupted run would: slot contents, priorities, insertion
        sequence, live ticket map and counters."""
        tickets = np.asarray(sorted(self._slot_of_ticket.items()),
                             np.int64).reshape(-1, 2)
        return {
            "kind": type(self).__name__,
            "capacity": self.capacity,
            "arrays": None if self._arrays is None else
                      {k: v.copy() for k, v in self._arrays.items()},
            "feat": None if self._feat is None else self._feat.copy(),
            "free": np.asarray(self._free, np.int64),
            "live": self._live.copy(),
            "prio": self._prio.copy(),
            "seq": self._seq.copy(),
            "next_seq": self._next_seq,
            "tickets": tickets,
            "inserted": self.inserted,
            "evicted": self.evicted,
            "sampled": self.sampled,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if state.get("kind") != type(self).__name__:
            raise ValueError(
                f"checkpoint replay buffer is {state.get('kind')!r}, this "
                f"run built {type(self).__name__} — resume with the same "
                "--replay flags")
        if int(state["capacity"]) != self.capacity:
            raise ValueError(
                f"checkpoint replay capacity {state['capacity']} != "
                f"{self.capacity} — resume with the same --replay-capacity")
        arrays = state["arrays"]
        self._arrays = None if arrays is None else \
            {k: np.asarray(v) for k, v in arrays.items()}
        feat = state["feat"]
        self._feat = None if feat is None else np.asarray(feat, np.float32)
        self._free = [int(i) for i in np.asarray(state["free"])]
        self._live = np.asarray(state["live"], bool)
        self._prio = np.asarray(state["prio"], np.float64)
        self._seq = np.asarray(state["seq"], np.int64)
        self._next_seq = int(state["next_seq"])
        self._slot_of_ticket = {int(t): int(s)
                                for t, s in np.asarray(state["tickets"])}
        self.inserted = int(state["inserted"])
        self.evicted = int(state["evicted"])
        self.sampled = int(state["sampled"])


class UniformReplay(_SlotReplay):
    """FIFO eviction, uniform sampling."""


class EliteReplay(_SlotReplay):
    """Keep what the learner found surprising: sampling ∝ priority^alpha,
    eviction kills the lowest-priority (oldest on ties) rollout."""

    def __init__(self, capacity: int, *, alpha: float = 1.0,
                 min_priority: float = 1e-3):
        super().__init__(capacity)
        self.alpha = alpha
        self.min_priority = min_priority

    def _victim(self) -> int:
        live = np.flatnonzero(self._live)
        # lexsort: lowest priority first, oldest first among equals
        order = np.lexsort((self._seq[live], self._prio[live]))
        return int(live[order[0]])

    def _choose(self, live, k, rng, query):
        p = np.maximum(self._prio[live], self.min_priority) ** self.alpha
        return rng.choice(live, size=k, replace=len(live) < k, p=p / p.sum())

    def update_priorities(self, slot_ids, priorities) -> None:
        priorities = np.maximum(np.asarray(priorities, np.float64),
                                self.min_priority)
        super().update_priorities(slot_ids, priorities)


class AttentiveReplay(_SlotReplay):
    """FIFO eviction; sampling returns the k stored rollouts whose
    mean-observation feature is nearest the query batch's (deterministic
    given buffer contents and query)."""

    needs_query = True

    def _choose(self, live, k, rng, query):
        if query is None:  # no query -> uniform fallback
            return super()._choose(live, k, rng, query)
        q = np.asarray(query, np.float32)
        # query is a full (T+1, B, *obs) fresh batch: average its columns
        qf = np.stack([_obs_feature(q[:, i]) for i in range(q.shape[1])]
                      ).mean(axis=0)
        d = np.linalg.norm(self._feat[live] - qf[None, :], axis=1)
        order = live[np.argsort(d, kind="stable")]
        reps = -(-k // len(order))  # ceil: wrap when k > live
        return np.tile(order, reps)[:k]


class ShardedReplay:
    """Replay partitioned over the ranks of the data mesh (``--mesh-data
    N``, ``launch/mesh.py``): the reference's one strategy buffer per
    device, with each rank a process holding only its own partition.

    Capacity is GLOBAL and splits evenly: the rank's partition is
    ``make_buffer(kind, capacity // N)``. ``insert`` takes the rank's
    fresh block; ``sample(k)`` takes the GLOBAL replayed column count
    (which must divide by N, as the reference requires) and draws this
    rank's k / N from its partition. Slot ids are ``(rank, ticket)``.

    The reference's buffer owns the mixed batch's layout, per-device
    interleaved ``[fresh_0 | replay_0 | fresh_1 | ...]``, and says which
    slot each column came from (``mix``, ``emitted_ids``). A rank's block
    of it, ``[fresh_r | replay_r]``, is the fresh-first batch
    ``ReplaySource`` emits over any buffer, so this one needs neither: the
    blocks concatenated in rank order are the reference's layout, and the
    learner's local priority vector routes back to this rank's slots.

    ``len`` counts this rank's partition (every rank inserts as many).
    ``stats`` and ``state_dict`` are collectives: the gauges are summed to
    the reference's global figures, and the state is gathered to rank 0
    as ``{"kind": "ShardedReplay", "n", "parts": [...]}`` (None on the
    other ranks); ``load_state_dict`` takes the rank's part and refuses
    another world size.
    """

    def __init__(self, kind: str, capacity: int, mesh, **kwargs):
        n = mesh.size
        if capacity % n != 0:
            raise ValueError(f"replay capacity {capacity} not divisible by "
                             f"mesh size {n}")
        self.mesh = mesh
        self.capacity = capacity
        self._part = make_buffer(kind, capacity // n, **kwargs)
        self.needs_query = bool(getattr(self._part, "needs_query", False))

    def insert(self, rollout: Rollout,
               priorities: Optional[np.ndarray] = None) -> List[Tuple]:
        rank = self.mesh.rank
        return [(rank, t) for t in self._part.insert(rollout, priorities)]

    def sample(self, k: int, rng: np.random.Generator, *,
               query: Optional[Any] = None) -> Tuple[Rollout, List[Tuple]]:
        n = self.mesh.size
        if k % n != 0:
            raise ValueError(
                f"sample size {k} not divisible by mesh size {n} — pick a "
                "--replay-ratio whose replayed column count divides the "
                "mesh")
        local, ids = self._part.sample(k // n, rng, query=query)
        return local, [(self.mesh.rank, t) for t in ids]

    def update_priorities(self, slot_ids, priorities) -> None:
        rank = self.mesh.rank
        foreign = sorted({int(d) for d, _ in slot_ids} - {rank})
        if foreign:
            raise ValueError(f"rank {rank} got priorities for the "
                             f"partitions of rank(s) {foreign}")
        self._part.update_priorities([int(t) for _, t in slot_ids],
                                     priorities)

    def __len__(self) -> int:
        return len(self._part)

    def stats(self) -> Dict[str, float]:
        p = self._part
        live, prio, inserted, evicted, sampled = sharding.sum_floats(
            [len(p), float(p._prio[p._live].sum()), p.inserted, p.evicted,
             p.sampled], self.mesh)
        return {
            "occupancy": live / self.capacity,
            "mean_priority": prio / live if live else 0.0,
            "inserted": inserted,
            "evicted": evicted,
            "sampled": sampled,
        }

    def clear(self) -> None:
        self._part.clear()

    def state_dict(self) -> Optional[Dict[str, Any]]:
        parts = sharding.gather_to_main(self._part.state_dict(), self.mesh)
        if parts is None:
            return None
        return {"kind": "ShardedReplay", "n": self.mesh.size,
                "parts": parts}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if state.get("kind") != "ShardedReplay":
            raise ValueError(
                f"checkpoint replay buffer is {state.get('kind')!r}, this "
                "run built ShardedReplay — resume with the same flags")
        if int(state["n"]) != self.mesh.size:
            raise ValueError(
                f"checkpoint replay has {state['n']} partitions, this mesh "
                f"has {self.mesh.size} — resume with the same --mesh-data")
        self._part.load_state_dict(state["parts"][self.mesh.rank])


_KINDS = {"uniform": UniformReplay, "elite": EliteReplay,
          "attentive": AttentiveReplay}


def make_buffer(kind: str, capacity: int, **kwargs) -> ReplayBuffer:
    """Factory behind the ``--replay {uniform,elite,attentive}`` flag."""
    try:
        cls = _KINDS[kind]
    except KeyError:
        raise ValueError(f"unknown replay kind {kind!r}; "
                         f"choose from {sorted(_KINDS)}") from None
    return cls(capacity, **kwargs)
