"""Rollout sources — the actor side of the IMPALA split, behind one
contract.

Every source produces *canonical time-major rollouts*: a dict with

  obs              (T+1, B, *obs_shape)   observations (obs[T] bootstraps)
  action           (T, B) int32
  behavior_logits  (T, B, A) float32
  reward           (T, B) float32
  done             (T, B) bool

exactly the learner-input layout of the paper's §2, so the ``Runtime``
(core/runtime.py) is indifferent to *how* rollouts are produced:

  ``DeviceSource``   — the on-device unroll (core/rollout.py), with
                       optional double-buffered dispatch: unroll N+1 is
                       dispatched with the params of step N-1 before the
                       learner consumes unroll N, so acting and learning
                       overlap at a one-step parameter lag (V-trace
                       corrects the resulting off-policyness — the IMPALA
                       argument).
  ``HostLoopSource`` — MonoBeast/PolyBeast host actor threads feeding the
                       inference queue (DynamicBatcher) and the learner
                       queue (BatchingQueue).
  ``ReplaySource``   — off-policy replay over either: fresh columns mixed
                       with columns replayed from a ``core/replay.py``
                       buffer, tagged by an ``is_replay`` mask.
  ``GeneratorSource`` — the LLM policy's token-MDP episodes from the
                       decode session (obs and action are tokens, the
                       behavior policy is a log-prob per step).
  ``DataSource``     — ready batches from a checkpointable iterator (LM
                       pretraining).

SourceState: every source is a stateful, checkpointable object.
``state_dict()`` captures everything the rollout stream depends on — env
carries, generator states, dispatch bookkeeping (the double-buffered
in-flight rollout and the actors' parameter copy) — as a tree of
dicts/lists/tuples/scalars/tensors; ``load_state_dict()`` restores it
into a freshly built source of the same shape. The Runtime saves it inside
every checkpoint (checkpoint.save ``structured=``) and ``train.py
--resume`` restores it, so a killed-and-resumed run replays the exact
batch stream of an uninterrupted one (bit-identical final params). The
one exception is the host-loop path: thread scheduling is not replayable,
so ``HostLoopSource`` restarts its actors fresh and only the learner state
resumes exactly. ``ReplaySource`` wraps either and checkpoints its buffer
with the inner source's state.

Data parallelism (``--mesh-data N``, one process per rank, see
``launch/mesh.py``): ``ShardedDeviceSource`` runs each rank's stream of
B/N columns, ``HostLoopSource(mesh=)`` each rank's actor pool, and
``ReplaySource`` over a ``core/replay.py::ShardedReplay`` each rank's
buffer partition. Their ``state_dict`` is then a collective that gathers
every rank's state to rank 0 in the reference's layout.
"""

from __future__ import annotations

import copy
import threading
import time
import warnings
from typing import (Any, Callable, Dict, Optional, Protocol,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch.core.compiled import Forward, Unroll
from repro_torch.distributed import sharding
from repro_torch.tree import leaves, rebuild


@runtime_checkable
class RolloutSource(Protocol):
    """The contract the Runtime consumes.

    ``next_batch(params)`` hands the source the learner's *current*
    parameters (the agent module) and returns one rollout batch. Sources
    are free to act with lagged parameters (that is the point of the
    decoupled architecture); the rollout's behavior outputs must describe
    the policy that actually produced it.

    ``state_dict()``/``load_state_dict()`` are the SourceState
    checkpoint/restore protocol (module docstring): a source with no
    resumable state returns ``{"kind": ...}`` and checks only that on
    load, but every source answers.
    """

    frames_per_batch: int

    def start(self, params) -> None: ...

    def next_batch(self, params) -> Dict[str, Any]: ...

    def stop(self) -> None: ...

    def state_dict(self) -> Dict[str, Any]: ...

    def load_state_dict(self, state: Dict[str, Any]) -> None: ...


def _check_kind(state: Dict[str, Any], obj) -> None:
    """Loud resume-composition guard: a checkpoint written by one source
    shape must not be loaded into another (e.g. saved with --actors host,
    resumed with device actors; or --replay elite saved, resumed without
    --replay)."""
    kind = state.get("kind") if hasattr(state, "get") else None
    if kind != type(obj).__name__:
        raise ValueError(
            f"checkpoint source state is {kind!r} but this run built "
            f"{type(obj).__name__} — resume with the same source flags "
            "(--actors/--replay)")


def _like(template, tree):
    """``tree`` (whose containers degraded to tuples/lists in the
    checkpoint, its leaves to numpy) rebuilt in the structure of
    ``template``, each leaf a tensor on the matching template leaf's
    device — the restore path for env carries (NamedTuple states)."""
    return rebuild(template, iter(
        torch.as_tensor(x).to(t.device)
        for t, x in zip(leaves(template), leaves(tree))))


def check_rollout(rollout: Dict[str, Any], unroll_length: int,
                  batch_size: int) -> None:
    """Check the canonical time-major contract (used by tests and as the
    executable spec of the layout above); raises ValueError."""
    t, b = unroll_length, batch_size
    expect = [
        ("obs", tuple(rollout["obs"].shape[:2]), (t + 1, b)),
        ("action", tuple(rollout["action"].shape), (t, b)),
        ("action", rollout["action"].dtype, torch.int32),
        ("reward", tuple(rollout["reward"].shape), (t, b)),
        ("reward", rollout["reward"].dtype, torch.float32),
        ("done", tuple(rollout["done"].shape), (t, b)),
        ("done", rollout["done"].dtype, torch.bool),
        ("behavior_logits", tuple(rollout["behavior_logits"].shape[:2]),
         (t, b)),
        ("behavior_logits", rollout["behavior_logits"].dtype,
         torch.float32),
    ]
    bad = [f"{k}: {got} != {want}" for k, got, want in expect if got != want]
    if bad:
        raise ValueError("rollout breaks the time-major contract: "
                         + "; ".join(bad))


# ---------------------------------------------------------------------------
# On-device actors


class _CompiledUnrollSource:
    """The dispatch cadence of the on-device actors: one unroll stream on
    one device, shared by ``DeviceSource`` and ``ShardedDeviceSource``
    (which differ in how they are built and checkpointed).

    Synchronous (``pipelined=False``): ``next_batch(params)`` dispatches one
    unroll with the given params and returns it — unroll N sees the params
    of step N.

    Double-buffered (``pipelined=True``): one unroll is always in flight.
    ``next_batch(params)`` returns the previously dispatched unroll and
    immediately dispatches the next one, so from step 1 onward the consumed
    rollout was generated with the params of the *previous* learner step
    (parameter lag 1). The unroll only enqueues device work, so the card
    runs it while the host goes on to the learner step. With frozen params
    both modes produce identical rollout streams (same generator draws).

    ``param_sync_every=k`` refreshes the behavior params only every k-th
    dispatch — the actor-lag knob.

    ``ready_event`` (CUDA only, else None) is recorded on the stream by
    every ``next_batch`` after the returned rollout and before the unroll
    it leaves in flight: waiting on it waits for the returned batch (and
    for whatever the caller queued before the call, such as the learner's
    last update), never for the unroll in flight. ``ReplaySource`` copies
    the batch to the host behind it.

    The actors act with their own copy of the agent (TorchBeast's
    ``actor_model`` beside the ``learner_model``). The learner updates its
    parameters in place, so each sync copies the learner's ``state_dict``
    into the actor copy; between syncs the actors keep the parameters of
    the last sync, whatever the learner does meanwhile.

    The unroll is the reference's jitted one (``compiled.Unroll``): the
    env carry lives in static buffers updated in place by every dispatch,
    and on CUDA each dispatch replays a CUDA graph of the unroll that
    draws from the source's generator, which it leaves where an eager
    dispatch would. Each rollout is copied out of graph memory, so the
    one handed out is never overwritten by the dispatch that follows it.
    """

    def __init__(self, unroll: Callable, carry, generator: torch.Generator,
                 actor: torch.nn.Module, *, unroll_length: int,
                 batch_size: int, pipelined: bool = True,
                 param_sync_every: int = 1):
        self._unroll = Unroll(unroll, carry, generator)
        self._gen = generator
        self._actor = actor
        self.unroll_length = unroll_length
        self.batch_size = batch_size
        self.frames_per_batch = unroll_length * batch_size
        self.pipelined = pipelined
        self.param_sync_every = max(1, param_sync_every)
        self._dispatches = 0
        self._pending = None
        self._device = next(actor.parameters()).device
        self.ready_event = None

    @property
    def _carry(self):
        return self._unroll.carry

    @property
    def captures(self) -> int:
        """CUDA graph captures of the unroll (``compiled.Unroll``)."""
        return self._unroll.captures

    def _dispatch(self, params):
        if self._dispatches % self.param_sync_every == 0:
            # in place: the actors' storages, which the graph reads, stay
            self._actor.load_state_dict(params.state_dict())
        self._dispatches += 1
        return self._unroll(self._actor)

    def start(self, params) -> None:
        del params  # first dispatch happens lazily in next_batch

    def _mark_ready(self) -> None:
        if self._device.type == "cuda":
            self.ready_event = torch.cuda.current_stream(
                self._device).record_event()

    def next_batch(self, params):
        if not self.pipelined:
            rollout = self._dispatch(params)
            self._mark_ready()
            return rollout
        if self._pending is None:
            self._pending = self._dispatch(params)
        self._mark_ready()
        rollout, self._pending = self._pending, self._dispatch(params)
        return rollout

    def stop(self) -> None:
        """Drop the in-flight rollout and the dispatch count: a stop/start
        cycle must behave like a fresh source, so its first dispatch syncs
        the actors instead of resuming the ``param_sync_every`` cadence with
        last run's parameters."""
        self._pending = None
        self._dispatches = 0

    # -- SourceState protocol -------------------------------------------------
    #
    # Captured at a step boundary (periodic/final checkpoints are), this is
    # the COMPLETE dispatch state: the env carry and the generator's state,
    # the dispatch counter (param_sync_every cadence), the in-flight
    # double-buffered rollout, and the actors' parameter copy (which lags
    # the learner's when param_sync_every > 1). Restoring all of it makes
    # the resumed rollout stream bit-identical to the uninterrupted one.
    # The tensors are the live ones, valid until the source next
    # dispatches: checkpoint.snapshot copies them. Subclasses lay the
    # stream's state out in their checkpoint.

    def _load_dispatch(self, dispatches, pending, actor) -> None:
        self._dispatches = int(dispatches)
        self._pending = None if pending is None else {
            k: torch.as_tensor(v).to(self._device)
            for k, v in pending.items()}
        self._actor.load_state_dict(
            {k: torch.as_tensor(v) for k, v in actor.items()})

    def _load_stream(self, carry, generator) -> None:
        self._unroll.load(_like(self._carry, carry))
        self._gen.set_state(torch.as_tensor(generator,
                                            dtype=torch.uint8).cpu())


class DeviceSource(_CompiledUnrollSource):
    """Single-device unroll source (see ``_CompiledUnrollSource`` for the
    pipelining and parameter-sync semantics)."""

    @classmethod
    def for_env(cls, env, agent: torch.nn.Module, *, unroll_length: int,
                batch_size: int, seed: int, **kwargs) -> "DeviceSource":
        """Build the feed-forward-agent source from an Env and the learner's
        agent, on the agent's device, drawing from a generator seeded with
        ``seed``."""
        from repro_torch.core import rollout as rollout_lib
        device = next(agent.parameters()).device
        gen = torch.Generator(device=device).manual_seed(seed)
        carry = rollout_lib.env_reset_batch(env, gen, batch_size, device)
        actor = copy.deepcopy(agent).requires_grad_(False)
        unroll = rollout_lib.make_unroll(env, unroll_length)
        return cls(unroll, carry, gen, actor, unroll_length=unroll_length,
                   batch_size=batch_size, **kwargs)

    def state_dict(self) -> Dict[str, Any]:
        return {
            "kind": type(self).__name__,
            "dispatches": self._dispatches,
            "pending": self._pending,
            "actor": self._actor.state_dict(),
            "stream": {"carry": self._carry,
                       "generator": self._gen.get_state()},
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        _check_kind(state, self)
        self._load_stream(state["stream"]["carry"],
                          state["stream"]["generator"])
        self._load_dispatch(state["dispatches"], state["pending"],
                            state["actor"])


# ---------------------------------------------------------------------------
# Data-parallel on-device actors (one stream per rank of the data mesh)


class ShardedDeviceSource(_CompiledUnrollSource):
    """The data-parallel actors: each rank of the data mesh (``--mesh-data
    N``, ``launch/mesh.py``) runs its own unroll stream of B/N columns on
    its own device, and its learner consumes that block where it was made
    — the reference's per-device streams fanned into one globally sharded
    batch, with the ranks as processes.

    ``batch_size`` and ``frames_per_batch`` are GLOBAL (B and T x B, so
    the Runtime's fps counts every rank's frames). Rank 0 draws from the generator ``DeviceSource.for_env`` builds
    from the same seed, so world size 1 emits bitwise ``DeviceSource``'s
    stream; rank r > 0 draws from ``sharding.rank_seed(seed, r)`` (the
    reference folds r into its key with ``jax.random.fold_in``, which has
    no torch counterpart). Double buffering and ``param_sync_every`` are
    ``_CompiledUnrollSource``'s.

    SourceState: ``state_dict`` is a collective (every rank calls it at
    the same step) that gathers the streams to rank 0 in the reference's
    layout — one carry and one generator per rank under ``stream``, the
    in-flight rollout as the global batch (rank r's block at its
    columns), the actors' parameter copy (equal on every rank) once; the
    other ranks get None. ``load_state_dict`` takes rank r's entries (and
    its block of the in-flight batch) and refuses a checkpoint of another
    world size.
    """

    def __init__(self, unroll: Callable, carry, generator: torch.Generator,
                 actor: torch.nn.Module, mesh, *, unroll_length: int,
                 batch_size: int, **kwargs):
        super().__init__(unroll, carry, generator, actor,
                         unroll_length=unroll_length,
                         batch_size=batch_size, **kwargs)
        self._mesh = mesh

    @classmethod
    def for_env(cls, env, agent: torch.nn.Module, *, unroll_length: int,
                batch_size: int, seed: int, mesh,
                **kwargs) -> "ShardedDeviceSource":
        """This rank's stream for an Env and the learner's agent (on the
        agent's device, which is the rank's); ``batch_size`` is global and
        must divide by the mesh size."""
        from repro_torch.core import rollout as rollout_lib
        if batch_size % mesh.size:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"mesh size {mesh.size}")
        device = next(agent.parameters()).device
        gen = torch.Generator(device=device).manual_seed(
            sharding.rank_seed(seed, mesh.rank))
        carry = rollout_lib.env_reset_batch(
            env, gen, batch_size // mesh.size, device)
        actor = copy.deepcopy(agent).requires_grad_(False)
        unroll = rollout_lib.make_unroll(env, unroll_length)
        return cls(unroll, carry, gen, actor, mesh,
                   unroll_length=unroll_length, batch_size=batch_size,
                   **kwargs)

    def state_dict(self) -> Optional[Dict[str, Any]]:
        parts = sharding.gather_to_main(
            {"pending": self._pending, "carry": self._carry,
             "generator": self._gen.get_state()}, self._mesh)
        if parts is None:
            return None
        pending = None if self._pending is None else {
            k: torch.cat([p["pending"][k] for p in parts], dim=1)
            for k in self._pending}
        return {
            "kind": type(self).__name__,
            "dispatches": self._dispatches,
            "pending": pending,
            "actor": self._actor.state_dict(),
            "stream": {"n": self._mesh.size,
                       "carries": [p["carry"] for p in parts],
                       "generators": [p["generator"] for p in parts]},
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        _check_kind(state, self)
        stream, n = state["stream"], self._mesh.size
        if int(stream["n"]) != n:
            raise ValueError(
                f"checkpoint source state spans {stream['n']} devices, "
                f"this mesh has {n} — resume with the same --mesh-data")
        rank = self._mesh.rank
        self._load_stream(stream["carries"][rank],
                          stream["generators"][rank])
        pending = state["pending"]
        self._load_dispatch(
            state["dispatches"],
            None if pending is None
            else sharding.shard_rollout(pending, self._mesh),
            state["actor"])


# ---------------------------------------------------------------------------
# Off-policy replay composition


class ReplaySource:
    """Compose a replay buffer over any ``RolloutSource``.

    Every ``next_batch`` (1) pulls one fresh rollout batch from the inner
    source, (2) inserts its B columns into the buffer, (3) samples
    ``round(B * replay_ratio)`` stored rollouts and (4) emits the
    concatenation along the batch axis, tagged with a per-column
    ``is_replay`` mask. Replayed columns keep the ``behavior_logits``
    recorded when they were generated, so the V-trace importance weights
    in the learner stay correct for stale data — no special-casing in the
    loss beyond the optional CLEAR terms (core/losses.py) gated on
    ``is_replay``.

    ``replay_ratio`` is replayed:fresh — 1.0 means a 1:1 mixed batch of
    2B columns. ``frames_per_batch`` counts only the B fresh columns
    (replayed rows cost no new environment frames; that is the
    sample-efficiency argument). Sampling happens BEFORE the fresh batch
    is inserted, so replayed rows always predate the current step — except
    the very first batch, which warm-starts from its own columns.

    ``value_fn(params, obs) -> (T, B) values`` (optional) records the
    acting network's value estimates on every fresh rollout at insert
    time; replayed columns then carry them back as ``behavior_value``, the
    cloning target of the CLEAR value-cloning term (core/losses.py).

    The learner step feeds per-column priorities back through
    ``on_learner_metrics`` (the Runtime calls it after every step when the
    metrics dict carries a ``priority`` vector aligned with the emitted
    columns: fresh first, then replayed).

    On the card the buffer stays in host memory. The fresh batch goes to
    the host on a side stream behind the inner source's ``ready_event``
    (or an event recorded when the batch came back), into pinned memory,
    and only that copy is waited for: a double-buffered inner source keeps
    its next unroll running meanwhile. ``value_fn`` runs on the same side
    stream. The replayed columns go back from pinned memory without
    waiting. ``split_ms`` holds the host-clock milliseconds of the parts
    of the last ``next_batch``: ``inner`` (the inner source's
    ``next_batch``), ``to_host`` (the wait and the copy, with
    ``value_fn``), ``sample``, ``insert`` and ``to_device`` (the enqueue
    of the replayed columns' copy and of the mixed batch); ``copy_event``
    (timing-enabled) marks on the card where the last host copy ended.
    """

    def __init__(self, source, buffer, *, replay_ratio: float = 1.0,
                 seed: int = 0, value_fn: Optional[Callable] = None):
        self.inner = source
        self.buffer = buffer
        self.replay_ratio = float(replay_ratio)
        self.frames_per_batch = source.frames_per_batch
        self._value_fn = value_fn
        # a ShardedReplay buffer makes this rank's source one of N: its
        # own generator (rank_seed), gauges and state gathered over ranks
        self._mesh = getattr(buffer, "mesh", None)
        if self._mesh is not None:
            seed = sharding.rank_seed(seed, self._mesh.rank)
        self._rng = np.random.default_rng(seed)
        self._last_ids: list = []
        self._served = 0        # replayed columns emitted
        self._hits = 0          # ... that were NOT inserted this very step
        self._prio_drops = 0    # priority vectors discarded (shape drift)
        self._prio_warned = False
        self._stream = None     # the side stream of the host copies, lazy
        self.copy_event = None  # recorded after the last host copy
        self.split_ms: Dict[str, float] = {}

    def start(self, params) -> None:
        self.inner.start(params)

    def _with_values(self, fresh, params):
        if self._value_fn is None or "behavior_value" in fresh:
            return fresh
        # ≈ the behavior network's values (exact up to the source's
        # parameter lag) — the CLEAR value-cloning anchor; data, not a
        # graph
        with torch.no_grad():
            values = self._value_fn(params, fresh["obs"][:-1])
        return dict(fresh, behavior_value=values.float())

    def _to_host(self, fresh, params):
        """(fresh with ``behavior_value``, its numpy host copy)."""
        device = fresh["action"].device
        if device.type != "cuda":
            fresh = self._with_values(fresh, params)
            return fresh, {k: v.numpy() for k, v in fresh.items()}
        main = torch.cuda.current_stream(device)
        ready = getattr(self.inner, "ready_event", None)
        if ready is None:
            ready = main.record_event()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        self._stream.wait_event(ready)
        with torch.cuda.stream(self._stream):
            fresh = self._with_values(fresh, params)
            if "behavior_value" in fresh:
                # made on the side stream, read later on the main one
                fresh["behavior_value"].record_stream(main)
            host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    for k, v in fresh.items()}
            for k, v in fresh.items():
                host[k].copy_(v, non_blocking=True)
        self.copy_event = torch.cuda.Event(enable_timing=True)
        self.copy_event.record(self._stream)
        self.copy_event.synchronize()
        return fresh, {k: v.numpy() for k, v in host.items()}

    def _mix(self, fresh, replayed, b: int, k: int):
        """The fresh-first mixed batch on the fresh batch's device. The
        fresh/replayed schemas must agree — a key present on one side only
        would silently vanish from the emitted batch (and the learner
        would train without it), so schema drift fails loudly instead."""
        missing = sorted(set(fresh) - set(replayed))
        extra = sorted(set(replayed) - set(fresh))
        if missing or extra:
            raise KeyError(
                f"fresh/replayed batch schemas diverge: fresh-only keys "
                f"{missing}, replay-only keys {extra} — the emitted batch "
                "would silently drop columns")
        device = fresh["action"].device
        pin = device.type == "cuda"
        batch = {}
        for key, x in fresh.items():
            r = torch.from_numpy(replayed[key])
            if pin:
                r = r.pin_memory()
            batch[key] = torch.cat(
                [x, r.to(device, non_blocking=True)], dim=1)
        batch["is_replay"] = torch.arange(b + k, device=device) >= b
        return batch

    def _sample(self, k: int, query):
        t0 = time.perf_counter()
        out = self.buffer.sample(k, self._rng, query=query)
        self.split_ms["sample"] += (time.perf_counter() - t0) * 1e3
        return out

    def next_batch(self, params):
        self.split_ms = {"sample": 0.0}
        t0 = time.perf_counter()
        fresh = self.inner.next_batch(params)
        t1 = time.perf_counter()
        fresh, host = self._to_host(fresh, params)
        self.split_ms["inner"] = (t1 - t0) * 1e3
        self.split_ms["to_host"] = (time.perf_counter() - t1) * 1e3
        b = host["action"].shape[1]
        # k counts the GLOBAL batch's replayed columns (B x ratio, as the
        # reference's); a sharded buffer samples this rank's k / N of them
        n = 1 if self._mesh is None else self._mesh.size
        k = int(round(b * n * self.replay_ratio))
        query = host["obs"] \
            if k and getattr(self.buffer, "needs_query", False) else None
        replayed = None
        if k and len(self.buffer):   # sample strictly-older data first
            replayed, replay_ids = self._sample(k, query)
        t0 = time.perf_counter()
        fresh_ids = self.buffer.insert(host)
        self.split_ms["insert"] = (time.perf_counter() - t0) * 1e3
        if k == 0:
            self._last_ids = list(fresh_ids)
            self.split_ms["to_device"] = 0.0
            return dict(fresh, is_replay=torch.zeros(
                (b,), dtype=torch.bool, device=fresh["action"].device))
        if replayed is None:         # first batch: warm-start from itself
            replayed, replay_ids = self._sample(k, query)
        t0 = time.perf_counter()
        batch = self._mix(fresh, replayed, b, len(replay_ids))
        self.split_ms["to_device"] = (time.perf_counter() - t0) * 1e3
        self._last_ids = list(fresh_ids) + list(replay_ids)
        self._served += len(replay_ids)
        fresh_set = set(fresh_ids)
        self._hits += sum(1 for i in replay_ids if i not in fresh_set)
        return batch

    def on_learner_metrics(self, step, metrics) -> None:
        """Runtime feedback hook: route the learner's per-column priority
        vector to the slots that produced the last batch. A vector that
        does not align with the emitted columns cannot be routed — that
        silently degrades elite replay to uniform, so it warns (once) and
        counts the drop in ``stats()``. A tensor is read to the host here:
        the one wait for the learner step that replay adds."""
        del step
        prio = metrics.get("priority") if hasattr(metrics, "get") else None
        if prio is None or not self._last_ids:
            return
        if isinstance(prio, torch.Tensor):
            prio = prio.detach().cpu().numpy()
        prio = np.asarray(prio, np.float64)
        if prio.shape[0] != len(self._last_ids):
            self._prio_drops += 1
            if not self._prio_warned:
                self._prio_warned = True
                warnings.warn(
                    f"replay priority vector has {prio.shape[0]} entries "
                    f"but the last batch emitted {len(self._last_ids)} "
                    "columns; feedback dropped — elite replay is degrading "
                    "to uniform (drops counted in stats()['replay_"
                    "priority_drops'])", RuntimeWarning, stacklevel=2)
            return
        self.buffer.update_priorities(self._last_ids, prio)

    def stats(self):
        """The buffer's gauges and the feedback counters; over a sharded
        buffer a collective, every figure global (summed over ranks)."""
        s = {f"replay_{k}": v for k, v in self.buffer.stats().items()}
        counts = [self._hits, self._served, self._prio_drops]
        if self._mesh is not None:
            counts = sharding.sum_floats(counts, self._mesh)
        hits, served, drops = counts
        s["replay_hit_rate"] = hits / max(served, 1)
        s["replay_priority_drops"] = float(drops)
        return s

    # -- SourceState protocol --------------------------------------------------

    def state_dict(self) -> Optional[Dict[str, Any]]:
        """Nested checkpoint: inner-source state + buffer slots/priorities
        + the sampling generator's state (its 128-bit PCG64 integers stay
        Python ints) and the feedback bookkeeping. ``last_ids`` entries are
        ints, or ``(rank, ticket)`` pairs over a ``ShardedReplay``.

        Over a sharded buffer this is a collective: rank 0 gets the
        reference's layout (the inner source's and the buffer's gathered
        states, every rank's ``last_ids`` in rank order — the reference's
        global emitted order), with the generator and the counters one
        entry per rank (each rank samples from its own generator), and
        the other ranks get None."""
        inner = self.inner.state_dict()
        buffer = self.buffer.state_dict()
        own = {"rng": self._rng.bit_generator.state,
               "last_ids": list(self._last_ids), "served": self._served,
               "hits": self._hits, "prio_drops": self._prio_drops}
        if self._mesh is not None:
            parts = sharding.gather_to_main(own, self._mesh)
            if parts is None:
                return None
            own = {k: [p[k] for p in parts] for k in own}
            own["last_ids"] = [i for ids in own["last_ids"] for i in ids]
        return {"kind": type(self).__name__, "inner": inner,
                "buffer": buffer, **own}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        _check_kind(state, self)
        self.inner.load_state_dict(state["inner"])
        self.buffer.load_state_dict(state["buffer"])
        ids = [tuple(int(j) for j in i) if isinstance(i, (tuple, list))
               else int(i) for i in state["last_ids"]]
        own = {k: state[k] for k in ("rng", "served", "hits", "prio_drops")}
        if self._mesh is not None:   # this rank's entries
            rank = self._mesh.rank
            own = {k: v[rank] for k, v in own.items()}
            ids = [i for i in ids if i[0] == rank]
        rng = np.random.default_rng()
        rng.bit_generator.state = own["rng"]
        self._rng = rng
        self._last_ids = ids
        self._served = int(own["served"])
        self._hits = int(own["hits"])
        self._prio_drops = int(own["prio_drops"])

    def stop(self) -> None:
        """Stop the inner source and recycle every buffer slot back to the
        free list — even when the learner died mid-batch."""
        try:
            self.inner.stop()
        finally:
            self._last_ids = []
            self.buffer.clear()


# ---------------------------------------------------------------------------
# Host-loop (MonoBeast/PolyBeast) actors

# The learner queue holds at most this many rollouts (actors block beyond
# it), and ``next_batch`` gives up after waiting this long for a batch.
_LEARNER_QUEUE_ITEMS = 128
_BATCH_TIMEOUT_S = 60.0


def _policy_logits(agent, obs):
    return agent(obs).policy_logits


class HostLoopSource:
    """Actor threads + inference queue + learner queue behind the contract.

    The envs run on the CPU in the actor threads (``HostEnv``), as the
    paper's actors do; the policy and the learner run on the agent's
    device. The policy runs on the source's own copy of the agent (the
    actor model beside the learner model): the learner updates its
    parameters in place, so ``next_batch(params)`` copies them into the
    actor copy under a lock that the inference thread holds for each
    forward pass — no forward pass ever sees a half-updated parameter
    set. Actors pick the new parameters up on their next policy
    evaluation, the natural asynchronous parameter lag of the host
    architecture; ``next_batch`` then blocks until the learner queue
    yields a stacked batch, which it moves to the device. The forward
    pass is ``policy`` (``compiled.Forward``): on the card one CUDA graph
    per padded batch size, captured on the inference thread, reading the
    copy's weights in place.

    ``mesh`` (the data mesh of ``--mesh-data N``, ``launch/mesh.py``):
    each rank runs a pool of its own, ``num_actors / N`` actors feeding a
    learner queue of B/N columns, seeded by ``sharding.rank_seed(seed,
    rank)`` — PolyBeast's shape, where the reference splits one pool's
    stacked batch over its devices. Neither path's batches are
    replayable, so the two differ in scheduling only. ``batch_size``,
    ``num_actors`` and ``frames_per_batch`` stay global.

    SourceState: thread scheduling (which actor's rollout lands in which
    batch slot) is not replayable, so the host path cannot promise
    bit-exact resume. ``state_dict`` records only the source kind; actors
    restart fresh on resume while the learner state restores exactly.
    """

    def __init__(self, env, agent: torch.nn.Module, *, num_actors: int,
                 unroll_length: int, batch_size: int, seed: int = 0,
                 inference_timeout_ms: float = 5.0, mesh=None):
        self._env = env
        self._actor = copy.deepcopy(agent).requires_grad_(False)
        self._device = next(agent.parameters()).device
        self._lock = threading.Lock()
        # the reference's jitted policy (``apply_fn(p, obs).policy_logits``)
        self.policy = Forward(_policy_logits)
        self.num_actors = num_actors
        self.unroll_length = unroll_length
        self.batch_size = batch_size
        self.frames_per_batch = unroll_length * batch_size
        self._local_actors, self._local_batch = num_actors, batch_size
        if mesh is not None:
            n = mesh.size
            if batch_size % n != 0:
                raise ValueError(f"batch {batch_size} not divisible by "
                                 f"mesh size {n}")
            if num_actors % n != 0:
                raise ValueError(f"{num_actors} actors not divisible by "
                                 f"mesh size {n}")
            self._local_actors = num_actors // n
            self._local_batch = batch_size // n
            seed = sharding.rank_seed(seed, mesh.rank)
        self.seed = seed
        self._inference_timeout_ms = inference_timeout_ms
        self._pool = None
        self._inference_thread = None

    def _sync(self, params) -> None:
        with self._lock:
            self._actor.load_state_dict(params.state_dict())

    def _policy(self, obs: np.ndarray) -> np.ndarray:
        """Runs on the inference thread: (n, *obs) -> (n, A) float32,
        through ``self.policy`` (on the card a CUDA graph per padded
        batch). The replay and the copy to the host stay under the lock:
        ``_sync`` must not overwrite weights a replay still reads."""
        x = torch.from_numpy(obs).to(self._device)
        with self._lock:
            logits = self.policy(self._actor, x).float().cpu()
        return logits.numpy()

    def start(self, params) -> None:
        from repro_torch.core.actor_pool import (ActorPool,
                                                 start_inference_thread)
        from repro_torch.core.batcher import BatchingQueue, DynamicBatcher
        from repro_torch.envs.base import HostEnv

        self._sync(params)
        self.inference = DynamicBatcher(
            max_batch_size=self._local_actors,
            timeout_ms=self._inference_timeout_ms)
        self.learner_queue = BatchingQueue(
            self._local_batch, batch_dim=1, max_items=_LEARNER_QUEUE_ITEMS)
        self._pool = ActorPool(
            lambda seed: HostEnv(self._env, seed), self._local_actors,
            self.unroll_length, self.inference, self.learner_queue,
            seed=self.seed)
        self._inference_thread = start_inference_thread(
            self.inference, self._policy, self._device)
        self._pool.start()

    def next_batch(self, params):
        if self._pool is None:
            self.start(params)
        self._sync(params)
        batch = self.learner_queue.get(timeout=_BATCH_TIMEOUT_S)
        if batch is None:
            raise TimeoutError(
                f"no learner batch within {_BATCH_TIMEOUT_S}s "
                f"({self._local_actors} actors, queue "
                f"size {self.learner_queue.size()})")
        return {k: torch.from_numpy(v).to(self._device)
                for k, v in batch.items()}

    def stop(self) -> None:
        """Stop the actor pool AND the inference thread. The pool closes
        the DynamicBatcher (unblocking the thread's ``get_batch``), but the
        thread itself must be joined — otherwise it lingers, evaluating the
        policy after the run has stopped."""
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.stop()
        thread, self._inference_thread = self._inference_thread, None
        if thread is not None:
            thread.join(timeout=5.0)
            if thread.is_alive():
                # warn, don't raise: stop() runs in Runtime's finally, and
                # raising here would mask the root-cause exception (e.g.
                # the actor TimeoutError a wedged policy eval produced).
                warnings.warn("inference thread did not exit within 5s of "
                              "stop()", RuntimeWarning, stacklevel=2)

    def state_dict(self) -> Dict[str, Any]:
        return {"kind": type(self).__name__}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        _check_kind(state, self)


# ---------------------------------------------------------------------------
# LLM-policy token-MDP actors


def token_task_reward(tokens, vocab_size: int, a_mod: int = 5,
                      b_mod: int = 3):
    """The synthetic token-MDP reward: +1 when token t+1 equals the affine
    target (a*token_t + b) mod V. tokens (B, S+1) -> reward (B, S)."""
    target = (a_mod * tokens[:, :-1] + b_mod) % vocab_size
    return (tokens[:, 1:] == target).float()


class GeneratorSource:
    """Episodes from the autoregressive decode path: the LM *is* the policy,
    tokens are actions, and the recorded sampling log-probs are the behavior
    policy outputs V-trace needs. Emitted time-major (obs[t] is the token
    consumed at step t; action[t] == obs[t+1]):

      obs               (T+1, B) int32   the one-token prompt, then T tokens
      action            (T, B) int32
      behavior_logprob  (T, B) float32
      reward            (T, B) float32
      done              (T, B) bool      set at the last step only

    Runs through ``generate.DecodeSession`` — the slot API the server
    drives. Each episode admits every slot in one batched prefill, steps
    the session in lockstep, then evicts. The session reads the learner's
    parameter tree itself, which the learner updates in place: the actors
    act with the current weights, and no copy of them is made. The
    attention/SSD impls come from the config (see ImplContext).

    Tokens are sampled at ``temperature`` (default 1) and rewarded by
    ``reward_fn``: the (B, T+1) tokens, a tensor on the session's device,
    to (B, T) float32 rewards (default ``token_task_reward``). Every
    episode's prompts and per-slot sampling seeds are drawn from one host
    ``torch.Generator`` seeded with ``seed``; its state is the source's
    state for ``--resume``.

    ``mesh``, ``rules``: the ("data", "model") mesh (a ``Mesh2D``) and its
    rules table. Each data index then generates its own B/D episodes,
    its generator seeded with ``sharding.rank_seed(seed, data_index)``
    (data index 0 draws what the unmeshed source draws), and the ranks of
    one model group generate them together (``generate.DecodeSession``
    under the mesh). ``frames_per_batch`` stays global.
    """

    def __init__(self, cfg, *, batch_size: int, episode_length: int,
                 seed: int, reward_fn: Optional[Callable] = None,
                 temperature: float = 1.0, mesh=None, rules=None):
        from repro_torch.distributed import sharding
        self._cfg = cfg
        self._mesh, self._rules = mesh, rules
        self.frames_per_batch = batch_size * episode_length
        if mesh is not None:
            if batch_size % mesh.data:
                raise ValueError(f"batch {batch_size} not divisible by the "
                                 f"data axis {mesh.data}")
            batch_size //= mesh.data
            seed = sharding.rank_seed(seed, mesh.data_index)
        self.batch_size = batch_size
        self.episode_length = episode_length
        self._gen = torch.Generator().manual_seed(seed)
        self._reward_fn = reward_fn or (
            lambda toks: token_task_reward(toks, cfg.vocab_size))
        self._temperature = temperature
        self._session = None

    def start(self, params) -> None:
        del params

    def _get_session(self, params):
        from repro_torch.core import generate as gen_lib
        if self._session is None:
            self._session = gen_lib.DecodeSession(
                params, self._cfg, max_batch=self.batch_size,
                max_len=self.episode_length + 1, mesh=self._mesh,
                rules=self._rules)
        self._session.params = params
        return self._session

    def next_batch(self, params):
        b, t = self.batch_size, self.episode_length
        prompt = torch.randint(0, self._cfg.vocab_size, (b, 1),
                               generator=self._gen)
        seeds = torch.randint(0, 2 ** 62, (b,), generator=self._gen)
        sess = self._get_session(params)
        # batched admit: every episode reset is one prefill (the prompts
        # share a prefill bucket), not one per slot
        first = sess.prefill_many(range(b), list(prompt.numpy()),
                                  seeds=seeds.tolist(),
                                  temperature=self._temperature)
        toks = [[f["token"] for f in first]]          # time-major lists
        lps = [[f["logprob"] for f in first]]
        for _ in range(t - 1):
            o = sess.step()
            toks.append(o["token"])
            lps.append(o["logprob"])
        for i in range(b):
            sess.evict(i)
        dev = sess.device
        obs = torch.cat([prompt.T, torch.as_tensor(np.asarray(toks))],
                        dim=0).to(dev)                 # (T+1, B)
        reward = self._reward_fn(obs.T).T
        done = torch.zeros((t, b), dtype=torch.bool, device=dev)
        done[-1] = True
        return {
            "obs": obs.int(),
            "action": obs[1:].int(),
            "behavior_logprob": torch.as_tensor(
                np.asarray(lps, np.float32), device=dev),
            "reward": reward.float(),
            "done": done,
        }

    def stop(self) -> None:
        pass

    def state_dict(self) -> Dict[str, Any]:
        return {"kind": type(self).__name__,
                "generator": self._gen.get_state()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        _check_kind(state, self)
        self._gen.set_state(torch.as_tensor(state["generator"],
                                            dtype=torch.uint8).cpu())


def lm_rl_step_from_rollout(lm_train_step: Callable) -> Callable:
    """Adapt ``learner.make_lm_train_step`` (batch-major token dict) to the
    canonical time-major rollout emitted by GeneratorSource."""

    def step(params, opt_state, step_i, rollout):
        batch = {
            "tokens": rollout["obs"].T,
            "behavior_logprob": rollout["behavior_logprob"].T,
            "reward": rollout["reward"].T,
            "done": rollout["done"].T,
        }
        return lm_train_step(params, opt_state, step_i, batch)

    return step


# ---------------------------------------------------------------------------
# Supervised data (LM pretraining)


class DataSource:
    """A RolloutSource over an iterator of ready batches — the non-RL
    substrate (LM pretraining) runs through the same Runtime loop.

    SourceState: the iterator is checkpointable (``state_dict`` /
    ``load_state_dict``, as data.PackedBatchIterator's seed and offset),
    and its state rides inside the source state — extending the bit-exact
    ``--resume`` guarantee to ``--mode lm``.

    Each batch's numpy arrays become tensors on ``device``; ``stop``
    closes the iterator, which reopens at its offset on the next batch.

    ``mesh``, ``rules``: under a ("data", "model") mesh every rank runs
    the same iterator over the global batch and keeps its data block
    (``sharding.shard_lm_batch``)."""

    def __init__(self, iterator, *, frames_per_batch: int, device,
                 mesh=None, rules=None):
        self._it = iterator
        self.frames_per_batch = frames_per_batch
        self._device = device
        self._mesh, self._rules = mesh, rules

    def start(self, params) -> None:
        del params

    def next_batch(self, params):
        batch = {k: torch.from_numpy(v).to(self._device)
                 for k, v in next(self._it).items()}
        if self._mesh is not None:
            from repro_torch.distributed import sharding
            batch = sharding.shard_lm_batch(batch, self._mesh, self._rules)
        return batch

    def stop(self) -> None:
        self._it.close()

    def state_dict(self) -> Dict[str, Any]:
        return {"kind": type(self).__name__,
                "iterator": self._it.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        _check_kind(state, self)
        self._it.load_state_dict(state["iterator"])
