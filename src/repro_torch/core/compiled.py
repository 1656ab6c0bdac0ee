"""CUDA graphs of the port's plain functions: its counterpart of the
reference's ``jax.jit``.

The reference compiles its entries once per shape and donates the state
they update. The port runs the same plain functions eagerly on the CPU,
and on the card as CUDA graphs of static memory:

  * ``Graphs`` is one owner's set of graphs (the owner: a session's decode
    step, its admissions, a learner step, an unroll stream). A call names
    the static memory its function reads and writes by address (``key``:
    the buffers, with their shapes, and the params' storages) and an
    ``anchor`` tensor whose life bounds the graphs of that memory. The
    first call for a key runs the function eagerly on a side stream, which
    loads its kernels and makes cuBLAS's and cuDNN's workspaces for that
    stream; it is a real call. The second captures the function on that
    stream into the owner's one memory pool, and replays it; every later
    call replays. So a key seen once costs no capture. A kernel wrapper
    under capture counts into ``ops.take_captured()`` and each replay adds
    those counts to ``ops.stats()`` (``ops.record_replay``), so launch
    counts stay exact. Generators whose draws the function makes are
    registered with the graph: a replay draws what an eager call from the
    same generator state would, and leaves the generator where that call
    would. A capture or replay failure raises: nothing falls back to
    eager on a CUDA tensor.
  * ``TrainStep`` wraps a learner step (the reference's
    ``jax.jit(make_train_step(...))`` and its jitted LM steps): the batch
    is copied into static buffers, the optimizer's changing scalars are
    written into device scalars before the replay, and the metrics are
    copied out.
  * ``Unroll`` wraps an unroll (the reference's jitted unroll with its
    carry donated): the carry lives in static buffers updated in place,
    and each rollout is copied out of graph memory, so a rollout handed
    to the learner is never overwritten by the next dispatch.
  * ``UnrollTrainStep`` composes an ``Unroll`` and a ``TrainStep`` into
    one graph (the reference's unroll and learner step jitted as one
    program): the carry stays in the unroll's static buffers, the
    rollout in graph memory, and the optimizer's scalars are staged as
    ``TrainStep`` stages them.
  * ``Forward`` wraps a module's forward (the reference's jitted
    ``apply_fn(p, obs).<head>``: the host actors' policy, replay's value
    function): one graph per input shape, the input copied into a static
    buffer and the output copied out.

Graphs may be captured on more than one thread (the host actors' policy
on the inference thread, the learner step on the main one): a capture
synchronises the device first, which is invalid while another capture is
underway, so captures take one lock (``CAPTURE_LOCK``).

Outputs that a graph writes lie in graph memory, which the next replay of
any graph of the same owner may overwrite: its caller copies out, at
once, what it keeps.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch.utils.weak import WeakTensorKeyDictionary

from repro_torch.kernels import ops
from repro_torch.tree import flatten, leaves, map_leaves

# held by every capture, on whichever thread (module docstring)
CAPTURE_LOCK = threading.Lock()


class Graph:
    """One key's graph: None until its second call captures it; its
    outputs (graph memory) and the kernel launches each replay makes."""

    def __init__(self):
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Any = None
        self.launches: Dict[str, int] = {}


class Graphs:
    """The CUDA graphs of one owner (see the module docstring). ``limit``:
    the most graphs kept per anchor (the oldest dropped first; None: no
    limit). ``captures`` counts the captures, ``capture_s`` their host
    seconds (``torch.cuda.graph`` synchronises and empties the caching
    allocator first)."""

    def __init__(self, limit: Optional[int] = None):
        self.limit = limit
        self.captures = 0
        self.capture_s = 0.0
        self._entries = WeakTensorKeyDictionary()   # anchor -> {key: Graph}
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        self._pool = None

    def get(self, anchor: torch.Tensor, key) -> Optional[Graph]:
        """The graph of ``key`` under ``anchor``, None if not seen."""
        return self._entries.get(anchor, {}).get(key)

    def __call__(self, anchor: torch.Tensor, key, fn: Callable[[], Any],
                 generators: Sequence[torch.Generator] = ()):
        """``fn()`` through the graph of ``key``: warmed eagerly on its
        first call, captured on its second, replayed after. ``fn`` reads
        and writes only the static memory ``key`` names and returns a tree
        of tensors; ``generators``: those it draws from."""
        entries = self._entries.get(anchor)
        if entries is None:
            entries = self._entries[anchor] = OrderedDict()
        entry = entries.get(key)
        if entry is None:
            while self.limit and len(entries) >= self.limit:
                entries.popitem(last=False)
            entries[key] = Graph()
            return self._warm(fn, anchor.device)
        if entry.graph is None:
            self._capture(entry, fn, anchor.device, generators)
        entry.graph.replay()
        ops.record_replay(entry.launches)
        return entry.outputs

    def _stream(self, device) -> torch.cuda.Stream:
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.Stream(device)
        return stream

    def _warm(self, fn, device):
        """An eager call on the capture stream, ordered after and before
        the current stream's work."""
        current = torch.cuda.current_stream(device)
        side = self._stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = fn()
        current.wait_stream(side)
        for x in leaves(out):
            if isinstance(x, torch.Tensor):
                x.record_stream(current)
        return out

    def _capture(self, entry: Graph, fn, device, generators) -> None:
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        with CAPTURE_LOCK:
            ops.take_captured()
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream(device),
                                  capture_error_mode="thread_local"):
                out = fn()
            entry.launches = ops.take_captured()
        entry.graph, entry.outputs = graph, out
        self.captures += 1
        self.capture_s += time.perf_counter() - t0


def _copy_out(tree):
    return map_leaves(lambda x: x.clone() if isinstance(x, torch.Tensor)
                      else x, tree)


def _ptrs(tree):
    return tuple((x.data_ptr(), tuple(x.shape)) for x in leaves(tree))


class TrainStep:
    """A learner step ``(params, opt_state, step, batch) -> (params,
    opt_state, metrics)`` compiled as the reference's
    ``jax.jit(make_train_step(...))`` is, with the same contract: the
    rl-agent steps, and the LM steps (``make_lm_train_step`` through
    ``lm_rl_step_from_rollout``, ``make_lm_pretrain_step``), whose
    decoder's backward runs K2's and K4's autograd Functions and remat's
    recomputations inside the capture.

    On CUDA with ``compiled`` (no mesh) the step runs as a CUDA graph
    per key: the batch's structure (each leaf's path, shape and dtype),
    the params' storages and the optimizer state's. The batch is copied
    into static buffers of its structure unless it already lies in them;
    the optimizer's rate (and AdamW's bias corrections) are written into
    its device scalars before each replay (``opt.stage``), so one graph
    serves every step whatever its rate; the metrics, ``priority``
    included, are copied out of graph memory. Replay's mixed batches are
    another structure, so another key.

    ``step_fn`` may be a step a user wrote around a learner step, taken as
    it stands (``examples/vtrace_ablation.py``'s uncorrected step: a
    forward under ``no_grad``, then the step on a new dict of the batch
    with its behaviour logits rebound).

    Elsewhere, and under a mesh (the gradients' all-reduce and the model
    axis's collectives, which no graph here captures), it calls
    ``step_fn``, eagerly.
    """

    def __init__(self, step_fn: Callable, opt, *, mesh=None):
        self.step_fn = step_fn
        self.opt = opt
        self.compiled = mesh is None
        self.graphs = Graphs()
        self._static: Dict[tuple, Any] = {}

    @property
    def captures(self) -> int:
        return self.graphs.captures

    def __call__(self, params, opt_state, step, batch):
        first = leaves(batch)[0]
        if not (self.compiled and first.is_cuda):
            return self.step_fn(params, opt_state, step, batch)
        static = self.inputs(batch)
        self.opt.stage(step, first.device)

        def run():
            return self.step_fn(params, opt_state, step, static)[2]
        metrics = self.graphs(leaves(static)[0],
                              self.graph_key(params, opt_state, static), run)
        return params, opt_state, _copy_out(metrics)

    @staticmethod
    def signature(batch) -> tuple:
        return tuple((path, tuple(x.shape), x.dtype, x.device)
                     for path, x in flatten(batch))

    def inputs(self, batch):
        """The static buffers of ``batch``'s structure, holding it."""
        sig = self.signature(batch)
        static = self._static.get(sig)
        if static is None:
            static = self._static[sig] = map_leaves(
                lambda x: torch.empty(x.shape, dtype=x.dtype,
                                      device=x.device), batch)
        for dst, src in zip(leaves(static), leaves(batch)):
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)
        return static

    def graph_key(self, params, opt_state, static) -> tuple:
        """What a captured step reads and writes by address: the static
        batch, the params' storages and the optimizer state's."""
        return (_ptrs(static), tuple(p.data_ptr() for p in params.parameters()),
                _ptrs(opt_state))


class Unroll:
    """An unroll ``unroll(agent, carry, gen) -> (carry, rollout)``
    (``core/rollout.py``) compiled as the reference's jitted unroll with
    its carry donated: ``carry`` is held in static buffers (``self.carry``)
    that every call updates in place, on every device.

    ``self(agent)`` returns one rollout. On CUDA it runs as a CUDA graph
    per key (the carry's buffers and the agent's storages), drawing from
    ``generator``, registered with the graph; the rollout is copied out of
    graph memory. A rollout leaf that is a carry buffer (the recurrent
    unroll's initial ``core_state``) is copied before the carry moves on.
    Updating the agent's parameters in place (``load_state_dict``) keeps
    the key, and the next replay reads them."""

    def __init__(self, unroll: Callable, carry, generator: torch.Generator):
        self._unroll = unroll
        self.carry = map_leaves(torch.clone, carry)
        self.generator = generator
        self.graphs = Graphs()

    @property
    def captures(self) -> int:
        return self.graphs.captures

    def graph_key(self, agent) -> tuple:
        return (_ptrs(self.carry),
                tuple(p.data_ptr() for p in agent.parameters()))

    def _step(self, agent):
        new, rollout = self._unroll(agent, self.carry, self.generator)
        held = {x.data_ptr() for x in leaves(self.carry)}
        rollout = map_leaves(lambda x: x.clone() if x.data_ptr() in held
                             else x, rollout)
        for dst, src in zip(leaves(self.carry), leaves(new)):
            dst.copy_(src)
        return rollout

    def __call__(self, agent):
        anchor = leaves(self.carry)[0]
        if not anchor.is_cuda:
            return self._step(agent)
        rollout = self.graphs(anchor, self.graph_key(agent),
                              lambda: self._step(agent),
                              generators=(self.generator,))
        return _copy_out(rollout)

    def load(self, carry) -> None:
        """Write ``carry`` (same structure) into the static buffers."""
        for dst, src in zip(leaves(self.carry), leaves(carry)):
            dst.copy_(src)


class UnrollTrainStep:
    """An unroll and then a learner step on its rollout, ``self(params,
    opt_state, step) -> (params, opt_state, metrics)``, compiled as the
    reference jits the two as one program (``examples/minatar_gridworld.py``'s
    ``combined``): the unroll acts with ``params`` themselves (no actor
    copy, no lag), and the step learns from that rollout at once.

    ``unroll`` (an ``Unroll``) holds the env carry in its static buffers
    and the generator; ``train_step`` (a ``TrainStep``) holds the plain
    step and its optimizer. On CUDA with ``train_step.compiled`` both run
    as one CUDA graph per key (the carry's buffers, the params' storages
    and the optimizer state's), the generator registered with it, the
    optimizer's changing scalars staged before each replay as
    ``TrainStep`` stages them; the rollout never leaves graph memory, and
    the metrics are copied out. Elsewhere ``step`` runs, eagerly."""

    def __init__(self, unroll: Unroll, train_step: TrainStep):
        self.unroll = unroll
        self.train_step = train_step
        self.graphs = Graphs()

    @property
    def captures(self) -> int:
        return self.graphs.captures

    def step(self, params, opt_state, step):
        """The plain function: the unroll (its carry updated in place),
        then the learner step."""
        rollout = self.unroll._step(params)
        return self.train_step.step_fn(params, opt_state, step, rollout)

    def __call__(self, params, opt_state, step):
        anchor = leaves(self.unroll.carry)[0]
        if not (self.train_step.compiled and anchor.is_cuda):
            return self.step(params, opt_state, step)
        self.train_step.opt.stage(step, anchor.device)
        key = self.unroll.graph_key(params) + (_ptrs(opt_state),)
        metrics = self.graphs(anchor, key,
                              lambda: self.step(params, opt_state, step)[2],
                              generators=(self.unroll.generator,))
        return params, opt_state, _copy_out(metrics)


class Forward:
    """A module's forward ``fn(module, x)``, without autograd, compiled as
    the reference jits ``apply_fn(p, obs).policy_logits`` (the host
    actors' policy) and ``.baseline`` (replay's value function).

    On a CUDA ``x`` it runs as a CUDA graph per key: ``x``'s shape and
    dtype (one static input buffer each, which ``x`` is copied into) and
    the module's storages. The host actors' inference queue pads its
    batches to ``batcher.bucket_size``'s ladder, so a policy has one graph
    per bucket. Updating the module's parameters in place
    (``load_state_dict``) keeps the key, and the next replay reads them.
    The output is copied out of graph memory. A forward holds no
    collective, so a data mesh does not keep it eager (as the unroll). On
    a CPU ``x`` it calls ``fn``."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.graphs = Graphs()
        self._static: Dict[tuple, torch.Tensor] = {}

    @property
    def captures(self) -> int:
        return self.graphs.captures

    def graph_key(self, module, static) -> tuple:
        return (static.data_ptr(), tuple(static.shape),
                tuple(p.data_ptr() for p in module.parameters()))

    def inputs(self, x: torch.Tensor) -> torch.Tensor:
        """The static input buffer of ``x``'s shape and dtype, holding
        it."""
        sig = (tuple(x.shape), x.dtype, x.device)
        static = self._static.get(sig)
        if static is None:
            static = self._static[sig] = torch.empty(
                x.shape, dtype=x.dtype, device=x.device)
        static.copy_(x)
        return static

    @torch.no_grad()
    def __call__(self, module, x: torch.Tensor):
        if not x.is_cuda:
            return self.fn(module, x)
        static = self.inputs(x)
        out = self.graphs(static, self.graph_key(module, static),
                          lambda: self.fn(module, static))
        return _copy_out(out)
