"""Autoregressive decoding on one per-slot session: the serving loop and the
actor-side inference path for LLM-policy IMPALA.

There is one decode loop. ``_session_prefill`` and ``_session_step`` work
on a *session state* with one row per slot:

    {"cache":  decode cache, leaves (G, B, ...), written in place
     "pos":    (B,) int32  position of the next token to decode
     "last":   (B,) int64  last sampled token (fed on the next step)
     "gens":   B torch.Generators on the session's device, one per slot
     "temp":   (B,) float32  per-slot sampling temperature
     "active": (B,) numpy bool  slots currently decoding (host side)}

``generate`` (fixed batch: every slot admitted together, no eviction) and
``DecodeSession`` (continuous batching: admission and eviction between
steps through ``prefill_into`` / ``step`` / ``evict``) both drive these
two functions.

Sampling is Gumbel-max with each slot's own generator: the reference's
per-slot threefry keys have no PyTorch counterpart, so a request carries an
integer ``seed`` that seeds its slot's generator at admission. Inactive
slots still compute (lockstep batch) but their pos/last are frozen and
their generators draw nothing, and admission rewrites the whole cache row,
so a slot's token stream is determined by its own (prompt, seed,
temperature): a single-request server is bitwise-identical to
``generate`` with the same seed.

Under a model axis (``mesh=``, ``rules=``: a ``Mesh2D`` and its rules
table, the params this rank's slices) each call runs the model under
``common.use_rules``; the logits reach ``_sample`` whole (gathered over the
model group where the vocabulary is split), and model rank 0's tokens,
log-probs and entropies are broadcast to the other ranks of its group, so
the ranks of a data index stay in lockstep whatever their arithmetic.

Both drive them through ``session_fns(cfg, mesh, rules)``, the
reference's compiled session functions, cached by the config's value. On
CUDA tensors with no mesh its ``step`` runs the model's decode step
(``model.serve_step``) as a CUDA graph of the state's static buffers: the
cache leaves, ``pos`` and ``last`` (written in place, never rebound) and
the params' storages; its ``admit`` runs the model's part of an admission
(``_session_admit``: the prefill, the last token's heads and the scatter
of the rows into the state's cache and pos) as a CUDA graph per (those
buffers, rows, prefill bucket, and a VLM's vision shape), its prompts,
lengths, slots and vision embeddings static inputs. Sampling and the
pos/last update stay outside the graphs, on the per-slot generators. On
CPU tensors, and under a mesh (gloo's collectives cannot be captured),
they are the eager ``_session_step`` and ``_session_admit``, the plain
versions.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.weak import WeakTensorKeyDictionary

from repro_torch.core.batcher import bucket_size
from repro_torch.core.compiled import Graphs
from repro_torch.models import model as model_lib
from repro_torch.models.common import model_mesh, tree_map, use_rules
from repro_torch.tree import leaves


def logprob_entropy(logits, tokens):
    """log p(token) and the entropy of softmax(logits), per row. logits
    (B, V) float32 (already divided by the temperature), tokens (B,)."""
    lp = torch.log_softmax(logits, dim=-1)
    chosen = lp.gather(1, tokens[:, None].long())[:, 0]
    ent = -torch.sum(torch.exp(lp) * lp, dim=-1)
    return chosen, ent


def _sample(logits, temp, gens, active):
    """One token per row. logits (B, V) float32; each active row draws its
    Gumbel noise from its own generator, inactive rows draw nothing (their
    token is garbage: the argmax)."""
    scaled = logits / temp[:, None]
    noise = torch.zeros_like(scaled)
    for row in np.flatnonzero(active):
        u = torch.rand(scaled.shape[1], generator=gens[row],
                       device=scaled.device)
        noise[row] = -torch.log(-torch.log(u))
    tok = torch.argmax(scaled + noise, dim=-1)
    lp, ent = logprob_entropy(scaled, tok)
    return tok, lp, ent


def _from_model_root(*tensors):
    """Model rank 0's values of ``tensors`` on every rank of its model
    group (a no-op without a model axis)."""
    mesh = model_mesh()
    if mesh is None:
        return tensors
    for t in tensors:
        dist.broadcast(t, src=mesh.model_root, group=mesh.model_group)
    return tensors


def _out(tok, lp, ent, baseline):
    return {"token": tok, "logprob": lp, "entropy": ent,
            "baseline": (baseline[:, 0] if baseline is not None
                         else torch.zeros_like(lp))}


def _prefill_heads(params, prompt, *, cfg, cache_seq_len, last_index=None,
                   vision=None):
    """The model part of a prefill: the model's prefill of every row, the
    hidden state of each row's true last token (``last_index``, as in
    ``_session_prefill``) and the heads on it. Returns (cache, li,
    logits0 (B, 1, V) float32, baseline (B, 1) or None), li the (B,)
    int64 last indices."""
    b, p = prompt.shape
    hidden, _, cache = model_lib.prefill(params, prompt, cfg=cfg,
                                         vision=vision,
                                         cache_seq_len=cache_seq_len)
    if last_index is None:
        li = torch.full((b,), p - 1, dtype=torch.int64, device=prompt.device)
    else:
        li = torch.as_tensor(last_index, dtype=torch.int64,
                             device=prompt.device).expand(b)
    h_last = hidden[torch.arange(b, device=prompt.device), li][:, None]
    return (cache, li, model_lib.logits_from_hidden(params, cfg, h_last),
            model_lib.baseline_from_hidden(params, cfg, h_last))


@torch.no_grad()
def _session_prefill(params, prompt, gens, temp, *, cfg, cache_seq_len,
                     last_index=None, vision=None):
    """Prefill every row and sample its first token.

    prompt (B, P) int (may be right-padded; ``last_index`` = index of the
    true last token: an int shared by every row or a (B,) tensor of
    per-row lengths-1, default P-1); vision (B, Sv, d) for a VLM, whose
    ``xattn`` caches it fills. Returns (state, out) where ``out`` holds
    the FIRST sampled token per row, aligned with ``_session_step``'s.
    """
    b = prompt.shape[0]
    cache, li, logits0, base0 = _prefill_heads(
        params, prompt, cfg=cfg, cache_seq_len=cache_seq_len,
        last_index=last_index, vision=vision)
    active = np.ones(b, bool)
    tok, lp, ent = _from_model_root(*_sample(logits0[:, 0], temp, gens,
                                             active))
    # ``last`` is updated in place by every step: its own copy of tok
    state = {"cache": cache, "pos": (li + 1).to(torch.int32),
             "last": tok.clone(), "gens": list(gens), "temp": temp,
             "active": active}
    return state, _out(tok, lp, ent, base0)


def _admit_views(inputs, n: int, pb: int):
    """An admission's int64 inputs, laid out in one buffer: the N padded
    prompts (N, pb), their lengths (N,) and their slots (N,)."""
    return (inputs[:n * pb].view(n, pb), inputs[n * pb:n * pb + n],
            inputs[n * pb + n:])


@torch.no_grad()
def _session_admit(params, state, inputs, n: int, pb: int, *, cfg,
                   cache_seq_len, vision=None):
    """The model part of admitting N prompts into ``state``'s rows (the
    reference's ``admit_many`` without its sampling): the prefill of the
    padded prompts (``inputs``, see ``_admit_views``; ``vision`` (N, Sv,
    d) a VLM's patch embeddings), then each row's whole cache row and pos
    written at its slot, in place. Returns (logits0 (N, 1, V) float32,
    baseline (N, 1) or None) of each row's true last token."""
    prompt, lengths, idx = _admit_views(inputs, n, pb)
    cache, li, logits0, base0 = _prefill_heads(
        params, prompt, cfg=cfg, cache_seq_len=cache_seq_len,
        last_index=lengths - 1, vision=vision)

    def overwrite(full, row):
        full[:, idx] = row.to(full.dtype)

    # every leaf of every subtree: attention k/v, Mamba2 conv/ssm, the
    # shared block's k/v, a VLM's xattn k/v of the vision positions
    tree_map(overwrite, state["cache"], cache)
    state["pos"][idx] = (li + 1).to(torch.int32)
    return logits0, base0


@torch.no_grad()
def _session_decode(params, state, *, cfg):
    """The model's decode step on every slot's last token at its position,
    the cache written in place: (logits (B,1,V) float32, baseline)."""
    logits, baseline, _ = model_lib.serve_step(
        params, state["last"][:, None], state["cache"], state["pos"],
        cfg=cfg)
    return logits, baseline


def _session_advance(state, logits, baseline):
    """Sample each slot's token from ``logits`` and move the active slots'
    pos and last, in place. Inactive rows' pos/last are frozen and their
    generators draw nothing. Returns (state, out)."""
    pos, last, active = state["pos"], state["last"], state["active"]
    tok, lp, ent = _from_model_root(*_sample(logits[:, 0], state["temp"],
                                             state["gens"], active))
    live = torch.as_tensor(active, device=pos.device)
    pos.copy_(torch.where(live, pos + 1, pos))
    last.copy_(torch.where(live, tok, last))
    return state, _out(tok, lp, ent, baseline)


@torch.no_grad()
def _session_step(params, state, *, cfg):
    """Advance every slot one token, eagerly: the plain version of the
    compiled step. Inactive rows still run (lockstep batch); their cache
    writes land in their own row only, which admission overwrites."""
    return _session_advance(state, *_session_decode(params, state, cfg=cfg))


def prefill_len(cfg, p: int, max_len: int) -> int:
    """Admission prefill length: bucket-laddered (few distinct shapes)
    where right-padding is provably inert, exact otherwise.

    Right-padding is safe only when every padded cache slot is overwritten
    before it becomes attendable: true for full causal attention (decode
    writes slot ``pos`` before attending) and for ring buffers while the
    bucket stays within the window cap. Recurrent mixers carry a state
    polluted by any suffix -> exact length.
    """
    if p >= max_len:
        return max_len
    if cfg.is_recurrent:
        return p
    pb = bucket_size(p)
    windowed = any(m in ("local_attn", "swa_attn")
                   for m, _ in cfg.block_pattern)
    if windowed and pb > cfg.sliding_window:
        return p
    return min(pb, max_len)


def _host(out):
    return {k: v.cpu().numpy() for k, v in out.items()}


# ---------------------------------------------------------------------------
# compiled session functions: one set per (cfg, mesh, rules)
# ---------------------------------------------------------------------------

_FNS_CACHE: Dict[tuple, "_SessionFns"] = {}


def _freeze_rules(rules):
    return tuple(sorted(rules.items())) if isinstance(rules, dict) else rules


class _SessionFns:
    """The session functions for one (cfg, mesh, rules), the counterpart
    of the reference's jitted ``prefill``, ``step`` and ``admit_many``
    (``step`` and ``admit`` updating the state in place, as the
    reference's donate it).

    Without a mesh (``compiled``) and on CUDA tensors, the model's parts
    of ``step`` and ``admit`` run as CUDA graphs (``core/compiled.py``):
    the decode step one per state's static buffers and params' storages
    (``graph_key``; ``steps``, which keeps one graph a state), an
    admission one per (those, N rows, prefill bucket) (``admissions``,
    all of one session functions' sharing one memory pool). The first
    call for a key runs eagerly on a side stream, the second captures,
    every later one replays. The same params module updated in place is
    read by the next replay; another module, or rebound storages, is
    another key. ``captures`` counts the decode step's captures,
    ``admissions.captures`` the admissions'. The sampling, on the
    per-slot generators, stays outside the graphs. A capture or replay
    failure raises: nothing falls back to eager on a CUDA tensor.

    ``buffers`` hands out zeroed static state buffers per (params module,
    batch, cache length), and ``release`` takes them back with their
    graphs, so that sessions one after another, and every ``generate``
    call of one shape, replay the same graphs; ``allocations`` counts the
    sets made.
    """

    def __init__(self, cfg, mesh, rules):
        self.cfg, self.mesh, self.rules = cfg, mesh, rules
        self.compiled = mesh is None
        self.allocations = 0                          # sets of buffers
        self.steps = Graphs(limit=1)                  # state's pos -> step
        self.admissions = Graphs()                    # state's pos -> admits
        self._admit_inputs = WeakTensorKeyDictionary()  # pos -> {sig: buf}
        self._free = weakref.WeakKeyDictionary()      # params -> {shape: []}
        self._lock = threading.Lock()

    @property
    def captures(self) -> int:
        return self.steps.captures

    def prefill(self, params, prompt, gens, temp, *, cache_seq_len,
                last_index=None, vision=None):
        """``_session_prefill`` under the session's mesh and rules."""
        with use_rules(self.mesh, self.rules):
            return _session_prefill(params, prompt, gens, temp, cfg=self.cfg,
                                    cache_seq_len=cache_seq_len,
                                    last_index=last_index, vision=vision)

    def _graphed(self, state) -> bool:
        return self.compiled and state["pos"].is_cuda

    @torch.no_grad()
    def admit(self, params, state, slots, padded, lengths, seeds, temps, *,
              cache_seq_len, vision=None):
        """Admit N requests into ``state``'s rows ``slots`` (the
        reference's ``admit_many``): ``padded`` (N, pb) int prompts of one
        prefill bucket, right-padded; ``lengths`` (N,) their true lengths;
        each slot's generator seeded with its ``seeds`` entry, its
        temperature ``temps``'s. The whole cache row, pos, last, generator
        and temperature of each slot are written, so nothing of the
        previous tenant survives; ``cache_seq_len``: the state's cache
        length; ``vision`` (N, Sv, d): a VLM's patch embeddings (the
        prefill of the reference's ``_generate_vision``), copied into a
        static buffer of their shape when graphed. Returns the first
        sampled token's {token, logprob, entropy, baseline} per row, on
        the device."""
        n, pb = padded.shape
        dev = state["pos"].device
        flat = torch.from_numpy(np.concatenate(
            [np.asarray(padded).reshape(-1), np.asarray(lengths),
             np.asarray(slots)]).astype(np.int64))
        if self._graphed(state):
            inputs = self._admit_buffer(state["pos"], flat)
            key = (self.graph_key(params, state), n, pb, inputs.data_ptr(),
                   cache_seq_len)
            if vision is not None:
                vision = self._admit_buffer(state["pos"], vision)
                key += (vision.data_ptr(), tuple(vision.shape))
            logits0, base0 = self.admissions(
                state["pos"], key, lambda: _session_admit(
                    params, state, inputs, n, pb, cfg=self.cfg,
                    cache_seq_len=cache_seq_len, vision=vision))
            base0 = None if base0 is None else base0.clone()
        else:
            inputs = flat.to(dev)
            with use_rules(self.mesh, self.rules):
                logits0, base0 = _session_admit(
                    params, state, inputs, n, pb, cfg=self.cfg,
                    cache_seq_len=cache_seq_len, vision=vision)
        idx = _admit_views(inputs, n, pb)[2]
        gens = [state["gens"][s].manual_seed(int(seed))
                for s, seed in zip(slots, seeds)]
        temp = torch.tensor(np.asarray(temps, np.float32), device=dev)
        with use_rules(self.mesh, self.rules):
            tok, lp, ent = _from_model_root(*_sample(
                logits0[:, 0], temp, gens, np.ones(n, bool)))
        state["last"][idx] = tok
        state["temp"][idx] = temp
        state["active"][list(slots)] = True
        return _out(tok, lp, ent, base0)

    def _admit_buffer(self, anchor, x: torch.Tensor) -> torch.Tensor:
        """The static buffer of ``x``'s shape and dtype for admissions
        into the state of ``anchor`` (its pos), holding ``x``: an
        admission's int64 inputs of N rows of one bucket, or a VLM's
        vision embeddings."""
        held = self._admit_inputs.get(anchor)
        if held is None:
            held = self._admit_inputs[anchor] = {}
        sig = (tuple(x.shape), x.dtype)
        buf = held.get(sig)
        if buf is None:
            buf = held[sig] = torch.empty(x.shape, dtype=x.dtype,
                                          device=anchor.device)
        buf.copy_(x)
        return buf

    @torch.no_grad()
    def step(self, params, state):
        """Advance every slot one token (``_session_step``), the decode
        step compiled where ``compiled`` and the state lies on CUDA.
        Returns (state, out); state is the same dict, updated in place."""
        logits, baseline = self.decode(params, state)
        with use_rules(self.mesh, self.rules):
            return _session_advance(state, logits, baseline)

    @torch.no_grad()
    def decode(self, params, state):
        """``_session_decode``: (logits, baseline), the cache written in
        place. From a graph replay the logits lie in graph memory that the
        next replay overwrites; the baseline is a copy."""
        if not self._graphed(state):
            with use_rules(self.mesh, self.rules):
                return _session_decode(params, state, cfg=self.cfg)
        logits, baseline = self.steps(
            state["pos"], self.graph_key(params, state),
            lambda: _session_decode(params, state, cfg=self.cfg))
        return logits, None if baseline is None else baseline.clone()

    def graph_key(self, params, state):
        """What a captured step or admission reads and writes by address:
        the state's cache leaves (with their shapes), pos and last, and
        the params' storages."""
        return (tuple((x.data_ptr(), tuple(x.shape))
                      for x in leaves(state["cache"])),
                state["pos"].data_ptr(), state["last"].data_ptr(),
                tuple(p.data_ptr() for p in params.parameters()))

    def buffers(self, params, batch: int, cache_len: int):
        """Zeroed static state buffers {"cache", "pos", "last"} for
        ``batch`` slots of ``cache_len`` tokens on the params' device: a
        released set of this params module's (its graph with it) if one
        is free, else new ones."""
        device = next(params.parameters()).device
        shape = (batch, cache_len, device)
        with self._lock:
            free = self._free.setdefault(params, {}).get(shape)
            bufs = free.pop() if free else None
        if bufs is None:
            self.allocations += 1
            return {"cache": model_lib.cache_init(self.cfg, batch, cache_len,
                                                  device=device),
                    "pos": torch.zeros((batch,), dtype=torch.int32,
                                       device=device),
                    "last": torch.zeros((batch,), dtype=torch.int64,
                                        device=device)}
        for x in leaves(bufs):
            x.zero_()
        return bufs

    def release(self, params_ref, batch: int, cache_len: int, bufs) -> None:
        """Take back ``bufs``, which ``buffers`` handed out for ``batch``
        slots of ``cache_len`` tokens; ``params_ref``: a weak reference to
        the params module they were handed out for (dropped with it)."""
        params = params_ref()
        if params is None:
            return
        shape = (batch, cache_len, bufs["pos"].device)
        with self._lock:
            self._free.setdefault(params, {}).setdefault(shape, []).append(
                bufs)


def session_fns(cfg, mesh=None, rules=None) -> _SessionFns:
    """The session functions of ``cfg`` under ``mesh`` and ``rules``,
    cached by value: two equal configs, built apart, share one object (and
    its graphs), as the reference's compile cache keys them."""
    key = (cfg, mesh, _freeze_rules(rules))
    if key not in _FNS_CACHE:
        _FNS_CACHE[key] = _SessionFns(cfg, mesh, rules)
    return _FNS_CACHE[key]


# ---------------------------------------------------------------------------
# DecodeSession: slot-indexed continuous-batching decode state
# ---------------------------------------------------------------------------

class DecodeSession:
    """Slot-indexed decode state with admission and eviction between steps.

    Owns a ``max_batch``-row decode cache (capacity ``max_len`` tokens per
    slot) on the device of ``params``, plus per-slot position, token,
    generator and temperature. The serving loop (``launch.serve.Server``)
    drives it:

      prefill_into(slot, prompt, seed=...) -> first-token dict for the slot
      prefill_many(slots, prompts, ...)   -> batched admit: one prefill
                                             per shared prefill bucket
      step()                              -> per-slot dict for one token
      evict(slot)                         -> frees the slot

    Its functions are ``session_fns(cfg, mesh, rules)``'s. Without a
    mesh its cache, pos and last are static buffers from
    ``_SessionFns.buffers``, given back when the session is collected,
    and on CUDA ``step`` and each admission replay their CUDA graphs
    (``compiled``); under a mesh they are its own and both are eager.
    """

    def __init__(self, params, cfg, *, max_batch: int, max_len: int,
                 mesh=None, rules=None):
        # as the reference: a VLM rolls out through generate(vision=) only
        if cfg.vision_seq:
            raise ValueError("DecodeSession serves text-only configs")
        self.cfg = cfg
        self._fns = session_fns(cfg, mesh, rules)
        self.max_batch = max_batch
        self.max_len = max_len
        self._params = params
        self.device = next(params.parameters()).device
        dev = self.device
        if self._fns.compiled:
            bufs = self._fns.buffers(params, max_batch, max_len)
            weakref.finalize(self, self._fns.release, weakref.ref(params),
                             max_batch, max_len, bufs)
        else:
            with use_rules(mesh, rules):
                bufs = {"cache": model_lib.cache_init(cfg, max_batch,
                                                      max_len, device=dev),
                        "pos": torch.zeros((max_batch,), dtype=torch.int32,
                                           device=dev),
                        "last": torch.zeros((max_batch,), dtype=torch.int64,
                                            device=dev)}
        self._state = dict(
            bufs,
            gens=[torch.Generator(device=dev) for _ in range(max_batch)],
            temp=torch.ones((max_batch,), dtype=torch.float32, device=dev),
            active=np.zeros(max_batch, bool))

    @property
    def compiled(self) -> bool:
        """Whether ``step`` and the admissions replay CUDA graphs (CUDA, no
        mesh); a session under a mesh runs them eagerly by rule."""
        return self._fns.compiled and self.device.type == "cuda"

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, params) -> None:
        """Swap the served params (e.g. the RL actor following the learner).
        Safe between calls: every call reads the params afresh (another
        module, or rebound storages, is another graph key)."""
        self._params = params

    # -- slot bookkeeping ---------------------------------------------------

    @property
    def active(self) -> np.ndarray:
        return self._state["active"].copy()

    # -- session API --------------------------------------------------------

    def _check_prompt(self, prompt) -> np.ndarray:
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if not 0 < prompt.shape[0] < self.max_len:
            raise ValueError(f"prompt length {prompt.shape[0]} not in "
                             f"[1, {self.max_len})")
        return prompt

    def _admit(self, slots, prompts, seeds, temps):
        """Prefill ``prompts`` (all of one prefill bucket) and write each
        into its slot's row (``_SessionFns.admit``)."""
        pb = prefill_len(self.cfg, prompts[0].shape[0], self.max_len)
        padded = np.zeros((len(slots), pb), np.int64)
        for row, p in enumerate(prompts):
            padded[row, :p.shape[0]] = p
        lengths = np.array([p.shape[0] for p in prompts], np.int64)
        return _host(self._fns.admit(self._params, self._state, slots,
                                     padded, lengths, seeds, temps,
                                     cache_seq_len=self.max_len))

    def prefill_into(self, slot: int, prompt, *, seed: int,
                     temperature: float = 1.0) -> Dict[str, np.ndarray]:
        """Admit a request into ``slot``. prompt: (P,) int, P <= max_len-1.
        Returns the first sampled token's {token, logprob, entropy,
        baseline} (host scalars)."""
        if self._state["active"][slot]:
            raise ValueError(f"slot {slot} is occupied (evict first)")
        prompt = self._check_prompt(prompt)
        out = self._admit([int(slot)], [prompt], [seed], [temperature])
        return {k: v[0] for k, v in out.items()}

    def prefill_many(self, slots, prompts, *, seeds,
                     temperature=1.0) -> list:
        """Admit N requests batched: one prefill per shared prefill bucket
        (one in all when every prompt pads to the same bucket) instead of
        one per slot.

        slots: N slot indices (unique, all free). prompts: N 1-D int prompt
        arrays (ragged ok). seeds: N ints. temperature: scalar or N floats.
        Returns a list of N per-slot first-token dicts, in ``slots`` order —
        each what ``prefill_into`` returns for that (prompt, seed,
        temperature), up to the float rounding of a larger batch.
        """
        slots = [int(s) for s in slots]
        n = len(slots)
        if len(set(slots)) != n:
            raise ValueError(f"duplicate slots in batched admit: {slots}")
        occupied = [s for s in slots if self._state["active"][s]]
        if occupied:
            raise ValueError(f"slots {occupied} are occupied (evict first)")
        if len(prompts) != n or len(seeds) != n:
            raise ValueError(f"{n} slots but {len(prompts)} prompts and "
                             f"{len(seeds)} seeds")
        prompts = [self._check_prompt(p) for p in prompts]
        temps = np.broadcast_to(np.asarray(temperature, np.float32), (n,))

        groups: Dict[int, list] = {}
        for i, p in enumerate(prompts):
            groups.setdefault(prefill_len(self.cfg, p.shape[0],
                                          self.max_len), []).append(i)
        results: list = [None] * n
        for idxs in groups.values():
            out = self._admit([slots[i] for i in idxs],
                              [prompts[i] for i in idxs],
                              [seeds[i] for i in idxs],
                              [float(temps[i]) for i in idxs])
            for row, i in enumerate(idxs):
                results[i] = {k: v[row] for k, v in out.items()}
        return results

    def step(self) -> Dict[str, np.ndarray]:
        """Advance every active slot one token. Returns per-slot arrays
        (B,); entries for inactive slots are garbage — gate on .active."""
        self._state, out = self._fns.step(self._params, self._state)
        return _host(out)

    def evict(self, slot: int) -> None:
        self._state["active"][slot] = False


# ---------------------------------------------------------------------------
# fixed-batch rollouts (IMPALA actors, tests)
# ---------------------------------------------------------------------------

def generate(params, prompt, seed: int, *, cfg, num_steps: int,
             temperature: float = 1.0, vision=None, mesh=None, rules=None):
    """prompt: (B, P) int. Samples ``num_steps`` tokens for every row
    through the same session functions the continuous server runs
    (``session_fns``); row i samples from a generator seeded with ``seed +
    i``, so a single-request server given ``seed`` is bitwise-identical to
    row 0. ``vision`` (B, Sv, d): a VLM's patch embeddings, which feed the
    prefill (and through the ``xattn`` caches every step), as the
    reference's ``_generate_vision``. Without a mesh the rows are
    admitted into static buffers per (cfg, B, P + num_steps, params) as a
    session admits them (a VLM's vision embeddings too, into a static
    buffer of their shape), so that on CUDA every call of one shape
    replays one admission graph and one decode step graph: the
    reference's ``_generate_vision``, prefill included, jitted whole.
    Returns a dict of tensors on the params' device:
      tokens    (B, P + num_steps)
      logprob   (B, num_steps)  behavior log-prob of each sampled token
      entropy   (B, num_steps)  policy entropy at each step
      baseline  (B, num_steps)  value estimates V(s_t)
    """
    dev = next(params.parameters()).device
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64,
                             device=dev)
    b, p = prompt.shape
    gens = [torch.Generator(device=dev).manual_seed(seed + i)
            for i in range(b)]
    temp = torch.full((b,), temperature, dtype=torch.float32, device=dev)
    if vision is not None:
        vision = torch.as_tensor(vision, device=dev)
    fns = session_fns(cfg, mesh, rules)
    cache_len = p + num_steps
    bufs = fns.buffers(params, b, cache_len) if fns.compiled else None
    try:
        if bufs is None:
            state, out0 = fns.prefill(params, prompt, gens, temp,
                                      cache_seq_len=cache_len, vision=vision)
        else:
            # admitted into the static buffers as a session admits
            state = dict(bufs, gens=gens, temp=temp,
                         active=np.zeros(b, bool))
            out0 = fns.admit(params, state, list(range(b)),
                             prompt.cpu().numpy(), np.full(b, p),
                             [seed + i for i in range(b)], [temperature] * b,
                             cache_seq_len=cache_len, vision=vision)
        outs = [out0]
        for _ in range(num_steps - 1):
            state, out = fns.step(params, state)
            outs.append(out)
    finally:
        if bufs is not None:
            fns.release(weakref.ref(params), b, cache_len, bufs)
    stacked = {k: torch.stack([o[k] for o in outs], dim=1) for k in outs[0]}
    return {"tokens": torch.cat([prompt, stacked["token"]], dim=1),
            "logprob": stacked["logprob"], "entropy": stacked["entropy"],
            "baseline": stacked["baseline"]}

