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
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.batcher import bucket_size
from repro_torch.models import model as model_lib
from repro_torch.models.common import model_mesh, tree_map, use_rules


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
    logits0 = model_lib.logits_from_hidden(params, cfg, h_last)
    base0 = model_lib.baseline_from_hidden(params, cfg, h_last)
    active = np.ones(b, bool)
    tok, lp, ent = _from_model_root(*_sample(logits0[:, 0], temp, gens,
                                             active))
    state = {"cache": cache, "pos": (li + 1).to(torch.int32), "last": tok,
             "gens": list(gens), "temp": temp, "active": active}
    return state, _out(tok, lp, ent, base0)


@torch.no_grad()
def _session_step(params, state, *, cfg):
    """Advance every slot one token. Inactive rows still run (lockstep
    batch) but their pos/last are frozen and their generators draw nothing;
    their cache writes land in their own row only, which admission
    overwrites."""
    pos, last, active = state["pos"], state["last"], state["active"]
    logits, baseline, cache = model_lib.serve_step(
        params, last[:, None], state["cache"], pos, cfg=cfg)
    tok, lp, ent = _from_model_root(*_sample(logits[:, 0], state["temp"],
                                             state["gens"], active))
    live = torch.as_tensor(active, device=pos.device)
    new_state = dict(state, cache=cache,
                     pos=torch.where(live, pos + 1, pos),
                     last=torch.where(live, tok, last))
    return new_state, _out(tok, lp, ent, baseline)


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
    """

    def __init__(self, params, cfg, *, max_batch: int, max_len: int,
                 mesh=None, rules=None):
        # as the reference: a VLM rolls out through generate(vision=) only
        if cfg.vision_seq:
            raise ValueError("DecodeSession serves text-only configs")
        self.cfg = cfg
        self._rules = (mesh, rules)
        self.max_batch = max_batch
        self.max_len = max_len
        self._params = params
        self.device = next(params.parameters()).device
        dev = self.device
        with use_rules(mesh, rules):
            cache = model_lib.cache_init(cfg, max_batch, max_len, device=dev)
        self._state = {
            "cache": cache,
            "pos": torch.zeros((max_batch,), dtype=torch.int32, device=dev),
            "last": torch.zeros((max_batch,), dtype=torch.int64, device=dev),
            "gens": [torch.Generator(device=dev) for _ in range(max_batch)],
            "temp": torch.ones((max_batch,), dtype=torch.float32,
                               device=dev),
            "active": np.zeros(max_batch, bool),
        }

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, params) -> None:
        """Swap the served params (e.g. the RL actor following the learner).
        Safe between calls: every call reads the params afresh."""
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
        into its slot's row: the whole cache row, pos, last, generator and
        temperature, so nothing of the previous tenant survives."""
        state, dev = self._state, self.device
        pb = prefill_len(self.cfg, prompts[0].shape[0], self.max_len)
        padded = np.zeros((len(slots), pb), np.int64)
        for row, p in enumerate(prompts):
            padded[row, :p.shape[0]] = p
        lengths = torch.tensor([p.shape[0] for p in prompts], device=dev)
        gens = [state["gens"][s].manual_seed(int(seed))
                for s, seed in zip(slots, seeds)]
        temp = torch.tensor(temps, dtype=torch.float32, device=dev)
        with use_rules(*self._rules):
            rows, out = _session_prefill(
                self._params, torch.as_tensor(padded, device=dev), gens,
                temp, cfg=self.cfg, cache_seq_len=self.max_len,
                last_index=lengths - 1)
        idx = torch.tensor(slots, device=dev)

        def overwrite(full, row):
            full[:, idx] = row.to(full.dtype)

        # every leaf of every subtree: attention k/v, Mamba2 conv/ssm, the
        # shared block's k/v
        tree_map(overwrite, state["cache"], rows["cache"])
        state["pos"][idx] = rows["pos"]
        state["last"][idx] = rows["last"]
        state["temp"][idx] = temp
        state["active"][slots] = True
        return _host(out)

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
        with use_rules(*self._rules):
            self._state, out = _session_step(self._params, self._state,
                                             cfg=self.cfg)
        return _host(out)

    def evict(self, slot: int) -> None:
        self._state["active"][slot] = False


# ---------------------------------------------------------------------------
# fixed-batch rollouts (IMPALA actors, tests)
# ---------------------------------------------------------------------------

def generate(params, prompt, seed: int, *, cfg, num_steps: int,
             temperature: float = 1.0, vision=None, mesh=None, rules=None):
    """prompt: (B, P) int. Samples ``num_steps`` tokens for every row
    through the same session functions the continuous server runs; row i
    samples from a generator seeded with ``seed + i``, so a single-request
    server given ``seed`` is bitwise-identical to row 0. ``vision`` (B, Sv,
    d): a VLM's patch embeddings, which feed the prefill (and through the
    ``xattn`` caches every step), as the reference's ``_generate_vision``.
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
    with use_rules(mesh, rules):
        state, out0 = _session_prefill(params, prompt, gens, temp, cfg=cfg,
                                       cache_seq_len=p + num_steps,
                                       vision=vision)
        outs = [out0]
        for _ in range(num_steps - 1):
            state, out = _session_step(params, state, cfg=cfg)
            outs.append(out)
    stacked = {k: torch.stack([o[k] for o in outs], dim=1) for k in outs[0]}
    return {"tokens": torch.cat([prompt, stacked["token"]], dim=1),
            "logprob": stacked["logprob"], "entropy": stacked["entropy"],
            "baseline": stacked["baseline"]}
