"""Trace audit: the port's compiled and in-place entries against the
contracts of the reference's ``analysis/trace_audit.py``, on the CPU.

The reference abstract-evaluates its ``jax.jit`` entries and checks three
contracts that misbehave only at scale. The port compiles its entries
into CUDA graphs (``core/compiled.py``: the decode step and the
admissions of ``core/generate.py::session_fns``, the rl-agent learner
steps and the device actors' unroll), and updates in place the state the
reference donates. Its counterparts:

  * **retrace -> recapture hazard** (``retrace-hazard``): every arch's
    ``ModelConfig`` is a value-keyed cache key (two fresh constructions
    equal and hash-equal, ``audit_static_key``); ``session_fns`` gives one
    object for two fresh, equal configs; and a compiled entry has one
    graph key per shape: two sessions one after another, and two
    ``generate`` calls, with fresh, equal configs, step on the same
    static buffers, so the card captures once (``audit_recapture``). A
    config keyed by identity would capture anew per construction. The
    rl-agent and LM learner steps keep one graph key over steps whose
    rate changes (the rate is a device scalar), the host actors' policy
    one per padded bucket across weight syncs, and a session's
    admissions one per (rows, prefill bucket) (``audit_compiled_keys``).
  * **donation -> in place** (``donation-rebound``): for each registered
    entry (``registered_entries``: the session step at ``max_batch`` 8,
    the rl-agent learner steps on Catch, the LM steps at reduced
    Qwen3-4B, the device actors' unroll carry on Catch), every leaf of
    the state the reference donates keeps its
    tensor and its storage across a call. A rebound leaf leaves the
    caller a second model-sized tree and, in a captured step, a graph
    that writes the stale storage.
  * **sharding axes live** (``sharding-unknown-axis``): every partition
    spec ``distributed/sharding.py::spec_for`` gives (parameter, ZeRO-1
    and batch specs) under every LM rules table, for every arch and
    audit mesh, names only the mesh's axes (the reference intercepts
    ``with_sharding_constraint`` for the same check).

Everything runs at reduced width on the CPU; the card's side (one
capture per key, the kernels' launches per replay) is ``chip_smoke.py``
phases 29 to 31.
"""

from __future__ import annotations

import dataclasses
import gc
import inspect
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.common import Finding
from repro_torch.tree import flatten

T, B, S = 8, 4, 32      # unroll length / batch / LM sequence (reduced)
SERVE_BATCH, SERVE_LEN = 8, 32
# the audit meshes: (data, model)
AUDIT_MESHES = ((1, 2), (2, 1), (2, 2), (1, 4))


@dataclasses.dataclass
class InPlaceEntry:
    """One entry whose state the reference donates. ``make()`` returns
    (donated, call): the tree of tensors the call must update in place,
    and ``call()``, which makes one call and returns that tree as the
    caller holds it afterwards."""
    name: str
    make: Callable[[], Tuple[Any, Callable[[], Any]]]
    file: str = ""
    line: int = 0


@dataclasses.dataclass
class AbstractMesh:
    """A ("data", "model") mesh by its sizes alone: what ``spec_for``
    reads."""
    data: int
    model: int
    axis_names: Tuple[str, ...] = ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}


def _loc(fn) -> Tuple[str, int]:
    raw = inspect.unwrap(fn)
    return inspect.getsourcefile(raw) or "", raw.__code__.co_firstlineno


def audit_static_key(make_obj: Callable, name: str,
                     file: str = "", line: int = 0) -> List[Finding]:
    """Two fresh constructions must be equal AND hash-equal: a cache key
    with ``__eq__`` but an identity ``__hash__`` misses the cache once
    per construction (a recapture a session)."""
    a, b = make_obj(), make_obj()
    try:
        ha, hb = hash(a), hash(b)
    except TypeError:
        return [Finding(rule="retrace-hazard", file=file, line=line,
                        message=f"{name}: unhashable, so it cannot key "
                                "the compiled-session cache")]
    if a == b and ha != hb:
        return [Finding(rule="retrace-hazard", file=file, line=line,
                        message=f"{name}: __eq__/__hash__ mismatch: two "
                                "equal instances hash differently, so "
                                "every fresh construction recaptures")]
    return []


def audit_recapture(arch: str = "qwen3-4b") -> Tuple[List[Finding], Dict]:
    """The compiled session's cache by value: fresh, equal configs share
    one ``session_fns`` object, two ``generate`` calls take one set of
    static buffers, and two sessions one after another step on one graph
    key."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.core import generate as gen_lib
    from repro_torch.models import model as model_lib

    findings: List[Finding] = []
    file, line = _loc(gen_lib.session_fns)

    def flag(message):
        findings.append(Finding(rule="retrace-hazard", file=file,
                                line=line, message=message))

    fns = gen_lib.session_fns(get_reduced_config(arch))
    if fns is not gen_lib.session_fns(get_reduced_config(arch)):
        flag(f"session_fns[{arch}]: two freshly built equal configs "
             "resolve to different session functions: the cache keys by "
             "identity and every actor and server recaptures")
    params = model_lib.init(get_reduced_config(arch), seed=0)
    prompt = np.arange(2 * 4).reshape(2, 4) % get_reduced_config(
        arch).vocab_size
    before = fns.allocations
    for _ in range(2):
        gen_lib.generate(params, prompt, 0, cfg=get_reduced_config(arch),
                         num_steps=3)
    generate_sets = fns.allocations - before
    if generate_sets != 1:
        flag(f"generate[{arch}]: two calls of one shape took "
             f"{generate_sets} sets of static buffers, so the card "
             f"captures {generate_sets} graphs")

    keys = []
    for _ in range(2):
        sess = gen_lib.DecodeSession(params, get_reduced_config(arch),
                                     max_batch=2, max_len=16)
        sess.prefill_into(0, prompt[0], seed=0)
        for _ in range(2):
            keys.append(fns.graph_key(params, sess._state))
            sess.step()
        del sess
        gc.collect()
    if len(set(keys)) != 1:
        flag(f"DecodeSession[{arch}]: two sessions one after another "
             f"stepped on {len(set(keys))} graph keys, not one")
    return findings, {"entry": f"session_fns[{arch}]",
                      "generate_buffer_sets": generate_sets,
                      "session_graph_keys": len(set(keys)),
                      "ok": not findings}


def audit_entry(entry: InPlaceEntry) -> Tuple[List[Finding], Dict]:
    """One call of ``entry``: every donated leaf must come back as the same
    tensor on the same storage."""
    donated, call = entry.make()
    before = [(path, x, x.data_ptr()) for path, x in flatten(donated)]
    after = flatten(call())
    rebound = [path for (path, x, ptr), (_, y) in zip(before, after)
               if y is not x or y.data_ptr() != ptr]
    if len(after) != len(before):
        rebound.append(f"<{len(before)} leaves in, {len(after)} out>")
    findings = []
    if rebound:
        findings.append(Finding(
            rule="donation-rebound", file=entry.file, line=entry.line,
            message=f"{entry.name}: {len(rebound)} of {len(before)} donated "
                    f"leaves rebound, not written in place (first: "
                    f"{rebound[0]}): the caller holds a second copy, and a "
                    "captured step would write the stale storage"))
    return findings, {"entry": entry.name, "donated_leaves": len(before),
                      "rebound": len(rebound), "ok": not findings}


def _spec_axes(spec) -> set:
    axes: set = set()
    for part in tuple(spec or ()):
        if part is None:
            continue
        axes.update(part if isinstance(part, tuple) else (part,))
    return axes


def audit_rules(axes: Dict[str, Sequence[str]],
                shapes: Dict[str, Sequence[int]], mesh, rules: Dict,
                name: str) -> Tuple[List[Finding], int]:
    """Every spec ``spec_for`` gives ``axes`` (the parameters, their
    ZeRO-1 state, a (B, S) batch) under ``rules`` on ``mesh`` names only
    the mesh's axes. Returns (findings, specs checked)."""
    from repro_torch.distributed import sharding

    file, line = _loc(sharding.spec_for)
    live = set(mesh.axis_names)
    try:
        specs = list(sharding.param_shardings(axes, mesh, rules,
                                              shapes).values())
        specs += sharding.zero1_shardings(axes, mesh, rules, shapes).values()
        specs.append(sharding.batch_axes_spec(mesh, rules, 2,
                                              (B * mesh.data, S), 0))
    except KeyError as e:
        return [Finding(rule="sharding-unknown-axis", file=file, line=line,
                        message=f"{name}: the rules name mesh axis {e} "
                                f"that is not live (axes: {sorted(live)})"
                        )], 0
    bad = sorted(set().union(*(_spec_axes(s) - live for s in specs)))
    if bad:
        return [Finding(rule="sharding-unknown-axis", file=file, line=line,
                        message=f"{name}: specs name axes {bad} that are "
                                f"not live on the mesh (axes: "
                                f"{sorted(live)})")], len(specs)
    return [], len(specs)


def audit_sharding(archs: Optional[Sequence[str]] = None,
                   meshes=AUDIT_MESHES) -> Tuple[List[Finding], List[Dict]]:
    """``audit_rules`` for every arch (reduced), LM rules table and audit
    mesh."""
    from repro_torch.configs import ARCHS, get_reduced_config
    from repro_torch.distributed import sharding
    from repro_torch.models import model as model_lib

    findings: List[Finding] = []
    summaries = []
    for arch in archs or ARCHS:
        cfg = get_reduced_config(arch)
        params = model_lib.init(cfg, seed=0)
        axes, shapes = model_lib.stacked_axes(
            params, cfg, {n: p.shape for n, p in params.named_parameters()})
        checked, known = 0, len(findings)
        for table in sharding.LM_RULES:
            for data, model in meshes:
                fnd, n = audit_rules(axes, shapes, AbstractMesh(data, model),
                                     sharding.rules_named(table),
                                     f"{arch}/{table}@({data},{model})")
                findings += fnd
                checked += n
        summaries.append({"entry": f"spec_for[{arch}]", "specs": checked,
                          "ok": len(findings) == known})
    return findings, summaries


# ---------------------------------------------------------------------------
# the registered entries
# ---------------------------------------------------------------------------

def _train_cfg():
    from repro_torch.configs.base import TrainConfig
    return TrainConfig(optimizer="adamw", learning_rate=1e-3, grad_clip=1.0,
                       lr_schedule="constant")


def _rl_entry(recurrent: bool) -> InPlaceEntry:
    from repro_torch.core import learner as learner_lib
    from repro_torch.core import rollout as rollout_lib
    from repro_torch.envs import catch
    from repro_torch.models.convnet import MinatarLSTMNet, MinatarNet
    from repro_torch.optim import make_optimizer

    factory = (learner_lib.make_recurrent_train_step if recurrent
               else learner_lib.make_train_step)

    def make():
        env = catch.make()
        gen = torch.Generator().manual_seed(0)
        net = MinatarLSTMNet if recurrent else MinatarNet
        agent = net(env.obs_shape, env.num_actions, generator=gen)
        unroll = (rollout_lib.make_recurrent_unroll(env, T) if recurrent
                  else rollout_lib.make_unroll(env, T))
        env_state, obs = env.reset(B, gen, "cpu")
        carry = (unroll.initial_carry(agent, env_state, obs) if recurrent
                 else (env_state, obs))
        _, batch = unroll(agent, carry, gen)
        opt = make_optimizer(_train_cfg())
        opt_state = opt.init(list(agent.parameters()))
        step = factory(opt, _train_cfg(), vtrace_impl="scan")
        donated = {"params": dict(agent.named_parameters()),
                   "opt_state": opt_state}

        def call():
            p, o, _ = step(agent, opt_state, 0, batch)
            return {"params": dict(p.named_parameters()), "opt_state": o}
        return donated, call

    name = ("make_recurrent_train_step" if recurrent
            else "make_train_step") + "[catch]"
    return InPlaceEntry(name, make, *_loc(factory))


def _lm_entry(pretrain: bool, arch: str = "qwen3-4b") -> InPlaceEntry:
    from repro_torch.configs import get_reduced_config
    from repro_torch.core import learner as learner_lib
    from repro_torch.models import model as model_lib
    from repro_torch.optim import make_optimizer

    factory = (learner_lib.make_lm_pretrain_step if pretrain
               else learner_lib.make_lm_train_step)

    def make():
        cfg = get_reduced_config(arch)
        params = model_lib.init(cfg, seed=0)
        opt = make_optimizer(_train_cfg())
        opt_state = opt.init(list(params.parameters()))
        gen = torch.Generator().manual_seed(1)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S + 1),
                                         generator=gen)}
        if pretrain:
            step = factory(cfg, opt, loss_chunk=S)
        else:
            step = factory(cfg, opt, _train_cfg(), loss_chunk=S,
                           vtrace_impl="scan")
            batch.update(behavior_logprob=-torch.rand((B, S), generator=gen),
                         reward=torch.rand((B, S), generator=gen),
                         done=torch.zeros((B, S), dtype=torch.bool))
        donated = {"params": dict(params.named_parameters()),
                   "opt_state": opt_state}

        def call():
            p, o, _ = step(params, opt_state, 0, batch)
            return {"params": dict(p.named_parameters()), "opt_state": o}
        return donated, call

    name = ("make_lm_pretrain_step" if pretrain
            else "make_lm_train_step") + f"[{arch}]"
    return InPlaceEntry(name, make, *_loc(factory))


def _session_entry(arch: str = "qwen3-4b") -> InPlaceEntry:
    """The serving step: a ``max_batch``-row session's state (cache, pos,
    last) through ``session_fns(cfg).step``, every slot admitted."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.core import generate as gen_lib
    from repro_torch.models import model as model_lib

    def make():
        cfg = get_reduced_config(arch)
        params = model_lib.init(cfg, seed=0)
        sess = gen_lib.DecodeSession(params, cfg, max_batch=SERVE_BATCH,
                                     max_len=SERVE_LEN)
        rng = np.random.default_rng(0)
        sess.prefill_many(range(SERVE_BATCH),
                          list(rng.integers(0, cfg.vocab_size,
                                            (SERVE_BATCH, 4))),
                          seeds=list(range(SERVE_BATCH)))
        fns = gen_lib.session_fns(cfg)
        keep = ("cache", "pos", "last")
        donated = {k: sess._state[k] for k in keep}

        def call():
            state, _ = fns.step(params, sess._state)
            return {k: state[k] for k in keep}
        return donated, call

    from repro_torch.core.generate import _SessionFns
    return InPlaceEntry(f"session_fns.step[{arch}, max_batch="
                        f"{SERVE_BATCH}]", make, *_loc(_SessionFns.step))


def _unroll_entry() -> InPlaceEntry:
    """The device actors' dispatch: a pipelined ``DeviceSource`` on Catch,
    whose unroll (``compiled.Unroll``) the reference jits with its carry
    donated."""
    from repro_torch.core import compiled
    from repro_torch.core.sources import DeviceSource
    from repro_torch.envs import catch
    from repro_torch.models.convnet import MinatarNet

    def make():
        env = catch.make()
        agent = MinatarNet(env.obs_shape, env.num_actions,
                           generator=torch.Generator().manual_seed(0))
        source = DeviceSource.for_env(env, agent, unroll_length=T,
                                      batch_size=B, seed=1)

        def call():
            source.next_batch(agent)
            return source._carry
        return source._carry, call

    return InPlaceEntry("DeviceSource.next_batch[catch]", make,
                        *_loc(compiled.Unroll._step))


def _learner_keys(recurrent: bool) -> Tuple[List[Finding], Dict]:
    """An rl-agent learner step (``compiled.TrainStep``) over three steps
    of a linear anneal: one graph key for all of them (the rate enters
    through the optimizer's device scalars, which keep their storage and
    take each step's value), so the card captures once."""
    from repro_torch.configs.atari_impala import small_train
    from repro_torch.core import compiled
    from repro_torch.core import learner as learner_lib
    from repro_torch.core import rollout as rollout_lib
    from repro_torch.envs import catch
    from repro_torch.models.convnet import MinatarLSTMNet, MinatarNet
    from repro_torch.optim import make_optimizer

    env = catch.make()
    gen = torch.Generator().manual_seed(0)
    net = MinatarLSTMNet if recurrent else MinatarNet
    agent = net(env.obs_shape, env.num_actions, generator=gen)
    unroll = (rollout_lib.make_recurrent_unroll(env, T) if recurrent
              else rollout_lib.make_unroll(env, T))
    env_state, obs = env.reset(B, gen, "cpu")
    carry = (unroll.initial_carry(agent, env_state, obs) if recurrent
             else (env_state, obs))
    _, batch = unroll(agent, carry, gen)
    tc = small_train(unroll_length=T, batch_size=B, total_steps=3)
    opt = make_optimizer(tc)
    factory = (learner_lib.make_recurrent_train_step if recurrent
               else learner_lib.make_train_step)
    step_fn = compiled.TrainStep(factory(opt, tc, vtrace_impl="scan"), opt)
    opt_state = opt.init(list(agent.parameters()))
    keys, rates, scalars = [], [], []
    for step in range(3):
        static = step_fn.inputs(batch)
        held = opt.stage(step, "cpu")
        rates.append(float(held["neg_lr"]))
        scalars.append(tuple(x.data_ptr() for x in held.values()))
        step_fn(agent, opt_state, step, static)
        keys.append(step_fn.graph_key(agent, opt_state, static))
    name = ("make_recurrent_train_step" if recurrent
            else "make_train_step") + "[catch, 3 rates]"
    findings = []
    if len(set(keys)) != 1 or len(set(scalars)) != 1 \
            or len(set(rates)) != 3:
        findings.append(Finding(
            rule="retrace-hazard", file=_loc(compiled.TrainStep.graph_key)[0],
            line=_loc(compiled.TrainStep.graph_key)[1],
            message=f"{name}: {len(set(keys))} graph keys and "
                    f"{len(set(scalars))} scalar storages over steps of "
                    f"{len(set(rates))} rates; want 1, 1 and 3: the card "
                    "would capture a step per rate"))
    return findings, {"entry": name, "graph_keys": len(set(keys)),
                      "rates": len(set(rates)), "ok": not findings}


def _lm_learner_keys(pretrain: bool,
                     arch: str = "qwen3-4b") -> Tuple[List[Finding], Dict]:
    """An LM learner step as ``launch/train.py`` builds it (``build_lm`` /
    ``build_lm_rl``: ``compiled.TrainStep``) over three steps: one graph
    key for all of them, with AdamW's staged scalars (the lm run's
    warmup rate, both runs' bias corrections) new each step in one set of
    storages, so the card captures once."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.core import compiled
    from repro_torch.launch import train

    mode = "lm" if pretrain else "lm-rl"
    args = train._parser().parse_args(
        ["--mode", mode, "--arch", arch, "--reduced", "--steps", "3",
         "--batch", str(B), "--seq", str(S), "--vtrace-impl", "scan",
         "--device", "cpu"])
    _, step_fn, params, opt_state, _ = (
        train.build_lm if pretrain else train.build_lm_rl)(args)
    vocab = get_reduced_config(arch).vocab_size
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, vocab, (S + 1, B), generator=gen)
    if pretrain:
        batch = {"tokens": tokens.T.contiguous()}
    else:
        batch = {"obs": tokens.int(), "action": tokens[1:].int(),
                 "behavior_logprob": -torch.rand((S, B), generator=gen),
                 "reward": torch.rand((S, B), generator=gen),
                 "done": torch.zeros((S, B), dtype=torch.bool)}
    keys, scalars, ptrs = [], [], []
    for step in range(3):
        static = step_fn.inputs(batch)
        held = step_fn.opt.stage(step, "cpu")
        scalars.append(tuple(float(x) for x in held.values()))
        ptrs.append(tuple(x.data_ptr() for x in held.values()))
        step_fn(params, opt_state, step, static)
        keys.append(step_fn.graph_key(params, opt_state, static))
    name = f"build_{mode.replace('-', '_')}[{arch}, 3 steps]"
    findings = []
    if not isinstance(step_fn, compiled.TrainStep) or len(set(keys)) != 1 \
            or len(set(ptrs)) != 1 or len(set(scalars)) != 3:
        findings.append(Finding(
            rule="retrace-hazard", file=_loc(compiled.TrainStep.graph_key)[0],
            line=_loc(compiled.TrainStep.graph_key)[1],
            message=f"{name}: {type(step_fn).__name__}, {len(set(keys))} "
                    f"graph keys and {len(set(ptrs))} scalar storages over "
                    f"{len(set(scalars))} sets of staged scalars; want a "
                    "TrainStep, 1, 1 and 3"))
    return findings, {"entry": name, "graph_keys": len(set(keys)),
                      "scalars": len(set(scalars)), "ok": not findings}


def _policy_keys() -> Tuple[List[Finding], Dict]:
    """The host actors' policy (``HostLoopSource.policy``, a
    ``compiled.Forward``): one graph key per padded bucket of the
    inference queue, the same key after ``_sync`` loads new weights into
    the actor copy in place, so the card captures once a bucket."""
    from repro_torch.core import compiled
    from repro_torch.launch import train

    args = train._parser().parse_args(["--actors", "host", "--device",
                                       "cpu", "--batch", str(B)])
    source, _, agent, _, _ = train.build_rl_agent(args)
    policy = source.policy
    source._sync(agent)
    shape = source._env.obs_shape
    buckets = (1, 2, 4, 8)

    def key(n):
        static = policy.inputs(torch.zeros((n,) + shape))
        return policy.graph_key(source._actor, static)
    keys = [key(n) for n in buckets]
    with torch.no_grad():
        for p in agent.parameters():
            p.add_(1.0)
    source._sync(agent)
    again = [key(n) for n in buckets]
    findings = []
    if len(set(keys)) != len(buckets) or again != keys:
        findings.append(Finding(
            rule="retrace-hazard", file=_loc(compiled.Forward.graph_key)[0],
            line=_loc(compiled.Forward.graph_key)[1],
            message=f"HostLoopSource.policy: {len(set(keys))} graph keys "
                    f"for {len(buckets)} buckets, "
                    f"{'the same' if again == keys else 'new ones'} after "
                    "_sync; want one a bucket, kept"))
    return findings, {"entry": "HostLoopSource.policy[catch]",
                      "graph_keys": len(set(keys)),
                      "buckets": len(buckets), "ok": not findings}


def _admission_keys(arch: str = "qwen3-4b") -> Tuple[List[Finding], Dict]:
    """A session's admissions (``_SessionFns.admit``): one graph key per
    (rows, prefill bucket), whatever the prompts and slots, so the card
    captures once per (rows, bucket)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.core import generate as gen_lib
    from repro_torch.models import model as model_lib

    cfg = get_reduced_config(arch)
    params = model_lib.init(cfg, seed=0)
    sess = gen_lib.DecodeSession(params, cfg, max_batch=4, max_len=32)
    fns = gen_lib.session_fns(cfg)
    rng = np.random.default_rng(0)
    keys = []
    # (slots, lengths): (N, bucket) = (2, 8), (2, 8), (2, 16), (1, 8)
    for slots, lens in (([0, 1], [5, 7]), ([2, 3], [6, 8]),
                        ([0, 1], [12, 16]), ([2], [8])):
        for slot in slots:
            sess.evict(slot)
        prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
        pb = gen_lib.prefill_len(cfg, lens[0], sess.max_len)
        sess.prefill_many(slots, prompts, seeds=list(range(len(slots))))
        keys.append((fns.graph_key(params, sess._state), len(slots), pb))
    want = len({(n, pb) for _, n, pb in keys})
    findings = []
    if len(set(keys)) != want:
        file, line = _loc(gen_lib._SessionFns.admit)
        findings.append(Finding(
            rule="retrace-hazard", file=file, line=line,
            message=f"admit[{arch}]: {len(set(keys))} graph keys for "
                    f"{want} (rows, bucket) pairs: the session's buffers "
                    "rebound between admissions"))
    return findings, {"entry": f"admit[{arch}]",
                      "graph_keys": len(set(keys)), "row_buckets": want,
                      "ok": not findings}


def registered_entries() -> List[InPlaceEntry]:
    """Every entry the reference jits with a donation, in the port."""
    return [_session_entry(), _rl_entry(False), _rl_entry(True),
            _lm_entry(False), _lm_entry(True), _unroll_entry()]


def audit_compiled_keys() -> Tuple[List[Finding], List[Dict]]:
    """The compiled learner steps (rl-agent, LM), the host actors' policy
    and the admissions: one graph key per step across changing rates, one
    per policy bucket, one per admission (rows, bucket)."""
    findings: List[Finding] = []
    summaries: List[Dict] = []
    for fnd, summary in (_learner_keys(False), _learner_keys(True),
                         _lm_learner_keys(False), _lm_learner_keys(True),
                         _policy_keys(), _admission_keys()):
        findings += fnd
        summaries.append(summary)
    return findings, summaries


def audit_traces(archs: Optional[Sequence[str]] = None,
                 ) -> Tuple[List[Finding], List[Dict]]:
    """Run the whole trace audit. Returns (findings, summaries)."""
    from repro_torch.configs import ARCHS, get_reduced_config
    from repro_torch.configs import base as cfg_base

    findings: List[Finding] = []
    summaries: List[Dict] = []
    where = (inspect.getsourcefile(cfg_base.ModelConfig),
             inspect.getsourcelines(cfg_base.ModelConfig)[1])
    for arch in archs or ARCHS:
        findings += audit_static_key(
            lambda arch=arch: get_reduced_config(arch),
            f"ModelConfig[{arch}]", *where)
    fnd, summary = audit_recapture()
    findings += fnd
    summaries.append(summary)
    for entry in registered_entries():
        fnd, summary = audit_entry(entry)
        findings += fnd
        summaries.append(summary)
    fnd, sums = audit_compiled_keys()
    findings += fnd
    summaries += sums
    fnd, sums = audit_sharding(archs)
    return findings + fnd, summaries + sums


__all__ = ["AbstractMesh", "InPlaceEntry", "audit_compiled_keys",
           "audit_entry", "audit_recapture",
           "audit_rules", "audit_sharding", "audit_static_key",
           "audit_traces", "registered_entries"]
