"""The programs of the launchers and their inputs, after the reference's
``launch/specs.py``.

For an (arch, input shape) pair ``build_program`` returns a step function
(the IMPALA LM learner step, a prefill, or one decode step), the inputs
to call it with, the resolved config and a dict of extras. The reference
returns ``ShapeDtypeStruct`` stand-ins carrying each input's sharding
and lets ``jax.jit`` compile the program over the mesh. Torch has no
abstract arrays, so here the inputs are this rank's materialised slices,
made as the reference's ``launch/multihost.py::main`` materialises its
stand-ins: each floating leaf ``0.01 * normal`` from a ``torch.Generator``
seeded with ``seed`` (the same draws on every rank, then cut), integer and
boolean ones zeros. The exception is the optimizer state, which starts
from the optimizer's own ``init``: the reference's normal draws would give
RMSProp negative second moments, and ``rsqrt(ms + eps)`` is NaN below
``-eps``.

Every rank of the ``Mesh2D`` builds its own program: its model and data
slices of every parameter (``models/model.py::shard_model`` under
``rules``), its data block of the batch (``sharding.shard_lm_batch``),
its share of the decode cache (``cache_init`` under the rules: its kv
heads and recurrent heads), and, for training, the reference's ZeRO-1
optimizer state and ZeRO-2 gradients (``models/model.py::zero_slices``,
``optim.zero1``). A caller can pass ``params``, a whole tree (e.g. the
reference's weights through ``convert.py``), instead of the draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import configs
from repro_torch.configs.base import (INPUT_SHAPES, ImplContext,
                                      InputShape, ModelConfig, TrainConfig)
from repro_torch.core import learner as learner_lib
from repro_torch.distributed import sharding
from repro_torch.models import model as model_lib
from repro_torch.models.common import dtype_of, use_rules
from repro_torch.optim import make_optimizer
from repro_torch.optim.optimizers import zero1

# archs whose exact config is pure full attention: long_500k runs only with
# the sliding-window serving variant
LONG_CONTEXT_OVERRIDE = {
    "qwen3-32b", "qwen3-4b", "deepseek-coder-33b", "musicgen-large",
    "llama-3.2-vision-90b",
}


def _shape(shape) -> InputShape:
    return shape if isinstance(shape, InputShape) else INPUT_SHAPES[shape]


def resolve_config(arch: str, shape_name, base_cfg=None,
                   impls: Optional[ImplContext] = None) -> ModelConfig:
    """The arch's config specialised to the input shape, as the
    reference's: long_500k turns full attention into sliding-window
    attention where the arch has no long-context variant, training caps
    ``ssm_chunk`` at 128, and the attention impl is ``impls.attn`` or the
    memory-bounded ``xla_chunked`` (``impls.ssd`` overrides the SSD impl).
    ``base_cfg`` replaces the registry's config (reduced tests)."""
    shape = _shape(shape_name)
    cfg = base_cfg if base_cfg is not None else configs.get_config(arch)
    if shape.name == "long_500k" and arch in LONG_CONTEXT_OVERRIDE:
        pattern = tuple(("swa_attn" if m == "attn" else m, f)
                        for m, f in cfg.block_pattern)
        cfg = dataclasses.replace(cfg, block_pattern=pattern,
                                  sliding_window=cfg.long_context_window)
    if shape.kind == "train":
        cfg = dataclasses.replace(cfg, ssm_chunk=min(cfg.ssm_chunk, 128))
    impls = impls or ImplContext()
    cfg = dataclasses.replace(cfg, attn_impl=impls.attn or "xla_chunked")
    if impls.ssd:
        cfg = dataclasses.replace(cfg, ssd_impl=impls.ssd)
    return cfg


def _materialise(shape, dtype, gen, device):
    """The reference's stand-in made real: ``0.01 * normal`` for a
    floating ``dtype``, zeros otherwise."""
    if not dtype.is_floating_point:
        return torch.zeros(shape, dtype=dtype, device=device)
    x = torch.empty(shape, dtype=torch.float32, device=device)
    return x.normal_(generator=gen).mul_(0.01).to(dtype)


def _generator(seed, device):
    return torch.Generator(device=device).manual_seed(seed)


def rank_params(cfg, mesh, rules, *, params=None, seed: int = 0):
    """This rank's parameters: the whole tree (``params``, or every leaf
    drawn ``0.01 * normal`` in state-dict order from ``seed``, alike on
    every rank) cut to the rank's slices under ``rules``."""
    device = mesh.device
    if params is None:
        params = model_lib.init(cfg, seed=seed, device=device)
        gen = _generator(seed, device)
        with torch.no_grad():
            for p in params.parameters():
                p.copy_(_materialise(p.shape, p.dtype, gen, device))
    else:
        params = params.to(device)
    return model_lib.shard_model(params, cfg, mesh, rules)


def cache_specs(cfg, mesh, rules, batch: int, seq_len: int, *,
                seed: int = 0):
    """This rank's decode cache for a global ``batch`` of ``seq_len``
    slots: its data block of the rows (when the data axis divides the
    batch), its kv heads and recurrent heads (``model.cache_init`` under
    the rules), every float leaf ``0.01 * normal`` from ``seed``."""
    rows = batch // _data_parts(mesh, batch)
    with use_rules(mesh, rules):
        cache = model_lib.cache_init(cfg, rows, seq_len, device=mesh.device)
    gen = _generator(seed, mesh.device)
    for leaf in _leaves(cache):
        leaf.copy_(_materialise(leaf.shape, leaf.dtype, gen, mesh.device))
    return cache


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _data_parts(mesh, batch: int) -> int:
    """How many blocks the data axes split a global batch into: the
    reference's ``_batch_spec``."""
    return mesh.data if batch % mesh.data == 0 else 1


def _batch(tensors, mesh, rules):
    return sharding.shard_lm_batch(tensors, mesh, rules)


# ---------------------------------------------------------------------------
# program builders
# ---------------------------------------------------------------------------

def build_train(arch: str, shape_name, mesh, rules,
                train_cfg: Optional[TrainConfig] = None, base_cfg=None,
                impls=None, *, params=None, seed: int = 0,
                vtrace_impl: str = "scan", loss_chunk: int = 512):
    """The IMPALA LM learner step and its inputs for a train shape.
    Returns (step_fn, (params, opt_state, step, batch), cfg, extras):
    ``step_fn(params, opt_state, step, batch) -> (params, opt_state,
    metrics)`` updates in place; ``extras["zero"]`` are the ZeRO slices."""
    cfg = resolve_config(arch, shape_name, base_cfg, impls)
    ishape = _shape(shape_name)
    train_cfg = train_cfg or TrainConfig()
    params = rank_params(cfg, mesh, rules, params=params, seed=seed)
    slices = model_lib.zero_slices(params, cfg, mesh, rules)
    opt = zero1(make_optimizer(train_cfg), slices, mesh)
    opt_state = opt.init(list(params.parameters()))
    step_fn = learner_lib.make_lm_train_step(
        cfg, opt, train_cfg, loss_chunk=loss_chunk, vtrace_impl=vtrace_impl,
        mesh=mesh, rules=rules, zero=slices)
    b, s = ishape.global_batch, ishape.seq_len
    gen, dev = _generator(seed + 1, mesh.device), mesh.device
    batch = {
        "tokens": _materialise((b, s + 1), torch.int32, gen, dev),
        "behavior_logprob": _materialise((b, s), torch.float32, gen, dev),
        "reward": _materialise((b, s), torch.float32, gen, dev),
        "done": _materialise((b, s), torch.bool, gen, dev),
    }
    if cfg.vision_seq:
        batch["vision"] = _materialise((b, cfg.vision_seq, cfg.d_model),
                                       dtype_of(cfg), gen, dev)
    return (step_fn, (params, opt_state, 0, _batch(batch, mesh, rules)),
            cfg, {"zero": slices})


def build_prefill(arch: str, shape_name, mesh, rules, base_cfg=None,
                  impls=None, *, params=None, seed: int = 0):
    """A prefill of the shape's whole sequence: ``prefill_step(params,
    tokens[, vision]) -> (logits of the last position (B, 1, V), cache)``
    on this rank's rows, with a cache of ``seq_len`` slots."""
    cfg = resolve_config(arch, shape_name, base_cfg, impls)
    ishape = _shape(shape_name)
    b, s = ishape.global_batch, ishape.seq_len
    params = rank_params(cfg, mesh, rules, params=params, seed=seed)
    gen, dev = _generator(seed + 1, mesh.device), mesh.device
    inputs = {"tokens": _materialise((b, s), torch.int32, gen, dev)}
    if cfg.vision_seq:
        inputs["vision"] = _materialise((b, cfg.vision_seq, cfg.d_model),
                                        dtype_of(cfg), gen, dev)
    inputs = _batch(inputs, mesh, rules)

    def prefill_step(params, tokens, vision=None):
        with torch.no_grad(), use_rules(mesh, rules):
            hidden, _, cache = model_lib.prefill(
                params, tokens, cfg=cfg, vision=vision, cache_seq_len=s)
            logits = model_lib.logits_from_hidden(params, cfg,
                                                  hidden[:, -1:])
        return logits, cache

    return prefill_step, (params, *inputs.values()), cfg, {}


def build_decode(arch: str, shape_name, mesh, rules, base_cfg=None,
                 impls=None, *, params=None, seed: int = 0):
    """One decode step, the port's ``serve_step`` layer by layer over a
    cache written in place: ``serve_step(params, tokens, cache, pos) ->
    (logits (B, 1, V), baseline, cache)`` on this rank's rows."""
    cfg = resolve_config(arch, shape_name, base_cfg, impls)
    ishape = _shape(shape_name)
    b, s = ishape.global_batch, ishape.seq_len
    params = rank_params(cfg, mesh, rules, params=params, seed=seed)
    gen, dev = _generator(seed + 1, mesh.device), mesh.device
    tokens = _batch({"tokens": _materialise((b, 1), torch.int32, gen, dev)},
                    mesh, rules)["tokens"]
    cache = cache_specs(cfg, mesh, rules, b, s, seed=seed + 2)

    def serve_step(params, tokens, cache, pos):
        with torch.no_grad(), use_rules(mesh, rules):
            return model_lib.serve_step(params, tokens, cache, pos, cfg=cfg)

    return serve_step, (params, tokens, cache, 0), cfg, {}


def build_program(arch: str, shape_name, mesh, rules, base_cfg=None,
                  impls=None, **kwargs):
    """The program of the shape's kind (train, prefill or decode), with
    its inputs: ``build_train`` / ``build_prefill`` / ``build_decode``."""
    kind = _shape(shape_name).kind
    build = {"train": build_train, "prefill": build_prefill}.get(
        kind, build_decode)
    return build(arch, shape_name, mesh, rules, base_cfg=base_cfg,
                 impls=impls, **kwargs)
