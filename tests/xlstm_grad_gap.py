#!/usr/bin/env python3
"""How far float32 xLSTM-125M gradients at full width lie apart between
three computations of one learner step: the JAX reference, the port in one
process, and the port on a (1, 2) model mesh (two gloo processes).

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tests/xlstm_grad_gap.py

One ``--mode lm-rl`` loss (``make_lm_train_step``, V-trace on its plain
path) at B 8, T 64 on the reference's seed-0 weights and a seeded batch;
the gradients are read off one SGD step at lr 1 without clipping (the
reference) and off an optimizer that keeps them (the port). Prints one
JSON line: the three losses, and for each pair the largest gap of a leaf's
gradient relative to that leaf's largest magnitude, with the leaf. It
runs on the CPU in a few minutes and takes about 4 GB. ``chip_smoke.py``
phase 27a's bar for the meshed xLSTM step (``XLSTM_GRAD_TOL``) rests on it.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

B, T = 8, 64


def _batch(vocab):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, vocab, (B, T + 1))
    done = np.zeros((B, T), bool)
    done[:, -1] = True
    return {"tokens": tokens.astype(np.int32),
            "behavior_logprob": np.full((B, T), -np.log(vocab), np.float32),
            "reward": (rng.random((B, T)) < 0.3).astype(np.float32),
            "done": done}


def _reference():
    """(loss, initial weights and gradients as port state dicts)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.configs.base import TrainConfig
    from repro.core import learner
    from repro.models import model
    from repro.optim import make_optimizer
    from repro_torch.convert import lm_state_dict_from_jax

    cfg = dataclasses.replace(get_config("xlstm-125m"), dtype="float32")
    tc = TrainConfig(optimizer="sgd", learning_rate=1.0, grad_clip=0.0,
                     lr_schedule="constant", entropy_cost=0.003)
    opt = make_optimizer(tc)
    p0, _ = model.init(jax.random.PRNGKey(0), cfg)
    step = jax.jit(learner.make_lm_train_step(cfg, opt, tc, loss_chunk=T))
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg.vocab_size).items()}
    p1, _, metrics = step(p0, opt.init(p0), jnp.int32(0), batch)
    s0, s1 = lm_state_dict_from_jax(p0), lm_state_dict_from_jax(p1)
    return float(metrics["loss"]), s0, {k: s0[k].double() - s1[k].double()
                                        for k in s0}


def _port(state, mesh=None):
    """(loss, gradients by name, split dimensions) of the port's step."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core import learner
    from repro_torch.distributed import sharding
    from repro_torch.models import model as model_lib
    from repro_torch.optim import optimizers

    cfg = dataclasses.replace(get_config("xlstm-125m"), dtype="float32")
    params = model_lib.init(cfg, seed=0)
    params.load_state_dict(state)
    rules = None
    if mesh is not None:
        rules = sharding.MEGATRON_RULES
        model_lib.shard_model(params, cfg, mesh, rules)
    kept = {}

    def keep(grads, state, plist, step, norm_fn=None):
        kept["grads"] = [g.clone() for g in grads]
        grads.clear()
        return state

    opt = optimizers.Optimizer(init=lambda p: {}, step=keep)
    step = learner.make_lm_train_step(
        cfg, opt, TrainConfig(entropy_cost=0.003), loss_chunk=T,
        vtrace_impl="scan", mesh=mesh, rules=rules)
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg.vocab_size).items()}
    _, _, metrics = step(params, {}, 0, batch)
    names = [n for n, _ in params.named_parameters()]
    return (float(metrics["loss"]), dict(zip(names, kept["grads"])),
            model_lib.split_dims(params))


def _rank(mesh, state):
    from repro_torch.distributed import sharding
    torch.set_num_threads(4)
    return sharding.gather_to_main(_port(state, mesh), mesh)


def _worst(got, want, dims=None, index=0, parts=1):
    """The largest gap of a leaf's gradient relative to its largest."""
    out = dict(rel=0.0, leaf=None)
    for name, g in got.items():
        w = want[name]
        if dims and dims[name] is not None:
            n = w.shape[dims[name]] // parts
            w = w.narrow(dims[name], index * n, n)
        scale = w.abs().max().item()
        if not scale:
            continue
        rel = (g.double() - w.double()).abs().max().item() / scale
        if rel > out["rel"]:
            out = dict(rel=rel, leaf=name)
    return out


def main():
    from repro_torch.launch import mesh as mesh_lib
    torch.set_num_threads(8)
    ref_loss, state, ref = _reference()
    loss, single, _ = _port(state)
    ranks = mesh_lib.launch(_rank, 2, device="cpu", model=2, args=(state,),
                            timeout_s=900)
    print(json.dumps({
        "arch": "xlstm-125m", "dtype": "float32", "batch": B, "seq": T,
        "loss": {"reference": ref_loss, "port": loss,
                 "mesh_1x2": ranks[0][0]},
        "port_vs_reference": _worst(single, ref),
        "mesh_vs_port": [_worst(g, single, d, r, 2)
                         for r, (_, g, d) in enumerate(ranks)],
        "mesh_vs_reference": [_worst(g, ref, d, r, 2)
                              for r, (_, g, d) in enumerate(ranks)]}))


if __name__ == "__main__":
    main()
