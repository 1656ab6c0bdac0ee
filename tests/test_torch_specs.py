"""The programs of ``launch/specs.py`` under the other rules tables
(ROADMAP item 27), on the CPU:

* ``build_program`` at (2, 2), four gloo ranks sharing one spawned group,
  against the reference's ``build_program`` with the same reduced config
  and a small ``InputShape`` on a (1, 1) mesh (as
  ``tests/test_dryrun_small.py`` builds it), run on the same JAX weights
  and numpy-seeded inputs. The cases cover every table the LM layers
  take but Megatron (fsdp, seqpar, fsdp_seqpar, cp_fsdp_seqpar, expert,
  expert_seqpar),
  every arch family (dense, MoE, hybrid Mamba2, xLSTM, VLM) and every
  program kind (train with ZeRO-1/2, prefill, decode); the
  context-parallel ``cp_fsdp_seqpar`` (a train and a VLM prefill) runs at
  (1, 2) as well. Bars: losses and
  logits within 1e-5 (float32, relative and absolute, as
  ``tests/test_torch_lm_learner.py``), every parameter after the
  RMSProp step within 1e-4 of the reference's, on each rank's slice.
* ZeRO-1/2 at (2, 1): a rank's optimizer state is its slice only, and two
  steps land within 1e-6 of the unsharded optimizer, for RMSProp and
  AdamW, under Megatron and FSDP.
* ``python -m repro_torch.launch.multihost --mode train`` and ``--mode
  serve`` as two ``--coordinator`` processes, with a reduced arch and a
  small shape that the processes register before ``main`` runs.

This module's top level imports no JAX: spawned ranks import it to find
their worker functions.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import TrainConfig, get_reduced_config
from repro_torch.configs.base import InputShape
from repro_torch.convert import lm_state_dict_from_jax
from repro_torch.core import learner
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs
from repro_torch.models import model as model_lib
from repro_torch.models.common import tree_map
from repro_torch.optim import make_optimizer
from repro_torch.optim.optimizers import zero1

torch.set_num_threads(1)

SHAPES = {"train": InputShape("train_small", 32, 4, "train"),
          "prefill": InputShape("prefill_small", 16, 2, "prefill"),
          "decode": InputShape("decode_small", 16, 4, "decode")}
DECODE_STEPS = 3
# (arch, rules table, program kind)
CASES = (("qwen3-4b", "fsdp_seqpar", "train"),
         ("granite-moe-1b-a400m", "expert_seqpar", "train"),
         ("zamba2-2.7b", "seqpar", "train"),
         ("xlstm-125m", "fsdp", "train"),
         ("llama-3.2-vision-90b", "fsdp_seqpar", "prefill"),
         ("qwen3-4b", "fsdp", "decode"),
         ("granite-moe-1b-a400m", "expert", "decode"),
         # context parallel: the queries split over the sequence through
         # attention (offset from their gathered keys), self-attention in
         # training and cross-attention in a prefill that builds the cache
         ("qwen3-4b", "cp_fsdp_seqpar", "train"),
         ("llama-3.2-vision-90b", "cp_fsdp_seqpar", "prefill"))
CP_CASES = tuple(c for c in CASES if c[1] == "cp_fsdp_seqpar")
TOL, PARAM_TOL, ZERO_TOL = 1e-5, 1e-4, 1e-6


def _inputs(cfg, kind):
    """The case's numpy inputs (seed 0), whole batches."""
    rng = np.random.default_rng(0)
    shape = SHAPES[kind]
    b, s = shape.global_batch, shape.seq_len
    if kind == "train":
        tokens = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
        target = (5 * tokens[:, :-1] + 3) % cfg.vocab_size
        done = np.zeros((b, s), bool)
        done[:, -1] = True
        out = {"tokens": tokens,
               "behavior_logprob": np.full((b, s), -np.log(cfg.vocab_size),
                                           np.float32),
               "reward": (tokens[:, 1:] == target).astype(np.float32),
               "done": done}
    elif kind == "prefill":
        out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)}
    else:
        out = {"tokens": rng.integers(0, cfg.vocab_size,
                                      (b, DECODE_STEPS)).astype(np.int32)}
    if cfg.vision_seq and kind != "decode":
        out["vision"] = rng.normal(0, 1, (b, cfg.vision_seq,
                                          cfg.d_model)).astype(np.float32)
    return out


def _reference(arch, table, kind):
    """The reference's program on a (1, 1) mesh: (initial weights as a
    port state dict, the inputs, its outputs)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced_config as jreduced
    from repro.configs.base import InputShape as JInputShape
    from repro.distributed.sharding import RULE_SETS
    from repro.launch.mesh import make_mesh
    from repro.launch.specs import build_program
    from repro.models import model as jmodel

    cfg = jreduced(arch)
    mesh = make_mesh((1, 1), ("data", "model"))
    shape = JInputShape(*vars(SHAPES[kind]).values())
    fn, args, _, jit_kwargs = build_program(arch, shape, mesh,
                                            RULE_SETS[table], base_cfg=cfg)
    params, _ = jmodel.init(jax.random.PRNGKey(0), cfg)
    state = lm_state_dict_from_jax(params)
    inputs = _inputs(cfg, kind)
    out = {}
    with mesh:
        step = jax.jit(fn, **jit_kwargs)
        if kind == "train":
            opt_state = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                                     args[1])
            batch = {k: jnp.asarray(v) for k, v in inputs.items()}
            new, _, metrics = step(params, opt_state, jnp.int32(0), batch)
            out["loss"] = float(metrics["loss"])
            out["params"] = {k: v.numpy() for k, v in
                             lm_state_dict_from_jax(new).items()}
        elif kind == "prefill":
            extra = [jnp.asarray(inputs["vision"])] if cfg.vision_seq else []
            logits, _ = step(params, jnp.asarray(inputs["tokens"]), *extra)
            out["logits"] = np.asarray(logits)
        else:
            cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                                 args[2])
            logits = []
            for t in range(DECODE_STEPS):
                lg, _, cache = step(params, jnp.asarray(
                    inputs["tokens"][:, t:t + 1]), cache, jnp.int32(t))
                logits.append(np.asarray(lg))
            out["logits"] = np.concatenate(logits, axis=1)
    return state, inputs, out


def _expected_slices(cfg, mesh, rules, whole):
    """A whole port state dict cut as this rank holds it."""
    params = model_lib.init(cfg, seed=0)
    params.load_state_dict({k: torch.as_tensor(v) for k, v in whole.items()})
    model_lib.shard_model(params, cfg, mesh, rules)
    return {n: p.detach() for n, p in params.named_parameters()}


def _port_case(mesh, arch, table, kind, state, inputs, ref):
    """This rank's outputs of the case, and the largest gap of its
    parameter slices after a train step."""
    cfg = get_reduced_config(arch)
    rules = sharding.rules_named(table)
    whole = model_lib.init(cfg, seed=0)
    whole.load_state_dict(state)
    fn, args, _, _ = specs.build_program(arch, SHAPES[kind], mesh, rules,
                                         base_cfg=cfg, params=whole)
    local = sharding.shard_lm_batch(
        {k: torch.as_tensor(v) for k, v in inputs.items()}, mesh, rules)
    out = {"rows": (mesh.data_index, mesh.data)}
    if kind == "train":
        params, opt_state, _, _ = args
        params, _, metrics = fn(params, opt_state, 0, local)
        out["loss"] = float(metrics["loss"])
        want = _expected_slices(cfg, mesh, rules, ref["params"])
        out["param_gap"] = max(
            float((p.detach() - want[n]).abs().max()) if p.numel() else 0.0
            for n, p in params.named_parameters())
    elif kind == "prefill":
        logits, _ = fn(args[0], *local.values())
        out["logits"] = logits.numpy()
    else:
        params, _, cache, _ = args
        cache = tree_map(torch.zeros_like, cache)
        logits = []
        for t in range(DECODE_STEPS):
            lg, _, cache = fn(params, local["tokens"][:, t:t + 1], cache, t)
            logits.append(lg)
        out["logits"] = torch.cat(logits, dim=1).numpy()
    return out


def _rank(mesh, cases):
    return sharding.gather_to_main(
        {case: _port_case(mesh, *case, *ref) for case, ref in cases.items()},
        mesh)


@pytest.fixture(scope="module")
def programs():
    from conftest import free_port
    refs = {case: _reference(*case) for case in CASES}
    got = mesh_lib.launch(_rank, 4, device="cpu", model=2,
                          args=(refs,), port=free_port(), timeout_s=120.0)
    return refs, got


def _check(want, got, case):
    for rank, outs in enumerate(got):
        out = outs[case]
        if case[2] == "train":
            np.testing.assert_allclose(out["loss"], want["loss"], rtol=TOL,
                                       atol=TOL, err_msg=f"rank {rank}")
            assert out["param_gap"] <= PARAM_TOL, (rank, out["param_gap"])
            continue
        index, parts = out["rows"]
        rows = want["logits"].shape[0] // parts
        np.testing.assert_allclose(
            out["logits"], want["logits"][index * rows:(index + 1) * rows],
            rtol=TOL, atol=TOL, err_msg=f"rank {rank}")


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_build_program_matches_reference(programs, case):
    refs, got = programs
    _check(refs[case][2], got, case)


@pytest.mark.parametrize("case", CP_CASES, ids=["-".join(c) for c in CP_CASES])
def test_cp_fsdp_seqpar_at_one_by_two_matches_reference(programs, case):
    """The context-parallel table on a (1, 2) mesh too: no data axis, the
    two ranks' queries at offsets 0 and S/2."""
    from conftest import free_port
    refs, _ = programs
    got = mesh_lib.launch(_rank, 2, device="cpu", model=2,
                          args=({case: refs[case]},), port=free_port(),
                          timeout_s=120.0)
    _check(refs[case][2], got, case)


# ---------------------------------------------------------------------------
# ZeRO-1/2 against the unsharded optimizer


def _zero_rank(mesh, state):
    cfg = get_reduced_config("qwen3-4b")
    rng = np.random.default_rng(1)
    batches = [{"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (4, 17)).astype(np.int32))} for _ in range(2)]
    out = {}
    for table in ("megatron", "fsdp"):
        rules = sharding.rules_named(table)
        for name in ("rmsprop", "adamw"):
            tc = TrainConfig(optimizer=name, learning_rate=1e-3,
                             grad_clip=1.0, lr_schedule="constant",
                             total_steps=2)
            ends = []
            for zero in (True, False):
                params = model_lib.init(cfg, seed=0)
                params.load_state_dict(state)
                model_lib.shard_model(params, cfg, mesh, rules)
                slices = model_lib.zero_slices(params, cfg, mesh, rules) \
                    if zero else None
                opt = make_optimizer(tc)
                if zero:
                    opt = zero1(opt, slices, mesh)
                step = learner.make_lm_pretrain_step(
                    cfg, opt, loss_chunk=16, mesh=mesh, rules=rules,
                    zero=slices)
                opt_state = opt.init(list(params.parameters()))
                held = sum(x.numel() for v in opt_state.values() for x in v)
                for s, batch in enumerate(batches):
                    params, opt_state, _ = step(
                        params, opt_state, s,
                        sharding.shard_lm_batch(batch, mesh, rules))
                ends.append((params.state_dict(), held))
            (zp, zheld), (pp, pheld) = ends
            out[(table, name)] = (
                max(float((zp[k] - pp[k]).abs().max()) for k in zp),
                zheld, pheld)
    return sharding.gather_to_main(out, mesh)


def test_zero1_matches_unsharded_optimizer():
    from conftest import free_port
    state = model_lib.init(get_reduced_config("qwen3-4b"),
                           seed=0).state_dict()
    got = mesh_lib.launch(_zero_rank, 2, device="cpu", model=1,
                          args=(state,), port=free_port(), timeout_s=120.0)
    for rank, out in enumerate(got):
        for (table, name), (gap, zheld, pheld) in out.items():
            assert gap <= ZERO_TOL, (rank, table, name, gap)
            # under Megatron a rank keeps about half of the state it keeps
            # unsharded; FSDP's leaves are split over the data axis already
            assert zheld < (0.6 if table == "megatron" else 1.0) * pheld \
                or (table == "fsdp" and zheld == pheld), \
                (rank, table, name, zheld, pheld)


# ---------------------------------------------------------------------------
# the CLI: two --coordinator processes

_CLI = """
import sys
from repro_torch import configs
from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.launch import multihost
configs._REGISTRY["tiny-xlstm"] = configs.get_reduced_config("xlstm-125m")
INPUT_SHAPES["tiny_train"] = InputShape("tiny_train", 32, 4, "train")
INPUT_SHAPES["tiny_decode"] = InputShape("tiny_decode", 32, 4, "decode")
multihost.main(sys.argv[1:])
"""


@pytest.mark.parametrize("mode,shape,said", [
    ("train", "tiny_train", "2 train steps OK"),
    ("serve", "tiny_decode", "serve steps OK")])
def test_multihost_cli_two_coordinator_processes(mode, shape, said):
    from conftest import free_port
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.abspath("src")] + env.get("PYTHONPATH", "").split(os.pathsep))
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CLI, "--mode", mode, "--arch", "tiny-xlstm",
         "--shape", shape, "--steps", "2", "--device", "cpu",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(i)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for i in range(2)]
    outs = [p.communicate(timeout=180)[0] for p in procs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert f"[host {i}] {said}" in out, out
        assert "mesh {'data': 1, 'model': 2}" in out, out
    rules = "seqpar" if mode == "train" else "megatron"
    assert f"({rules})" in outs[0]
