"""Every rules table's decisions against the reference's, on the CPU
without process groups:

* For every arch of the registry (reduced), every table of
  ``RULE_SETS`` but ``rl_agent``, and the meshes (1, 2), (2, 1), (2, 2)
  and (1, 4): each leaf's partition spec equals the reference's
  ``param_shardings`` and its optimizer-state spec the reference's
  ``zero1_shardings`` (built on the current ``AbstractMesh(axis_sizes,
  axis_names)`` form), and every rank's slice of each leaf (``shard_model``)
  and of its optimizer state (``zero_slices``) is the block those specs
  give that rank of the whole stacked leaf.
* ``resolve_rules`` picks the reference's table for every arch and shape.
* ``rules_named`` takes every LM table, ``cp_fsdp_seqpar`` included, and
  refuses the agent's; ``multihost --mode dryrun`` refuses more
  processes than its rendezvous joins.
"""

import copy
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_reduced_config
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import multihost
from repro_torch.launch.dryrun import resolve_rules
from repro_torch.models import model as model_lib
from repro_torch.optim.optimizers import zero_view

MESHES = ((1, 2), (2, 1), (2, 2), (1, 4))
TABLES = tuple(n for n in sharding.RULE_SETS if n != "rl_agent")


def _view(data, model, rank=0):
    return mesh_lib.Mesh2D(rank, data, model, torch.device("cpu"), "gloo")


@functools.lru_cache(maxsize=None)
def _reference_tree(arch):
    import jax

    from repro.configs import get_reduced_config as jreduced
    from repro.models import model as jmodel
    return jmodel.init(jax.random.PRNGKey(0), jreduced(arch))


def _flat_specs(tree):
    import jax
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s.spec)
            for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _reference_specs(arch, table, data, model):
    from jax.sharding import AbstractMesh

    from repro.distributed import sharding as jshd
    jparams, jaxes = _reference_tree(arch)
    jmesh = AbstractMesh((data, model), ("data", "model"))
    rules = jshd.RULE_SETS[table]
    return (_flat_specs(jshd.param_shardings(jaxes, jmesh, rules, jparams)),
            _flat_specs(jshd.zero1_shardings(jaxes, jparams, jmesh, rules)))


def _key(name):
    """The reference's path of a port leaf (block leaves stacked)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        parts = ["blocks"] + parts[2:]
    return "/".join(parts)


def _block(whole, spec, view):
    """The block of ``whole`` (a numpy array) that ``spec`` gives rank
    (``view.data_index``, ``view.model_index``)."""
    index = {"data": (view.data_index, view.data),
             "model": (view.model_index, view.model)}
    out = whole
    for dim, part in enumerate(spec):
        if part is None:
            continue
        pos, parts = 0, 1
        for axis in (part if isinstance(part, tuple) else (part,)):
            pos, parts = pos * index[axis][1] + index[axis][0], \
                parts * index[axis][1]
        n = out.shape[dim] // parts
        out = np.take(out, range(pos * n, (pos + 1) * n), axis=dim)
    return out


def _expected(whole, spec, view, name):
    """The rank's part of a port leaf: its block of the (stacked) whole,
    then, for a block leaf, its group's entry (empty where the block
    holds other groups)."""
    if not name.startswith("blocks."):
        return _block(whole[name], spec, view)
    group = int(name.split(".")[1])
    stacked = np.stack([whole[f"blocks.{g}.{name.split('.', 2)[2]}"]
                        for g in range(len(whole["_groups"]))])
    got = _block(stacked, spec, view)
    lo = _block(np.arange(stacked.shape[0]), spec[:1], view)
    if group not in lo:
        return got[0][:0]      # another rank keeps this group's leaf
    return got[list(lo).index(group)]


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_slices_and_zero1_match_reference(arch, table):
    cfg = get_reduced_config(arch)
    rules = sharding.RULE_SETS[table]
    base = model_lib.init(cfg, seed=0)
    whole = {n: p.detach().numpy().copy() for n, p in
             base.named_parameters()}
    whole["_groups"] = range(cfg.num_groups)
    for data, model in MESHES:
        want, want_zero = _reference_specs(arch, table, data, model)
        got = model_lib.param_specs(base, cfg, _view(data, model), rules)
        assert {_key(n) for n in got} == set(want)
        for name, (spec, _) in got.items():
            assert spec == want[_key(name)], (data, model, name)
        for rank in range(data * model):
            view = _view(data, model, rank)
            params = model_lib.shard_model(copy.deepcopy(base), cfg, view,
                                           rules)
            zero = model_lib.zero_slices(params, cfg, view, rules)
            for (name, leaf), zs in zip(params.named_parameters(), zero):
                key = _key(name)
                held = leaf.detach().numpy()
                ref = _expected(whole, want[key], view, name)
                assert held.shape == ref.shape, (data, model, rank, name)
                np.testing.assert_array_equal(held, ref)
                # ZeRO-1: the optimizer state's slice of the reference's
                # zero1 spec (its data split on top of the param spec)
                ref_state = _expected(whole, want_zero[key], view, name)
                mine = zero_view(leaf.detach(), zs).numpy()
                assert mine.shape == ref_state.shape, \
                    (data, model, rank, name, want_zero[key])
                np.testing.assert_array_equal(mine, ref_state)


def test_zero1_specs_match_reference_for_every_table():
    """``sharding.zero1_shardings`` on the reference's stacked axes and
    shapes, every arch and table at (2, 2): spec for spec."""
    for arch in ARCHS:
        cfg = get_reduced_config(arch)
        params = model_lib.init(cfg, seed=0)
        axes, shapes = model_lib.stacked_axes(
            params, cfg, {n: p.shape for n, p in params.named_parameters()})
        for table in TABLES:
            _, want = _reference_specs(arch, table, 2, 2)
            got = sharding.zero1_shardings(axes, _view(2, 2),
                                           sharding.RULE_SETS[table], shapes)
            assert {_key(n): s for n, s in got.items()} == want, \
                (arch, table)


@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
def test_resolve_rules_matches_reference(shape):
    from repro.launch.dryrun import resolve_rules as jresolve
    for arch in ARCHS:
        assert resolve_rules("auto", shape, arch) == \
            jresolve("auto", shape, arch), arch
        assert resolve_rules("seqpar", shape, arch) == "seqpar"


def test_rules_named_takes_the_lm_tables_and_refuses_cp():
    # (the name is kept from when cp_fsdp_seqpar was refused: the table
    # is taken now, its programs in tests/test_torch_specs.py; the agent's
    # table is what is still refused)
    for name in ("megatron", "fsdp", "seqpar", "fsdp_seqpar",
                 "cp_fsdp_seqpar", "expert", "expert_seqpar"):
        assert sharding.rules_named(name) is sharding.RULE_SETS[name]
    assert sharding.rules_named("cp_fsdp_seqpar")["attn_pref"] == "seq"
    with pytest.raises(NotImplementedError, match="not ported yet"):
        sharding.rules_named("rl_agent")
    with pytest.raises(KeyError):
        sharding.rules_named("nope")


def test_multihost_dryrun_is_refused():
    # (the name is kept from when --mode dryrun was refused; it now runs,
    # tests/test_torch_roofline.py, and refuses only what every mode does:
    # more processes than the rendezvous can join)
    with pytest.raises(SystemExit, match="requires --coordinator"):
        multihost.main(["--mode", "dryrun", "--device", "cpu",
                        "--num-processes", "2"])
    assert multihost.factor_mesh(1) == (1, 1)
    assert multihost.factor_mesh(4) == (1, 4)
    assert multihost.factor_mesh(6) == (3, 2)
    assert multihost.factor_mesh(48) == (3, 16)


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("arch", ["xlstm-125m", "llama-3.2-vision-90b"])
def test_model_axis_refuses_nothing_for_xlstm_and_vlm(arch, model):
    from repro_torch.configs import get_config
    model_lib.check_model_parallel(get_config(arch), model)
    cfg = get_reduced_config(arch)
    params = model_lib.shard_model(model_lib.init(cfg, seed=0), cfg,
                                   _view(1, model),
                                   sharding.MEGATRON_RULES)
    assert any(d is not None for d in model_lib.split_dims(params).values())
