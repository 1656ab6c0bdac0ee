"""The ("data", "model") mesh of the LM paths (``--mesh-model``) on the
CPU, gloo ranks:

* ``make_mesh2d``'s contract: ranks, data and model indices, the model
  and data groups, and the over-subscription refusal.
* The dimension each rank holds of every leaf of every reduced arch at
  M = 1, 2, 4 equals the reference's ``param_shardings`` under
  ``MEGATRON_RULES`` (dropped mappings and ``fallback_model`` included).
* Mesh (1, 1) is bitwise the unmeshed path, for both LM steps: losses and
  final parameters.
* At M = 2 every kind of split leaf is strictly smaller on each rank.
* ``DecodeSession`` / ``generate`` at (1, 2): teacher-forced logits
  within 1e-5 of the unmeshed ones, and the model ranks' tokens bitwise
  equal.
* The xLSTM mixers and the VLM's cross-attention take a model axis.

The (2, 2) parity against the reference's steps is in
``test_torch_mesh2d_parity.py``; the sharded checkpoints in
``test_torch_checkpoint_sharded.py``. This module's top level imports no
JAX: spawned ranks import it to find their worker functions.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, TrainConfig, get_reduced_config
from repro_torch.convert import LMCheckpointLayout
from repro_torch.core import generate as gen_lib
from repro_torch.core import learner
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train
from repro_torch.models import attention
from repro_torch.models import model as model_lib
from repro_torch.models.common import use_rules
from repro_torch.optim import make_optimizer

torch.set_num_threads(1)

JOIN_S = 60.0
RULES = sharding.MEGATRON_RULES
B, S = 4, 16


def _port():
    from conftest import free_port
    return free_port()


def _view(model, index=0, data=1):
    """A rank's Mesh2D without a process group: what the slicer and the
    spec decisions read."""
    return mesh_lib.Mesh2D(index, data, model, torch.device("cpu"), "gloo")


# ---------------------------------------------------------------------------
# make_mesh2d


def _mesh_rank(mesh):
    ones = torch.tensor([float(mesh.rank)])
    in_model, in_data = ones.clone(), ones.clone()
    dist.all_reduce(in_model, group=mesh.model_group)
    dist.all_reduce(in_data, group=mesh.data_group)
    mesh_lib.store_barrier(mesh, "contract")
    return sharding.gather_to_main(
        (mesh.rank, mesh.data_index, mesh.model_index, mesh.model_root,
         float(in_model), float(in_data), mesh.size), mesh)


def test_make_mesh2d_contract():
    got = mesh_lib.launch(_mesh_rank, 4, device="cpu", model=2,
                          port=_port(), timeout_s=JOIN_S)
    # rank r at data r // 2, model r % 2; model groups {0,1} {2,3}, data
    # groups {0,2} {1,3}
    assert got == [(0, 0, 0, 0, 1.0, 2.0, 4), (1, 0, 1, 0, 1.0, 4.0, 4),
                   (2, 1, 0, 2, 5.0, 2.0, 4), (3, 1, 1, 2, 5.0, 4.0, 4)]
    with pytest.raises(ValueError, match=r"mesh \(2, 2\) needs 4 devices "
                                         "but only 1 visible"):
        mesh_lib.mesh2d_devices(2, 2, "cuda", visible=1)
    assert mesh_lib.mesh2d_devices(2, 2, "cpu") == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="do not form a mesh"):
        mesh_lib.launch(_mesh_rank, 3, device="cpu", model=2)


# ---------------------------------------------------------------------------
# spec decisions against the reference


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_decisions_match_reference(arch):
    import jax
    from jax.sharding import AbstractMesh

    from repro.configs import get_reduced_config as jreduced
    from repro.distributed import sharding as jshd
    from repro.models import model as jmodel

    cfg = get_reduced_config(arch)
    params = model_lib.init(cfg, seed=0)
    jparams, jaxes = jmodel.init(jax.random.PRNGKey(0), jreduced(arch))
    layout = LMCheckpointLayout([])
    seen = {"dropped": 0, "fallback": 0, "split": 0}
    for m in (1, 2, 4):
        jmesh = AbstractMesh((1, m), ("data", "model"))
        want = {
            "/".join(str(getattr(k, "key", k)) for k in path): tuple(s.spec)
            for path, s in jax.tree_util.tree_flatten_with_path(
                jshd.param_shardings(jaxes, jmesh, RULES, jparams))[0]}
        got = model_lib.param_specs(params, cfg, _view(m), RULES)
        assert {layout._where(f"params/{n}")[0][len("params/"):]
                for n in got} == set(want)
        axes = model_lib.logical_axes(params, cfg)
        for name, (spec, dim) in got.items():
            key = layout._where(f"params/{name}")[0][len("params/"):]
            assert spec == want[key], (m, name, spec, want[key])
            stacked = name.startswith("blocks.")
            ax = (("layers",) if stacked else ()) + tuple(axes[name])
            parts = list(spec) + [None] * (len(ax) - len(spec))
            if m > 1 and any(RULES.get(a) == "model" and p is None
                             for a, p in zip(ax, parts)):
                seen["dropped"] += 1
            if dim is not None:
                seen["split"] += 1
                if RULES.get(ax[dim + stacked]) != "model":
                    seen["fallback"] += 1
    assert seen["split"] and seen["fallback"]
    if arch in ("qwen3-4b", "granite-moe-1b-a400m"):
        assert seen["dropped"]      # kv_heads 2 on a 4-way model axis


def test_every_leaf_kind_is_split_on_each_rank():
    for arch, kinds in (("qwen3-4b", ("mixer.wq", "mixer.wo", "ffn.wi",
                                      "ffn.wo", "embed")),
                        ("zamba2-2.7b", ("mixer.in_proj_x", "mixer.out_proj",
                                         "mixer.a_log", "mixer.conv_w")),
                        ("granite-moe-1b-a400m", ("ffn.wi", "ffn.wo",
                                                  "ffn.router"))):
        cfg = get_reduced_config(arch)
        whole = {n: p.shape for n, p in
                 model_lib.init(cfg, seed=0).named_parameters()}
        for index in range(2):
            params = model_lib.shard_model(model_lib.init(cfg, seed=0), cfg,
                                           _view(2, index), RULES)
            for kind in kinds:
                names = [n for n, _ in params.named_parameters()
                         if n.endswith(kind)]
                assert names, (arch, kind)
                for n in names:
                    part = params.get_parameter(n).shape
                    assert part.numel() * 2 == whole[n].numel(), (n, part)


# ---------------------------------------------------------------------------
# mesh (1, 1) is the unmeshed path


def _steps(cfg, mode, mesh, batches):
    train_cfg = TrainConfig(optimizer="adamw", learning_rate=1e-3,
                            grad_clip=1.0, total_steps=3,
                            lr_schedule="constant", entropy_cost=0.003)
    opt = make_optimizer(train_cfg)
    params = model_lib.init(cfg, seed=0)
    rules = None
    if mesh is not None:
        rules = RULES
        model_lib.shard_model(params, cfg, mesh, rules)
    opt_state = opt.init(list(params.parameters()))
    if mode == "lm":
        step = learner.make_lm_pretrain_step(cfg, opt, loss_chunk=S,
                                             mesh=mesh, rules=rules)
    else:
        step = learner.make_lm_train_step(cfg, opt, train_cfg, loss_chunk=S,
                                          vtrace_impl="scan", mesh=mesh,
                                          rules=rules)
    losses = []
    for s, batch in enumerate(batches):
        if mesh is not None:
            batch = sharding.shard_lm_batch(batch, mesh, rules)
        params, opt_state, m = step(params, opt_state, s, batch)
        losses.append(float(m["loss"]))
    return losses, {k: v.clone() for k, v in params.state_dict().items()}


def lm_batches(cfg, mode, steps=3, b=B, s=S, seed=0):
    """Seeded batch-major batches of either LM step."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                               (b, s + 1)))
        if mode == "lm":
            out.append({"tokens": tokens})
            continue
        out.append({"tokens": tokens,
                    "behavior_logprob": torch.from_numpy(
                        rng.uniform(-8.0, -4.0, (b, s)).astype(np.float32)),
                    "reward": torch.from_numpy(
                        rng.integers(0, 2, (b, s)).astype(np.float32)),
                    "done": torch.from_numpy(
                        np.arange(s)[None].repeat(b, 0) == s - 1)})
    return out


def _mesh11_rank(mesh, arch, mode):
    cfg = get_reduced_config(arch)
    return _steps(cfg, mode, mesh, lm_batches(cfg, mode))


@pytest.mark.parametrize("mode", ["lm", "lm-rl"])
def test_mesh11_bitwise_unmeshed(mode):
    arch = "zamba2-2.7b" if mode == "lm" else "granite-moe-1b-a400m"
    cfg = get_reduced_config(arch)
    want_losses, want = _steps(cfg, mode, None, lm_batches(cfg, mode))
    losses, got = mesh_lib.launch(_mesh11_rank, 1, device="cpu", model=1,
                                  args=(arch, mode), port=_port(),
                                  timeout_s=JOIN_S)
    assert losses == want_losses
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# decoding at (1, 2)


def _teacher_forced(params, cfg, tokens, mesh):
    """Prefill the first half, then decode the rest token by token."""
    p = tokens.shape[1] // 2
    with use_rules(mesh, RULES):
        h, _, cache = model_lib.prefill(params, tokens[:, :p], cfg=cfg,
                                        cache_seq_len=tokens.shape[1])
        out = [model_lib.logits_from_hidden(params, cfg, h)]
        for t in range(p, tokens.shape[1]):
            logits, _, cache = model_lib.serve_step(
                params, tokens[:, t:t + 1], cache, t, cfg=cfg)
            out.append(logits)
    return torch.cat(out, dim=1)


def _decode_rank(mesh, arch, tokens):
    cfg = get_reduced_config(arch)
    params = model_lib.shard_model(model_lib.init(cfg, seed=0), cfg, mesh,
                                   RULES)
    logits = _teacher_forced(params, cfg, tokens, mesh)
    sampled = gen_lib.generate(params, tokens[:, :4], 3, cfg=cfg,
                               num_steps=6, mesh=mesh, rules=RULES)
    sess = gen_lib.DecodeSession(params, cfg, max_batch=2, max_len=12,
                                 mesh=mesh, rules=RULES)
    first = sess.prefill_many([0, 1], [tokens[0, :3].numpy(),
                                       tokens[1, :5].numpy()], seeds=[5, 6])
    steps = [sess.step()["token"] for _ in range(4)]
    return sharding.gather_to_main(
        (logits, sampled["tokens"], [f["token"] for f in first], steps),
        mesh)


@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-2.7b",
                                  "granite-moe-1b-a400m"])
def test_decode_at_model_2(arch):
    cfg = get_reduced_config(arch)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 16)))
    want = _teacher_forced(model_lib.init(cfg, seed=0), cfg, tokens, None)
    ranks = mesh_lib.launch(_decode_rank, 2, device="cpu", model=2,
                            args=(arch, tokens), port=_port(),
                            timeout_s=JOIN_S)
    for logits, *_ in ranks:
        torch.testing.assert_close(logits, want, rtol=1e-5, atol=1e-5)
    (_, tok0, first0, steps0), (_, tok1, first1, steps1) = ranks
    assert torch.equal(tok0, tok1)
    assert [int(t) for t in first0] == [int(t) for t in first1]
    assert all(np.array_equal(a, b) for a, b in zip(steps0, steps1))


# ---------------------------------------------------------------------------
# what the model axis now takes


@pytest.mark.parametrize("arch", ["xlstm-125m", "llama-3.2-vision-90b"])
def test_mesh_model_refuses_xlstm_and_vlm(arch, capsys):
    """Once refused, the xLSTM mixers and the VLM's cross-attention now
    take a model axis: ``train.main --mesh-model 2`` trains, and
    ``shard_model`` splits their leaves."""
    runtime = train.main(["--mode", "lm", "--arch", arch, "--reduced",
                          "--mesh-model", "2", "--device", "cpu",
                          "--steps", "1", "--batch", "2", "--seq", "16"])
    assert np.isfinite(float(runtime.metrics["loss"]))
    assert "not ported yet" not in capsys.readouterr().err
    cfg = get_reduced_config(arch)
    params = model_lib.shard_model(model_lib.init(cfg, seed=0), cfg,
                                   _view(2), RULES)
    layer = params["blocks"][0]["l1"]["mixer"]
    assert layer.shard_dims, arch
    if arch == "llama-3.2-vision-90b":
        with use_rules(_view(2), RULES):
            assert attention.head_split(cfg) == 2
        assert layer["wk"].shape[1] == cfg.num_kv_heads // 2


def test_rules_other_than_megatron_are_data_only():
    """Once data only, every LM table now has layers behind it; the
    context-parallel table (ROADMAP item 27) and the agent's table are
    still refused."""
    assert sharding.rules_named("megatron") is RULES
    for name in sharding.RULE_SETS:
        if name in sharding.LM_RULES:
            assert sharding.rules_named(name) is sharding.RULE_SETS[name]
        else:
            with pytest.raises(NotImplementedError, match="not ported yet"):
                sharding.rules_named(name)
    assert dataclasses.is_dataclass(_view(2))
