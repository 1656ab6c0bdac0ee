"""The port's compiled session functions (``core/generate.py::session_fns``)
on the CPU, where ``step`` is the eager ``_session_step``, held to the
reference's ``session_fns`` and to what the CUDA graph of the decode step
needs from the state:
  * the cache keyed by the config's value in both packages, every arch's
    config a well-behaved key in both,
  * cache leaves, pos and last written in place across steps (dense,
    hybrid, MoE and xLSTM decoders), one graph key a session and across
    sessions one after another (recycled, zeroed buffers),
  * ``generate`` through static buffers per shape: one set for two
    calls, its stacked baselines those of the eager steps,
  * the params-swap rules: in-place updates keep the key and are read by
    the next step, another module or rebound storages change it,
  * a session under a mesh is eager by rule (``compiled`` False),
  * the launch counts a replay adds (``ops.record_replay``).
The card's side (capture, replay, bitwise against eager, K3 per replay) is
in tests/test_torch_session_graph_gpu.py and chip_smoke.py phase 29."""

import gc

import numpy as np
import pytest
import torch

from repro.analysis.trace_audit import audit_static_key as jax_static_key
from repro.configs import get_reduced_config as jax_reduced
from repro.core import generate as jgen
from repro_torch.analysis.trace_audit import audit_static_key
from repro_torch.configs import ARCHS, get_reduced_config
from repro_torch.core import generate as G
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh2D
from repro_torch.models import model as model_lib
from repro_torch.tree import leaves

torch.set_num_threads(1)

DECODERS = ["qwen3-4b", "zamba2-2.7b", "granite-moe-1b-a400m", "xlstm-125m"]


def _session(arch, params=None, *, slots=4, max_len=16, cfg=None):
    cfg = cfg or get_reduced_config(arch)
    params = params if params is not None else model_lib.init(cfg, seed=0)
    sess = G.DecodeSession(params, cfg, max_batch=slots, max_len=max_len)
    rng = np.random.default_rng(3)
    sess.prefill_many(range(slots),
                      list(rng.integers(0, cfg.vocab_size, (slots, 4))),
                      seeds=list(range(slots)))
    return sess


def _storage(state):
    return [(x, x.data_ptr()) for x in
            leaves(state["cache"]) + [state["pos"], state["last"]]]


def test_session_fns_keyed_by_value_in_both_packages():
    assert G.session_fns(get_reduced_config("qwen3-4b")) \
        is G.session_fns(get_reduced_config("qwen3-4b"))
    assert jgen.session_fns(jax_reduced("qwen3-4b")) \
        is jgen.session_fns(jax_reduced("qwen3-4b"))
    assert G.session_fns(get_reduced_config("qwen3-4b")) \
        is not G.session_fns(get_reduced_config("xlstm-125m"))


@pytest.mark.parametrize("arch", ARCHS)
def test_every_config_is_a_value_key_in_both_packages(arch):
    assert audit_static_key(lambda: get_reduced_config(arch), arch) == []
    assert jax_static_key(lambda: jax_reduced(arch), arch) == []


@pytest.mark.parametrize("arch", DECODERS)
def test_cache_leaves_keep_their_storage_across_steps(arch):
    sess = _session(arch)
    fns = G.session_fns(sess.cfg)
    before = _storage(sess._state)
    key = fns.graph_key(sess.params, sess._state)
    pos0 = sess._state["pos"].clone()
    for _ in range(3):
        sess.step()
    after = _storage(sess._state)
    assert all(a is b and pa == pb for (a, pa), (b, pb) in zip(before, after))
    assert fns.graph_key(sess.params, sess._state) == key
    assert torch.equal(sess._state["pos"], pos0 + 3)
    assert not sess.compiled


def test_sessions_one_after_another_share_zeroed_buffers():
    cfg = get_reduced_config("zamba2-2.7b")
    params = model_lib.init(cfg, seed=0)
    fns = G.session_fns(cfg)
    first = _session("zamba2-2.7b", params)
    first.step()
    key = fns.graph_key(params, first._state)
    made = fns.allocations
    del first
    gc.collect()
    second = G.DecodeSession(params, get_reduced_config("zamba2-2.7b"),
                             max_batch=4, max_len=16)
    assert fns.allocations == made
    assert fns.graph_key(params, second._state) == key
    for x in leaves(second._state["cache"]):
        assert not x.any()
    assert not second._state["pos"].any()
    # a second live session of the same shape takes buffers of its own
    third = G.DecodeSession(params, cfg, max_batch=4, max_len=16)
    assert fns.allocations == made + 1
    assert fns.graph_key(params, third._state) != key


def _eager_generate(params, prompt, seed, cfg, n):
    """``generate`` by hand from the plain functions: prefill, then
    ``_session_step`` on the prefill's own state."""
    b = prompt.shape[0]
    gens = [torch.Generator().manual_seed(seed + i) for i in range(b)]
    temp = torch.ones((b,), dtype=torch.float32)
    state, out = G._session_prefill(params, torch.as_tensor(prompt), gens,
                                    temp, cfg=cfg,
                                    cache_seq_len=prompt.shape[1] + n)
    outs = [out]
    for _ in range(n - 1):
        state, out = G._session_step(params, state, cfg=cfg)
        outs.append(out)
    return {k: torch.stack([o[k] for o in outs], 1) for k in outs[0]}


@pytest.mark.parametrize("arch", ["qwen3-4b", "xlstm-125m"])
def test_generate_reuses_static_buffers_and_keeps_each_baseline(arch):
    cfg = get_reduced_config(arch)
    params = model_lib.init(cfg, seed=0)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 4))
    fns = G.session_fns(cfg)
    made = fns.allocations
    outs = [G.generate(params, prompt, 5, cfg=get_reduced_config(arch),
                       num_steps=6) for _ in range(2)]
    assert fns.allocations == made + 1
    want = _eager_generate(params, prompt, 5, cfg, 6)
    for out in outs:
        assert torch.equal(out["baseline"], want["baseline"])
        assert torch.equal(out["logprob"], want["logprob"])
        assert torch.equal(out["tokens"][:, 4:], want["token"])
    # the steps' baselines differ: none is a view of a later step's
    assert len(set(want["baseline"][0].tolist())) > 1


def test_params_swap_rules():
    cfg = get_reduced_config("qwen3-4b")
    params = model_lib.init(cfg, seed=0)
    sess = _session("qwen3-4b", params)
    fns = G.session_fns(cfg)
    key = fns.graph_key(params, sess._state)
    # updated in place (as the optimizers do): the same key, and the next
    # step reads the new weights
    with torch.no_grad():
        for p in params.parameters():
            p.mul_(1.5)
    assert fns.graph_key(params, sess._state) == key
    ref = _session("qwen3-4b", model_lib.init(cfg, seed=0))
    with torch.no_grad():
        for p in ref.params.parameters():
            p.mul_(1.5)
    got, want = sess.step(), ref.step()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    # another module: another key
    other = model_lib.init(cfg, seed=1)
    sess.params = other
    assert fns.graph_key(other, sess._state) != key
    # rebound storages of the same module: another key
    sess.params = params
    params.embed.data = params.embed.data.clone()
    assert fns.graph_key(params, sess._state) != key


def test_a_session_under_a_mesh_is_eager_by_rule():
    from repro_torch.distributed.sharding import MEGATRON_RULES
    cfg = get_reduced_config("qwen3-4b")
    mesh = Mesh2D(rank=0, data=1, model=1, device=torch.device("cpu"),
                  backend="gloo")
    fns = G.session_fns(cfg, mesh, MEGATRON_RULES)
    assert fns is G.session_fns(get_reduced_config("qwen3-4b"), mesh,
                                dict(MEGATRON_RULES))
    assert not fns.compiled and G.session_fns(cfg).compiled
    params = model_lib.init(cfg, seed=0)
    meshed = G.DecodeSession(params, cfg, max_batch=2, max_len=16, mesh=mesh,
                             rules=MEGATRON_RULES)
    plain = G.DecodeSession(params, cfg, max_batch=2, max_len=16)
    assert not meshed.compiled
    prompt = np.arange(4)
    a = meshed.prefill_into(0, prompt, seed=3)
    b = plain.prefill_into(0, prompt, seed=3)
    assert a["token"] == b["token"]
    for _ in range(3):
        a, b = meshed.step(), plain.step()
        assert a["token"][0] == b["token"][0]


def test_a_replay_adds_its_captured_launches():
    ops.reset_stats()
    assert ops.take_captured() == dict.fromkeys(ops.stats(), 0)
    launches = dict(ops.stats(), decode_attention=36)
    for _ in range(3):
        ops.record_replay(launches)
    assert ops.stats()["decode_attention"] == 108
    assert ops.stats()["flash_attention"] == 0
    ops.reset_stats()
    assert ops.stats()["decode_attention"] == 0
