"""The port's trace audit (``analysis/trace_audit.py``): each of its three
contracts flags a seeded fault, as tests/test_analysis.py's trace_audit
fixtures do for the reference's (an identity-hashed config, a step that
rebinds a donated cache leaf, a rules table naming a stale mesh axis, a
compiled-session cache keyed by identity), and the port's real entries
and the CLI are clean."""

import json

import numpy as np
import pytest
import torch

from repro.analysis.trace_audit import audit_static_key as jax_static_key
from repro_torch.analysis import trace_audit as ta
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.configs import get_reduced_config
from repro_torch.core import generate as G
from repro_torch.distributed.sharding import MEGATRON_RULES
from repro_torch.models import model as model_lib

torch.set_num_threads(1)


def _rules(findings):
    return {f.rule for f in findings}


class _IdHashCfg:
    """__eq__ by value but __hash__ by identity: every freshly built (but
    equal) config would key a cache entry, and a capture, of its own."""

    def __init__(self, d):
        self.d = d

    def __eq__(self, other):
        return isinstance(other, _IdHashCfg) and self.d == other.d

    __hash__ = object.__hash__


class _UnhashableCfg:
    def __init__(self, d):
        self.d = d

    def __eq__(self, other):           # defining __eq__ kills __hash__
        return isinstance(other, _UnhashableCfg) and self.d == other.d


@pytest.mark.parametrize("make,flagged", [
    (lambda: _IdHashCfg(8), True), (lambda: _UnhashableCfg(8), True),
    (lambda: (1, 2), False), (lambda: get_reduced_config("qwen3-4b"), False),
])
def test_static_key_flags_what_the_reference_flags(make, flagged):
    got = ta.audit_static_key(make, "fixture")
    assert _rules(got) == ({"retrace-hazard"} if flagged else set())
    assert bool(jax_static_key(make, "fixture")) == flagged


def _session_state():
    cfg = get_reduced_config("qwen3-4b")
    params = model_lib.init(cfg, seed=0)
    sess = G.DecodeSession(params, cfg, max_batch=2, max_len=8)
    sess.prefill_into(0, np.arange(3), seed=0)
    return cfg, params, sess


def test_audit_entry_flags_a_step_that_rebinds_a_cache_leaf():
    cfg, params, sess = _session_state()

    def make():
        state = sess._state
        donated = {"cache": state["cache"], "pos": state["pos"]}

        def call():
            logits, baseline, cache = model_lib.serve_step(
                params, state["last"][:, None], state["cache"],
                state["pos"], cfg=cfg)
            # the fault: a fresh k leaf in place of the written one
            leaf = cache["block"]["l0"]
            leaf["k"] = leaf["k"].clone()
            return {"cache": cache, "pos": state["pos"]}
        return donated, call

    findings, summary = ta.audit_entry(ta.InPlaceEntry("fixture-rebind",
                                                       make))
    assert _rules(findings) == {"donation-rebound"}
    assert summary["rebound"] == 1 and "l0/k" in findings[0].message


def test_audit_entry_passes_an_in_place_step():
    cfg, params, sess = _session_state()
    fns = G.session_fns(cfg)

    def make():
        donated = {k: sess._state[k] for k in ("cache", "pos", "last")}

        def call():
            state, _ = fns.step(params, sess._state)
            return {k: state[k] for k in ("cache", "pos", "last")}
        return donated, call

    assert ta.audit_entry(ta.InPlaceEntry("fixture", make))[0] == []


def test_audit_rules_flags_a_stale_mesh_axis():
    cfg = get_reduced_config("qwen3-4b")
    params = model_lib.init(cfg, seed=0)
    axes, shapes = model_lib.stacked_axes(
        params, cfg, {n: p.shape for n, p in params.named_parameters()})
    mesh = ta.AbstractMesh(2, 2)
    stale = dict(MEGATRON_RULES, heads="tensor")
    findings, _ = ta.audit_rules(axes, shapes, mesh, stale, "fixture")
    assert _rules(findings) == {"sharding-unknown-axis"}
    assert "tensor" in findings[0].message
    # a mesh whose sizes know an axis its names do not: a spec on it
    ghost = ta.AbstractMesh(2, 2, axis_names=("data",))
    findings, _ = ta.audit_rules(axes, shapes, ghost, MEGATRON_RULES,
                                 "fixture")
    assert _rules(findings) == {"sharding-unknown-axis"}
    assert ta.audit_rules(axes, shapes, mesh, MEGATRON_RULES, "ok")[0] == []


def test_audit_recapture_flags_a_cache_keyed_by_identity(monkeypatch):
    monkeypatch.setattr(G, "session_fns",
                        lambda cfg, mesh=None, rules=None:
                        G._SessionFns(cfg, mesh, rules))
    findings, summary = ta.audit_recapture()
    assert _rules(findings) == {"retrace-hazard"}
    assert not summary["ok"]


def test_the_ports_real_entries_are_clean():
    findings, summaries = ta.audit_traces(archs=["qwen3-4b", "xlstm-125m"])
    assert findings == []
    names = {s["entry"] for s in summaries}
    assert {"session_fns[qwen3-4b]", "make_train_step[catch]",
            "make_recurrent_train_step[catch]",
            "make_lm_train_step[qwen3-4b]",
            "make_lm_pretrain_step[qwen3-4b]",
            "spec_for[xlstm-125m]"} <= names
    assert all(s["ok"] for s in summaries)


def test_cli_runs_the_trace_audit(tmp_path, capsys):
    report = tmp_path / "report.json"
    assert analysis_main(["--archs", "qwen3-4b", "--report",
                          str(report)]) == 0
    out = capsys.readouterr().out
    assert "trace entries audited" in out
    assert "0 unwaived finding(s)" in out
    entries = json.loads(report.read_text())["trace_entries"]
    assert any(e["entry"].startswith("session_fns.step") for e in entries)


# ---------------------------------------------------------------------------
# the compiled rl-agent entries and admissions (core/compiled.py)


def test_the_unroll_and_the_compiled_keys_are_clean():
    findings, summary = ta.audit_entry(ta._unroll_entry())
    assert findings == [] and summary["rebound"] == 0
    assert summary["entry"] == "DeviceSource.next_batch[catch]"
    findings, summaries = ta.audit_compiled_keys()
    assert findings == []
    assert {s["entry"] for s in summaries} == {
        "make_train_step[catch, 3 rates]",
        "make_recurrent_train_step[catch, 3 rates]",
        "build_lm_rl[qwen3-4b, 3 steps]", "build_lm[qwen3-4b, 3 steps]",
        "HostLoopSource.policy[catch]", "admit[qwen3-4b]"}
    assert all(s["graph_keys"] == 1 and s["rates"] == 3
               for s in summaries if "rates" in s)
    assert all(s["graph_keys"] == 1 and s["scalars"] == 3
               for s in summaries if "scalars" in s)
    admit = next(s for s in summaries if s["entry"] == "admit[qwen3-4b]")
    assert admit["graph_keys"] == admit["row_buckets"] == 3


def test_audit_entry_flags_an_unroll_that_rebinds_its_carry(monkeypatch):
    from repro_torch.core import compiled

    plain = compiled.Unroll._step

    def rebinding(self, agent):         # the fault: a fresh carry
        rollout = plain(self, agent)
        self.carry = type(self.carry)(x.clone() if isinstance(x, torch.Tensor)
                                      else x for x in self.carry)
        return rollout

    monkeypatch.setattr(compiled.Unroll, "_step", rebinding)
    findings, _ = ta.audit_entry(ta._unroll_entry())
    assert _rules(findings) == {"donation-rebound"}


def test_audit_flags_a_rate_that_is_not_a_device_scalar(monkeypatch):
    """An optimizer whose scalars are fresh tensors each step: a graph
    captured at one step would read the first step's rate forever."""
    import repro_torch.optim as optim

    made = optim.make_optimizer

    def fresh_scalars(train_cfg):
        opt = made(train_cfg)

        def stage(step, device):
            held = opt.stage(step, device)
            return {k: v.clone() for k, v in held.items()}
        return opt._replace(stage=stage)

    monkeypatch.setattr(optim, "make_optimizer", fresh_scalars)
    findings, summary = ta._learner_keys(False)
    assert _rules(findings) == {"retrace-hazard"} and not summary["ok"]


def test_audit_flags_admissions_that_rebind_the_session(monkeypatch):
    admit = G._SessionFns.admit

    def rebinding(self, params, state, *args, **kwargs):
        out = admit(self, params, state, *args, **kwargs)
        state["pos"] = state["pos"].clone()     # the fault
        return out

    monkeypatch.setattr(G._SessionFns, "admit", rebinding)
    findings, summary = ta._admission_keys()
    assert _rules(findings) == {"retrace-hazard"}
    assert summary["graph_keys"] > summary["row_buckets"]


@pytest.mark.parametrize("pretrain", [False, True], ids=["lm-rl", "lm"])
def test_audit_flags_an_lm_step_left_eager(monkeypatch, pretrain):
    """A builder that hands Runtime the plain LM step (the eager path the
    reference's jit replaced) is flagged."""
    from repro_torch.core import compiled
    from repro_torch.launch import train

    build = train.build_lm if pretrain else train.build_lm_rl

    class Plain(compiled.TrainStep):      # the fault: no static buffers
        def inputs(self, batch):
            return {k: v.clone() for k, v in batch.items()}

    def eager(args, mesh=None):
        source, step_fn, params, opt_state, extras = build(args, mesh)
        return (source, Plain(step_fn.step_fn, step_fn.opt), params,
                opt_state, extras)

    monkeypatch.setattr(train, "build_lm" if pretrain else "build_lm_rl",
                        eager)
    findings, summary = ta._lm_learner_keys(pretrain)
    assert _rules(findings) == {"retrace-hazard"} and not summary["ok"]


def test_audit_flags_a_policy_rebound_by_its_sync(monkeypatch):
    """A weight sync that replaces the actor copy instead of loading into
    it: a captured policy would go on reading the old weights."""
    import copy

    from repro_torch.core.sources import HostLoopSource

    def rebinding(self, params):
        self._actor = copy.deepcopy(params).requires_grad_(False)

    monkeypatch.setattr(HostLoopSource, "_sync", rebinding)
    findings, summary = ta._policy_keys()
    assert _rules(findings) == {"retrace-hazard"} and not summary["ok"]
