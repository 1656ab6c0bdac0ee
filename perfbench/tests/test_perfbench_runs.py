"""Whole runs of every cell on the CPU at a tiny size (``bench.run_cell``
past its look for a card): the result's keys, its metrics by name and
unit, a traced run's per-layer metrics, and ``correct`` on a sound run.
The decoder runs in float32 here, so a sound run meets the limits set on
the card. CPU only; imports no JAX."""

import json
import os
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[:0] = [p for p in (ROOT, os.path.join(ROOT, "src"))
                if p not in sys.path]

from perfbench import bench  # noqa: E402

ATARI = {"config": {"agent": {"obs_shape": [20, 20, 4]}},
         "traffic": {"unroll_length": 5, "batch_size": 4, "timing_steps": 2,
                     "env": {"frames": 16, "min_len": 3, "scale": 2}}}
GRANITE = {"config": {"model": {
    "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
    "num_experts": 8, "num_experts_per_tok": 2, "moe_d_ff": 32,
    "vocab_size": 256, "num_groups": 2, "dtype": "float32"}},
    "traffic": {"batch_size": 4, "episode_length": 8, "seq_len": 16,
                "doc_len": 24}}
SMALL = {"impala_deep_atari.device_actors": ATARI,
         "impala_deep_atari.learner_only": ATARI,
         "granite_3_0_1b_a400m.lm_rl": GRANITE,
         "granite_3_0_1b_a400m.lm_pretrain": GRANITE}
CELLS = sorted(SMALL)
SEED = 2 ** 31 + 17          # past 32 signed bits


def run(cell, trace, **kw):
    return bench.run_cell(cell, SEED, 0.3, trace,
                          started=time.perf_counter(), device="cpu",
                          overrides=SMALL[cell], **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_and_reports_its_metrics(cell):
    man = bench.manifest()
    out = run(cell, False)
    assert out["correct"], out["checks"]
    want = {m["name"]: m["unit"]
            for m in bench.metrics_of(man, cell, "end_to_end")}
    assert {k: v["unit"] for k, v in out["metrics"].items()} == want
    assert all(v["value"] > 0 or k == "peak_mem_gib"
               for k, v in out["metrics"].items())
    assert set(out["checks"]) == set(bench.read_json("limits",
                                                     cell + ".json"))
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_its_layers(cell):
    man = bench.manifest()
    out = run(cell, True)
    assert out["correct"]
    want = {m["name"] for m in bench.metrics_of(man, cell, "per_layer")}
    got = set(out["metrics"])
    assert got <= want
    # the spans' readers and the whole step's read on any device; the
    # rooflines and the idle share read the card's trace
    assert {n for n in want if "_ms." in n or n.startswith("mfu.")} <= got
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_last_line_has_the_contracts_keys():
    out = run("impala_deep_atari.learner_only", True)
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
           "power_limit_w": 700.0}
    line = bench.result_line(out, dev, True)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert "breakdown" in line
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    json.loads(json.dumps(line))


def test_without_a_card_a_run_exits_nonzero_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "perfbench", "run.py"),
         "--workload", "impala_deep_atari.learner_only", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_same_seed_same_inputs():
    a = bench.prepare("impala_deep_atari.learner_only", SEED, "cpu",
                      overrides=ATARI)
    b = bench.prepare("impala_deep_atari.learner_only", SEED, "cpu",
                      overrides=ATARI)
    for x, y in zip(a.setup.params.parameters(), b.setup.params.parameters()):
        assert x.equal(y)
    ba, bb = a.setup.source.next_batch(None), b.setup.source.next_batch(None)
    assert all(ba[k].equal(bb[k]) for k in ba)
