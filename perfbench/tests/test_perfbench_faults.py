"""The check against broken runs, on the CPU at a tiny size: each cell's
run with the timed path broken underneath (``bench.run_cell``'s
``patch``) comes out not correct, once for each fault the cell can have:
a learner step that returns its state unchanged; half of the batch left
out, the mean taken over the rest; an answer or a token altered where it
is produced (the actors' behaviour logits and rewards, a generated
token). One chip runs no exchange between chips to leave out. And the
control (the reference at the precision below the configuration's in the
program's place) fails the check. CPU only; imports no JAX."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[:0] = [p for p in (ROOT, os.path.join(ROOT, "src"))
                if p not in sys.path]
HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

from perfbench import bench  # noqa: E402
from test_perfbench_runs import CELLS, SEED, SMALL, run  # noqa: E402


def unchanged(setup):
    """The step runs on copies: params and optimizer state stay."""
    inner = setup.step_fn

    def step(params, opt_state, i, batch):
        _, _, metrics = inner(copy.deepcopy(params),
                              copy.deepcopy(opt_state), i, batch)
        return params, opt_state, metrics
    setup.step_fn = step


def half(setup):
    """The learner sees half of each batch's columns (rows for lm)."""
    inner = setup.step_fn

    def step(params, opt_state, i, batch):
        if "tokens" in batch:
            cut = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        else:
            cut = {k: v[:, :v.shape[1] // 2] for k, v in batch.items()}
        return inner(params, opt_state, i, cut)
    setup.step_fn = step


def _altered_source(setup, alter):
    source = setup.source
    produce = source.next_batch

    def next_batch(params):
        batch = produce(params)
        alter(batch)
        return batch
    source.next_batch = next_batch


def altered_logits(setup):
    def alter(batch):
        batch["behavior_logits"][0, 0, 0] += 0.5
    _altered_source(setup, alter)


def altered_reward(setup):
    def alter(batch):
        batch["reward"][1, 0] = 1.0 - batch["reward"][1, 0]
    _altered_source(setup, alter)


def altered_token(setup):
    vocab = setup.cfg.vocab_size

    def alter(batch):
        tok = (batch["obs"][3, 0] + 1) % vocab
        batch["obs"][3, 0] = tok
        batch["action"][2, 0] = tok
    _altered_source(setup, alter)


FAULTS = [(cell, f) for cell in CELLS for f in (unchanged, half)]
FAULTS += [("impala_deep_atari.device_actors", altered_logits),
           ("impala_deep_atari.device_actors", altered_reward),
           ("granite_3_0_1b_a400m.lm_rl", altered_token)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_run_is_not_correct(cell, fault):
    out = run(cell, False, patch=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_check(cell):
    c = bench.prepare(cell, SEED, "cpu", overrides=SMALL[cell])
    bench.warm_up(c, 0)
    bench.free_program(c)
    numbers = c.setup.control("control")
    over = {k: v for k, v in numbers.items()
            if k in c.limits and v > c.limits[k]}
    assert over, (numbers, c.limits)


def test_a_state_left_unchanged_reads_one():
    c = bench.prepare("impala_deep_atari.learner_only", SEED, "cpu",
                      overrides=SMALL["impala_deep_atari.learner_only"],
                      patch=unchanged)
    bench.warm_up(c, 0)
    bench.free_program(c)
    numbers = c.setup.check()
    assert numbers["change_gap"] == pytest.approx(1.0)
    assert numbers["grad_gap"] == pytest.approx(1.0)

