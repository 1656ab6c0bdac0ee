"""LM checkpoints across packages: a reduced ``--mode lm`` run checkpointed
by the JAX package and resumed by the port, and one checkpointed by the
port and resumed by the JAX package, for ``qwen3-4b``,
``granite-moe-1b-a400m`` and ``xlstm-125m`` (the mLSTM and sLSTM leaves). Both packages write the reference's layout
(block leaves stacked on the group axis, AdamW's ``mu`` and ``nu`` as
trees; ``repro_torch.convert.LMCheckpointLayout``), and the data
iterator's state (seed, offset) crosses with them, so the resumed run
continues the uninterrupted one: its next steps' losses, and its final
parameters and optimizer state, are held at tests/test_torch_lm_learner.py's
float32 tolerances (1e-5; at most one element in 10,000 of a leaf within
half an AdamW step, that file's near-eps allowance).

An ``--mode lm-rl`` checkpoint does not cross: the episode generator's
state is a threefry key in the reference and a ``torch.Generator`` here.
The port refuses such a resume up front; the reference, which is not
edited, raises ``KeyError('key')`` on the port's source state after
restoring the learner state (ROADMAP.md §3)."""

import os
import shutil

import numpy as np
import pytest
import torch

from repro.core.runtime import Runtime as JRuntime
from repro.launch import train as jtrain
from repro_torch import checkpoint as ckpt_lib
from repro_torch.core.runtime import Runtime as TRuntime
from repro_torch.launch import train as ttrain

# The suite runs several test processes side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

STEPS = 4
TOL = dict(rtol=1e-5, atol=1e-5)
STEP_ATOL = 3e-4 / 2     # half of AdamW's largest first step at lr 3e-4
ARCHS = ["qwen3-4b", "granite-moe-1b-a400m", "xlstm-125m"]


def _argv(arch, directory, *extra):
    return ["--mode", "lm", "--arch", arch, "--reduced", "--batch", "2",
            "--seq", "16", "--steps", str(STEPS), "--checkpoint-dir",
            directory, *extra]


def _run(package, argv, monkeypatch):
    """``train.main(argv)`` of ``package`` ("jax" or "torch"); returns
    {step: loss} as the Runtime logged them."""
    runtime, main = ((JRuntime, jtrain.main) if package == "jax"
                     else (TRuntime, ttrain.main))
    losses = {}
    log = runtime._log

    def record(self, step, t0):
        losses[step] = float(self.metrics["loss"])
        log(self, step, t0)

    with monkeypatch.context() as m:
        m.setattr(runtime, "_log", record)
        main(argv + (["--device", "cpu"] if package == "torch" else []))
    return losses


def _assert_checkpoints_close(path, want_path):
    got, meta = ckpt_lib.load_flat(path)
    want, want_meta = ckpt_lib.load_flat(want_path)
    assert meta == want_meta and meta["step"] == STEPS
    assert set(got) == set(want)
    assert any(k.startswith("opt_state/mu/blocks/") for k in got)
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape and g.dtype == w.dtype, key
        np.testing.assert_allclose(g, w, rtol=TOL["rtol"],
                                   atol=max(TOL["atol"], STEP_ATOL),
                                   err_msg=key)
        outside = int((~np.isclose(g, w, **TOL)).sum())
        assert outside <= max(1, w.size // 10_000), (key, outside)
    source = ckpt_lib.restore_structured(path, "source")
    assert source == ckpt_lib.restore_structured(want_path, "source") == {
        "kind": "DataSource", "iterator": {
            "kind": "PackedBatchIterator", "seed": 0, "offset": STEPS}}


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_checkpoint_resumes_across_packages(tmp_path, monkeypatch,
                                               capsys, arch, writer,
                                               reader):
    d_ref, d = str(tmp_path / "ref"), str(tmp_path / "run")
    want = _run(writer, _argv(arch, d_ref, "--checkpoint-every", "2"),
                monkeypatch)
    assert sorted(os.listdir(d_ref)) == ["step_2", f"step_{STEPS}"]
    os.makedirs(d)
    shutil.copytree(os.path.join(d_ref, "step_2"),
                    os.path.join(d, "step_2"))
    capsys.readouterr()
    got = _run(reader, _argv(arch, d, "--resume"), monkeypatch)
    assert (f"resumed {d}/step_2 at step 2 (source state restored)"
            in capsys.readouterr().out)
    assert sorted(got) == [2, 3]
    for step in got:
        np.testing.assert_allclose(got[step], want[step], **TOL,
                                   err_msg=f"loss at step {step}")
    _assert_checkpoints_close(os.path.join(d, f"step_{STEPS}"),
                              os.path.join(d_ref, f"step_{STEPS}"))


LM_RL = ["--mode", "lm-rl", "--arch", "qwen3-4b", "--reduced", "--batch",
         "2", "--seq", "8", "--steps", "1", "--checkpoint-dir"]


def test_lm_rl_resume_across_packages_is_refused(tmp_path, monkeypatch):
    d = str(tmp_path / "jax")
    _run("jax", LM_RL + [d], monkeypatch)
    with pytest.raises(SystemExit, match="threefry key"):
        ttrain.main(LM_RL + [d, "--resume", "--device", "cpu"])
    d = str(tmp_path / "torch")
    _run("torch", LM_RL + [d], monkeypatch)
    with pytest.raises(KeyError, match="key"):
        jtrain.main(LM_RL + [d, "--resume"])
