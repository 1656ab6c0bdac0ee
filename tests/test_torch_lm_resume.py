"""Resume of the LM modes, as tests/test_resume.py pins it for the
reference: a ``--mode lm`` or ``--mode lm-rl`` run (reduced configs, on
the CPU) that is cut and resumed ends BITWISE where an uninterrupted run
of the same ``--steps`` ends — parameters, AdamW state and the source's
state (the packed iterator's position, or the episode generator's state)
— whether it was cut at a CLI boundary (a ``--checkpoint-every``
checkpoint, the later ones deleted as if the process had been killed) or
by a crash after a completed step (the crash checkpoint). A resume with
another ``--mode`` or ``--arch`` fails up front, naming the key."""

import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.core.runtime import Runtime
from repro_torch.launch import train

# The suite runs several test processes side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

STEPS = 6
MODES = {
    "lm": ["--mode", "lm", "--arch", "zamba2-2.7b", "--attn-impl", "kernel",
           "--ssd-impl", "kernel", "--seq", "16"],
    "lm-rl": ["--mode", "lm-rl", "--arch", "qwen3-4b", "--attn-impl",
              "kernel", "--seq", "8"],
}


def _argv(mode, directory, *extra):
    return MODES[mode] + ["--reduced", "--device", "cpu", "--batch", "2",
                          "--steps", str(STEPS), "--checkpoint-dir",
                          directory, *extra]


def _assert_final_checkpoints_equal(d_ref, d):
    flat_ref, meta_ref = ckpt_lib.load_flat(os.path.join(d_ref,
                                                         f"step_{STEPS}"))
    flat, meta = ckpt_lib.load_flat(os.path.join(d, f"step_{STEPS}"))
    assert meta == meta_ref and meta["step"] == STEPS
    assert set(flat) == set(flat_ref)
    assert any(k.startswith("opt_state/") for k in flat)
    for k in flat:
        np.testing.assert_array_equal(flat[k], flat_ref[k], err_msg=k)
    source = ckpt_lib.restore_structured(os.path.join(d, f"step_{STEPS}"),
                                         "source")
    source_ref = ckpt_lib.restore_structured(
        os.path.join(d_ref, f"step_{STEPS}"), "source")
    assert source["kind"] == source_ref["kind"]
    if source["kind"] == "DataSource":
        assert source["iterator"] == source_ref["iterator"] == {
            "kind": "PackedBatchIterator", "seed": 0, "offset": STEPS}
    else:
        np.testing.assert_array_equal(np.asarray(source["generator"]),
                                      np.asarray(source_ref["generator"]))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cli_boundary_resume_bit_identical(tmp_path, mode, capsys):
    d_ref, d = str(tmp_path / "ref"), str(tmp_path / "run")
    ref = train.main(_argv(mode, d_ref))
    train.main(_argv(mode, d, "--checkpoint-every", "3"))
    assert sorted(os.listdir(d)) == ["step_3", f"step_{STEPS}"]
    shutil.rmtree(os.path.join(d, f"step_{STEPS}"))  # killed after step 3
    capsys.readouterr()
    resumed = train.main(_argv(mode, d, "--resume"))
    out = capsys.readouterr().out
    assert f"resumed {d}/step_3 at step 3 (source state restored)" in out
    assert [int(ln.split()[1]) for ln in out.splitlines()
            if ln.startswith("step ")] == [3, 4, 5]
    for (k, a), b in zip(ref.params.state_dict().items(),
                         resumed.params.state_dict().values()):
        assert torch.equal(a, b), k
    _assert_final_checkpoints_equal(d_ref, d)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_crash_resume_bit_identical(tmp_path, mode, monkeypatch, capsys):
    d_ref, d = str(tmp_path / "ref"), str(tmp_path / "run")
    train.main(_argv(mode, d_ref))
    log = Runtime._log

    def killed_after_step_3(self, step, t0):
        if step == 3:
            raise KeyboardInterrupt("killed")
        log(self, step, t0)

    with monkeypatch.context() as m:
        m.setattr(Runtime, "_log", killed_after_step_3)
        with pytest.raises(KeyboardInterrupt):
            train.main(_argv(mode, d))
    assert sorted(os.listdir(d)) == ["step_4"]     # the crash checkpoint
    capsys.readouterr()
    train.main(_argv(mode, d, "--resume"))
    assert f"resumed {d}/step_4 at step 4" in capsys.readouterr().out
    _assert_final_checkpoints_equal(d_ref, d)


@pytest.mark.parametrize("other,key", [
    (["--mode", "lm", "--arch", "qwen3-4b"], "arch"),
    (["--mode", "lm-rl", "--arch", "zamba2-2.7b"], "mode"),
    (["--mode", "rl-agent"], "mode"),
])
def test_resume_with_another_mode_or_arch_fails_up_front(tmp_path, other,
                                                         key):
    d = str(tmp_path)
    train.main(MODES["lm"] + ["--reduced", "--device", "cpu", "--batch", "2",
                              "--steps", "1", "--checkpoint-dir", d])
    with pytest.raises(SystemExit, match=f"different configuration "
                                         f"\\({key}: checkpoint="):
        train.main(other + ["--reduced", "--device", "cpu", "--batch", "2",
                            "--steps", "2", "--seq", "16",
                            "--checkpoint-dir", d, "--resume"])
