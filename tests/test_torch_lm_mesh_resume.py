"""Kill and resume of the LM paths' mesh runs through the entry point,
bitwise against uninterrupted runs:

* ``--mode lm --mesh-model 2`` (two ranks spawned by one command),
  SIGKILLed once its step-3 checkpoint has landed and resumed to the same
  horizon: the reference's acceptance test for its 2-D mesh
  (``tests/test_mesh2d.py:249``).
* The same run as two processes joined by ``--coordinator``, both
  SIGKILLed, resumed as two processes (``tests/test_checkpoint_sharded.py
  :325``'s counterpart).

Final parameters and AdamW state bitwise; the data iterator's position
rode in each rank's source state.
"""

import os

import numpy as np

from repro_torch import checkpoint as ckpt_lib

LM_FLAGS = ["-m", "repro_torch.launch.train", "--mode", "lm", "--arch",
            "qwen3-4b", "--reduced", "--batch", "8", "--seq", "32",
            "--steps", "6", "--mesh-model", "2", "--device", "cpu"]


def _cmd(ckpt_dir, extra=()):
    return LM_FLAGS + ["--checkpoint-dir", ckpt_dir, *extra]


def _assert_same_final(dir_a, dir_b):
    flat_a, _ = ckpt_lib.load_flat(os.path.join(dir_a, "step_6"))
    flat_b, _ = ckpt_lib.load_flat(os.path.join(dir_b, "step_6"))
    assert set(flat_a) == set(flat_b) and flat_a
    for k in flat_a:
        assert np.array_equal(flat_a[k], flat_b[k]), k
    state = ckpt_lib.restore_structured(os.path.join(dir_b, "step_3"),
                                        "source", process=1,
                                        num_processes=2)
    assert state["kind"] == "DataSource"
    assert state["iterator"]["offset"] == 3


def test_lm_mesh_model_sigkill_resume_bitwise(tmp_path):
    from conftest import prune_after, run_forced, sigkill_at_boundary
    dir_a, dir_b = str(tmp_path / "a"), str(tmp_path / "b")
    run_forced(_cmd(dir_a), devices=1, timeout=300)
    sigkill_at_boundary(_cmd(dir_b, ["--checkpoint-every", "3"]), dir_b, 3,
                        devices=1)
    prune_after(dir_b, 3)
    proc = run_forced(_cmd(dir_b, ["--resume"]), devices=1, timeout=300)
    assert "source state restored" in proc.stdout
    _assert_same_final(dir_a, dir_b)


def test_two_process_sigkill_resume_bitwise(tmp_path):
    from conftest import prune_after, run_coordinated
    dir_a, dir_b = str(tmp_path / "a"), str(tmp_path / "b")
    res = run_coordinated(_cmd(dir_a), 2, timeout=300)
    assert all(rc == 0 for rc, _ in res), "\n".join(o for _, o in res)
    marker = os.path.join(dir_b, "step_3", "manifest.json")
    run_coordinated(_cmd(dir_b, ["--checkpoint-every", "3"]), 2,
                    kill_marker=marker)
    assert os.path.exists(marker)
    prune_after(dir_b, 3)
    res = run_coordinated(_cmd(dir_b, ["--resume"]), 2, timeout=300)
    assert all(rc == 0 for rc, _ in res), "\n".join(o for _, o in res)
    assert any("resumed" in o and "at step 3" in o for _, o in res)
    _assert_same_final(dir_a, dir_b)
