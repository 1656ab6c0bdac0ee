"""The multi-process bootstrap (``--coordinator HOST:PORT --num-processes
N --process-id i``, ``launch/multihost.py``) and the reference's flag
refusals:

* Two CLI processes joined by ``--coordinator`` train ``--mode lm
  --mesh-model 2`` to the same log lines and bitwise the same final
  checkpoint as the one command that spawns both ranks.
* ``--mesh-model`` with ``--mode rl-agent`` is refused, and so is
  ``--num-processes > 1`` without ``--coordinator``
  (``src/repro/launch/train.py:328-333``), both in the port and in the
  reference.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch import checkpoint as ckpt_lib
from repro_torch.launch import multihost
from repro_torch.launch import train

FLAGS = ["-m", "repro_torch.launch.train", "--mode", "lm", "--arch",
         "qwen3-4b", "--reduced", "--batch", "8", "--seq", "32", "--steps",
         "3", "--mesh-model", "2", "--device", "cpu"]


def _steps(out):
    return [ln.split(" tok/s=")[0] for ln in out.splitlines()
            if ln.startswith("step")]


def test_coordinated_processes_match_the_spawning_launch(tmp_path):
    from conftest import forced_cpu_env, run_coordinated
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    proc = subprocess.run(
        [sys.executable, *FLAGS, "--checkpoint-dir", one],
        env=forced_cpu_env(1), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    res = run_coordinated(FLAGS + ["--checkpoint-dir", two], 2, timeout=300)
    assert all(rc == 0 for rc, _ in res), "\n".join(o for _, o in res)
    # process 0 prints the log; process 1 prints only its bootstrap line
    assert _steps(res[0][1]) == _steps(proc.stdout) and _steps(proc.stdout)
    assert not _steps(res[1][1]) and "[process 1] rank 1 of 2" in res[1][1]
    flat_one, _ = ckpt_lib.load_flat(os.path.join(one, "step_3"))
    flat_two, _ = ckpt_lib.load_flat(os.path.join(two, "step_3"))
    assert set(flat_one) == set(flat_two)
    for k in flat_one:
        assert np.array_equal(flat_one[k], flat_two[k]), k


@pytest.mark.parametrize("argv,message", [
    (["--mesh-model", "2"], "--mesh-model applies to the LM paths"),
    (["--mode", "lm", "--num-processes", "2"],
     "--num-processes > 1 requires --coordinator"),
])
def test_the_references_flag_refusals(argv, message, capsys):
    with pytest.raises(SystemExit):
        train.main(argv + ["--device", "cpu"])
    assert message in capsys.readouterr().err
    from repro.launch import train as jtrain
    with pytest.raises(SystemExit):
        jtrain.main(argv)
    assert message in capsys.readouterr().err


def test_bootstrap_arguments():
    assert multihost.parse_coordinator("127.0.0.1:29511") == ("127.0.0.1",
                                                              29511)
    with pytest.raises(ValueError, match="HOST:PORT"):
        multihost.parse_coordinator("127.0.0.1")
    with pytest.raises(ValueError, match=r"the mesh is \(1, 2\) = 2 ranks"):
        with multihost.bootstrap("127.0.0.1:1", 3, 0, data=1, model=2,
                                 device="cpu"):
            pass
    with pytest.raises(ValueError, match="--process-id 2"):
        with multihost.bootstrap("127.0.0.1:1", 2, 2, data=1, model=2,
                                 device="cpu"):
            pass
