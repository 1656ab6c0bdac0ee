"""``--mode rl-agent`` over coordinated processes (``--coordinator
HOST:PORT --num-processes N --process-id i``): each command is one rank
of the ``--mesh-data`` data mesh (``launch/multihost.py::bootstrap``
yields a ``DataMesh``), as the reference bootstraps every mode before its
``--mesh-data`` mesh spans the processes.

* Two coordinated processes of ``--mesh-data 2`` print the spawning
  command's log lines and write its final checkpoint, bit for bit: the
  default trainer, ``--replay elite``, and a run checkpointed at step 2,
  cut there and resumed by two coordinated processes.
* ``--actors host``: the actor threads' timing decides which parameter
  version acts, so two spawned runs already differ after the first step;
  the coordinated run matches the spawned one at step 0 and in every
  checkpoint leaf's shape.
* A mesh that does not match ``--num-processes`` is refused.
* The backend: NCCL on CUDA whatever the global process count (16
  processes over hosts of 8 GPUs, or 2 over hosts of 1), gloo only where
  this host's processes outnumber its GPUs or ``--backend gloo`` asks
  for it; ``--backend`` alone is refused.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from repro_torch import checkpoint as ckpt_lib
from repro_torch.launch import multihost
from repro_torch.launch import train

FLAGS = ["-m", "repro_torch.launch.train", "--mode", "rl-agent",
         "--mesh-data", "2", "--device", "cpu", "--batch", "8"]


def _steps(out):
    """The log's step lines without their wall-clock rates."""
    return [ln.split(" fps=")[0] for ln in out.splitlines()
            if ln.startswith("step")]


def _no_frames(line):
    step, _, rest = line.partition(" frames ")
    return step, rest.split(maxsplit=1)[1]


def _spawned(argv):
    from conftest import forced_cpu_env
    proc = subprocess.run([sys.executable, *FLAGS, *argv],
                          env=forced_cpu_env(1), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def _coordinated(argv):
    from conftest import run_coordinated
    res = run_coordinated(FLAGS + argv, 2, timeout=300)
    assert all(rc == 0 for rc, _ in res), "\n".join(o for _, o in res)
    # process 0 prints the log; process 1 only its bootstrap line
    assert "[process 1] rank 1 of 2 on cpu" in res[1][1]
    assert not _steps(res[1][1])
    return res[0][1]


def _flat(path):
    return ckpt_lib.load_flat(path)[0]


def _assert_same_checkpoint(one, two):
    flat_one, flat_two = _flat(one), _flat(two)
    assert set(flat_one) == set(flat_two) and flat_one
    for k in flat_one:
        assert np.array_equal(flat_one[k], flat_two[k]), k


@pytest.mark.parametrize("extra", [[], ["--replay", "elite"]],
                         ids=["trainer", "replay-elite"])
def test_coordinated_rl_agent_matches_the_spawned_run(extra, tmp_path):
    argv = ["--steps", "3", *extra]
    one = str(tmp_path / "one")
    two = str(tmp_path / "two")
    spawned = _spawned(argv + ["--checkpoint-dir", one])
    coordinated = _coordinated(argv + ["--checkpoint-dir", two])
    assert _steps(coordinated) == _steps(spawned) and len(
        _steps(spawned)) == 3
    _assert_same_checkpoint(os.path.join(one, "step_3"),
                            os.path.join(two, "step_3"))


def test_coordinated_rl_agent_host_actors(tmp_path):
    argv = ["--steps", "2", "--actors", "host"]
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    spawned = _steps(_spawned(argv + ["--checkpoint-dir", one]))
    coordinated = _steps(_coordinated(argv + ["--checkpoint-dir", two]))
    assert len(coordinated) == len(spawned) == 2
    assert coordinated[0] == spawned[0]
    flat_one = _flat(os.path.join(one, "step_2"))
    flat_two = _flat(os.path.join(two, "step_2"))
    assert {k: v.shape for k, v in flat_one.items()} == \
        {k: v.shape for k, v in flat_two.items()}
    assert all(np.isfinite(v).all() for v in flat_two.values()
               if v.dtype.kind == "f")


def test_coordinated_rl_agent_resumes_bitwise(tmp_path):
    whole, cut = str(tmp_path / "whole"), str(tmp_path / "cut")
    spawned = _spawned(["--steps", "4", "--checkpoint-dir", whole])
    _coordinated(["--steps", "4", "--checkpoint-every", "2",
                  "--checkpoint-dir", cut])
    shutil.rmtree(os.path.join(cut, "step_4"))
    resumed = _coordinated(["--steps", "4", "--checkpoint-dir", cut,
                            "--resume"])
    assert f"resumed {cut}/step_2 at step 2 (source state restored)" \
        in resumed
    # (a resumed run counts its frames from its own start)
    assert [_no_frames(ln) for ln in _steps(resumed)] == \
        [_no_frames(ln) for ln in _steps(spawned)[2:]]
    _assert_same_checkpoint(os.path.join(whole, "step_4"),
                            os.path.join(cut, "step_4"))


def test_a_mesh_unlike_the_process_count_is_refused():
    with pytest.raises(ValueError, match=r"the mesh is \(3,\) = 3 ranks"):
        train.main(["--mesh-data", "3", "--num-processes", "2",
                    "--coordinator", "127.0.0.1:1", "--device", "cpu"])
    with pytest.raises(ValueError, match=r"the mesh is \(1,\) = 1 ranks"):
        with multihost.bootstrap("127.0.0.1:1", 2, 0, data=1,
                                 device="cpu"):
            pass


# (device, --backend, LOCAL_WORLD_SIZE, visible GPUs) -> backend (None:
# the mesh's default, NCCL on CUDA)
BACKENDS = [
    ("cuda", None, "2", 2, None),        # 2 processes, 2 GPUs: NCCL
    ("cuda", None, None, 8, None),       # one of 16 over two 8-GPU hosts
    ("cuda", None, None, 1, None),       # one of 2 over two 1-GPU hosts
    ("cuda", None, "8", 8, None),        # torchrun, 8 a host of 8
    ("cuda", None, "2", 1, "gloo"),      # two processes share the card
    ("cuda", "gloo", None, 2, "gloo"),   # asked for
    ("cuda", "nccl", "2", 1, "nccl"),    # asked for
    ("cpu", None, "4", 0, None),         # the CPU mesh's gloo
]


@pytest.mark.parametrize("device,asked,local,visible,want", BACKENDS)
def test_the_backend_follows_this_hosts_processes(monkeypatch, device,
                                                  asked, local, visible,
                                                  want):
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    assert multihost.coordinated_backend(device, asked,
                                         visible=visible) == want


def test_backend_without_coordinator_is_refused(capsys):
    with pytest.raises(SystemExit):
        train.main(["--backend", "gloo", "--device", "cpu"])
    assert "--backend applies with --coordinator" in capsys.readouterr().err
