"""Each cell run once on the card through the benchmark's command,
briefly: exit code 0, the last line the result, ``correct`` true. Needs an
NVIDIA GPU and nvcc; every case skips without one:

    python3 -m pytest -q -m gpu perfbench/tests/test_perfbench_gpu.py
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = ["impala_deep_atari.device_actors", "impala_deep_atari.learner_only",
         "granite_3_0_1b_a400m.lm_rl", "granite_3_0_1b_a400m.lm_pretrain"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_runs_on_the_card(card, cell):
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 3), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
