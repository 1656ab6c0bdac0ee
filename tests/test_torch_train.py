"""The port's training entry point: it trains on the CPU when asked, raises
when CUDA is asked for on a host without a GPU, refuses what is not ported
with a message that says so, and the package (and chip_smoke.py) imports
nothing of JAX or of the JAX package."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.launch import train

# The suite runs several test processes side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


@pytest.mark.parametrize("agent,env", [("minatar", "catch"),
                                       ("deep", "gridworld")])
def test_main_trains_on_cpu(agent, env, capsys):
    runtime = train.main(["--mode", "rl-agent", "--env", env, "--agent",
                          agent, "--device", "cpu", "--steps", "3",
                          "--batch", "8"])
    assert runtime.frames == 3 * 20 * 8
    assert np.isfinite(float(runtime.metrics["loss"]))
    assert next(runtime.params.parameters()).device.type == "cpu"
    out = capsys.readouterr().out
    assert "step     2" in out and "fps=" in out


def test_main_sync_scan_on_cpu():
    before = ops.stats()["vtrace"]
    runtime = train.main(["--sync", "--vtrace-impl", "scan", "--device",
                          "cpu", "--steps", "2", "--batch", "4"])
    assert np.isfinite(float(runtime.metrics["loss"]))
    assert ops.stats()["vtrace"] == before   # CPU never counts a launch


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--steps", "1", "--batch", "4"])


@pytest.mark.parametrize("mode", ["lm-rl", "lm"])
def test_lm_modes_without_gpu_raise(mode):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--mode", mode, "--reduced", "--steps", "1"])


@pytest.mark.parametrize("argv,label,keys", [
    (["--mode", "lm-rl", "--arch", "qwen3-4b", "--attn-impl", "kernel"],
     "fps", ("reward/step=", "pg_loss=", "entropy_loss=")),
    (["--mode", "lm", "--arch", "zamba2-2.7b", "--attn-impl", "kernel",
      "--ssd-impl", "kernel"], "tok/s", ("loss=",)),
])
def test_lm_modes_train_on_cpu(argv, label, keys, capsys):
    runtime = train.main(argv + ["--reduced", "--device", "cpu", "--steps",
                                 "2", "--batch", "2", "--seq", "16"])
    assert runtime.frames == 2 * 2 * 16
    assert all(np.isfinite(float(v)) for v in runtime.metrics.values())
    assert next(runtime.params.parameters()).device.type == "cpu"
    out = capsys.readouterr().out
    assert "step     1" in out and f" {label}=" in out \
        and f" {label}_avg=" in out
    assert all(k in out for k in keys)


# (the first case, xlstm-125m under --mesh-model 2, went with its refusal:
# the xLSTM mixers take a model axis; the next two, --coordinator with
# --num-processes or --mesh-data for rl-agent, with theirs: rl-agent runs
# over coordinated processes (tests/test_torch_multihost_rl.py); the id
# of the last stays)
@pytest.mark.parametrize("argv,message", [
    pytest.param(["--no-such-flag"], "unrecognized", id="argv3-unrecognized"),
])
def test_unported_options_exit_with_a_clear_error(argv, message, capsys):
    with pytest.raises(SystemExit):
        train.main(argv + ["--device", "cpu"])
    assert message in capsys.readouterr().err


def _imported_top_names(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_or_reference_imports_in_source():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(SRC, "repro_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        bad = {"jax", "jaxlib", "repro"} & set(_imported_top_names(path))
        assert not bad, f"{path} imports {bad}"


def test_importing_every_module_loads_no_jax():
    script = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.launch.train' in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
