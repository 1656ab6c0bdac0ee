"""Nothing the benchmark runs imports JAX or the JAX package ``repro``:
top-level module names compared whole (``repro_torch`` passes, ``repro``
fails), in every source file under ``perfbench/`` and in a process that
imports the harness, its readers and references; and the references
import nothing of the port. CPU only; imports no JAX."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[:0] = [p for p in (ROOT, os.path.join(ROOT, "src"))
                if p not in sys.path]

from perfbench import bench  # noqa: E402

HERE = os.path.join(ROOT, "perfbench")


def _sources():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_top_level_names_are_compared_whole():
    assert bench.forbidden_modules({"repro_torch": 1,
                                    "repro_torch.core": 1}) == []
    assert bench.forbidden_modules({"repro.core.vtrace": 1}) == ["repro"]
    assert bench.forbidden_modules({"jax": 1, "jaxlib.xla": 1,
                                    "flax.linen": 1, "jaxtyping": 1}) \
        == ["flax", "jax", "jaxlib"]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _imported(path) & set(bench.FORBIDDEN)


def test_the_references_import_nothing_of_the_port():
    ref = os.path.join(HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            assert "repro_torch" not in _imported(os.path.join(ref, f)), f
    for f in os.listdir(os.path.join(HERE, "configs")):
        if f.endswith(".py"):
            path = os.path.join(HERE, "configs", f)
            assert "repro_torch" not in _imported(path), f


def test_a_process_running_the_harness_holds_no_jax():
    script = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from perfbench import bench, control, trace, checks\n"
        "from perfbench.families import impala_agent, decoder\n"
        "from perfbench.reference import common\n"
        "import perfbench.reference.impala_deep_atari\n"
        "import perfbench.reference.granite_3_0_1b_a400m\n"
        "from perfbench.traffic import generator, atari_env\n"
        "from perfbench.traffic.kinds import device_actors, packed_corpus\n"
        "from perfbench.traffic.kinds import generated_episodes\n"
        "from perfbench.traffic.kinds import synthetic_rollouts\n"
        "man = bench.manifest()\n"
        "for m in man['per_layer']: bench.load_reader(m['name'])\n"
        "import repro_torch.core.runtime, repro_torch.core.generate\n"
        "import repro_torch.launch.train\n"
        "print(','.join(bench.forbidden_modules()))\n"
        % (ROOT, os.path.join(ROOT, "src")))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ""
