"""The port's roofline (``launch/roofline.py``) and dry run
(``launch/dryrun.py``, ``multihost --mode dryrun``) against the
reference's:

* ``kernel_rooflines``' FLOPs, bytes, intensity and ``calls_per_step``,
  and ``inner_scan_corrections``, equal ``repro.launch.roofline``'s for
  every arch x ``INPUT_SHAPES``; ``roofline_s`` reads the H100's peak for
  the operands' type (a float32 kernel is not bounded by the bf16 peak).
* ``model_flops`` equals the reference's for every arch x shape.
* The block program runs one super-block (train, prefill, decode).
* ``dryrun.main`` on two spawned gloo ranks and ``multihost --mode
  dryrun`` as two ``--coordinator`` processes, on a small registered
  shape; a production mesh is modelled with no run, its argument bytes
  from ``spec_for`` equal to those a run at (1, 2) holds.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import ARCHS, get_config, get_reduced_config
from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import mesh as mesh_lib

FIELDS = ("flops", "bytes", "intensity", "calls_per_step")


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_rooflines_match_reference(arch):
    from repro.configs import get_config as jget
    from repro.launch import roofline as jroofline
    for shape in INPUT_SHAPES:
        want = jroofline.kernel_rooflines(jget(arch), shape)
        got = roofline.kernel_rooflines(get_config(arch), shape)
        assert set(got) == set(want), (arch, shape)
        for kernel, row in want.items():
            for field in FIELDS:
                assert got[kernel][field] == row[field], \
                    (arch, shape, kernel, field)
            bound = roofline.bound(row["flops"], row["bytes"],
                                   got[kernel]["dtype"])
            assert got[kernel]["roofline_s"] == bound["roofline_s"]
        assert roofline.inner_scan_corrections(get_config(arch), shape,
                                               256) == \
            jroofline.inner_scan_corrections(jget(arch), shape, 256)


def test_bound_reads_the_peak_of_the_operands_type():
    from repro_torch.launch import mesh as m
    row = roofline.kernel_roofline("ssd_chunk", dtype_bytes=4, bh=80, l=256,
                                   n=64, p=64)
    assert row["dtype"] == "float32"
    assert row["roofline_s"] == max(row["flops"] / m.PEAK_FLOPS_FP32,
                                    row["bytes"] / m.HBM_BW)
    assert roofline.kernel_roofline("vtrace", t=80, b=32)["dtype"] == \
        "float32"
    bf16 = roofline.kernel_roofline("flash_attention", b=1, h=32, kh=8,
                                    s=512, hd=128)
    assert bf16["dtype"] == "bfloat16" and bf16["bound"] == "memory"
    assert roofline.peak_flops(torch.bfloat16) == m.PEAK_FLOPS_BF16
    assert roofline.peak_flops("tf32") == m.PEAK_FLOPS_TF32
    with pytest.raises(ValueError, match="no peak"):
        roofline.peak_flops("int8")


def test_flash_roofline_with_a_query_offset():
    """``sq`` queries at ``q_offset``: every pair counted; the whole
    sequence from offset 0 is the reference's causal count."""
    whole = roofline.kernel_roofline("flash_attention", b=2, h=4, kh=2,
                                     s=64, hd=64)
    same = roofline.kernel_roofline("flash_attention", b=2, h=4, kh=2,
                                    s=64, hd=64, sq=64, q_offset=0)
    assert same["flops"] == whole["flops"] and same["bytes"] == \
        whole["bytes"]
    halves = [roofline.kernel_roofline("flash_attention", b=2, h=4, kh=2,
                                       s=64, hd=64, sq=32, q_offset=o)
              for o in (0, 32)]
    assert sum(h["flops"] for h in halves) == whole["flops"]
    assert halves[1]["flops"] == 4.0 * 2 * 4 * 64 * sum(
        range(33, 65))


@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
def test_model_flops_match_reference(shape):
    from repro.configs import get_config as jget
    from repro.configs.base import INPUT_SHAPES as JSHAPES
    from repro.launch.dryrun import model_flops as jflops
    for arch in ARCHS:
        assert dryrun.model_flops(get_config(arch), INPUT_SHAPES[shape],
                                  256) == \
            jflops(jget(arch), JSHAPES[shape], 256), arch


def test_collective_bytes_weight_the_ports_counts():
    stats = {"by": {"model/all_reduce": {"bytes": 100},
                    "data/all_gather": {"bytes": 7},
                    "data/reduce_scatter": {"bytes": 3}}}
    assert dryrun.collective_bytes(stats) == {
        "data/all-gather": 7.0, "data/reduce-scatter": 3.0,
        "model/all-reduce": 200.0}


def _one_rank():
    return mesh_lib.make_mesh2d(1, 1, "cpu", port=mesh_lib.free_port())


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_block_program_runs_one_super_block(kind):
    cfg = get_reduced_config("zamba2-2.7b")
    shape = InputShape(f"b_{kind}", 32, 2, kind)
    with _one_rank() as mesh:
        fn, args = roofline.build_block_program(
            cfg, shape, mesh, sharding.MEGATRON_RULES)
        out = fn(*args)
    if kind == "train":
        grads, gx = out
        leaves = list(args[0].parameters()) + list(args[1].parameters())
        assert len(grads) == len(leaves)
        assert all(g.shape == p.shape for g, p in zip(grads, leaves))
        assert gx.shape == args[2].shape and torch.isfinite(gx).all()
    else:
        y, cache = out
        assert y.shape == args[2].shape and torch.isfinite(y).all()
        assert set(cache) == {"block", "shared"}


_CLI = """
import sys
from repro_torch import configs
from repro_torch.configs.base import INPUT_SHAPES, InputShape
configs._REGISTRY["tiny-qwen"] = configs.get_reduced_config("qwen3-4b")
INPUT_SHAPES["tiny_train"] = InputShape("tiny_train", 32, 4, "train")
INPUT_SHAPES["tiny_decode"] = InputShape("tiny_decode", 32, 4, "decode")
if sys.argv[1] == "dryrun":
    from repro_torch.launch import dryrun
    dryrun.main(sys.argv[2:])
else:
    from repro_torch.launch import multihost
    multihost.main(sys.argv[2:])
"""


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.abspath("src")] + env.get("PYTHONPATH", "").split(os.pathsep))
    return env


def test_dryrun_main_on_two_gloo_ranks(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _CLI, "dryrun", "--arch", "tiny-qwen",
         "--shape", "tiny_train", "--ranks", "2", "--device", "cpu", "--out",
         str(tmp_path)], capture_output=True, text=True, env=_env(),
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "all 1 dry runs OK" in proc.stdout
    with open(tmp_path / "tiny-qwen__tiny_train__1x2__seqpar.json") as f:
        result = json.load(f)
    assert result["chips"] == 2 and result["kind"] == "train"
    assert result["collectives"]["model/all-reduce"] > 0
    assert result["cost_block"]["collective_bytes"] > 0
    assert result["memory"]["peak_bytes"] is None          # the CPU
    assert result["sources"]["memory.peak_bytes"] == "not measured"
    assert result["sources"]["collectives"] == "measured"
    assert result["sources"]["roofline.compute_s"] == "modelled"
    assert result["roofline"]["model_flops_global"] > 0
    # the run's argument bytes are those spec_for models with no tensors
    mesh = mesh_lib.Mesh2D(0, 1, 2, torch.device("meta"), "none")
    cfg = get_reduced_config("qwen3-4b")
    from repro_torch.launch.specs import resolve_config
    cfg = resolve_config("qwen3-4b", InputShape("tiny_train", 32, 4,
                                                "train"), cfg)
    assert dryrun.argument_bytes(
        cfg, InputShape("tiny_train", 32, 4, "train"), mesh,
        sharding.SEQPAR_RULES) == result["memory"]["argument_bytes"]


def test_multihost_dryrun_two_coordinator_processes():
    from conftest import free_port
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CLI, "multihost", "--mode", "dryrun",
         "--arch", "tiny-qwen", "--shape", "tiny_decode", "--device", "cpu",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(i)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=_env()) for i in range(2)]
    outs = [p.communicate(timeout=180)[0] for p in procs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert f"[host {i}] dryrun OK (megatron)" in out, out
    assert "[tiny-qwen | tiny_decode | 1x2 | megatron] measured" in outs[0]


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
def test_production_mesh_is_modelled_without_a_run(mesh_name, tmp_path):
    results = dryrun.main(["--arch", "llama-3.2-vision-90b", "--shape",
                           "decode_32k", "--mesh", mesh_name, "--out",
                           str(tmp_path)])
    (result,) = results
    assert result["rules"] == "fsdp" and result["chips"] == \
        {"16x16": 256, "2x16x16": 512}[mesh_name]
    assert result["sources"]["memory.argument_bytes"] == "modelled"
    assert "collectives" not in result and "launches" not in result
    # FSDP splits the float32 weights over every chip; the rest is the
    # chip's rows of the 32,768-slot cache
    weights = 4 * result["params"] / result["chips"]
    assert weights < result["memory"]["argument_bytes"]
    assert (tmp_path / f"llama-3.2-vision-90b__decode_32k__{mesh_name}"
            "__fsdp.json").exists()
