"""The dry run: one step of a ``launch/specs.py`` program, measured, after
the reference's ``launch/dryrun.py``.

The reference lowers and compiles every (arch x input shape) program on
its production meshes (16x16 chips, 2x16x16 across pods, on 512 faked
host devices) and reads XLA's memory, cost and collective analyses. Torch
compiles nothing, so here the program runs, and the numbers are the
port's own:

  ``_analyze``           peak memory (``torch.cuda.max_memory_allocated``
                         on the card), launches by kernel
                         (``kernels/ops.py::stats``) and collective bytes
  ``collective_bytes``   ``models/common.py::collective_stats`` by group
                         and kind, weighted by the reference's ring
                         factors (``_COLL_FACTOR``)
  ``model_flops``        the reference's useful-compute estimate, exactly
  ``run_one``            one step of the program on the ranks that were
                         started (a mesh of gloo ranks on the CPU, or the
                         card), and one step of the block program
                         (``roofline.build_block_program``)

A production mesh cannot be started: ``--mesh 16x16`` or ``2x16x16``
reports only what needs no run, each device's argument bytes (the
reference's ``spec_for`` over the parameter, optimizer-state, batch and
cache shapes, on ``meta`` tensors), the model FLOPs and the roofline
terms against the H100's peaks. The JSON carries the reference's keys
where the port can fill them, and ``sources`` names each filled number
"measured" (this run counted or timed it) or "modelled" (computed from
shapes); a number neither could give is null, marked "not measured".

Usage (``--ranks N`` spawns N ranks of the (data, model) mesh that
``multihost.factor_mesh`` makes of N, on ``--device``; ranks beyond the
visible GPUs share them through gloo):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
      --shape train_4k --mesh 16x16            # modelled, no run
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch xlstm-125m \\
      --shape decode_32k --ranks 2              # measured on the card

``launch/multihost.py --mode dryrun`` runs ``run_one`` on every process
it joins. ``resolve_rules`` is the reference's ``--rules auto``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import INPUT_SHAPES, ImplContext, InputShape

# bytes on the wire per byte of a collective's output (ring algorithms),
# the reference's
_COLL_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}
# the port's kinds (``common.collective_stats``) by the reference's names
_KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
          "reduce_scatter": "reduce-scatter"}
# the meshes the reference compiles for: (data, model); the two pods of
# 2x16x16 are one data axis of 32 here, which ``spec_for`` splits as it
# splits the reference's ("pod", "data") axes
PRODUCTION_MESHES = {"16x16": (16, 16), "2x16x16": (32, 16)}


def resolve_rules(rules_name: str, shape_name, arch: str) -> str:
    """The rules table for ``--rules``; ``auto`` is the reference's
    baseline: training keeps the residual stream sequence-parallel, with
    FSDP weights from 8B parameters; serving is Megatron, FSDP from 60B;
    an MoE whose expert count divides 16 runs expert-parallel."""
    if rules_name != "auto":
        return rules_name
    cfg = get_config(arch)
    n = cfg.param_count()
    ep = cfg.num_experts and cfg.num_experts % 16 == 0
    if _shape(shape_name).kind == "train":
        if ep:
            return "expert_seqpar"
        return "fsdp_seqpar" if n >= 8e9 else "seqpar"
    if ep:
        return "expert"
    return "fsdp" if n >= 60e9 else "megatron"


def _shape(shape) -> InputShape:
    return shape if isinstance(shape, InputShape) else INPUT_SHAPES[shape]


def collective_bytes(stats=None) -> Dict[str, float]:
    """Per-device collective bytes by ``"<group>/<kind>"`` (group "model"
    or "data", the reference's kind names), each kind weighted by
    ``_COLL_FACTOR``; ``stats``: ``common.collective_stats()`` (default:
    the counts now)."""
    if stats is None:
        from repro_torch.models.common import collective_stats
        stats = collective_stats()
    out: Dict[str, float] = {}
    for key, entry in sorted(stats["by"].items()):
        group, kind = key.split("/")
        name = _KINDS[kind]
        out[f"{group}/{name}"] = out.get(f"{group}/{name}", 0.0) \
            + entry["bytes"] * _COLL_FACTOR[name]
    return out


def model_flops(cfg, shape, chips: int) -> float:
    """Useful-compute estimate (global): 6·N·D train, 2·N·D inference.
    MoE uses active params (top-k experts)."""
    del chips
    n = cfg.param_count()
    if cfg.num_experts:
        inactive = cfg.num_groups * len(cfg.block_pattern) * \
            (cfg.num_experts - cfg.num_experts_per_tok) * \
            3 * cfg.d_model * cfg.moe_d_ff
        n -= inactive
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def _reset(device) -> None:
    from repro_torch.kernels import ops
    from repro_torch.models.common import reset_collective_stats
    ops.reset_stats()
    reset_collective_stats()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def _analyze(device) -> Dict:
    """What the work since ``_reset`` left: peak memory on the card (None
    on the CPU), launches by kernel, collective bytes by group and kind."""
    from repro_torch.kernels import ops
    peak = None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    return {"peak_bytes": peak, "launches": ops.stats(),
            "collectives": collective_bytes()}


def _tensor_bytes(tree) -> int:
    """Bytes of every tensor in a tree of dicts, lists, tuples and
    modules (each storage once)."""
    seen, total = set(), 0

    def walk(x):
        nonlocal total
        if isinstance(x, torch.nn.Module):
            for p in x.parameters():
                walk(p)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, torch.Tensor) and x.data_ptr() not in seen:
            seen.add(x.data_ptr())
            total += x.numel() * x.element_size()

    walk(tree)
    return total


def _split_numel(shape, spec, mesh) -> int:
    """Elements of one device's block of a leaf of ``shape`` split as
    ``spec`` says over ``mesh``."""
    n = math.prod(shape)
    for part in spec:
        for axis in (part if isinstance(part, tuple) else (part,)):
            if axis is not None:
                n //= mesh.shape[axis]
    return n


def argument_bytes(cfg, shape, mesh, rules) -> int:
    """One device's argument bytes of the program, with no tensors made:
    its slices of the float32 parameters (the reference's ``spec_for``
    over the stacked shapes), for training the ZeRO-1 slices of the
    optimizer state and its block of the batch, for a decode its share of
    the cache and tokens, for a prefill its block of the tokens (and of
    the vision input)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed import sharding
    from repro_torch.launch.specs import _data_parts
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import dtype_of, use_rules
    from repro_torch.optim import make_optimizer

    with torch.device("meta"):
        params = model_lib.init(cfg)
    axes, shapes = model_lib.stacked_axes(
        params, cfg, {n: p.shape for n, p in params.named_parameters()})
    # a group's block leaves stand for the reference's stacked leaf, which
    # holds every group's: count group 0's alone
    shapes = {n: v for n, v in shapes.items()
              if not n.startswith("blocks.") or n.startswith("blocks.0.")}
    axes = {n: axes[n] for n in shapes}
    specs = sharding.param_shardings(axes, mesh, rules, shapes)
    total = 4 * sum(_split_numel(shapes[n], specs[n], mesh) for n in shapes)
    b, s = shape.global_batch, shape.seq_len
    rows = b // _data_parts(mesh, b)
    act = torch.empty((), dtype=dtype_of(cfg)).element_size()
    if shape.kind == "train":
        opt = make_optimizer(TrainConfig())     # build_train's
        with torch.device("meta"):
            slots = len(opt.init([torch.zeros(1)]))    # state a parameter
        zero = sharding.zero1_shardings(axes, mesh, rules, shapes)
        total += 4 * slots * sum(_split_numel(shapes[n], zero[n], mesh)
                                 for n in shapes)
        # tokens (B, S+1) int32; behaviour log-probs, rewards (B, S)
        # float32; done (B, S) bool
        total += rows * (4 * (s + 1) + 4 * s * 2 + s)
    elif shape.kind == "prefill":
        total += rows * 4 * s
    else:
        with torch.device("meta"), use_rules(mesh, rules):
            cache = model_lib.cache_init(cfg, rows, s)
        total += _tensor_meta_bytes(cache) + rows * 4
    if cfg.vision_seq and shape.kind != "decode":
        total += rows * cfg.vision_seq * cfg.d_model * act
    return total


def _tensor_meta_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tensor_meta_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _step(fn, inputs, kind):
    """One step of a ``build_program`` program on its inputs."""
    if kind == "train":
        params, opt_state, step, batch = inputs
        return fn(params, opt_state, step, batch)
    if kind == "decode":
        params, tokens, cache, _ = inputs
        return fn(params, tokens, cache, 1)
    return fn(*inputs)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_one(arch: str, shape_name, *, mesh=None, production=None,
            rules_name: str = "auto", out_dir: Optional[str] = None,
            verbose: bool = True, impls=None, base_cfg=None) -> Dict:
    """The dry run of one (arch, shape, rules). With ``mesh`` (this rank
    of the started ranks), one step of the ``specs`` program and of the
    block program, measured; with ``production`` ("16x16" or "2x16x16")
    the modelled report, no run. Returns the result (and writes it to
    ``out_dir``, from rank 0)."""
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.roofline import (build_block_program, bound,
                                             inner_scan_corrections,
                                             kernel_rooflines)
    from repro_torch.launch.specs import build_program, resolve_config

    shape = _shape(shape_name)
    name = arch if isinstance(arch, str) else "custom"
    rules_name = resolve_rules(rules_name, shape, name)
    cfg = resolve_config(name, shape, base_cfg, impls)
    if mesh is None:
        data, model = PRODUCTION_MESHES[production or "16x16"]
        mesh = mesh_lib.Mesh2D(0, data, model, torch.device("meta"), "none")
        mesh_name = production or "16x16"
        rules = sharding.RULE_SETS[rules_name]
        live = False
    else:
        mesh_name = f"{mesh.data}x{mesh.model}"
        rules = sharding.rules_named(rules_name)
        live = True
    chips = mesh.size
    mflops = model_flops(cfg, shape, chips)
    corr = inner_scan_corrections(cfg, shape, chips)
    result = {"arch": name, "shape": shape.name, "mesh": mesh_name,
              "rules": rules_name, "chips": chips, "kind": shape.kind,
              "rank": mesh.rank, "params": cfg.param_count(),
              "inner_scan_corrections_global_flops": corr,
              "kernel_rooflines": kernel_rooflines(cfg, shape)}
    sources = {"params": "modelled",
               "inner_scan_corrections_global_flops": "modelled",
               "kernel_rooflines": "modelled"}
    coll_total = None
    if live:
        t0 = time.perf_counter()
        fn, inputs, _, _ = build_program(
            name, shape, mesh, rules, base_cfg=base_cfg, impls=impls)
        _sync(mesh.device)
        result["build_s"] = time.perf_counter() - t0
        args_bytes = _tensor_bytes(inputs)
        _reset(mesh.device)
        t0 = time.perf_counter()
        _step(fn, inputs, shape.kind)
        _sync(mesh.device)
        result["step_s"] = time.perf_counter() - t0
        seen = _analyze(mesh.device)
        coll_total = sum(seen["collectives"].values())
        result["collectives"] = seen["collectives"]
        result["launches"] = seen["launches"]
        result["memory"] = {"argument_bytes": args_bytes,
                            "peak_bytes": seen["peak_bytes"],
                            "per_device_total": seen["peak_bytes"]}
        peak_how = "measured" if seen["peak_bytes"] is not None \
            else "not measured"
        sources.update({"build_s": "measured", "step_s": "measured",
                        "collectives": "measured", "launches": "measured",
                        "memory.argument_bytes": "measured",
                        "memory.peak_bytes": peak_how,
                        "memory.per_device_total": peak_how})
        del fn, inputs
        bfn, bargs = build_block_program(cfg, shape, mesh, rules)
        _reset(mesh.device)
        bfn(*bargs)
        block = _analyze(mesh.device)
        result["cost_block"] = {
            "collective_bytes": sum(block["collectives"].values()),
            "collectives": block["collectives"],
            "launches": block["launches"],
            "peak_bytes": block["peak_bytes"]}
        sources["cost_block"] = "measured"
        del bfn, bargs
    else:
        args_bytes = argument_bytes(cfg, shape, mesh, rules)
        result["memory"] = {"argument_bytes": args_bytes,
                            "peak_bytes": None, "per_device_total": None}
        sources.update({"memory.argument_bytes": "modelled",
                        "memory.peak_bytes": "not measured",
                        "memory.per_device_total": "not measured"})
    flops_dev = (mflops + sum(corr.values())) / chips
    terms = {"compute_s": bound(flops_dev, 0, cfg.dtype)["compute_s"],
             "memory_s": args_bytes / mesh_lib.HBM_BW,
             "collective_s": None if coll_total is None
             else coll_total / mesh_lib.NVLINK_BW}
    known = {k: v for k, v in terms.items() if v is not None}
    result["cost_corrected"] = {"flops_per_device": flops_dev,
                                "bytes_per_device": args_bytes,
                                "collective_bytes_per_device": coll_total}
    result["roofline"] = {**terms, "bottleneck": max(known, key=known.get),
                          "model_flops_global": mflops}
    sources.update({
        "cost_corrected.flops_per_device": "modelled",
        "cost_corrected.bytes_per_device": sources["memory.argument_bytes"],
        "cost_corrected.collective_bytes_per_device":
            "measured" if live else "not measured",
        "roofline.compute_s": "modelled", "roofline.memory_s": "modelled",
        "roofline.collective_s": "modelled" if live else "not measured",
        "roofline.model_flops_global": "modelled"})
    result["sources"] = sources
    result["device"] = str(mesh.device) if live else None
    if out_dir and mesh.rank == 0:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{name}__{shape.name}__{mesh_name}__{rules_name}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(result, f, indent=1)
    if verbose:
        how = "measured" if live else "modelled"
        print(f"[{name} | {shape.name} | {mesh_name} | {rules_name}] "
              f"{how}: args/dev={args_bytes / 2**30:.3f}GiB "
              f"flops/dev={flops_dev:.3g} "
              f"coll/dev={coll_total if coll_total is not None else '-'}B "
              f"bottleneck={result['roofline']['bottleneck']}", flush=True)
    return result


def _rank(mesh, arch, shape, rules_name, out_dir, impls, base_cfg):
    """A spawned rank's dry run; rank 0's result is returned."""
    from repro_torch import resolve_device
    resolve_device(mesh.device.type)      # pins float32, as train does
    return run_one(arch, shape, mesh=mesh, rules_name=rules_name,
                   out_dir=out_dir, verbose=mesh.rank == 0, impls=impls,
                   base_cfg=base_cfg)


def _parser():
    p = argparse.ArgumentParser(
        description="Run (or, on a production mesh, model) one step of a "
                    "launch/specs.py program and report its memory, "
                    "launches, collectives and roofline terms")
    p.add_argument("--arch", default=None, help="a registered arch")
    p.add_argument("--shape", default=None,
                   help="a registered input shape (configs.base.INPUT_SHAPES)")
    p.add_argument("--all", action="store_true",
                   help="every arch x input shape")
    p.add_argument("--rules", default="auto")
    p.add_argument("--mesh", default="local",
                   choices=["local"] + list(PRODUCTION_MESHES),
                   help="local: run on --ranks started ranks; 16x16, "
                        "2x16x16: the modelled report, no run")
    p.add_argument("--ranks", type=int, default=1,
                   help="ranks to start for --mesh local")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--attn-impl", default=None,
                   choices=["xla", "xla_chunked", "xla_chunked_skip",
                            "kernel"])
    p.add_argument("--ssd-impl", default=None, choices=["xla", "kernel"])
    p.add_argument("--out", default=None,
                   help="write <arch>__<shape>__<mesh>__<rules>.json here")
    return p


def main(argv=None):
    """Returns the list of results (rank 0's for a run)."""
    args = _parser().parse_args(argv)
    if args.all:
        pairs = [(a, s) for a in ARCHS for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        pairs = [(args.arch, args.shape)]
    else:
        raise SystemExit("--arch and --shape, or --all")
    impls = ImplContext(attn=args.attn_impl, ssd=args.ssd_impl)
    results, failures = [], []
    for arch, shape in pairs:
        try:
            if args.mesh != "local":
                results.append(run_one(arch, shape, production=args.mesh,
                                       rules_name=args.rules,
                                       out_dir=args.out, impls=impls))
                continue
            results.append(_launch(arch, shape, args, impls))
        except Exception as e:  # noqa: BLE001 - report every pair's failure
            failures.append((arch, shape, repr(e)))
            print(f"[{arch} | {shape}] FAILED: {e}", flush=True)
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} failures:")
        for f in failures:
            print(" ", f)
        sys.exit(1)
    print(f"\nall {len(pairs)} dry runs OK")
    return results


def _launch(arch, shape, args, impls):
    """One pair on ``args.ranks`` spawned ranks; the config and the input
    shape go to the children as objects, so that ones registered by the
    caller reach them."""
    from repro_torch import resolve_device
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.multihost import factor_mesh
    device = resolve_device(args.device)        # no GPU: raises here
    _, model = factor_mesh(args.ranks)
    devices, backend = None, None
    if device.type == "cuda" and args.ranks > torch.cuda.device_count():
        devices = [torch.device("cuda", r % torch.cuda.device_count())
                   for r in range(args.ranks)]
        backend = "gloo"
    return mesh_lib.launch(
        _rank, args.ranks, device=device, devices=devices, backend=backend,
        model=model, args=(arch, INPUT_SHAPES[shape],
                           resolve_rules(args.rules, shape, arch), args.out,
                           impls, get_config(arch)))


if __name__ == "__main__":
    main()
