"""Multi-process bootstrap: one process per rank, started by hand or by a
scheduler, instead of spawned by ``launch/mesh.py::launch``.

The reference wires every host into one global JAX device mesh with
``jax.distributed.initialize``. Here each process is one rank of the
``Mesh2D``: ``--coordinator HOST:PORT --num-processes N --process-id i``
joins the N-rank process group whose rendezvous store process 0 serves
at HOST:PORT (process 0 must be able to bind it), and ``launch/train.py``
then runs that rank's part of the training with no spawn. On the CPU
(``--device cpu``) the processes may share one host, e.g.

  PYTHONPATH=src python -m repro_torch.launch.train --mode lm \\
      --arch qwen3-4b --reduced --steps 4 --batch 8 --seq 32 \\
      --mesh-model 2 --device cpu --coordinator 127.0.0.1:29511 \\
      --num-processes 2 --process-id 0 &
  PYTHONPATH=src python -m repro_torch.launch.train ... --process-id 1

``main`` is the reference's entry point for the programs of
``launch/specs.py``: every process runs one rank of the (data, model)
mesh that the world size factors into (the model axis the largest of 16,
8, 4, 2, 1 that divides it), builds its slices of the program for
``--arch`` / ``--shape`` under ``--rules`` (``auto``: the reference's
``resolve_rules``), and runs ``--steps`` real steps, e.g. two processes
of one host on the CPU:

  for i in 0 1; do PYTHONPATH=src python -m repro_torch.launch.multihost \
      --mode serve --arch xlstm-125m --shape decode_32k --steps 10 \
      --device cpu --coordinator 127.0.0.1:29512 --num-processes 2 \
      --process-id $i & done; wait

``--mode dryrun`` runs one step of the program and of its block program
on every process and reports what ``launch/dryrun.py::run_one`` measures
(peak memory on the card, launches by kernel, collective bytes by group
and kind) beside the modelled roofline terms; the reference compiles the
program instead and prints XLA's memory analysis.

``launch/train.py`` joins its processes here too (``bootstrap``): the LM
modes' (data, model) mesh, or, for ``--mode rl-agent``, a ``DataMesh`` of
``--mesh-data`` ranks, one a process.

On CUDA the ranks talk through NCCL, which refuses two ranks on one
device. Processes that share a card talk through gloo instead, which
takes CUDA tensors: ``--backend gloo``, or ``LOCAL_WORLD_SIZE`` (the
processes of this host, as torchrun exports it) above the host's GPUs.
The global process count does not decide it: across hosts every host
has cards of its own.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Optional

import torch

from repro_torch.launch import mesh as mesh_lib


def parse_coordinator(coordinator: str):
    """``HOST:PORT`` -> (host, port)."""
    host, sep, port = coordinator.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"--coordinator {coordinator!r}: expected HOST:PORT")
    return host, int(port)


def process_device(device, process_id: int) -> torch.device:
    """The device of process ``process_id``: ``cuda:i`` modulo the GPUs
    this host sees on CUDA, else ``device``."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", process_id % torch.cuda.device_count())


def coordinated_backend(device, backend: Optional[str] = None, *,
                        local_processes: Optional[int] = None,
                        visible: Optional[int] = None) -> Optional[str]:
    """The process group's backend for a coordinated rank on ``device``:
    ``backend`` when given; else gloo when this host's processes
    (``local_processes``, default ``LOCAL_WORLD_SIZE``, 1 when unset)
    outnumber its ``visible`` GPUs on CUDA, so that two of them share a
    card; else None, the mesh's default (NCCL on CUDA, gloo on the
    CPU)."""
    if backend is not None or torch.device(device).type != "cuda":
        return backend
    if local_processes is None:
        local_processes = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    if visible is None:
        visible = torch.cuda.device_count()
    return "gloo" if local_processes > visible else None


@contextlib.contextmanager
def bootstrap(coordinator: str, num_processes: int, process_id: int, *,
              data: int, model: Optional[int] = None, device, backend=None,
              timeout_s: float = mesh_lib.DEFAULT_TIMEOUT_S):
    """Join the ``num_processes``-rank mesh at ``coordinator`` as rank
    ``process_id`` and yield its view: a ``Mesh2D`` of (data, model), or,
    with ``model`` None (rl-agent's ``--mesh-data``), a ``DataMesh`` of
    ``data`` ranks. The group is destroyed on the way out. ``backend``:
    as ``coordinated_backend`` decides it."""
    ranks = data * (model or 1)
    if ranks != num_processes:
        shape = f"({data},)" if model is None else f"({data}, {model})"
        raise ValueError(f"--num-processes {num_processes} but the mesh is "
                         f"{shape} = {ranks} ranks")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} not in "
                         f"[0, {num_processes})")
    host, port = parse_coordinator(coordinator)
    device = process_device(device, process_id)
    backend = coordinated_backend(device, backend)
    if model is None:
        join = mesh_lib.make_data_mesh(data, device, rank=process_id,
                                       host=host, port=port,
                                       backend=backend, timeout_s=timeout_s)
    else:
        join = mesh_lib.make_mesh2d(data, model, device, rank=process_id,
                                    host=host, port=port, backend=backend,
                                    timeout_s=timeout_s)
    with mesh_lib._threads_for(device), join as mesh:
        where = "" if model is None else \
            f": data {mesh.data_index}, model {mesh.model_index}"
        print(f"[process {process_id}] rank {mesh.rank} of {mesh.size}"
              f"{where} on {device}")
        yield mesh


def factor_mesh(n: int):
    """(data, model) of ``n`` ranks, as the reference factors its device
    count: the model axis is the largest of 16, 8, 4, 2, 1 dividing n."""
    model = next(m for m in (16, 8, 4, 2, 1) if n % m == 0)
    return n // model, model


def _parser():
    p = argparse.ArgumentParser(
        description="Run real steps of a launch/specs.py program on the "
                    "(data, model) mesh of every process started")
    p.add_argument("--coordinator", default=None,
                   help="HOST:PORT of process 0 (omit for one process)")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--mode", choices=["train", "serve", "dryrun"],
                   default="dryrun")
    p.add_argument("--arch", default="qwen3-4b")
    p.add_argument("--shape", default="train_4k")
    p.add_argument("--rules", default="auto")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--attn-impl", default=None)
    p.add_argument("--ssd-impl", default=None)
    p.add_argument("--vtrace-impl", default="scan",
                   choices=["scan", "kernel"])
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="the process group's backend (default: NCCL on "
                        "CUDA, gloo on the CPU or where this host's "
                        "LOCAL_WORLD_SIZE processes outnumber its GPUs); "
                        "gloo lets processes share one card")
    return p


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run(mesh, args, pid):
    from repro_torch.configs.base import INPUT_SHAPES, ImplContext
    from repro_torch.distributed import sharding
    from repro_torch.launch.dryrun import resolve_rules
    from repro_torch.launch.specs import build_program

    if args.mode == "dryrun":
        from repro_torch.launch.dryrun import run_one
        result = run_one(args.arch, args.shape, mesh=mesh,
                         rules_name=args.rules, verbose=pid == 0,
                         impls=ImplContext(attn=args.attn_impl,
                                           ssd=args.ssd_impl))
        print(f"[host {pid}] dryrun OK ({result['rules']}) peak="
              f"{result['memory']['peak_bytes']} launches="
              f"{result['launches']}")
        return result
    rules_name = resolve_rules(args.rules, args.shape, args.arch)
    kw = {"vtrace_impl": args.vtrace_impl} \
        if INPUT_SHAPES[args.shape].kind == "train" else {}
    t0 = time.perf_counter()
    fn, inputs, _, _ = build_program(
        args.arch, args.shape, mesh, sharding.rules_named(rules_name),
        impls=ImplContext(attn=args.attn_impl, ssd=args.ssd_impl), **kw)
    print(f"[host {pid}] built {args.arch}/{args.shape} ({rules_name}) "
          f"in {time.perf_counter() - t0:.1f}s")
    if args.mode == "train":
        params, opt_state, _, batch = inputs
        for step in range(args.steps):
            params, opt_state, metrics = fn(params, opt_state, step, batch)
        loss = float(metrics["loss"])
        print(f"[host {pid}] {args.steps} train steps OK loss={loss:.4f}")
        return loss
    if len(inputs) == 4:                    # decode
        params, tokens, cache, _ = inputs
        for step in range(args.steps):
            logits, _, cache = fn(params, tokens, cache, step + 1)
    else:                                   # prefill
        logits, _ = fn(*inputs)
    _sync(mesh.device)
    print(f"[host {pid}] serve steps OK")
    return logits


def main(argv=None):
    """Returns this process's last loss (train), logits (serve) or dry-run
    result (dryrun)."""
    args = _parser().parse_args(argv)
    from repro_torch import resolve_device
    device = resolve_device(args.device)    # no GPU: raises here
    data, model = factor_mesh(args.num_processes)
    if args.coordinator:
        ctx = bootstrap(args.coordinator, args.num_processes,
                        args.process_id, data=data, model=model,
                        device=device, backend=args.backend)
    elif args.num_processes > 1:
        raise SystemExit("--num-processes > 1 requires --coordinator")
    else:
        ctx = mesh_lib.make_mesh2d(1, 1, device,
                                   port=mesh_lib.free_port())
    with ctx as mesh:
        print(f"[host {args.process_id}] mesh {mesh.shape}")
        return _run(mesh, args, args.process_id)


if __name__ == "__main__":
    main()
