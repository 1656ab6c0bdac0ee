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

Only the bootstrap is ported; the reference's ``main`` (which drives the
dry-run programs of ``launch/specs.py``) waits for those programs.
"""

from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def bootstrap(coordinator: str, num_processes: int, process_id: int, *,
              data: int, model: int, device, backend=None,
              timeout_s: float = mesh_lib.DEFAULT_TIMEOUT_S):
    """Join the ``num_processes``-rank (data, model) mesh at
    ``coordinator`` as rank ``process_id`` and yield its ``Mesh2D``; the
    group is destroyed on the way out."""
    if data * model != num_processes:
        raise ValueError(
            f"--num-processes {num_processes} but the mesh is ({data}, "
            f"{model}) = {data * model} ranks")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} not in "
                         f"[0, {num_processes})")
    host, port = parse_coordinator(coordinator)
    device = process_device(device, process_id)
    with mesh_lib._threads_for(device), mesh_lib.make_mesh2d(
            data, model, device, rank=process_id, host=host, port=port,
            backend=backend, timeout_s=timeout_s) as mesh:
        print(f"[process {process_id}] rank {mesh.rank} of {mesh.size}: "
              f"data {mesh.data_index}, model {mesh.model_index} on "
              f"{device}")
        yield mesh
