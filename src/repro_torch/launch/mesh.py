"""The data mesh of ``--mesh-data N`` on ``torch.distributed``.

The reference's ``launch/mesh.py::make_data_mesh`` builds a 1-D ("data",)
JAX mesh over the devices of one process, and sharding propagation does
the rest. Here each rank of the mesh is a process of its own, as PyTorch
does data parallelism: rank r acts and learns on its block of B/N batch
columns on its own device, and the learner all-reduces the gradients
(``distributed/sharding.py``).

``launch(fn, n, device=...)`` runs ``fn(mesh, *args)`` in every rank:
rank 0 in the calling process (so an entry point returns what rank 0
returns), ranks 1..n-1 in children started with the ``spawn`` method.
The process group rendezvous at a free loopback port; its backend is NCCL
on CUDA and gloo on the CPU (gloo also takes CUDA tensors, which lets two
ranks share one card, where NCCL refuses). CUDA ranks take ``cuda:r``, and
asking for more ranks than there are visible GPUs raises, as the
reference does. A rank on the CPU runs one intra-op thread, so that N
ranks beside each other do not oversubscribe the cores (world size 1 on
the CPU is therefore bitwise the single-process path at one thread).

Failure: a rank that raises leaves the group. A spawned rank prints its
traceback and exits nonzero, and its peers' next collective fails
(gloo notices the closed connection at once; otherwise the group's
timeout ends the wait); rank 0's failure stops the children before it
propagates. ``launch`` raises if any rank failed, and leaves no process
behind.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import multiprocessing
import os
import socket
import sys
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

# How long a collective or the rendezvous may wait for a peer before the
# group gives up, and how long ``launch`` waits for the children after
# rank 0 is done.
DEFAULT_TIMEOUT_S = 120.0


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """One rank's view of the data mesh.

    ``group`` carries the tensor collectives (``all_reduce``,
    ``broadcast``) on ``device``; ``object_group`` the object collectives
    of checkpoint state, on the CPU (the same group under gloo, a gloo
    group beside NCCL's)."""

    rank: int
    size: int
    device: torch.device
    backend: str
    group: Any = None
    object_group: Any = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_devices(n: int, device) -> list:
    """The device of each of ``n`` ranks: ``cuda:r`` on CUDA, which needs
    ``n`` visible GPUs, else the CPU for every rank."""
    device = torch.device(device)
    if n < 1:
        raise ValueError(f"--mesh-data {n}: the mesh needs at least 1 rank")
    if device.type != "cuda":
        return [device] * n
    visible = torch.cuda.device_count()
    if n > visible:
        raise ValueError(
            f"--mesh-data {n} but only {visible} devices visible (on the "
            "CPU pass --device cpu)")
    return [torch.device("cuda", r) for r in range(n)]


@contextlib.contextmanager
def make_data_mesh(n: int, device, *, rank: int = 0, port: int,
                   backend: Optional[str] = None,
                   timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join the ``n``-rank process group at ``127.0.0.1:port`` as
    ``rank`` on ``device`` and yield its ``DataMesh``; the group is
    destroyed on the way out, whatever happened inside."""
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=n, timeout=timeout)
    try:
        group = dist.group.WORLD
        objects = group if backend == "gloo" else dist.new_group(
            backend="gloo", timeout=timeout)
        yield DataMesh(rank, n, device, backend, group, objects)
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _threads_for(device: torch.device):
    """One intra-op thread for a CPU rank, restored afterwards."""
    if device.type != "cpu":
        yield
        return
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _child(fn, rank, n, device, backend, port, timeout_s, args):
    """A spawned rank's body. It ends with ``os._exit`` so that no thread
    left behind by a failure can keep the process alive."""
    code = 0
    try:
        with _threads_for(device), make_data_mesh(
                n, device, rank=rank, port=port, backend=backend,
                timeout_s=timeout_s) as mesh:
            fn(mesh, *args)
    except BaseException:
        traceback.print_exc()
        code = 1
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)


def _reap(procs, deadline: float) -> list:
    """Join every child until ``deadline`` (``time.monotonic``), kill the
    ones still running; returns ``(rank, exitcode)`` of every child that
    failed or had to be killed."""
    bad = []
    for rank, p in enumerate(procs, start=1):
        p.join(max(0.0, deadline - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join()
            bad.append((rank, "killed after the timeout"))
        elif p.exitcode != 0:
            bad.append((rank, p.exitcode))
    return bad


def launch(fn: Callable, n: int, *, device, args: Sequence = (),
           devices: Optional[Sequence] = None, backend: Optional[str] = None,
           port: Optional[int] = None,
           timeout_s: Optional[float] = None) -> Any:
    """Run ``fn(mesh, *args)`` in each of ``n`` ranks and return rank 0's
    result; raises if any rank failed.

    ``fn`` and ``args`` must pickle (a module-level function), since the
    children are spawned. ``devices`` overrides ``rank_devices`` (two
    ranks sharing one card: ``["cuda:0", "cuda:0"]`` with ``backend=
    "gloo"``); ``port`` defaults to a free one; ``timeout_s`` bounds every
    wait on a peer (default ``DEFAULT_TIMEOUT_S``)."""
    devs = [torch.device(d) for d in devices] if devices is not None \
        else rank_devices(n, device)
    if len(devs) != n:
        raise ValueError(f"{len(devs)} devices for {n} ranks")
    port = free_port() if port is None else port
    timeout_s = DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(
        fn, r, n, devs[r], backend, port, timeout_s, tuple(args)))
        for r in range(1, n)]
    for p in procs:
        p.start()
    try:
        with _threads_for(devs[0]), make_data_mesh(
                n, devs[0], rank=0, port=port, backend=backend,
                timeout_s=timeout_s) as mesh:
            out = fn(mesh, *args)
    except BaseException:
        # the group is gone, so a child blocked on rank 0 fails at once;
        # a few seconds let it print why before it is killed
        _reap(procs, time.monotonic() + 5.0)
        raise
    bad = _reap(procs, time.monotonic() + timeout_s)
    if bad:
        raise RuntimeError("data-parallel rank(s) failed: " + ", ".join(
            f"rank {r}: {why}" for r, why in bad))
    return out
