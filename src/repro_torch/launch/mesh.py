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

``--mesh-model M`` (the LM paths) adds the reference's "model" axis: a
``Mesh2D`` of ``data * model`` ranks, rank ``r`` at data index ``r // M``
and model index ``r % M`` (the reference's device order on its ("data",
"model") mesh). Its model group (the ranks of one data index) carries
the tensor-parallel collectives of ``models/common.py``, its data group
(the ranks of one model index) the gradient all-reduce, and the
rendezvous ``TCPStore`` the checkpoint writer's barriers, which run off
the learner's thread and so must not be collectives on a group the
learner uses. ``launch(..., model=M)`` spawns them; ``make_mesh2d``
joins one from a process started by hand (``--coordinator``,
``launch/multihost.py``).

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

# The card's peaks for the roofline model (``launch/roofline.py``), the
# role the reference's TPU v5e constants play in its ``launch/mesh.py``:
# NVIDIA H100 SXM5 80 GB, from NVIDIA's H100 Tensor Core GPU datasheet
# (dense rates, no sparsity; at the card's full 700 W power limit).
HBM_BW = 3.35e12              # bytes/s of HBM3 per card
PEAK_FLOPS_BF16 = 989e12      # bf16 (and fp16) tensor cores, dense
PEAK_FLOPS_TF32 = 495e12      # TF32 tensor cores, dense
PEAK_FLOPS_FP32 = 67e12       # float32 on the CUDA cores
NVLINK_BW = 450e9             # bytes/s per card per direction (900 GB/s both)
HBM_BYTES = 80 * 10**9        # device memory per card
# the peak by the type the operands are multiplied in
PEAK_FLOPS = {"bfloat16": PEAK_FLOPS_BF16, "float16": PEAK_FLOPS_BF16,
              "tf32": PEAK_FLOPS_TF32, "float32": PEAK_FLOPS_FP32}


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


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """One rank's view of the ("data", "model") mesh of ``data * model``
    ranks. ``group`` spans every rank; ``model_group`` the ``model`` ranks
    of this rank's data index, ``data_group`` the ``data`` ranks of its
    model index; ``object_group`` as ``DataMesh``'s; ``store_addr`` the
    (host, port) of the rendezvous key-value store (host-side barriers)
    and ``mesh_id`` a token rank 0 drew for this group, the same on every
    rank (so the names of its barriers never meet another group's)."""

    rank: int
    data: int
    model: int
    device: torch.device
    backend: str
    group: Any = None
    model_group: Any = None
    data_group: Any = None
    object_group: Any = None
    store_addr: Any = None
    mesh_id: str = ""

    axis_names = ("data", "model")

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def model_root(self) -> int:
        """The global rank of model index 0 in this rank's model group."""
        return self.data_index * self.model

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def data_view(self) -> DataMesh:
        """The data axis alone as a ``DataMesh`` (the collectives of
        ``distributed/sharding.py`` over the data group)."""
        return DataMesh(self.data_index, self.data, self.device,
                        self.backend, self.data_group, self.object_group)


def mesh2d_devices(data: int, model: int, device, visible=None) -> list:
    """The device of each rank of a (data, model) mesh: ``cuda:r`` on
    CUDA, which needs ``data * model`` visible GPUs (the reference's
    ``make_mesh2d`` refuses more devices than it sees), else the CPU."""
    device = torch.device(device)
    n = data * model
    if data < 1 or model < 1:
        raise ValueError(f"mesh ({data}, {model}): each axis needs at least "
                         "1 rank")
    if device.type != "cuda":
        return [device] * n
    visible = torch.cuda.device_count() if visible is None else visible
    if n > visible:
        raise ValueError(
            f"mesh ({data}, {model}) needs {n} devices but only {visible} "
            "visible (on the CPU pass --device cpu; two ranks may share "
            "one card only through gloo: launch(..., devices=, "
            "backend='gloo'))")
    return [torch.device("cuda", r) for r in range(n)]


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
def make_data_mesh(n: int, device, *, rank: int = 0,
                   host: str = "127.0.0.1", port: int,
                   backend: Optional[str] = None,
                   timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join the ``n``-rank process group whose rendezvous rank 0 serves
    at ``host:port`` as ``rank`` on ``device`` and yield its
    ``DataMesh``; the group is destroyed on the way out, whatever
    happened inside."""
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=f"tcp://{host}:{port}",
                            rank=rank, world_size=n, timeout=timeout)
    try:
        group = dist.group.WORLD
        objects = group if backend == "gloo" else dist.new_group(
            backend="gloo", timeout=timeout)
        yield DataMesh(rank, n, device, backend, group, objects)
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def make_mesh2d(data: int, model: int, device, *, rank: int = 0,
                host: str = "127.0.0.1", port: int,
                backend: Optional[str] = None,
                timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join the ``data * model``-rank process group whose rendezvous store
    rank 0 serves at ``host:port`` as ``rank`` on ``device``, and yield
    its ``Mesh2D``; the group is destroyed on the way out. Every rank
    creates the subgroups in one order: the model groups by data index,
    then the data groups by model index."""
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    n = data * model
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, port, n, is_master=rank == 0,
                          timeout=timeout)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                            timeout=timeout)
    try:
        model_groups = [dist.new_group([d * model + m for m in range(model)])
                        for d in range(data)]
        data_groups = [dist.new_group([d * model + m for d in range(data)])
                       for m in range(model)]
        objects = dist.group.WORLD if backend == "gloo" else dist.new_group(
            backend="gloo", timeout=timeout)
        if rank == 0:
            store.set("mesh_id", os.urandom(8).hex())
        mesh_id = store.get("mesh_id").decode()
        yield Mesh2D(rank, data, model, device, backend, dist.group.WORLD,
                     model_groups[rank // model], data_groups[rank % model],
                     objects, (host, port), mesh_id)
    finally:
        dist.destroy_process_group()


def store_barrier(mesh, name: str, timeout_s: float = DEFAULT_TIMEOUT_S
                  ) -> None:
    """Every rank of ``mesh`` reaches ``name`` before any leaves it: a
    host-side barrier on the rendezvous store (no collective, so safe on a
    thread beside the learner's collectives: it talks to the store over a
    connection of its own). Each name is used once."""
    host, port = mesh.store_addr
    store = dist.TCPStore(host, port, is_master=False,
                          timeout=datetime.timedelta(seconds=timeout_s),
                          wait_for_workers=False)
    store.set(f"{name}/{mesh.rank}", b"1")
    store.wait([f"{name}/{r}" for r in range(mesh.size)],
               datetime.timedelta(seconds=timeout_s))


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


def _join(n, model, device, rank, port, backend, timeout_s):
    """The mesh context of rank ``rank``: a ``DataMesh`` of ``n`` ranks
    when ``model`` is None, else a ``Mesh2D`` of (n // model, model)."""
    if model is None:
        return make_data_mesh(n, device, rank=rank, port=port,
                              backend=backend, timeout_s=timeout_s)
    return make_mesh2d(n // model, model, device, rank=rank, port=port,
                       backend=backend, timeout_s=timeout_s)


def _child(fn, rank, n, device, backend, port, timeout_s, args,
           model=None):
    """A spawned rank's body. It ends with ``os._exit`` so that no thread
    left behind by a failure can keep the process alive."""
    code = 0
    try:
        with _threads_for(device), _join(n, model, device, rank, port,
                                         backend, timeout_s) as mesh:
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
           timeout_s: Optional[float] = None,
           model: Optional[int] = None) -> Any:
    """Run ``fn(mesh, *args)`` in each of ``n`` ranks and return rank 0's
    result; raises if any rank failed. With ``model``, the ranks form a
    ``Mesh2D`` of (n // model, model) (``mesh2d_devices`` places them),
    else a ``DataMesh``.

    ``fn`` and ``args`` must pickle (a module-level function), since the
    children are spawned. ``devices`` overrides ``rank_devices`` (two
    ranks sharing one card: ``["cuda:0", "cuda:0"]`` with ``backend=
    "gloo"``); ``port`` defaults to a free one; ``timeout_s`` bounds every
    wait on a peer (default ``DEFAULT_TIMEOUT_S``)."""
    if model is not None and n % model:
        raise ValueError(f"{n} ranks do not form a mesh with model axis "
                         f"{model}")
    devs = [torch.device(d) for d in devices] if devices is not None \
        else (rank_devices(n, device) if model is None
              else mesh2d_devices(n // model, model, device))
    if len(devs) != n:
        raise ValueError(f"{len(devs)} devices for {n} ranks")
    port = free_port() if port is None else port
    timeout_s = DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(
        fn, r, n, devs[r], backend, port, timeout_s, tuple(args), model))
        for r in range(1, n)]
    for p in procs:
        p.start()
    try:
        with _threads_for(devs[0]), _join(n, model, devs[0], 0, port,
                                          backend, timeout_s) as mesh:
            out = fn(mesh, *args)
    except BaseException:
        # the group is gone, so a child blocked on rank 0 fails at once;
        # a few seconds let it print why before it is killed
        _reap(procs, time.monotonic() + 5.0)
        raise
    bad = _reap(procs, time.monotonic() + timeout_s)
    if bad:
        raise RuntimeError("mesh rank(s) failed: " + ", ".join(
            f"rank {r}: {why}" for r, why in bad))
    return out
