"""Meshes, their process groups and the multi-process bootstrap (port of
``repro/launch/mesh.py``).

A ``Mesh`` is a small frozen record: a (data, model) array of
``torch.device`` - row r is data-parallel replica r, its entries the
replica's tensor-parallel shard devices - and a matching array of the
process index that hosts each entry; its axes are always ``("data",
"model")``.  Entries may repeat a
device: that is how the CPU tests build a mesh (every entry ``cpu``) and how
one card serves a whole mesh (every entry ``cuda:0``), the counterpart of
the reference's forced virtual host devices.  A mesh is never widened or
narrowed quietly: ``make_serve_mesh`` and ``make_host_mesh`` raise when the
devices they need are not there.

A serve mesh splits its data axis over a few processes; a train mesh
(``make_host_mesh``) is one process an entry, rank ``d * M + m`` at entry
(d, m).  ``mesh_groups`` builds a train mesh's process groups - the
mesh's world, each data-axis group (one model index, every data index) and
each model-axis group - in the same order on every process, as
``torch.distributed.new_group`` needs, and keeps them per mesh.  The
backend comes from the mesh (``train_backend``): NCCL where every entry is
its own card, gloo otherwise - every CPU mesh, and several ranks on one
card, which NCCL refuses.

``make_production_mesh`` is the reference's production mesh for the dry
run (``launch/dryrun.py``): 16 x 16 = 256 cards, or two such pods (512),
whose ``pod`` axis folds into ``data`` here; its entries are fake cards
(``fake_mesh``), which only the dry run's ``FakeTensorMode`` holds tensors
on, and ``mesh_info`` reports the reference's axes.  The reference's
``bootstrap_mesh_env``, ``strip_forced_device_count`` and ``mesh_arg``
size XLA's forced host devices and have no torch counterpart.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import ClassVar

import numpy as np

AXES = ("data", "model")
_BIND_ATTEMPTS = 5       # pick_coordinator's ephemeral binds
_INIT_ATTEMPTS = 3       # init_distributed's rendezvous attempts
_INIT_BACKOFF_S = 1.0    # its first retry's delay, doubled at each retry


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    devices: np.ndarray          # (data, model) object array of torch.device
    processes: np.ndarray        # (data, model) int: the hosting process
    axis_names: ClassVar[tuple[str, ...]] = AXES

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


@dataclasses.dataclass(frozen=True, eq=False)
class FakeMesh(Mesh):
    """The dry run's mesh (``fake_mesh``): ``pods`` pods folded into its
    data axis."""
    pods: int = 1


def parse_mesh(spec: str) -> tuple[int, int]:
    """'4x2' -> (data=4, model=2)."""
    try:
        data, model = (int(p) for p in spec.lower().split("x"))
    except ValueError as e:
        raise ValueError(f"--mesh expects DxM (e.g. 4x2), got {spec!r}") from e
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be positive, got {spec!r}")
    return data, model


def pick_coordinator(addr: str | None) -> str:
    """``addr`` if given, else 127.0.0.1 with a fresh OS-assigned port: two
    fleets on one host must not rendezvous with each other.  The ephemeral
    bind is retried (bounded) so a transient EADDRINUSE does not kill the
    launcher."""
    if addr:
        return addr
    import socket
    for attempt in range(_BIND_ATTEMPTS):
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                return f"127.0.0.1:{s.getsockname()[1]}"
        except OSError:
            if attempt == _BIND_ATTEMPTS - 1:
                raise
            time.sleep(0.2 * (2 ** attempt))
    raise AssertionError("unreachable")


def init_distributed(coordinator: str, num_processes: int, process_id: int, *,
                     timeout: float = 300.0, backend: str = "gloo") -> None:
    """Join this process to a group of ``num_processes`` over
    ``tcp://coordinator``: gloo carries the serving fleet's host data
    (plans, the command header, sampled tokens) as CPU tensors, and a train
    mesh's collectives (``train_backend``).  Retried with exponential
    backoff (bounded): the coordinator's port can be mid-release from a
    previous fleet, or process 0 can come up a beat after a worker."""
    import datetime

    import torch.distributed as dist
    for attempt in range(_INIT_ATTEMPTS):
        try:
            dist.init_process_group(
                backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
                rank=process_id, timeout=datetime.timedelta(seconds=timeout))
            return
        except Exception as e:
            if attempt == _INIT_ATTEMPTS - 1:
                raise
            if dist.is_initialized():
                dist.destroy_process_group()
            delay = _INIT_BACKOFF_S * (2 ** attempt)
            print(f"init_distributed: attempt {attempt + 1}/{_INIT_ATTEMPTS} failed ({e!r}); "
                  f"retrying in {delay:.1f}s", file=sys.stderr, flush=True)
            time.sleep(delay)


def make_serve_mesh(data: int, model: int, devices=None, *, processes: int = 1) -> Mesh:
    """The (data, model) serving mesh; ``processes`` split its data axis
    into contiguous blocks, one a process (``MultiHostServeEngine``).

    ``devices``: the data * model entries in row-major order, any value
    ``torch.device`` takes; they may repeat.  Without it every process's
    entries are its first data * model / processes CUDA devices, and too
    few of them raise with the count."""
    import torch
    n = data * model
    if data % processes:
        raise ValueError(f"mesh {data}x{model}: the data axis ({data}) must divide "
                         f"over {processes} processes")
    if devices is None:
        local = n // processes
        have = torch.cuda.device_count()
        if have < local:
            per = f" in each of {processes} processes" if processes > 1 else ""
            raise RuntimeError(f"mesh {data}x{model} needs {local} CUDA devices{per}, "
                               f"found {have}")
        devices = [f"cuda:{i % local}" for i in range(n)]
    devices = list(devices)
    if len(devices) != n:
        raise ValueError(f"mesh {data}x{model} needs {n} device entries, got {len(devices)}")
    devs = np.empty(n, dtype=object)
    devs[:] = [torch.device(d) for d in devices]
    procs = np.repeat(np.arange(processes), n // processes).reshape(data, model)
    return Mesh(devs.reshape(data, model), procs)


def make_host_mesh(data: int, model: int, devices=None) -> Mesh:
    """The (data, model) train mesh: one process an entry, rank d * M + m
    at entry (d, m).  ``devices``: the data * model entries in row-major
    order (they may repeat: four ranks on one card, or every entry the
    CPU); without it, the first data * model CUDA devices, and too few of
    them raise with the count."""
    import torch
    n = data * model
    if devices is None:
        have = torch.cuda.device_count()
        if have < n:
            raise RuntimeError(f"mesh {data}x{model} needs {n} CUDA devices, found {have}; "
                               f"give the entries' devices to share fewer")
        devices = [f"cuda:{i}" for i in range(n)]
    devices = list(devices)
    if len(devices) != n:
        raise ValueError(f"mesh {data}x{model} needs {n} device entries, got {len(devices)}")
    devs = np.empty(n, dtype=object)
    devs[:] = [torch.device(d) for d in devices]
    return Mesh(devs.reshape(data, model), np.arange(n).reshape(data, model))


POD = (16, 16)      # the reference's production pod: data x model cards


def fake_mesh(data: int, model: int, pods: int = 1) -> FakeMesh:
    """A (data, model) mesh of one process an entry, rank ``d * model +
    m``, for the dry run (``launch/dryrun.py``, whose ``FakeTensorMode`` and
    fake process group stand in for the cards and processes; no other code
    runs on it).  Entry (d, m) is fake card ``meta:<m>``: a ``meta`` device
    of its own index, which fake tensors keep apart from the others and
    which, unlike a fake ``cuda`` device, takes autograd and indexing (they
    need a device guard that a process without the card, or without CUDA,
    cannot take).  A row's cards are distinct; the rows reuse them (a device
    index is at most 127), as a trace runs one entry's or one row's program.
    ``pods``: how many pods the data axis folds in."""
    import torch
    devs = np.empty(data * model, dtype=object)
    devs[:] = [torch.device("meta", i % model) for i in range(data * model)]
    return FakeMesh(devs.reshape(data, model), np.arange(data * model).reshape(data, model),
                    pods)


def make_production_mesh(*, multi_pod: bool = False) -> FakeMesh:
    """The reference's production mesh as a ``fake_mesh``: one pod of 16 x
    16 = 256 cards, or with ``multi_pod`` two pods (512) whose ``pod`` axis
    folds into ``data`` (32 x 16)."""
    pods = 2 if multi_pod else 1
    return fake_mesh(POD[0] * pods, POD[1], pods)


def mesh_info(mesh: Mesh) -> dict:
    """The reference's record of a mesh: its axes, their sizes and its
    entries; a multi-pod mesh reports its ``pod`` axis apart from
    ``data``."""
    data, model = mesh.devices.shape
    pods = getattr(mesh, "pods", 1)
    if pods > 1:
        names, shape = ["pod", "data", "model"], [pods, data // pods, model]
    else:
        names, shape = ["data", "model"], [data, model]
    return {"axis_names": names, "shape": shape, "n_devices": int(data * model)}


def train_backend(mesh: Mesh) -> str:
    """NCCL where every entry is a CUDA device of its own, else gloo."""
    devs = list(mesh.devices.flat)
    if all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs):
        return "nccl"
    return "gloo"


@dataclasses.dataclass(frozen=True)
class MeshGroups:
    """A train-mesh rank's view of its groups: ``world`` (every entry),
    ``data`` (its model index, every data index, in data order) and
    ``model`` (its data index, every model index); a group of one process
    is None (its collectives are no-ops)."""
    coords: dict             # {"data": d, "model": m}
    world: object
    data: object
    model: object


def mesh_coords(mesh: Mesh) -> dict | None:
    """{"data": d, "model": m} of this process's entry (its rank in the
    default group, 0 without one), None when it holds none; no
    collective."""
    import torch.distributed as dist
    if mesh.processes.size == 1:
        return {"data": 0, "model": 0}
    rank = dist.get_rank() if dist.is_initialized() else 0
    where = np.argwhere(mesh.processes == rank)
    if not len(where):
        return None
    return {"data": int(where[0][0]), "model": int(where[0][1])}


_GROUPS: dict[int, tuple[Mesh, MeshGroups | None]] = {}


def mesh_groups(mesh: Mesh) -> MeshGroups | None:
    """This process's groups of ``mesh`` (None when it holds no entry).
    The first call for a mesh is collective: every process of the default
    group makes it, in the same order."""
    hit = _GROUPS.get(id(mesh))
    if hit is not None and hit[0] is mesh:
        return hit[1]
    import torch.distributed as dist
    procs = mesh.processes
    if procs.size == 1:
        out = MeshGroups({"data": 0, "model": 0}, None, None, None)
        _GROUPS[id(mesh)] = (mesh, out)
        return out
    if not dist.is_initialized():
        raise RuntimeError(f"a {procs.shape[0]}x{procs.shape[1]} mesh needs a process group: "
                           f"init_distributed first")
    rank = dist.get_rank()

    def group(ranks):
        g = dist.new_group([int(r) for r in ranks])
        return g if rank in ranks and len(ranks) > 1 else None

    world = group(list(procs.flat))
    data = [group(list(procs[:, m])) for m in range(procs.shape[1])]
    model = [group(list(procs[d])) for d in range(procs.shape[0])]
    out, c = None, mesh_coords(mesh)
    if c is not None:
        out = MeshGroups(c, world, data[c["model"]], model[c["data"]])
    _GROUPS[id(mesh)] = (mesh, out)
    return out


__all__ = ["AXES", "FakeMesh", "Mesh", "MeshGroups", "fake_mesh", "init_distributed",
           "make_host_mesh", "make_production_mesh", "make_serve_mesh", "mesh_coords",
           "mesh_groups", "mesh_info", "parse_mesh", "pick_coordinator", "train_backend"]
