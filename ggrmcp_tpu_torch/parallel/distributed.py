"""The multi-process runtime: counterpart of
`ggrmcp_tpu/parallel/distributed.py`.

The reference joins JAX's multi-controller runtime and builds a mesh
over every process's devices, and XLA inserts the collectives for any
axis that crosses processes. Here `initialize` joins a
`torch.distributed` process group, and `global_mesh` builds the port's
mesh (parallel/mesh.py) over every process's devices, each coordinate
tagged with the process that owns it, then forms one process group per
set of processes a collective spans (`mesh.axis_ranks` along the batch
axes, tensor, expert, expert x tensor, sequence and stage, and the batch
axes with stage), created in one order on every process. Training over
it (models/training.py `train_step`) runs each process's coordinates
and reaches the others' through those groups (parallel/collectives.py).
Like the reference, neither the `train` CLI nor the sidecar calls
`initialize`.

The backend follows from where a process computes, decided before the
group forms and the same in every process:
- `gloo` on the CPU, and when processes share a card: a process given a
  card by index (`device="cuda:0"`) is taken to share it, and NCCL
  refuses two ranks on one device;
- `nccl` when each process owns a distinct card: a process given no
  card index (`device=None` or "cuda") takes `cuda:<process_id>` of its
  host, which must exist.
A group that cannot form raises; nothing drops to another backend or to
the CPU. Every collective, of the default group and of every group
`global_mesh` forms, waits at most `TIMEOUT_S`, so a process whose peer
died raises instead of hanging.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Optional, Sequence

import torch

from ggrmcp_tpu_torch.core.config import MeshConfig
from ggrmcp_tpu_torch.parallel import mesh as mesh_mod
from ggrmcp_tpu_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger("ggrmcp.torch.parallel.distributed")

# The device this process computes on once `initialize` joined a group.
_device: Optional[torch.device] = None

# Seconds a collective of any group waits before it raises.
TIMEOUT_S = 600.0

# The axis sets whose collectives may cross processes, in the order
# `global_mesh` forms their groups.
GROUP_AXES = (mesh_mod.BATCH_AXES, ("tensor",), ("expert",),
              ("expert", "tensor"), ("sequence",), ("stage",),
              (*mesh_mod.BATCH_AXES, "stage"))


def placement(device: DeviceLike, process_id: int) -> tuple[str, str]:
    """(backend, device spec) of process `process_id` asked to run on
    `device`, by the module's rule; reads no card."""
    spec = torch.device("cuda" if device is None else device)
    if spec.type == "cpu":
        return "gloo", "cpu"
    if spec.type != "cuda":
        raise ValueError(f"unsupported device type {spec.type!r}")
    if spec.index is not None:
        return "gloo", str(spec)
    return "nccl", f"cuda:{process_id}"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = None,
) -> bool:
    """Join the process group. Arguments fall back to GGRMCP_COORDINATOR
    (host:port of process 0's rendezvous) / GGRMCP_NUM_PROCESSES /
    GGRMCP_PROCESS_ID, explicit arguments first. Returns False for one
    process (nothing configured, or one process), True once the group
    has formed. `device`: where this process computes (the module's rule
    picks the backend from it)."""
    global _device
    coordinator_address = coordinator_address or os.environ.get(
        "GGRMCP_COORDINATOR")
    env_np = os.environ.get("GGRMCP_NUM_PROCESSES")
    env_pid = os.environ.get("GGRMCP_PROCESS_ID")
    num_processes = num_processes if num_processes is not None else (
        int(env_np) if env_np else None)
    process_id = process_id if process_id is not None else (
        int(env_pid) if env_pid else None)
    if coordinator_address is None and num_processes is None:
        logger.info("single-process runtime (no coordinator configured)")
        return False
    if num_processes == 1:
        logger.info("single-process runtime (one process)")
        return False
    if coordinator_address is None or num_processes is None or (
            process_id is None):
        raise ValueError(
            f"a multi-process runtime needs a coordinator "
            f"({coordinator_address!r}), a process count ({num_processes!r}) "
            f"and this process's id ({process_id!r}): set "
            f"GGRMCP_COORDINATOR, GGRMCP_NUM_PROCESSES and GGRMCP_PROCESS_ID "
            f"or pass them")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} of {num_processes}")
    backend, spec = placement(device, process_id)
    dev = resolve_device(spec)
    if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"process {process_id} of {num_processes} owns {spec}, which "
            f"this host does not have ({torch.cuda.device_count()} cards); "
            f"name one card (device='cuda:0') for processes that share it")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.distributed.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _device = dev
    logger.info("joined the process group: process %d/%d on %s, %s",
                process_id, num_processes, dev, backend)
    return True


def local_device() -> torch.device:
    """The device `initialize` gave this process."""
    if _device is None:
        raise RuntimeError("no process group: call initialize() first")
    return _device


def global_mesh(cfg: Optional[MeshConfig] = None,
                devices: Optional[Sequence] = None) -> mesh_mod.Mesh:
    """Mesh over every process's devices, sized by the global count, with
    the reference's axis layout: `devices` are this process's (default
    its `initialize` device; every card without a group), gathered from
    every process in rank order, so processes own consecutive
    coordinates and any axis may cross them. The configuration and the
    layout are checked on every process before the first collective
    (the same arguments give the same refusal everywhere); then the
    groups of `GROUP_AXES` form (`Mesh.groups`)."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return mesh_mod.build_mesh(cfg, devices)
    mine = [str(torch.device(d)) for d in
            (devices if devices is not None else [local_device()])]
    world, rank = dist.get_world_size(), dist.get_rank()
    sizes = mesh_mod.resolve_axis_sizes(cfg or MeshConfig(),
                                        world * len(mine))
    mesh_mod.check_owners([sizes[a] for a in mesh_mod.AXES],
                          [p for p in range(world) for _ in mine])
    everyone: list = [None] * world
    dist.all_gather_object(everyone, mine)
    if len({len(ds) for ds in everyone}) > 1:
        raise ValueError(f"processes hold different device counts: "
                         f"{everyone}")
    mesh = mesh_mod.build_mesh(
        cfg, [d for ds in everyone for d in ds],
        owners=[p for p, ds in enumerate(everyone) for _ in ds], rank=rank)
    return dataclasses.replace(mesh, groups=form_groups(mesh))


def form_groups(mesh: mesh_mod.Mesh) -> dict:
    """One process group per set of processes a collective over an axis
    set of `GROUP_AXES` spans, each created once, in one order, on every
    process (`new_group` is collective: a process outside a group takes
    part in its creation too), each with the default group's timeout;
    the whole world is the default group.
    Returns ranks -> group for this process's groups."""
    dist = torch.distributed
    world = tuple(range(dist.get_world_size()))
    sets = set()
    for axes in GROUP_AXES:
        for p in world:
            ranks = mesh_mod.axis_ranks(
                dataclasses.replace(mesh, rank=p), axes)
            if 1 < len(ranks) < len(world):
                sets.add(ranks)
    groups = {world: dist.group.WORLD}
    for ranks in sorted(sets):
        group = dist.new_group(
            list(ranks), timeout=datetime.timedelta(seconds=TIMEOUT_S))
        if mesh.rank in ranks:
            groups[ranks] = group
    return groups
