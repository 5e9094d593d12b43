"""Device mesh construction and sharding specs.

Port of `ggrmcp_tpu/parallel/mesh.py`'s host-side logic. The reference
builds a `jax.sharding.Mesh` and lets XLA insert the collectives; here a
mesh is a plain object — the six axis sizes in the reference's order and
an explicit `torch.device` per coordinate — and the collectives are the
explicit functions of parallel/collectives.py. One process drives every
coordinate (the reference's single-controller model), so the device
list may name one device more than once: two tensor shards on one card,
or any number on the CPU.

A mesh over several processes (parallel/distributed.py's `global_mesh`,
the reference's multi-controller mesh) also names the process that owns
each coordinate. Processes own consecutive flat coordinates, as many
each (the reference's process-major reshape of `jax.devices()`), so a
process holds a box of the mesh: one index on each axis before the one
its share splits, a run of that axis, every index of the axes after it.
Any axis may cross processes. Each process builds, places and computes
its own coordinates only, one device a process: `Mesh.home` is the
corner of its box (where it computes an axis it replicates), `local()`
its box as a mesh of its own, `process_rows` its rows of a global
batch, `axis_ranks` the processes a collective over some axes spans. A
mesh of one process behaves as before.

A spec is a tuple with one entry per array dim: None (replicated), an
axis name, or a tuple of axis names (the dim split over their product),
the entries of a `PartitionSpec`.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Optional, Sequence

import torch

from ggrmcp_tpu_torch.core.config import MeshConfig
from ggrmcp_tpu_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger("ggrmcp.torch.parallel.mesh")

# Canonical axis order; axes of size 1 are still present.
AXES = ("data", "fsdp", "tensor", "sequence", "expert", "stage")
# The batch dim's spec entry (the reference's `shard_batch`): rows split
# over data x fsdp, data major.
BATCH_AXES = ("data", "fsdp")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes (in AXES order) and the device of every coordinate,
    flattened row-major over AXES (the last axis fastest)."""

    sizes: tuple[int, ...]
    devices: tuple[torch.device, ...]
    # The process (rank) owning each coordinate, and this process's rank;
    # None: this process owns every coordinate.
    owners: Optional[tuple[int, ...]] = None
    rank: int = 0
    # Ranks -> the process group of those processes, for this process's
    # collectives (parallel/distributed.py `global_mesh`).
    groups: Optional[dict] = dataclasses.field(default=None, compare=False,
                                               repr=False)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(AXES, self.sizes))

    @property
    def spans_processes(self) -> bool:
        return self.owners is not None and len(set(self.owners)) > 1

    def is_local(self, index: int) -> bool:
        return self.owners is None or self.owners[index] == self.rank

    def local_indices(self) -> list[int]:
        """The flat coordinates this process owns, in order."""
        return [i for i in range(self.size) if self.is_local(i)]

    @property
    def home(self) -> dict[str, int]:
        """The first coordinate this process owns (the corner of its
        box; index 0 on every axis for a mesh of one process)."""
        if self.owners is None:
            return dict.fromkeys(AXES, 0)
        return self.coord(self.owners.index(self.rank))

    def box(self, rank: int) -> tuple[tuple[int, int], ...]:
        """The [first, last] index on each axis of process `rank`'s
        coordinates."""
        first = self.owners.index(rank)
        last = len(self.owners) - 1 - self.owners[::-1].index(rank)
        lo, hi = self.coord(first), self.coord(last)
        return tuple((lo[a], hi[a]) for a in AXES)

    def local(self) -> "Mesh":
        """This process's coordinates as a mesh of one process: its box,
        the axes in order (itself when it owns every coordinate)."""
        if not self.spans_processes:
            return self
        box = self.box(self.rank)
        return Mesh(tuple(hi - lo + 1 for lo, hi in box),
                    tuple(self.devices[i] for i in self.local_indices()))

    @property
    def size(self) -> int:
        return len(self.devices)

    def coord(self, index: int) -> dict[str, int]:
        """Axis name -> index of flat coordinate `index`."""
        out = {}
        for name, n in reversed(list(zip(AXES, self.sizes))):
            out[name] = index % n
            index //= n
        return out

    def index(self, **coord: int) -> int:
        """Flat index of a coordinate (axes left out are at 0)."""
        flat = 0
        for name, n in zip(AXES, self.sizes):
            flat = flat * n + coord.get(name, 0)
        return flat

    def distinct_devices(self) -> list[torch.device]:
        """This process's devices, each once."""
        return list(dict.fromkeys(self.devices[i]
                                  for i in self.local_indices()))


def resolve_axis_sizes(
    cfg: MeshConfig, n_devices: Optional[int] = None
) -> dict[str, int]:
    """Fill in zero ("infer") axes so the product equals n_devices
    (default: the CUDA devices)."""
    n = n_devices if n_devices is not None else torch.cuda.device_count()
    sizes = {
        "data": cfg.data,
        "fsdp": cfg.fsdp,
        "tensor": cfg.tensor,
        "sequence": cfg.sequence,
        "expert": cfg.expert,
        "stage": cfg.stage,
    }
    fixed = math.prod(v for v in sizes.values() if v > 0)
    free = [k for k, v in sizes.items() if v == 0]
    if n % max(fixed, 1) != 0:
        raise ValueError(
            f"device count {n} not divisible by fixed axis product {fixed}"
        )
    remaining = n // max(fixed, 1)
    if not free:
        if fixed != n:
            raise ValueError(
                f"axis product {fixed} != device count {n}; set one axis "
                f"to 0 to infer it"
            )
    else:
        # First free axis soaks up the remainder; the rest get 1.
        sizes[free[0]] = remaining
        for k in free[1:]:
            sizes[k] = 1
    return sizes


def _cards() -> list[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def default_devices(
    cfg: Optional[MeshConfig], device: torch.device, named: bool = False
) -> list[torch.device]:
    """The device list a mesh is built over when none is given. On the
    CPU, `device` repeated as many times as the fixed axes' product, so
    an inferred axis resolves to 1. On CUDA, `device` alone unless `cfg`
    asks for more than one coordinate (a fixed axis above 1): then every
    card, which a caller that `named` one card index cannot have."""
    cfg = cfg or MeshConfig()
    fixed = math.prod(getattr(cfg, a) for a in AXES if getattr(cfg, a) > 0)
    if device.type == "cpu":
        return [device] * max(fixed, 1)
    if fixed <= 1:
        return [device]
    if named:
        raise ValueError(
            f"serving.mesh asks for {fixed} coordinates but device "
            f"{device} names one card: name no card index to shard over "
            f"every card, or pass a mesh built over a device list")
    return _cards()


def serving_mesh(cfg: Optional[MeshConfig], device: DeviceLike = None) -> Mesh:
    """The mesh an entry point serves on when it is given none: `cfg`
    over `default_devices` of the caller's device (None = the current
    card)."""
    named = device is not None and torch.device(device).index is not None
    dev = resolve_device(device)
    return build_mesh(cfg, default_devices(cfg, dev, named))


def build_mesh(
    cfg: Optional[MeshConfig] = None,
    devices: Optional[Sequence] = None,
    owners: Optional[Sequence[int]] = None,
    rank: int = 0,
) -> Mesh:
    """The mesh of `cfg` over `devices` (default: every CUDA card).
    `owners`: the process owning each device's coordinate (every one of
    them `rank`'s when None): consecutive coordinates, as many for each
    process, a box of the mesh each, on one device each."""
    cfg = cfg or MeshConfig()
    devs = ([torch.device(d) for d in devices] if devices is not None
            else _cards())
    if not devs:
        raise ValueError("build_mesh: no devices")
    sizes = resolve_axis_sizes(cfg, len(devs))
    mesh = Mesh(tuple(sizes[a] for a in AXES), tuple(devs),
                None if owners is None else tuple(owners), rank)
    if owners is not None:
        check_owners(mesh.sizes, mesh.owners)
        if rank not in mesh.owners:
            raise ValueError(f"rank {rank} owns no coordinate of "
                             f"{list(mesh.owners)}")
        for p in sorted(set(mesh.owners)):
            held = {mesh.devices[i] for i in range(mesh.size)
                    if mesh.owners[i] == p}
            if len(held) > 1:
                raise ValueError(
                    f"process {p} holds coordinates on {sorted(map(str, held))}:"
                    f" across processes each computes on one device (one "
                    f"process a card)")
    logger.info(
        "mesh: %s over %d coordinate(s) on %s%s",
        {a: s for a, s in sizes.items() if s > 1} or {"(single)": 1},
        len(devs), ", ".join(str(d) for d in mesh.distinct_devices()),
        f" (process {rank} of {len(set(owners))})" if owners else "",
    )
    return mesh


def check_owners(sizes: Sequence[int], owners: Sequence[int]) -> None:
    """Processes 0..n-1 own consecutive flat coordinates, as many each,
    and each one's share is a box of the mesh: a run of one axis times
    every index of the axes after it (the reference's process-major
    reshape gives no other). Reads nothing but its arguments, so every
    process refuses the same layouts before any collective."""
    owners = list(owners)
    if len(owners) != math.prod(sizes):
        raise ValueError(f"mesh owners: {len(owners)} for "
                         f"{math.prod(sizes)} coordinates")
    procs = sorted(set(owners))
    n = len(owners) // len(procs)
    shape = ",".join(f"{a}={s}" for a, s in zip(AXES, sizes) if s > 1)
    if (procs != list(range(len(procs)))
            or owners != [p for p in procs for _ in range(n)]):
        raise ValueError(
            f"mesh {shape} over processes {owners}: processes 0..n-1 own "
            f"consecutive coordinates, as many each")
    inner = 1
    for axis, size in reversed(list(zip(AXES, sizes))):
        if n <= inner * size:
            if n % inner or size % (n // inner):
                raise ValueError(
                    f"mesh {shape} over processes {owners}: {n} "
                    f"coordinates a process straddle the {axis} axis "
                    f"(a share is a run of one axis times every index of "
                    f"the axes after it)")
            return
        inner *= size


def axis_ranks(mesh: Mesh, axes: Sequence[str]) -> tuple[int, ...]:
    """The processes a collective over `axes` spans from this process:
    those whose boxes match this one's on every other axis (this
    process alone on a mesh of one)."""
    if not mesh.spans_processes:
        return (mesh.rank,)
    keep = [i for i, a in enumerate(AXES) if a not in axes]
    mine = mesh.box(mesh.rank)
    return tuple(p for p in sorted(set(mesh.owners))
                 if all(mesh.box(p)[i] == mine[i] for i in keep))


def coord_ranks(mesh: Mesh, coords: Sequence[int]) -> tuple[int, ...]:
    """The processes owning `coords`, in rank order."""
    if mesh.owners is None:
        return (mesh.rank,)
    return tuple(sorted({mesh.owners[c] for c in coords}))


def process_rows(mesh: Mesh, batch: int) -> slice:
    """The rows of a global [batch] that this process's data blocks
    hold (all of them on a mesh of one process, or when the data axes
    stay in one process). The data blocks must divide the batch when
    they cross processes: there is no single block there."""
    n = data_size(mesh)
    if not mesh.spans_processes or len(axis_ranks(mesh, BATCH_AXES)) == 1:
        return slice(0, batch)
    if batch % n:
        raise ValueError(f"a batch of {batch} rows over {n} data blocks "
                         f"on {len(set(mesh.owners))} processes: the blocks "
                         f"must divide it")
    blocks = [data_block(mesh, i) for i in mesh.local_indices()]
    per = batch // n
    return slice(min(blocks) * per, (max(blocks) + 1) * per)


def single_device_mesh(device: torch.device) -> Mesh:
    """A 1-device mesh with every axis of size 1."""
    return build_mesh(MeshConfig(tensor=1), [device])


def data_size(mesh: Mesh) -> int:
    """The number of data blocks a batch splits into (data x fsdp)."""
    return mesh.shape["data"] * mesh.shape["fsdp"]


def data_coord(mesh: Mesh, block: int) -> dict[str, int]:
    """The data and fsdp indices of data block `block` (the flat index
    over data x fsdp, data major, as a tuple entry orders its axes)."""
    fsdp = mesh.shape["fsdp"]
    return {"data": block // fsdp, "fsdp": block % fsdp}


def data_block(mesh: Mesh, index: int) -> int:
    """The data block flat coordinate `index` belongs to."""
    return block_index(mesh, BATCH_AXES, mesh.coord(index))


def data_blocks(mesh: Mesh, batch: int) -> list[tuple[slice, dict]]:
    """(rows, data coordinate) of every data block of a [batch] call, in
    batch order. A batch the data product does not divide runs as one
    block at data index 0 (the reference's `shard_map` needs the split
    to divide, so its dispatcher takes the unsharded path; one
    controller has no such limit and keeps the kernel). On a mesh over
    processes `batch` is this process's rows (`process_rows`), split
    over the data blocks it holds."""
    n = data_size(mesh)
    first = 0
    if mesh.spans_processes and len(axis_ranks(mesh, BATCH_AXES)) > 1:
        blocks = sorted({data_block(mesh, i) for i in mesh.local_indices()})
        first, n = blocks[0], len(blocks)
    if data_size(mesh) == 1 or batch % n:
        return [(slice(0, batch), {})]
    per = batch // n
    return [(slice(i * per, (i + 1) * per), data_coord(mesh, first + i))
            for i in range(n)]


def check_data_placement(mesh: Mesh) -> None:
    """Refuse data blocks on distinct devices for serving: the batcher
    moves cache rows between blocks (admission merges, the prefix pool,
    the draft pool) through one storage per device, which needs every
    block of a coordinate on one device; across cards that is the
    exchange of ROADMAP A18b item 3. A mesh over processes is refused,
    whatever axis crosses them: serving is one process (the reference's
    sidecar never joins a multi-controller runtime either)."""
    if mesh.spans_processes:
        raise ValueError(
            f"serving on {mesh_shape_str(mesh)} across "
            f"{len(set(mesh.owners))} processes: a sidecar is one process "
            f"(the multi-process mesh is for training)")
    if data_size(mesh) == 1:
        return
    for i, dev in enumerate(mesh.devices):
        home = mesh.index(**{**mesh.coord(i), "data": 0, "fsdp": 0})
        if mesh.devices[home] != dev:
            raise ValueError(
                f"serving on {mesh_shape_str(mesh)}: data blocks on "
                f"distinct devices ({mesh.devices[home]}, {dev}) need the "
                f"multi-card row exchange (ROADMAP A18b item 3); build "
                f"the mesh over one device repeated")


def axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape[name]


def _entry_names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def axis_product(mesh: Mesh, entry) -> int:
    """The number of blocks a spec entry splits its dim into."""
    sizes = mesh.shape
    return math.prod(sizes.get(n, 1) for n in _entry_names(entry))


def block_index(mesh: Mesh, entry, coord: dict[str, int]) -> int:
    """Which block of its dim a coordinate holds under a spec entry
    (row-major over the entry's axes)."""
    sizes = mesh.shape
    idx = 0
    for name in _entry_names(entry):
        idx = idx * sizes[name] + coord[name]
    return idx


def compatible_spec(
    spec: tuple, shape: tuple[int, ...], mesh: Mesh, on_downgrade=None
) -> tuple:
    """Drop spec axes whose mesh size doesn't divide the corresponding
    array dimension (replicate that dim instead). The result has one
    entry per dim of `shape`.

    `on_downgrade(dim_index, entry, dim_size, axis_size)` is invoked for
    every REAL downgrade — a named axis of product > 1 replaced by
    replication — so that a replicated fallback is counted, never a
    masquerade of tensor-parallel serving (the engine's
    `mesh_spec_downgrades`)."""
    out = []
    for i, (dim, entry) in enumerate(
        zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec)))
    ):
        product = max(axis_product(mesh, entry), 1)
        if dim % product == 0:
            out.append(entry)
        else:
            if on_downgrade is not None:
                on_downgrade(i, entry, dim, product)
            out.append(None)
    return tuple(out)


def drop_axis(spec: tuple, name: str) -> tuple:
    """`spec` with axis `name` taken out of every entry (that dim is no
    longer split over it)."""
    out = []
    for entry in spec:
        rest = tuple(n for n in _entry_names(entry) if n != name)
        out.append(None if not rest else
                   rest if isinstance(entry, tuple) else rest[0])
    return tuple(out)


def mesh_shape_str(mesh: Mesh) -> str:
    """Human-readable mesh shape ("tensor=8", "tensor=2,expert=2", or
    "single" for one device): the ServingStats `mesh_shape` label."""
    parts = [f"{a}={s}" for a, s in zip(AXES, mesh.sizes) if s > 1]
    return ",".join(parts) or "single"
