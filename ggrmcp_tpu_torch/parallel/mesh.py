"""Device mesh construction and sharding specs.

Port of `ggrmcp_tpu/parallel/mesh.py`'s host-side logic. The reference
builds a `jax.sharding.Mesh` and lets XLA insert the collectives; here a
mesh is a plain object — the six axis sizes in the reference's order and
an explicit `torch.device` per coordinate — and the collectives are the
explicit functions of parallel/collectives.py. One process drives every
coordinate (the reference's single-controller model), so the device
list may name one device more than once: two tensor shards on one card,
or any number on the CPU.

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

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(AXES, self.sizes))

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
        return list(dict.fromkeys(self.devices))


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
) -> Mesh:
    """The mesh of `cfg` over `devices` (default: every CUDA card)."""
    cfg = cfg or MeshConfig()
    devs = ([torch.device(d) for d in devices] if devices is not None
            else _cards())
    if not devs:
        raise ValueError("build_mesh: no devices")
    sizes = resolve_axis_sizes(cfg, len(devs))
    mesh = Mesh(tuple(sizes[a] for a in AXES), tuple(devs))
    logger.info(
        "mesh: %s over %d coordinate(s) on %s",
        {a: s for a, s in sizes.items() if s > 1} or {"(single)": 1},
        len(devs), ", ".join(str(d) for d in mesh.distinct_devices()),
    )
    return mesh


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
    controller has no such limit and keeps the kernel)."""
    n = data_size(mesh)
    if n == 1 or batch % n:
        return [(slice(0, batch), {})]
    per = batch // n
    return [(slice(i * per, (i + 1) * per), data_coord(mesh, i))
            for i in range(n)]


def check_data_placement(mesh: Mesh) -> None:
    """Refuse data blocks on distinct devices for serving: the batcher
    moves cache rows between blocks (admission merges, the prefix pool,
    the draft pool) through one storage per device, which needs every
    block of a coordinate on one device; across cards that is the
    exchange of ROADMAP A18b item 3."""
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
