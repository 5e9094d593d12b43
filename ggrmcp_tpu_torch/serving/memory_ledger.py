"""Device-memory ledger: named accounting of every persistent device
allocation of the serving stack, reconciled against what the device
holds. Port of `ggrmcp_tpu/serving/memory_ledger.py` for torch.

- Every owner of a persistent allocation REGISTERS a named component
  with a zero-argument supplier returning its live tensor tree
  (`ledger.register("kv_arena", lambda: (cache.k, cache.v, ...))`);
  the supplier reads the owner's current attributes, so a cache rebuilt
  after a failure is accounted at the next read.
- Bytes are counted per distinct STORAGE (`untyped_storage()`): a view,
  an alias or a tensor reachable twice in one tree counts once, and a
  storage claimed by two components is attributed to the first and
  counted in `double_registered`.
- `reconcile()` partitions the devices' live bytes: `live` is the sum
  of `torch.cuda.memory_allocated` over the mesh's distinct CUDA
  devices and, on the CPU, a census of the live tensors there by
  storage; `unattributed`
  is `live - attributed`, so attributed + unattributed == live by
  construction. Unattributed bytes are what no component claims: a
  tensor nobody registered, and on CUDA the caching allocator's
  rounding of each block. The live tensors no component claims are
  listed (largest first) from the same census.

Disabled (serving.observability.enabled = false): `register` stores
nothing and every query is empty.

Threading: registration happens at construction; queries run from the
stats and debug paths and read attributes the batcher's executor
mutates (the usual stale-read contract). The TTL cache takes a lock.
"""

from __future__ import annotations

import dataclasses
import gc
import threading
import time
from typing import Any, Callable, Iterator, Optional

import torch

def tensor_leaves(tree: Any) -> Iterator[torch.Tensor]:
    """Every tensor of a supplier's tree: tensors, dicts, lists, tuples
    and dataclasses (caches, quantized tensors); None prunes."""
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from tensor_leaves(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from tensor_leaves(value)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from tensor_leaves(getattr(tree, f.name))


def _storage(t: torch.Tensor) -> Optional[tuple[int, int]]:
    """(data pointer, bytes) of a tensor's storage; None for a tensor
    that has none (sparse, meta) or holds no bytes."""
    try:
        s = t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None
    n = s.nbytes()
    return (s.data_ptr(), n) if n else None


def _census(devices: list[torch.device]
            ) -> dict[int, tuple[int, torch.Tensor]]:
    """data pointer -> (bytes, one tensor) of every distinct storage that
    a live Python-visible tensor on one of `devices` holds."""
    out: dict[int, tuple[int, torch.Tensor]] = {}
    for obj in gc.get_objects():
        # type(), not isinstance(): the latter reads `__class__`, which
        # some deprecated module proxies answer with a warning.
        if (not issubclass(type(obj), torch.Tensor)
                or obj.device not in devices):
            continue
        key = _storage(obj)
        if key is not None and key[0] not in out:
            out[key[0]] = (key[1], obj)
    return out


class MemoryLedger:
    """Registry of named persistent allocations for ONE engine on its
    mesh's devices (one device, or each shard's; a device the mesh
    names twice counts once) and the batchers built over it (per-tier
    scopes)."""

    def __init__(self, devices, enabled: bool = True):
        if isinstance(devices, (str, torch.device)):
            devices = [devices]
        self.devices = list(dict.fromkeys(torch.device(d) for d in devices))
        self.enabled = bool(enabled)
        self._suppliers: dict[tuple[str, str], Callable[[], Any]] = {}
        self._host_suppliers: dict[tuple[str, str], Callable[[], Any]] = {}
        self._lock = threading.Lock()
        self._cache: tuple[float, dict] = (0.0, {})

    def register(
        self, component: str, supplier: Callable[[], Any], scope: str = ""
    ) -> None:
        """Attach a component; re-registering a key replaces it."""
        if self.enabled:
            self._suppliers[(scope, component)] = supplier

    def register_host(
        self, component: str, supplier: Callable[[], Any], scope: str = ""
    ) -> None:
        """Attach a HOST-memory component (the host page pool). The
        supplier returns a dict with at least `bytes` and `entries`, or
        None while the component is off. Host bytes are exact by
        construction (the owner counts what it stores), so they have no
        reconcile pass; GetMemory reports them as its `host` section."""
        if self.enabled:
            self._host_suppliers[(scope, component)] = supplier

    # -- queries -------------------------------------------------------------

    def component_storages(self) -> dict[tuple[str, str], dict[int, int]]:
        """(scope, component) -> {data pointer: bytes} of the distinct
        storages on this ledger's devices each supplier holds. Supplier
        errors are the owner's bug and propagate."""
        out = {}
        for key, supplier in self._suppliers.items():
            storages: dict[int, int] = {}
            for leaf in tensor_leaves(supplier()):
                if leaf.device not in self.devices:
                    continue
                st = _storage(leaf)
                if st is not None:
                    storages[st[0]] = st[1]
            out[key] = storages
        return out

    def component_bytes(self, max_age_s: float = 0.0) -> dict:
        """(scope, component) -> bytes. `max_age_s` > 0 may serve a
        cached snapshot (the per-tick record path): sizes change only
        on allocation and rebuild events."""
        if not self.enabled:
            return {}
        now = time.monotonic()
        with self._lock:
            stamp, cached = self._cache
            if max_age_s > 0 and now - stamp < max_age_s:
                return dict(cached)
        out = {
            key: sum(storages.values())
            for key, storages in self.component_storages().items()
        }
        with self._lock:
            self._cache = (now, dict(out))
        return out

    def host_components(self) -> dict[tuple[str, str], dict]:
        """(scope, component) -> host-memory info (bytes, entries, ...)
        of every registered host component that is on."""
        out: dict[tuple[str, str], dict] = {}
        for key, supplier in self._host_suppliers.items():
            info = supplier()
            if info is not None:
                out[key] = info
        return out

    # -- closure -------------------------------------------------------------

    def reconcile(self) -> dict:
        """Partition the device's live bytes against the registered
        components: per-component bytes (first registration wins for a
        storage claimed twice), attributed / live / unattributed totals,
        and the live tensors no component claims. attributed +
        unattributed == live holds by construction."""
        owner: dict[int, int] = {}  # data pointer -> bytes
        per_comp: dict[tuple[str, str], int] = {}
        double = 0
        for key, storages in self.component_storages().items():
            per_comp.setdefault(key, 0)
            for ptr, n in storages.items():
                if ptr in owner:
                    double += 1
                    continue
                owner[ptr] = n
                per_comp[key] += n
        cuda = [d for d in self.devices if d.type == "cuda"]
        for dev in cuda:
            torch.cuda.synchronize(dev)
        census = _census(self.devices)
        for ptr, n in owner.items():
            # A claimed storage is live whether or not the census saw it.
            census.setdefault(ptr, (n, None))
        live = (sum(int(torch.cuda.memory_allocated(d)) for d in cuda)
                if cuda else sum(n for n, _ in census.values()))
        attributed = sum(per_comp.values())
        unattributed = sorted(
            (
                {"shape": list(t.shape), "dtype": str(t.dtype), "bytes": n}
                for ptr, (n, t) in census.items() if ptr not in owner
            ),
            key=lambda e: -e["bytes"],
        )
        return {
            "components": {
                f"{scope}/{comp}" if scope else comp: b
                for (scope, comp), b in sorted(per_comp.items())
            },
            "attributed_bytes": attributed,
            "live_bytes": live,
            "unattributed_bytes": live - attributed,
            "unattributed_arrays": unattributed,
            "double_registered": double,
        }
