"""Dynamic LoRA adapter arena: many tenants' adapters served from one
batch. Port of `ggrmcp_tpu/serving/adapter_arena.py`: the host half
(refcounts, LRU, the name index, the live registry scan, the name and
path checks and the typed errors) is the reference's code; the device
half is rewritten for torch.

- *Registered* adapters are a DISK REGISTRY (`serving.lora.registry`):
  one `{name}.npz` per adapter with pre-scaled float32 factors `a`
  [L, D, r] / `b` [L, r, (H+2KVH)*Dh]. Discoverable at runtime:
  dropping a new file serves a new tenant with no restart.
- *Resident* adapters occupy rows 1..R of ONE fixed-shape device pair
  `lora_qkv_a` [L, R+1, D, r] / `lora_qkv_b` [L, R+1, r, O] (row 0 is
  the reserved base no-op). The pair is allocated once, zeroed; a load
  writes one row of each IN PLACE and never reallocates, so
  `params["layers"]` holds the same tensors for the arena's lifetime.
- Admission resolves `adapter name → arena row` through `acquire()`:
  resident names refcount-share their row; missing ones load from the
  registry, one host-to-device copy per factor, serialized through the
  batcher's `run_host_op` stream BETWEEN ticks. Refcount-0 rows stay
  resident as LRU cache and evict under churn; when every row is
  pinned by in-flight requests the acquire sheds TYPED
  (`AdapterExhaustedError` → RESOURCE_EXHAUSTED), the same overload
  ladder as page exhaustion.

Threading: host state (row maps, refcounts, stamps) takes an internal
lock: releases run from both the loop thread (shed paths) and the
executor stream (`_record_terminal`). Loads (the device writes) run
inside the batcher's serialized stream: the sidecar routes every
serving-path acquire through `ContinuousBatcher.acquire_adapter`
(run_host_op). The copies come from pageable host memory, which
returns only once the write is done, on the stream every tick uses.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Callable, Optional

import numpy as np

import torch

from ggrmcp_tpu_torch.utils import failpoints

logger = logging.getLogger("ggrmcp.torch.adapter_arena")


class AdapterExhaustedError(RuntimeError):
    """Every arena row is pinned by an in-flight request: the arena
    cannot host another adapter even after evicting all reusable
    (refcount-0) rows. The sidecar sheds the request typed —
    RESOURCE_EXHAUSTED, HTTP 429 + Retry-After at the gateway (the
    overload ladder) — and resident rows are untouched."""


class UnknownAdapterError(ValueError):
    """The adapter name is in neither the registry nor the resident
    set: the CALLER's error (INVALID_ARGUMENT), never a 500."""


class AdapterLoadError(RuntimeError):
    """Reading or installing a registered adapter's factors failed
    (unreadable/corrupt npz, injected `adapter_load_fail` chaos, device
    write failure). TYPED degradation: the request is aborted loudly —
    it must shed or retry on a replica holding the adapter, never
    silently serve base weights."""


@dataclasses.dataclass
class AdapterLease:
    """One request's pin on an arena row. Held from acquire() until the
    request's terminal chunk (`_record_terminal` releases it on every
    terminal path, like the grammar handle); a pinned row can never be
    evicted under churn. Row 0 (the base no-op) is never refcounted —
    its lease is inert."""

    name: str
    row: int
    released: bool = False


class AdapterArena:
    """Host-side manager of the device-resident adapter working set —
    refcounts / LRU / name index exactly like `PageAllocator`, over
    adapter factor rows instead of KV pages."""

    def __init__(
        self,
        registry: str,
        rows: int,
        rank: int,
        cfg,  # models.llama.LlamaConfig (geometry + dtype)
        device=None,
        ledger=None,
        ledger_scope: str = "",
        mesh=None,
    ):
        if rows < 1:
            raise ValueError("adapter arena needs at least 1 row")
        if rank < 1:
            raise ValueError("lora.rank must be >= 1")
        if not registry:
            raise ValueError("adapter arena requires lora.registry")
        self.registry = registry
        self.rows = rows
        self.rank = rank
        self._cfg = cfg
        self._device = torch.device(device) if device is not None else (
            torch.device("cpu"))
        self._mesh = mesh
        self._commit: Optional[Callable[[], None]] = None
        self._lock = threading.Lock()
        # name <-> row maps (the "hash index": resident names resolve
        # in O(1), like the page allocator's chain-key index).
        self._row_of: dict[str, int] = {}
        self._name_of: dict[int, str] = {}
        self._ref = np.zeros(rows + 1, np.int64)  # row 0 unused
        self._free: list[int] = list(range(1, rows + 1))
        self._stamp: dict[int, int] = {}  # LRU stamps, refcount-0 rows
        self._clock = 0
        # Counters (ServingStats lora_* fields).
        self.loads = 0
        self.evictions = 0
        self.hits = 0
        self.shed = 0
        self.load_ms = 0.0
        self._build_device_rows()
        if ledger is not None:
            self.register_ledger(ledger, ledger_scope)

    # -- device arrays -------------------------------------------------------

    def _build_device_rows(self) -> None:
        """The fixed-shape device working set: all-zero rows (every row
        starts as an exact no-op, b == 0). ONE allocation for the
        arena's whole lifetime; loads only ever write a row in place,
        never reallocate. On a mesh `b` splits by wqkv's head-aligned
        columns over tensor and `a` is replicated (`llama.lora_specs`)."""
        from ggrmcp_tpu_torch.models import llama

        cfg = self._cfg
        qkv_out = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
        dtype = cfg.torch_dtype
        self.a_dev = torch.zeros(
            (cfg.num_layers, self.rows + 1, cfg.hidden_dim, self.rank),
            dtype=dtype, device=self._device,
        )
        self.b_dev = torch.zeros(
            (cfg.num_layers, self.rows + 1, self.rank, qkv_out),
            dtype=dtype, device=self._device,
        )
        if self._mesh is not None:
            placed = llama.shard_lora(
                {"lora_qkv_a": self.a_dev, "lora_qkv_b": self.b_dev}, cfg,
                self._mesh)
            self.a_dev, self.b_dev = (placed["lora_qkv_a"],
                                      placed["lora_qkv_b"])

    def register_ledger(self, ledger, scope: str = "") -> None:
        """Register the arena arrays as the engine ledger's `lora`
        component (the supplier reads the LIVE attributes, so row
        updates are accounted automatically). The engine's params tree
        holds the SAME array objects, and reconcile() attributes by
        identity to the first registrant — the weights supplier
        excludes lora_ keys, so the partition stays exact."""
        ledger.register(
            "lora", lambda: (self.a_dev, self.b_dev), scope=scope
        )

    def attach_commit(self, fn: Callable[[], None]) -> None:
        """`fn()` runs after every successful load: the engine
        reinstalls the (new) arena arrays into params["layers"] so the
        next device call serves the loaded factors."""
        self._commit = fn

    # -- registry ------------------------------------------------------------

    @staticmethod
    def _check_name(name: str) -> None:
        # Names become `{registry}/{name}.npz` — separators would let a
        # request read factors from outside the directory (the same
        # rule the boot-time loader enforces on config names).
        if "/" in name or "\\" in name or name.startswith("."):
            raise UnknownAdapterError(
                f"adapter name {name!r} must be a plain name (no path "
                f"separators or leading dots)"
            )

    def registered(self) -> list[str]:
        """Adapter names currently discoverable in the registry — a
        LIVE directory scan, so a file dropped after engine boot is
        served with no restart (the whole point of the registry)."""
        try:
            entries = os.listdir(self.registry)
        except OSError:
            return []
        return sorted(
            e[: -len(".npz")] for e in entries
            if e.endswith(".npz") and not e.startswith(".")
        )

    def resident(self) -> int:
        """Rows holding an adapter (pinned + LRU-cached)."""
        with self._lock:
            return len(self._row_of)

    # -- residency -----------------------------------------------------------

    def acquire(self, name: str) -> AdapterLease:
        """Resolve `name` to a pinned arena row, loading its factors
        from the registry when not resident. Runs inside the batcher's
        serialized run_host_op stream on every serving path — the H2D
        factor write lands between ticks, never racing a dispatch."""
        if not name:
            return AdapterLease("", 0)
        self._check_name(name)
        with self._lock:
            row = self._row_of.get(name)
            if row is not None:
                if self._ref[row] == 0:
                    self._stamp.pop(row, None)
                self._ref[row] += 1
                self.hits += 1
                return AdapterLease(name, row)
            path = os.path.join(self.registry, f"{name}.npz")
            if not os.path.exists(path):
                raise UnknownAdapterError(
                    f"unknown adapter {name!r}; registered: "
                    f"{self.registered()}"
                )
            row = self._take_row_locked()
        # The load itself runs outside the lock (disk + device work;
        # the row is reserved — mapped to no name, refcount 1 pending —
        # so no concurrent acquire can take it).
        try:
            self._load(name, row, path)
        except Exception:
            with self._lock:
                self._ref[row] = 0
                self._free.append(row)
            raise
        with self._lock:
            self._row_of[name] = row
            self._name_of[row] = name
        return AdapterLease(name, row)

    def _take_row_locked(self) -> int:
        """A free row, else the LRU refcount-0 resident row (evicted),
        else typed exhaustion. The evicted row's stale factors stay in
        device memory until the load overwrites them — harmless, no
        live request references the row (refcount 0 is the invariant
        the lease pin exists to hold)."""
        if self._free:
            row = self._free.pop()
        elif self._stamp:
            row = min(self._stamp, key=self._stamp.__getitem__)
            del self._stamp[row]
            name = self._name_of.pop(row)
            del self._row_of[name]
            self.evictions += 1
            logger.info("adapter arena: evicted %r from row %d", name, row)
        else:
            self.shed += 1
            raise AdapterExhaustedError(
                f"adapter arena exhausted: all {self.rows} rows pinned "
                f"by in-flight requests"
            )
        self._ref[row] = 1  # reserved for the pending load
        return row

    def _load(self, name: str, row: int, path: str) -> None:
        """Read `{name}.npz` and install its factors into arena `row`:
        one all-layer host-to-device copy per factor, written in place
        (`a_dev[:, row].copy_(...)`; every shard its own columns on a
        mesh, `llama.set_lora_row`), so the tensors every caller holds
        serve the new row at the next forward."""
        from ggrmcp_tpu_torch.models import llama

        t0 = time.perf_counter()
        # Failpoint adapter_load_fail: an injected fault IS a failed
        # load, the same typed path as a corrupt file; the reserved row
        # returns to the free list.
        try:
            failpoints.evaluate("adapter_load_fail")
        except failpoints.FailpointError as exc:
            raise AdapterLoadError(
                f"adapter {name!r} load failed (injected): {exc}"
            ) from exc
        cfg = self._cfg
        qkv_out = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
        want_a = (cfg.num_layers, cfg.hidden_dim, self.rank)
        want_b = (cfg.num_layers, self.rank, qkv_out)
        try:
            with np.load(path) as data:
                a = np.asarray(data["a"])
                b = np.asarray(data["b"])
        except Exception as exc:  # noqa: BLE001 — typed AdapterLoadError
            raise AdapterLoadError(
                f"adapter {name!r}: unreadable factors at {path}: {exc}"
            ) from exc
        if a.shape != want_a or b.shape != want_b:
            raise AdapterLoadError(
                f"adapter {name!r}: factor shapes {a.shape}/{b.shape} != "
                f"expected {want_a}/{want_b} (pre-scaled a [L, D, r] / "
                f"b [L, r, (H+2KVH)*Dh])"
            )
        dtype = cfg.torch_dtype
        try:
            for leaf, value in ((self.a_dev, a), (self.b_dev, b)):
                llama.set_lora_row(leaf, row, torch.from_numpy(
                    np.ascontiguousarray(value, np.float32)).to(dtype), cfg)
        except Exception as exc:  # noqa: BLE001 — typed AdapterLoadError
            raise AdapterLoadError(
                f"adapter {name!r}: device install failed: {exc}"
            ) from exc
        if self._commit is not None:
            self._commit()
        dt = (time.perf_counter() - t0) * 1000.0
        self.loads += 1
        self.load_ms += dt
        logger.info(
            "adapter arena: loaded %r into row %d (%.1f ms)", name, row, dt
        )

    def release(self, lease: AdapterLease) -> None:
        """Return a terminal request's pin (idempotent — several
        terminal paths can observe the same request). Refcount-0 rows
        stay RESIDENT as LRU cache: the next same-adapter admission is
        a free hit, eviction only happens under churn pressure."""
        if lease.released or lease.row == 0:
            lease.released = True
            return
        lease.released = True
        with self._lock:
            row = lease.row
            if self._name_of.get(row) != lease.name:
                return  # row was force-reset (tick-failure recovery)
            self._ref[row] -= 1
            if self._ref[row] <= 0:
                self._ref[row] = 0
                self._clock += 1
                self._stamp[row] = self._clock

    # -- stats / audit -------------------------------------------------------

    def stats(self) -> dict:
        """ServingStats lora_* scalars (gateway_backend_lora_*)."""
        with self._lock:
            resident = len(self._row_of)
        return {
            "lora_adapters_registered": len(self.registered()),
            "lora_adapters_resident": resident,
            "lora_rows_total": self.rows,
            "lora_loads": self.loads,
            "lora_evictions": self.evictions,
            "lora_hits": self.hits,
            "lora_load_ms": round(self.load_ms, 2),
            "lora_shed": self.shed,
        }

    def check_invariants(self) -> None:
        """Exhaustive bookkeeping audit (test surface — the churn
        regression suite calls this between steps to prove no row is
        lost or double-mapped). Raises AssertionError naming the
        violated invariant."""
        with self._lock:
            free = set(self._free)
            assert len(free) == len(self._free), "duplicate free row"
            for row in free:
                assert self._ref[row] == 0, f"free row {row} has refs"
                assert row not in self._name_of, f"free row {row} mapped"
            for name, row in self._row_of.items():
                assert self._name_of.get(row) == name, (
                    f"row maps disagree for {name!r}"
                )
                assert row not in free, f"resident row {row} is free"
                if self._ref[row] == 0:
                    assert row in self._stamp, (
                        f"refcount-0 resident row {row} unstamped (leak)"
                    )
            for row in self._stamp:
                assert self._ref[row] == 0, f"stamped row {row} has refs"
                assert row in self._name_of, f"stamped row {row} unmapped"
            # Conservation: every row is free, pending, or mapped.
            pending = sum(
                1 for row in range(1, self.rows + 1)
                if self._ref[row] > 0 and row not in self._name_of
                and row not in free
            )
            assert len(free) + len(self._row_of) + pending == self.rows, (
                f"rows lost: {len(free)} free + {len(self._row_of)} "
                f"mapped + {pending} pending != {self.rows}"
            )
