"""Host-tier KV page pool: DRAM (and optionally disk) behind the HBM
page arena (docs/paged_kv.md "Host tier").

At millions of users the preamble working set exceeds HBM itself, not
just the old slot pool: the paged arena's LRU then *discards*
refcount-0 indexed pages and every evicted prefix is a full recompute
— the thrash cliff the page arena flipped at 3x the working set comes back at
10x. The Mooncake/LMCache/vLLM-KV-offload answer is a multi-tier pool:
eviction DEMOTES page contents to host RAM (one D2H copy, int8 KV at
half the bytes), and a prefix hit on a demoted page RESTORES it with
one H2D copy instead of a prefill. This module is that host tier —
`PageAllocator` keeps owning the index and placement (the chain keys
here are THE SAME hash-chain keys the device index uses, so the prefix
index spans both tiers); this pool only stores and serves bytes.

Storage format: each entry is one serialized ``KVPagePayload``
(serving/tensors.py pack_kv_pages) — the exact codec TransferKV ships
pages with, so the wire plane and the host tier cannot drift.

Two sub-tiers:

* **RAM** — a byte-budgeted LRU dict (``batching.paged_kv_host_bytes``).
  put() evicts least-recently-used entries past the budget.
* **file** (optional, ``batching.paged_kv_host_path``) — an append-only
  record log read through ``mmap``. Writes are write-THROUGH on demote
  (dedup by key), so a RAM eviction never loses the only copy and a
  REPLICA RESTART warms from the file: chain keys are stable across
  processes (pages.py hashes with blake2b, not the salted builtin), so
  a fresh process re-derives the same keys from the same prompts and
  restores instead of recomputing — the fleet supervisor's
  drain → restart cycle re-admits sessions from the persisted pool
  (docs/fleet.md warm-restart runbook). A geometry header guards
  against loading a file written under a different page shape/dtype:
  mismatch logs and starts fresh, never serves wrong-shaped KV.

Threading: every method runs inside the owning batcher's serialized
executor calls, exactly like PageAllocator (docs/threading.md) —
demotes happen inside ``admit``'s reclaim, restores inside ``admit``,
imports/exports ride ``run_host_op``. stats() reads are loop-side
stale-read-safe snapshots of monotonic counters and ints.
"""

from __future__ import annotations

import dataclasses
import logging
import mmap
import os
import struct
from typing import Optional

import numpy as np

logger = logging.getLogger("ggrmcp.torch.host_pool")

# File-tier record log: MAGIC + header, then length-prefixed records.
#   header: <MAGIC><u32 header_len><header bytes = geometry signature>
#   record: <i64 key><i64 parent><u32 n_tokens><u32 blob_len>
#           <tokens int32 LE bytes><blob bytes>
_MAGIC = b"GGKVHOST1\n"
_REC = struct.Struct("<qqII")


@dataclasses.dataclass
class _Entry:
    parent: int
    tokens: np.ndarray  # int32 page tokens — content verification
    blob: bytes  # serialized KVPagePayload
    stamp: int


class HostPagePool:
    """Byte-budgeted host-RAM pool of demoted KV page contents, keyed
    by the device index's chain keys, with an optional mmap'd
    append-only file tier behind it."""

    def __init__(
        self,
        budget_bytes: int,
        geometry: str = "",
        file_path: str = "",
        file_budget_bytes: int = 0,
    ):
        if budget_bytes < 1:
            raise ValueError("host pool budget_bytes must be >= 1")
        self.budget = int(budget_bytes)
        self.geometry = geometry  # "<L>x<P>x<KVH>x<Dh>:<dtype>" guard
        self.file_path = file_path
        self.file_budget = int(file_budget_bytes or 0)
        self._entries: dict[int, _Entry] = {}
        self._bytes = 0
        self._clock = 0
        # File tier state: key -> (blob_offset, blob_len, parent,
        # tokens). The offset index is rebuilt by scanning the log at
        # open; reads go through one shared mmap view, remapped when
        # appends outgrow it.
        self._file = None
        self._mm: Optional[mmap.mmap] = None
        self._file_index: dict[int, tuple[int, int, int, np.ndarray]] = {}
        self._file_bytes = 0
        if file_path:
            self._open_file(file_path)

    # -- RAM tier ------------------------------------------------------------

    def put(
        self, key: int, parent: int, tokens: np.ndarray, blob: bytes
    ) -> int:
        """Store one demoted page's packed contents under its chain
        key. Returns the bytes newly stored in RAM (0 when the key was
        already resident — a page can be demoted, restored, and
        demoted again). Write-through to the file tier when
        configured, then LRU-evict RAM past the budget (file copies
        survive RAM eviction, so spill order doesn't matter)."""
        self._clock += 1
        entry = self._entries.get(key)
        if entry is not None:
            entry.stamp = self._clock
            return 0
        tokens = np.asarray(tokens, np.int32)
        self._append_file(key, parent, tokens, blob)
        self._entries[key] = _Entry(parent, tokens, blob, self._clock)
        self._bytes += len(blob)
        while self._bytes > self.budget and len(self._entries) > 1:
            lru = min(self._entries, key=lambda k: self._entries[k].stamp)
            self._bytes -= len(self._entries[lru].blob)
            del self._entries[lru]
        return len(blob)

    def has(self, key: int, tokens: np.ndarray) -> bool:
        """Content-verified membership across BOTH sub-tiers (the
        lookup the allocator's extended chain walk rides)."""
        entry = self._entries.get(key)
        if entry is not None:
            return np.array_equal(entry.tokens, tokens)
        rec = self._file_index.get(key)
        return rec is not None and np.array_equal(rec[3], tokens)

    def get(self, key: int, tokens: np.ndarray) -> Optional[bytes]:
        """The packed page contents for `key`, content-verified; RAM
        first, then the file tier. A RAM hit refreshes the LRU stamp.
        None on miss or token mismatch (hash collision verifies as a
        miss, exactly like the device index)."""
        entry = self._entries.get(key)
        if entry is not None:
            if not np.array_equal(entry.tokens, tokens):
                return None
            self._clock += 1
            entry.stamp = self._clock
            return entry.blob
        rec = self._file_index.get(key)
        if rec is None or not np.array_equal(rec[3], tokens):
            return None
        off, length, _parent, _toks = rec
        view = self._map()
        if view is None:
            return None
        return bytes(view[off:off + length])

    def drop(self, key: int) -> None:
        """Forget a RAM entry (file copies are append-only history and
        stay — dedup on re-put keys off the file index)."""
        entry = self._entries.pop(key, None)
        if entry is not None:
            self._bytes -= len(entry.blob)

    def clear(self) -> None:
        self._entries.clear()
        self._bytes = 0

    # -- file tier -----------------------------------------------------------

    def _open_file(self, path: str) -> None:
        """Open (or create) the record log and rebuild the offset
        index. A header mismatch — different page geometry/dtype, or a
        torn file — starts fresh: restoring wrong-shaped KV would be
        corruption, recomputing is merely slow."""
        header = _MAGIC + struct.pack(
            "<I", len(self.geometry.encode())
        ) + self.geometry.encode()
        exists = os.path.exists(path) and os.path.getsize(path) > 0
        if exists:
            try:
                with open(path, "rb") as fh:
                    if fh.read(len(header)) != header:
                        raise ValueError("header/geometry mismatch")
                self._file = open(path, "r+b")
                self._scan_file(len(header))
            except (OSError, ValueError, struct.error) as exc:
                logger.warning(
                    "host pool file %s unusable (%s): starting fresh",
                    path, exc,
                )
                self._file_index.clear()
                self._file = None
        if self._file is None:
            self._file = open(path, "w+b")
            self._file.write(header)
            self._file.flush()
        self._file.seek(0, os.SEEK_END)
        self._file_bytes = self._file.tell()

    def _scan_file(self, start: int) -> None:
        """Rebuild {key -> record} from the log (duplicate keys: last
        write wins). A torn tail record — a crash mid-append — is
        truncated away; everything before it is intact by format."""
        self._file.seek(0, os.SEEK_END)
        size = self._file.tell()
        good = start
        self._file.seek(start)
        while good + _REC.size <= size:
            hdr = self._file.read(_REC.size)
            if len(hdr) < _REC.size:
                break
            key, parent, n_tokens, blob_len = _REC.unpack(hdr)
            body = 4 * n_tokens + blob_len
            if good + _REC.size + body > size:
                break  # torn tail
            tokens = np.frombuffer(
                self._file.read(4 * n_tokens), np.int32
            ).copy()
            blob_off = good + _REC.size + 4 * n_tokens
            self._file.seek(blob_len, os.SEEK_CUR)
            self._file_index[key] = (blob_off, blob_len, parent, tokens)
            good += _REC.size + body
        if good < size:
            self._file.truncate(good)
            logger.warning(
                "host pool file %s: truncated torn tail at %d",
                self.file_path, good,
            )

    def _append_file(
        self, key: int, parent: int, tokens: np.ndarray, blob: bytes
    ) -> None:
        if self._file is None or key in self._file_index:
            return
        rec_len = _REC.size + 4 * len(tokens) + len(blob)
        if self.file_budget and self._file_bytes + rec_len > self.file_budget:
            return  # log full: RAM tier still serves; documented cap
        self._file.seek(0, os.SEEK_END)
        off = self._file.tell()
        self._file.write(_REC.pack(key, parent, len(tokens), len(blob)))
        self._file.write(np.asarray(tokens, np.int32).tobytes())
        self._file.write(blob)
        self._file.flush()
        self._file_bytes = off + rec_len
        self._file_index[key] = (
            off + _REC.size + 4 * len(tokens), len(blob), parent,
            np.asarray(tokens, np.int32).copy(),
        )
        # Appends invalidate the mapped view's size; remap lazily.
        if self._mm is not None:
            self._mm.close()
            self._mm = None

    def _map(self) -> Optional[mmap.mmap]:
        if self._file is None:
            return None
        if self._mm is None:
            try:
                self._mm = mmap.mmap(
                    self._file.fileno(), 0, access=mmap.ACCESS_READ
                )
            except (OSError, ValueError):
                return None
        return self._mm

    def close(self) -> None:
        """Release the file tier (appends are flushed per record, so
        the log is already durable). The pool keeps working RAM-only
        afterwards — the file index is dropped so lookups never point
        at an unreadable file."""
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        if self._file is not None:
            self._file.close()
            self._file = None
        self._file_index.clear()
        self._file_bytes = 0

    # -- stats ---------------------------------------------------------------

    def entries(self) -> int:
        return len(self._entries)

    def bytes_used(self) -> int:
        return self._bytes

    def stats(self) -> dict:
        """Occupancy gauges (the ServingStats kv_host_* fields)."""
        return {
            "kv_host_entries": len(self._entries),
            "kv_host_bytes_used": self._bytes,
            "kv_host_budget_bytes": self.budget,
            "kv_host_file_entries": len(self._file_index),
            "kv_host_file_bytes": self._file_bytes,
        }

    def memory_info(self) -> dict:
        """The memory ledger's host-supplier payload (`host` section
        of GET /debug/memory): occupancy vs budget plus the file
        tier's identity. Host bytes are exact by construction — the
        pool counts what it stores; no reconcile pass exists."""
        return {
            "bytes": self._bytes,
            "entries": len(self._entries),
            "budget_bytes": self.budget,
            "file_path": self.file_path,
            "file_bytes": self._file_bytes,
            "file_entries": len(self._file_index),
        }
