"""Host-side page allocator for the paged KV cache (batching.paged_kv).

A copy of `ggrmcp_tpu/serving/pages.py` (the port imports nothing of
the JAX package); only the logger name differs in the code, so the
same call sequence through both gives identical tables and counters.
The batcher attaches the host tier (`attach_host`) when
`batching.paged_kv_host_bytes` > 0.

The KV plane's storage manager: the device holds ONE fixed-shape arena
of `[n_pages, page_size, kv_heads, head_dim]` K/V pages per layer
(models/llama.py::PagedKVCache) and every decode slot owns a
`[S_max / page_size]` int32 block-table row mapping its logical token
positions onto arena pages. This module owns everything about that
mapping that is HOST state — which it all is, by design: refcounts,
the free list, the token-content prefix index, LRU eviction stamps, and
the block tables themselves (the batcher uploads a table snapshot
before each device call; the device never allocates).

The prefix index spans TWO tiers: eviction under
pressure DEMOTES refcount-0 indexed pages' contents to a host-RAM pool
(serving/host_pool.py, one D2H copy) instead of discarding them, and
the admission lookup extends past the device-resident chain into host
entries — a prefix hit on a demoted page is one H2D restore instead of
a recomputed prefill (Mooncake/LMCache-style DRAM behind HBM,
docs/paged_kv.md "Host tier"). Chain keys are shared across tiers and
stable across processes, so an mmap'd file tier gives restarted
replicas warm restores.

vLLM's PagedAttention supplies the arena/block-table storage model;
SGLang's radix-tree prefix matching supplies the lookup discipline —
realized here as a hash CHAIN over page contents: page j of a prompt is
keyed by hash(key_{j-1}, tokens_j), so the longest page-aligned shared
prefix is found by walking children from the root in O(matched pages),
and any number of requests whose prompts share those pages hold
refcounts on the SAME physical pages (admitted once, stored once).
Copy-on-write happens at the first divergent page: if an indexed page
extends the matched chain and agrees with the request's next tokens for
t > 0 positions, its KV is gathered into the admission mini alongside
the shared prefix and re-merged into the request's own fresh page — one
page-sized device copy instead of recomputing up to page_size - 1
positions (the `paged_cow_copies` counter).

Invariants the device side relies on (serving/batching.py):
  * A page referenced by 2+ slots (or indexed for reuse) is IMMUTABLE:
    admission merges skip positions below the shared boundary and
    decode writes land at positions >= the owner's prompt length, which
    is always inside the owner's exclusive tail pages.
  * Only full pages whose every position is covered by a successfully
    prefilled prompt enter the index — indexed KV is always valid.
  * A parked slot's table row is reset to the out-of-range SENTINEL
    (= n_pages): in-flight device writes against a stale table row are
    scatter-dropped, never corruption.

Threading: every method runs inside the owning batcher's serialized
executor calls (docs/threading.md — batcher-owned host state, exactly
like the old prefix-pool maps this module replaces).
"""

from __future__ import annotations

import dataclasses
import hashlib
import heapq
import logging
from typing import Callable, Optional

import numpy as np

logger = logging.getLogger("ggrmcp.torch.pages")

_ROOT = 0  # chain key of the empty prefix (base-model domain)


def adapter_root(adapter: str) -> int:
    """Chain key every walk for `adapter` starts from — the key-DOMAIN
    separation that makes cross-adapter page sharing impossible by
    construction: an adapter'd prompt's page j is keyed by
    hash(..., hash(adapter_root, tokens_0), ..., tokens_j), so two
    adapters' chains can only collide as blake2b collisions (verified
    as misses against stored tokens, like any chain collision). Keys
    derive from the stable adapter NAME, never the arena row — rows
    are reused after eviction; names are the tenant identity (and stay
    stable across processes, so adapter'd pages ride the host tier's
    file tier and TransferKV exactly like base pages)."""
    if not adapter:
        return _ROOT
    h = hashlib.blake2b(digest_size=8)
    h.update(b"lora-adapter\x00")
    h.update(adapter.encode("utf-8", "surrogatepass"))
    # A zero digest would alias the base domain; astronomically
    # unlikely, and mapped off 0 so the invariant is unconditional.
    return int.from_bytes(h.digest(), "little", signed=True) or 1


class PageExhaustedError(RuntimeError):
    """The arena cannot supply the pages an admission needs even after
    evicting every reusable (refcount-0) cached page. The batcher sheds
    the request typed — RESOURCE_EXHAUSTED at the sidecar, HTTP 429 +
    Retry-After at the gateway (the overload ladder) — and resident
    block tables are untouched (admit() is all-or-nothing)."""


@dataclasses.dataclass(frozen=True)
class PageAdmission:
    """One admission's placement decision.

    merge_start: first position the suffix prefill must WRITE into the
        slot's pages (= shared full pages × page_size; everything below
        is shared, immutable storage).
    scan_start: first position the suffix prefill must COMPUTE —
        merge_start, plus the copy-on-write overlap when a cached
        divergent page supplied the first `scan_start - merge_start`
        positions' KV (those ride the gather and are re-merged into the
        slot's own page).
    gather_row: [table_width] int32 block-table row the admission
        program GATHERS the prefix view through — the slot's real row,
        except the first divergent entry points at the CoW source page.
    pages_shared: full prefix pages reused (refcounted, not copied).
    """

    merge_start: int
    scan_start: int
    gather_row: np.ndarray
    pages_shared: int
    # Prefix pages served by an H2D restore from the host tier (a
    # subset of pages_shared; 0 without a host pool). Restored pages
    # are re-indexed at refcount > 0, so from here on they are
    # ordinary shared device pages — the proven sharing path.
    pages_restored: int = 0


class PageAllocator:
    """Refcounted page allocator + token-level prefix index for ONE
    batcher's paged KV arena."""

    def __init__(self, n_pages: int, page_size: int, slots: int,
                 table_width: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError("n_pages and page_size must be >= 1")
        self.n_pages = n_pages
        self.page_size = page_size
        self.width = table_width
        self.sentinel = n_pages  # out-of-range: gather clips, scatter drops
        # [B, W] block tables — THE host-authoritative mapping; the
        # batcher snapshots it to the device when marked dirty.
        self.tables = np.full((slots, table_width), self.sentinel, np.int32)
        self._ref = np.zeros(n_pages, np.int64)
        self._free: list[int] = list(range(n_pages))
        # Prefix index: chain key -> page, plus per-page content and
        # chain linkage for verification, CoW probing, and eviction.
        self._index: dict[int, int] = {}
        self._key_of: dict[int, int] = {}
        self._tokens_of: dict[int, np.ndarray] = {}
        self._parent_of: dict[int, int] = {}
        self._children: dict[int, set[int]] = {}
        # LRU stamps for refcount-0 indexed pages (the evictable set).
        self._stamp: dict[int, int] = {}
        self._clock = 0
        # Host tier (serving/host_pool.py, attach_host): eviction
        # demotes page contents D2H instead of discarding, and the
        # prefix lookup extends past the device-resident chain into
        # host entries, restoring them H2D at admission. The two hooks
        # are the batcher's device halves: fetch gathers + packs
        # victim pages, restore unpacks + writes restored pages.
        self.host = None
        self._fetch_pages: Optional[Callable] = None
        self._restore_pages: Optional[Callable] = None
        # Counters (ServingStats): admissions that reused shared pages
        # or a CoW source / that found nothing; cumulative pages
        # reference-shared instead of recomputed; divergent-page copies.
        self.hits = 0
        self.misses = 0
        self.pages_reused = 0
        self.pages_admitted = 0
        self.cow_copies = 0
        # Host-tier traffic (all 0 without a host pool): pages demoted
        # D2H / restored H2D, payload bytes both ways, and admissions
        # whose restore failed and degraded typed to recompute.
        self.host_demotions = 0
        self.host_restores = 0
        self.host_bytes_demoted = 0
        self.host_bytes_restored = 0
        self.host_restore_failures = 0

    # -- stats ---------------------------------------------------------------

    def in_use(self) -> int:
        """Arena pages resident (live + cached-for-reuse) — the HBM
        occupancy gauge."""
        return self.n_pages - len(self._free)

    def shared(self) -> int:
        """Pages currently referenced by 2+ slots."""
        return int((self._ref >= 2).sum())

    def stats(self) -> dict:
        return {
            "kv_pages_total": self.n_pages,
            "kv_pages_in_use": self.in_use(),
            "kv_pages_shared": self.shared(),
            "paged_prefix_hits": self.hits,
            "paged_cow_copies": self.cow_copies,
            # Page-granular reuse: the binary hits counter above says
            # an admission reused SOMETHING (even a 1-token CoW
            # overlap); reused/admitted is the honest fraction of
            # admission pages served from the index — the signal the
            # replica-routing bench A/Bs (docs/routing.md).
            "paged_pages_reused": self.pages_reused,
            "paged_pages_admitted": self.pages_admitted,
            # Host tier (docs/paged_kv.md "Host tier"): traffic
            # counters here, occupancy gauges from the pool itself.
            # (pages_reused + host_restores) / pages_admitted is the
            # EFFECTIVE hit rate — admission pages not recomputed.
            "kv_host_demotions": self.host_demotions,
            "kv_host_restores": self.host_restores,
            "kv_host_bytes_demoted": self.host_bytes_demoted,
            "kv_host_bytes_restored": self.host_bytes_restored,
            "kv_host_restore_failures": self.host_restore_failures,
            **(
                self.host.stats() if self.host is not None else {
                    "kv_host_entries": 0, "kv_host_bytes_used": 0,
                    "kv_host_budget_bytes": 0,
                    "kv_host_file_entries": 0, "kv_host_file_bytes": 0,
                }
            ),
        }

    # -- host tier -----------------------------------------------------------

    def attach_host(
        self, pool, fetch: Callable, restore: Callable
    ) -> None:
        """Wire the host tier in. `fetch(pages) -> list[bytes]` gathers
        the arena pages D2H and packs each one (tensors.pack_kv_pages);
        `restore(pages, blobs)` unpacks and writes blobs into arena
        pages H2D. Both run inside the batcher's serialized executor
        stream (demote inside _reclaim, restore inside admit), so
        neither can interleave with a tick, an admission, or a
        TransferKV host op."""
        self.host = pool
        self._fetch_pages = fetch
        self._restore_pages = restore

    # -- prefix index --------------------------------------------------------

    @staticmethod
    def _chain(parent: int, tokens: np.ndarray) -> int:
        # STABLE across processes (blake2b, not the PYTHONHASHSEED-
        # salted builtin): the host pool's file tier persists entries
        # by chain key, so a restarted replica must re-derive the SAME
        # keys from the same prompts to warm-restore (docs/fleet.md).
        # Collisions verify as misses against the stored tokens, here
        # and in the host pool alike.
        h = hashlib.blake2b(digest_size=8)
        h.update(parent.to_bytes(8, "little", signed=True))
        h.update(tokens.tobytes())
        return int.from_bytes(h.digest(), "little", signed=True)

    def _probe_cow(self, key: int, rem: np.ndarray) -> tuple[int, int]:
        """Best partially matching divergent page among `key`'s indexed
        children vs the request's next tokens `rem`. Returns
        (cow_page or -1, matching-token overlap)."""
        cow_page, cow_t = -1, 0
        for page in self._children.get(key, ()):
            cached = self._tokens_of[page]
            n = min(len(cached), len(rem))
            neq = np.nonzero(cached[:n] != rem[:n])[0]
            t = int(neq[0]) if neq.size else n
            if t > cow_t:
                cow_page, cow_t = page, t
        return cow_page, cow_t

    def _lookup(
        self, arr: np.ndarray, limit: int, root: int = _ROOT
    ) -> tuple[list, int, int, int]:
        """Longest page-aligned indexed prefix of arr[:limit] plus the
        best partially matching divergent page, walking from `root`
        (the adapter's key domain). Returns (shared pages, chain key at
        the divergence, cow_page or -1, cow_overlap)."""
        p = self.page_size
        key = root
        pages: list[int] = []
        for j in range(limit // p):
            toks = arr[j * p:(j + 1) * p]
            nxt = self._chain(key, toks)
            page = self._index.get(nxt)
            if page is None or not np.array_equal(self._tokens_of[page], toks):
                break  # hash collision verifies as a miss
            pages.append(page)
            key = nxt
        m = len(pages)
        cow_page, cow_t = self._probe_cow(
            key, arr[m * p: min(limit, (m + 1) * p)]
        )
        return pages, key, cow_page, cow_t

    def _unindex(self, page: int) -> None:
        key = self._key_of.pop(page)
        self._index.pop(key, None)
        self._children.pop(key, None)  # orphan subtree: verification
        # against _tokens_of keeps any dangling child unreachable, and
        # those children are themselves evictable entries.
        parent = self._parent_of.pop(page)
        kids = self._children.get(parent)
        if kids is not None:
            kids.discard(page)
            if not kids:
                self._children.pop(parent, None)
        self._tokens_of.pop(page, None)

    def _demote(self, victims: list[int]) -> None:
        """Move the victims' page contents to the host tier before
        they leave the index — eviction becomes one batched D2H copy
        instead of a discard. Best-effort: a fetch failure logs and
        degrades to the old discard behavior (recompute on next
        sighting), never blocks the admission that needed the pages.
        Pages whose chain key the pool already holds (demoted before,
        restored, evicted again) skip the D2H — the host copy is
        bit-identical by construction (indexed pages are immutable)."""
        if self.host is None or self._fetch_pages is None:
            return
        todo = [
            page for page in victims
            if not self.host.has(self._key_of[page], self._tokens_of[page])
        ]
        self.host_demotions += len(victims)
        if not todo:
            return
        try:
            blobs = self._fetch_pages(todo)
        except Exception as exc:  # noqa: BLE001 — degrade to discard
            self.host_demotions -= len(todo)
            logger.warning("host-tier demotion failed (D2H): %s", exc)
            return
        for page, blob in zip(todo, blobs):
            self.host.put(
                self._key_of[page], self._parent_of[page],
                self._tokens_of[page], blob,
            )
            self.host_bytes_demoted += len(blob)

    def _reclaim(self, need: int, keep: frozenset = frozenset()) -> None:
        """Evict refcount-0 indexed pages, LRU first, until `need`
        pages are free — demoting their contents to the host tier when
        one is attached. All-or-nothing: raises before mutating
        anything if the evictable set cannot cover the shortfall.

        `keep` excludes pages the CALLING admission just matched from
        victim selection: a matched refcount-0 page is still in the
        evictable set, and evicting it here would let the admission
        refcount a freed page (and hand the same page out again as
        `fresh`) — silent table corruption under exactly the pressure
        the tier exists for.

        heapq.nsmallest keeps victim selection O(E log shortfall)
        instead of sorting the whole stamp dict (O(E log E)) on every
        shortfall — the allocator's hottest path under sustained
        pressure (same victims, property-tested)."""
        shortfall = need - len(self._free)
        if shortfall <= 0:
            return
        if keep:
            evictable = len(self._stamp) - sum(
                1 for page in keep if page in self._stamp
            )
            candidates = (p for p in self._stamp if p not in keep)
        else:
            evictable = len(self._stamp)
            candidates = self._stamp
        if shortfall > evictable:
            raise PageExhaustedError(
                f"page pool exhausted: need {need} pages, "
                f"{len(self._free)} free + {evictable} evictable "
                f"of {self.n_pages}"
            )
        victims = heapq.nsmallest(
            shortfall, candidates, key=self._stamp.__getitem__
        )
        self._demote(victims)
        for page in victims:
            del self._stamp[page]
            self._unindex(page)
            self._free.append(page)

    # -- slot lifecycle ------------------------------------------------------

    def admit(self, slot: int, prompt: list, need_len: int,
              share: bool = True, adapter: str = "") -> PageAdmission:
        """Build slot's block table for a request that will occupy
        positions [0, need_len): reuse the longest page-aligned indexed
        prefix (refcounted), pick a CoW source for the divergent page,
        allocate fresh exclusive pages for the rest. All-or-nothing —
        PageExhaustedError leaves every resident table untouched.
        `adapter` scopes the chain walk to that adapter's key domain
        (adapter_root): same-adapter requests share pages and ride the
        host tier; cross-adapter sharing is impossible by key
        construction — the rule the old `share=False` full-recompute
        gate enforced by never sharing at all. `share=False` still
        allocates fully exclusive and consults nothing (transfer/test
        paths that must bypass the index). Under jump-ahead constrained
        decoding (grammar.jump_max > 0) the batcher folds the jump
        window into a GRAMMAR-CARRYING request's need_len at admission
        — a jump tick writes up to 1 + jump_max KV positions at once,
        so a constrained row's block table already covers the deepest
        multi-token advance and the paged walk never extends mid-run.
        Unconstrained rows keep the plain reserve; their surplus window
        positions in a jump tick scatter to the sentinel and drop
        (models/llama.py)."""
        self.free_slot(slot)  # defensive: admit implies a parked row
        p = self.page_size
        w_need = -(-need_len // p)
        if w_need > self.width:
            raise ValueError(
                f"request needs {w_need} pages > table width {self.width}"
            )
        arr = np.asarray(prompt, np.int32)
        root = adapter_root(adapter)
        # At least one suffix token must run through the model to
        # produce sampling logits — cap reuse at len(prompt) - 1.
        limit = len(prompt) - 1
        if share:
            shared, break_key, cow_page, cow_t = self._lookup(
                arr, limit, root
            )
        else:
            shared, break_key, cow_page, cow_t = [], root, -1, 0
        m = len(shared)
        # Host-tier extension (attach_host): continue the chain walk
        # past the device break — orphaned device pages re-link free,
        # host-tier entries restore with one batched H2D write.
        ext: list[tuple[str, int, int]] = []
        if share and self.host is not None:
            ext = self._extend_lookup(arr, limit, m, break_key)
        n_dev = sum(1 for kind, _, _ in ext if kind == "dev")
        # Exclude every matched page from victim selection: a matched
        # refcount-0 page is in the evictable set, and evicting it
        # below would refcount a freed page and hand it out again as
        # fresh — the keep set closes that corruption window.
        keep = frozenset(shared) | frozenset(
            page for kind, _, page in ext if kind == "dev"
        )
        # may raise; nothing mutated yet (demotion only fills the host
        # pool — additive, safe even if the admission then sheds)
        self._reclaim(w_need - m - n_dev, keep=keep)
        fresh = [self._free.pop() for _ in range(w_need - m - n_dev)]
        restored: list[tuple[int, int]] = []  # (ext index, blob bytes)
        host_items = [
            (i, nk, j) for i, (kind, nk, j) in enumerate(ext)
            if kind == "host"
        ]
        if host_items:
            try:
                ext, fresh, restored = self._try_restore(
                    arr, ext, host_items, fresh, keep
                )
            except PageExhaustedError:
                self._free.extend(fresh)  # all-or-nothing still holds
                raise
        n_host = sum(1 for kind, _, _ in ext if kind == "host")
        # Commit. Shared + re-linked pages gain a reference; fresh
        # pages (restore targets included) are owned by this slot.
        relinked = [page for kind, _, page in ext if kind == "dev"]
        for page in shared + relinked:
            if self._ref[page] == 0:
                self._stamp.pop(page, None)  # no longer evictable
            self._ref[page] += 1
        for page in relinked:
            # Re-attach the orphan to its parent's children set (the
            # CoW probe's edge list — dropped when the parent was
            # demoted; the re-link proves the linkage again).
            self._children.setdefault(self._parent_of[page], set()).add(
                page
            )
        for page in fresh:
            self._ref[page] = 1
        # Index restored pages at refcount > 0: from here on they are
        # ordinary shared device pages riding the proven sharing path
        # (free_slot parks them as evictable cache like any other).
        for i, blob_len in restored:
            _kind, nk, j = ext[i]
            dst = fresh[sum(1 for q, _ in restored if q < i)]
            parent = break_key if i == 0 else ext[i - 1][1]
            self._index[nk] = dst
            self._key_of[dst] = nk
            self._tokens_of[dst] = arr[j * p:(j + 1) * p].copy()
            self._parent_of[dst] = parent
            self._children.setdefault(parent, set()).add(dst)
            self.host_restores += 1
            self.host_bytes_restored += blob_len
        # Build the slot's row: shared, then the extension (re-linked
        # device pages and restore targets in chain order), then the
        # exclusive tail.
        prefix_pages = list(shared)
        fi = 0
        for kind, _nk, x in ext:
            if kind == "dev":
                prefix_pages.append(int(x))
            else:
                prefix_pages.append(fresh[fi])
                fi += 1
        t = len(prefix_pages)  # == m + len(ext)
        row = self.tables[slot]
        row[:] = self.sentinel
        row[:t] = prefix_pages
        row[t:w_need] = fresh[n_host:]
        if ext:
            # The divergence moved past the original break: re-probe
            # the CoW source among the FINAL key's children.
            cow_page, cow_t = self._probe_cow(
                ext[-1][1], arr[t * p: min(limit, (t + 1) * p)]
            )
        gather = row.copy()
        if cow_page >= 0 and cow_t > 0:
            gather[t] = cow_page
            self.cow_copies += 1
        self.pages_admitted += w_need
        self.pages_reused += m + len(relinked)
        if t or cow_t:
            self.hits += 1
        elif share:
            self.misses += 1
        return PageAdmission(
            merge_start=t * p,
            scan_start=t * p + cow_t,
            gather_row=gather,
            pages_shared=t,
            pages_restored=n_host,
        )

    def _extend_lookup(
        self, arr: np.ndarray, limit: int, m: int, key: int
    ) -> list[tuple[str, int, int]]:
        """Walk the chain past the device-resident break. A key still
        in the device index is an ORPHANED page — its ancestor was
        evicted, so _lookup can't reach it, but the cumulative chain
        key plus content verification proves it — and re-links for
        free. A key the host pool holds restores with one H2D. Stops
        at the first key neither tier has. Returns chain-ordered
        [("dev", key, page) | ("host", key, prompt_page_j)]."""
        p = self.page_size
        ext: list[tuple[str, int, int]] = []
        for j in range(m, limit // p):
            toks = arr[j * p:(j + 1) * p]
            nk = self._chain(key, toks)
            page = self._index.get(nk)
            if page is not None and np.array_equal(
                self._tokens_of[page], toks
            ):
                ext.append(("dev", nk, page))
            elif self.host.has(nk, toks):
                ext.append(("host", nk, j))
            else:
                break
            key = nk
        return ext

    def _try_restore(
        self,
        arr: np.ndarray,
        ext: list[tuple[str, int, int]],
        host_items: list[tuple[int, int, int]],
        fresh: list[int],
        keep: frozenset,
    ) -> tuple[list, list, list[tuple[int, int]]]:
        """Attempt the admission's restore set as ONE batched H2D
        write into the first len(host_items) fresh pages. On any
        failure (host_restore_fail chaos included) degrade TYPED to
        recompute: truncate the extension at the first host item —
        later re-links would leave a chain gap — and top the fresh
        set up to cover the dropped pages. Returns (final ext, final
        fresh, [(ext index, blob bytes)] for restored items)."""
        p = self.page_size
        dst = fresh[:len(host_items)]
        blobs: list[bytes] = []
        ok = True
        for _i, nk, j in host_items:
            blob = self.host.get(nk, arr[j * p:(j + 1) * p])
            if blob is None:  # pool raced/invalidated: same degradation
                ok = False
                break
            blobs.append(blob)
        if ok:
            try:
                self._restore_pages(dst, blobs)
            except Exception as exc:  # noqa: BLE001 — typed degrade
                ok = False
                logger.warning(
                    "host-tier restore failed (H2D), degrading to "
                    "recompute: %s", exc,
                )
        if ok:
            return ext, fresh, [
                (i, len(blob)) for (i, _nk, _j), blob in zip(
                    host_items, blobs
                )
            ]
        self.host_restore_failures += 1
        first = host_items[0][0]
        dropped = [
            page for kind, _, page in ext[first:] if kind == "dev"
        ]
        if dropped:
            # Dropped re-links are evictable again — only the kept
            # prefix still needs protecting from victim selection.
            self._reclaim(
                len(dropped), keep=keep - frozenset(dropped)
            )  # may raise; the caller restores all-or-nothing
            fresh = fresh + [
                self._free.pop() for _ in range(len(dropped))
            ]
        return ext[:first], fresh, []

    def chain_pages(self, prompt: list, adapter: str = "") -> list[int]:
        """The indexed arena pages holding `prompt`'s full pages,
        walking the hash chain from the root — the export set a
        prefill-role replica ships over TransferKV (docs/paged_kv.md
        "pages over the wire"). Content-verified like _lookup; stops at
        the first un-indexed (or evicted) page, so the result is always
        a valid page-aligned prefix. Read-only: refcounts, stamps, and
        the index are untouched — handoff safety comes from the caller
        running inside the batcher's serialized executor stream, where
        no eviction can interleave with the device gather. `adapter`
        walks that adapter's key domain ("" = base)."""
        p = self.page_size
        arr = np.asarray(prompt, np.int32)
        key = adapter_root(adapter)
        pages: list[int] = []
        for j in range(len(arr) // p):
            toks = arr[j * p:(j + 1) * p]
            nxt = self._chain(key, toks)
            page = self._index.get(nxt)
            if page is None or not np.array_equal(
                self._tokens_of[page], toks
            ):
                break
            pages.append(page)
            key = nxt
        return pages

    def import_chain(
        self, prompt: list, start_page: int, count: int,
        adapter: str = "",
    ) -> list[tuple[int, int]]:
        """Register externally computed KV pages (a TransferKV chunk)
        for `prompt`'s full pages [start_page, start_page + count).
        Returns [(prompt_page_j, arena_page)] for the pages actually
        allocated — the caller writes those pages' contents into the
        device arena at the returned indices. Pages whose chain key is
        already indexed are skipped (dedup — the resident copy was
        verified at registration; a colliding-but-different entry keeps
        precedence exactly like register()).

        Refcount handoff rule: imported pages enter at refcount 0,
        LRU-stamped — evictable cache, indistinguishable from a
        finished local request's indexed pages. The re-issued request's
        admission refcounts them through the ordinary prefix-sharing
        path; until then they may be evicted under pressure, which
        costs the decode replica a (bit-identical) partial prefill,
        never correctness. Raises PageExhaustedError when the arena
        cannot host the chunk (all-or-nothing: nothing registered)."""
        p = self.page_size
        arr = np.asarray(prompt, np.int32)
        full = len(arr) // p
        if start_page < 0 or count < 1 or start_page + count > full:
            raise ValueError(
                f"import range [{start_page}, {start_page + count}) "
                f"outside the prompt's {full} full pages"
            )
        keys: list[int] = []
        root = adapter_root(adapter)
        key = root
        for j in range(start_page + count):
            key = self._chain(key, arr[j * p:(j + 1) * p])
            keys.append(key)
        todo: list[int] = []
        for j in range(start_page, start_page + count):
            if keys[j] in self._index:
                continue  # resident (or colliding) entry keeps precedence
            todo.append(j)
        self._reclaim(len(todo))  # may raise; nothing registered yet
        placed: list[tuple[int, int]] = []
        for j in todo:
            page = self._free.pop()
            parent = keys[j - 1] if j > 0 else root
            self._index[keys[j]] = page
            self._key_of[page] = keys[j]
            self._tokens_of[page] = arr[j * p:(j + 1) * p].copy()
            self._parent_of[page] = parent
            self._children.setdefault(parent, set()).add(page)
            self._ref[page] = 0
            self._clock += 1
            self._stamp[page] = self._clock
            placed.append((j, page))
        return placed

    def register(self, slot: int, prompt: list, adapter: str = "") -> None:
        """Index every full page of a successfully prefilled prompt so
        later admissions can share it — under `adapter`'s key domain
        ("" = base; adapter'd K/V never aliases another domain's
        chain). Pages already on the chain (including the ones this
        admission itself reused) pass through; a colliding-but-
        different index entry keeps precedence (the duplicate page
        simply stays private to this slot)."""
        p = self.page_size
        arr = np.asarray(prompt, np.int32)
        key = adapter_root(adapter)
        for j in range(len(prompt) // p):
            toks = arr[j * p:(j + 1) * p]
            nxt = self._chain(key, toks)
            page = self._index.get(nxt)
            if page is None:
                page = int(self.tables[slot, j])
                if page == self.sentinel or page in self._key_of:
                    break  # defensive: never double-index a page
                self._index[nxt] = page
                self._key_of[page] = nxt
                self._tokens_of[page] = toks.copy()
                self._parent_of[page] = key
                self._children.setdefault(key, set()).add(page)
            key = nxt

    def free_slot(self, slot: int, discard_index: bool = False) -> None:
        """Release a slot's page references. Exclusive un-indexed pages
        return to the free list; indexed pages whose refcount reaches 0
        stay resident as evictable cache (LRU-stamped) — the reuse
        window that holds the hit rate when the working set fits the
        arena. `discard_index=True` (admission FAILURE): pages this row
        eagerly indexed were never prefilled — a ref-0 page leaves the
        index and frees instead of caching garbage (a still-referenced
        indexed page is kept: any surviving sharer was admitted by a
        call that already materialized its content)."""
        row = self.tables[slot]
        for mapped in row[row != self.sentinel]:
            page = int(mapped)
            self._ref[page] -= 1
            if self._ref[page] == 0:
                if page in self._key_of and discard_index:
                    self._unindex(page)
                    self._free.append(page)
                elif page in self._key_of:
                    self._clock += 1
                    self._stamp[page] = self._clock
                else:
                    self._free.append(page)
        row[:] = self.sentinel

    def demote_for_preempt(self, slot: int, prompt: list,
                           adapter: str = "") -> int:
        """Park a preempted slot's KV: index the slot's VALID pages,
        release the slot, and proactively copy the parked chain to the
        host tier. `prompt` is the preemption-time effective prompt
        (original prompt + accepted tokens, the replay fold); only its
        first `len(prompt) - 1` positions have written KV — the newest
        accepted token's KV is unwritten until the next tick, the same
        `limit = len(prompt) - 1` reuse cap admit() applies — so the
        registration covers exactly that prefix's full pages.

        The pages STAY indexed as evictable cache: if pressure never
        comes, the resume's admit() hits them on device for free; if
        eviction does come, `host.has` dedup makes it demote-free (the
        copy below already paid the D2H) and the resume restores with
        one batched H2D — the host-tier restore path. Best-effort like all
        demotion: a D2H failure degrades to plain eviction-and-
        recompute, never an error. Returns the number of chain pages
        parked (0 = nothing page-aligned survived; resume recomputes,
        bit-identically)."""
        kept = prompt[:max(0, len(prompt) - 1)]
        self.register(slot, kept, adapter)
        chain = self.chain_pages(kept, adapter)
        self.free_slot(slot)
        if chain:
            # Shared-prefix pages still referenced by OTHER slots skip
            # the copy — they demote via _reclaim when they go ref-0.
            self._demote([
                page for page in chain
                if self._ref[page] == 0 and page in self._key_of
            ])
        return len(chain)

    def reset(self) -> None:
        """Arena rebuilt from zeros (tick-failure recovery): every page
        and every index entry is device-dead — forget it all. Victims
        replay through admission, which re-prefills and re-registers;
        shared prefixes re-share from the first replayed sighting."""
        self.tables[:] = self.sentinel
        self._ref[:] = 0
        self._free = list(range(self.n_pages))
        self._index.clear()
        self._key_of.clear()
        self._tokens_of.clear()
        self._parent_of.clear()
        self._children.clear()
        self._stamp.clear()
        # The host pool (if attached) deliberately SURVIVES a reset:
        # its entries are host-RAM/file copies of pages that were valid
        # when demoted — replays restore from it instead of recomputing
        # the whole working set against the rebuilt arena.

    def check_invariants(self) -> None:
        """Exhaustive bookkeeping audit (test surface — the
        eviction-racing-restore chaos suite calls this between every
        interleaved step to prove zero pages are lost or double-mapped
        through the serialized host-op stream). Raises AssertionError
        naming the violated invariant."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate page in free list"
        for page in free:
            assert self._ref[page] == 0, f"free page {page} has refs"
            assert page not in self._key_of, f"free page {page} indexed"
        live = self.tables[self.tables != self.sentinel]
        counts = np.bincount(live, minlength=self.n_pages)
        assert (counts == self._ref[:self.n_pages]).all(), (
            "refcounts disagree with block-table occurrences"
        )
        for key, page in self._index.items():
            assert self._key_of.get(page) == key, (
                f"index/key_of disagree for page {page}"
            )
            assert page in self._tokens_of, f"indexed page {page} tokenless"
            assert page not in free, f"indexed page {page} is free"
        for page in self._stamp:
            assert self._ref[page] == 0, f"stamped page {page} has refs"
            assert page in self._key_of, f"stamped page {page} unindexed"
        for page, key in self._key_of.items():
            if self._ref[page] == 0:
                assert page in self._stamp, (
                    f"indexed refcount-0 page {page} unstamped (leak)"
                )
        # Conservation: every page is free, referenced, or cached.
        cached = sum(
            1 for page in self._key_of if self._ref[page] == 0
        )
        referenced = int((self._ref > 0).sum())
        assert len(free) + referenced + cached == self.n_pages, (
            f"pages lost: {len(free)} free + {referenced} live + "
            f"{cached} cached != {self.n_pages}"
        )
