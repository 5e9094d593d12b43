"""Grammar runtime state: the sidecar's compile cache and the
batcher's device-table arena. A copy of `ggrmcp_tpu/grammar/runtime.py`
with one addition: the arena records the row ranges each insert wrote
(`take_dirty`), so the batcher uploads only those rows instead of the
whole [arena_states, V] tables (2.6 GB at a 128,256-token vocabulary).

GrammarCache — an LRU of CompiledGrammar keyed by canonical schema
hash, so a tool whose output schema is enforced on every call compiles
its DFA once (counters feed the ``grammar_compiles`` /
``grammar_cache_hits`` ServingStats fields).

GrammarArena — the fixed-shape host mirror of the device tables the
decode tick consumes. All LIVE grammars share ONE ``[arena_states, V]``
allow-mask + transition table: each acquired grammar gets a contiguous
state range (its local transitions relocate by plain offset because
disallowed transitions are self-loops), per-row decode state is an
absolute index into the arena, and row/state 0 is the reserved
universal accept-all state unconstrained rows carry — which is what
lets mixed constrained/unconstrained batches share one compiled
function. The FIXED shape is the point: a new schema changes table
*contents* (an upload of its rows), never table *shape*.

Threading: acquire() runs on the event loop (submit), release() on
either the loop or the batcher's executor (terminal paths) — a small
lock guards the entry map and refcounts. The numpy tables are written
only under that lock; the batcher takes the rows written since its last
upload (also under the lock) when the version counter moves.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np

from ggrmcp_tpu_torch.grammar.compiler import (
    CompiledGrammar,
    GrammarCapacityError,
    GrammarError,
    compile_schema,
    schema_fingerprint,
)


class GrammarCache:
    """LRU of compiled DFAs keyed by canonical schema hash."""

    def __init__(self, max_entries: int = 32):
        self.max_entries = max(1, int(max_entries))
        self._entries: dict[str, CompiledGrammar] = {}
        self._stamp: dict[str, int] = {}
        self._clock = 0
        self._lock = threading.Lock()
        self.compiles = 0
        self.hits = 0

    def get(
        self,
        schema: "str | dict",
        vocab_size: int,
        eos_id: int = 2,
        max_states: int = 1024,
        byte_offset: int = 3,
    ) -> CompiledGrammar:
        key = schema_fingerprint(schema)
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self.hits += 1
                self._clock += 1
                self._stamp[key] = self._clock
                return hit
        # Compile outside the lock (pure host work, possibly slow);
        # a racing duplicate compile is wasted work, not corruption.
        compiled = compile_schema(
            schema, vocab_size, eos_id=eos_id, max_states=max_states,
            byte_offset=byte_offset,
        )
        with self._lock:
            if key not in self._entries:
                self.compiles += 1
                if len(self._entries) >= self.max_entries:
                    victim = min(self._stamp, key=self._stamp.get)
                    del self._entries[victim]
                    del self._stamp[victim]
                self._entries[key] = compiled
            self._clock += 1
            self._stamp[key] = self._clock
            return self._entries[key]


@dataclasses.dataclass
class GrammarHandle:
    """A live grammar's residency in one arena: absolute state range
    [base, base+n) and the compiled artifact. Host-side stepping goes
    through the ARENA tables (absolute states), not the local ones."""

    grammar: CompiledGrammar
    base: int

    @property
    def start(self) -> int:
        return self.base + self.grammar.start


class GrammarArena:
    """Fixed-shape shared token tables for all live grammars.

    State 0 is the universal accept-all state (allow everything,
    self-transition) that unconstrained rows carry. Grammars are
    acquired with a refcount; zero-ref entries stay resident (warm
    cache) and are evicted LRU-first only when a new grammar needs
    their rows. `version` increments on every table mutation so the
    batcher knows when to re-upload to device.
    """

    def __init__(self, max_states: int, vocab_size: int,
                 jump_max: int = 0):
        self.max_states = max(2, int(max_states))
        self.vocab_size = int(vocab_size)
        self.jump_max = max(0, int(jump_max))
        self.allow = np.zeros((self.max_states, self.vocab_size), dtype=bool)
        self.allow[0, :] = True  # state 0: unconstrained rows
        self.trans = np.zeros((self.max_states, self.vocab_size), np.int32)
        self.sink = np.zeros((self.max_states,), dtype=bool)
        # Forced-run tables (jump-ahead decoding), same fixed-shape
        # residency rows as allow/trans: per-state run length (clipped
        # to jump_max), run token ids, and absolute landing states.
        # State 0 (and every unoccupied row) has jump_len 0, so
        # unconstrained/parked rows never jump. jump_states cells
        # default to 0 — a valid absolute state — so a stale row can
        # never index out of the arena.
        width = max(1, self.jump_max)
        self.jump_len = np.zeros((self.max_states,), np.int32)
        self.jump_tokens = np.zeros((self.max_states, width), np.int32)
        self.jump_states = np.zeros((self.max_states, width), np.int32)
        self.version = 1
        # [start, end) row ranges written by inserts since the last
        # take_dirty (evictions write nothing: no live row points there).
        self._dirty: list[tuple[int, int]] = []
        self._lock = threading.Lock()
        # schema hash → [handle-agnostic entry]
        self._entries: dict[str, dict] = {}
        self._clock = 0

    # -- queries ------------------------------------------------------------

    def states_in_use(self) -> int:
        with self._lock:
            return 1 + sum(e["n"] for e in self._entries.values())

    def step(self, state: int, token: int) -> int:
        """Host-side transition on ABSOLUTE state ids (per-token emit
        tracking and replay re-derivation). Lock-free: rows of live
        entries are immutable while referenced."""
        return int(self.trans[state, int(token)])

    def is_sink(self, state: int) -> bool:
        return bool(self.sink[state])

    def snapshot(self) -> tuple:
        """(allow, trans, jump_len, jump_tokens, jump_states, version)
        copies for device upload — copied under the lock so an
        in-flight acquire can't tear them."""
        with self._lock:
            return (
                self.allow.copy(), self.trans.copy(),
                self.jump_len.copy(), self.jump_tokens.copy(),
                self.jump_states.copy(), self.version,
            )

    def take_dirty(self) -> tuple[list, int]:
        """([(start, end, allow, trans, jump_len, jump_tokens,
        jump_states)], version): copies of the rows written since the
        last call and the version they bring the tables to, under the
        lock so an in-flight acquire can't tear them."""
        with self._lock:
            spans = [
                (a, b, self.allow[a:b].copy(), self.trans[a:b].copy(),
                 self.jump_len[a:b].copy(), self.jump_tokens[a:b].copy(),
                 self.jump_states[a:b].copy())
                for a, b in self._dirty
            ]
            self._dirty = []
            return spans, self.version

    def forced_run(self, state: int) -> list:
        """Forced token run from an ABSOLUTE state, clipped to the
        arena's jump_max — the host-side mirror of the device jump
        (collect-side validation and replay re-derivation). Lock-free
        for the same reason step() is."""
        length = int(self.jump_len[state])
        return [int(t) for t in self.jump_tokens[state, :length]]

    # -- residency ----------------------------------------------------------

    def acquire(self, grammar: CompiledGrammar) -> GrammarHandle:
        """Make `grammar` resident (inserting its tables if needed) and
        take a reference. Raises GrammarCapacityError when the arena
        cannot fit it even after evicting every zero-ref entry."""
        if grammar.vocab_size != self.vocab_size:
            raise GrammarError(
                f"grammar compiled for vocab {grammar.vocab_size}, "
                f"arena serves vocab {self.vocab_size}"
            )
        with self._lock:
            self._clock += 1
            entry = self._entries.get(grammar.schema_hash)
            if entry is not None:
                entry["refs"] += 1
                entry["stamp"] = self._clock
                return GrammarHandle(grammar=grammar, base=entry["base"])
            n = grammar.n_states
            if n > self.max_states - 1:
                raise GrammarCapacityError(
                    f"grammar needs {n} states; arena holds "
                    f"{self.max_states - 1} (serving.grammar.arena_states)"
                )
            base = self._find_gap(n)
            if base is None:
                self._evict_idle(n)
                base = self._find_gap(n)
            if base is None:
                raise GrammarCapacityError(
                    "grammar table arena full: too many distinct "
                    "schemas decoding at once "
                    "(serving.grammar.arena_states)"
                )
            self.allow[base:base + n] = grammar.allow
            self.trans[base:base + n] = grammar.trans + base
            self.sink[base:base + n] = grammar.sink
            self._install_jump(grammar, base, n)
            self._dirty.append((base, base + n))
            self.version += 1
            self._entries[grammar.schema_hash] = {
                "base": base, "n": n, "refs": 1, "stamp": self._clock,
            }
            return GrammarHandle(grammar=grammar, base=base)

    def release(self, handle: Optional[GrammarHandle]) -> None:
        if handle is None:
            return
        with self._lock:
            entry = self._entries.get(handle.grammar.schema_hash)
            if entry is not None and entry["refs"] > 0:
                entry["refs"] -= 1

    # -- internals (lock held) ----------------------------------------------

    def _install_jump(self, grammar: CompiledGrammar, base: int,
                      n: int) -> None:
        """Relocate the grammar's forced-run tables into rows
        [base, base+n): run lengths clip to the arena's serving-time
        window (jump_max), token columns pad with 0 and state columns
        pad with the landing state (compiler padding convention), and
        states relocate by `+ base` exactly like trans."""
        if self.jump_max == 0:
            return  # jump-ahead off: tables stay all-zero
        width = self.jump_tokens.shape[1]
        cap = grammar.jump_tokens.shape[1]
        self.jump_len[base:base + n] = np.minimum(
            grammar.jump_len, width
        ).astype(np.int32)
        take = min(cap, width)
        jt = np.zeros((n, width), np.int32)
        js = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, width))
        jt[:, :take] = grammar.jump_tokens[:, :take]
        js[:, :take] = grammar.jump_states[:, :take]
        if take and width > take:
            js[:, take:] = grammar.jump_states[:, take - 1:take]
        self.jump_tokens[base:base + n] = jt
        self.jump_states[base:base + n] = js + base

    def _find_gap(self, n: int) -> Optional[int]:
        """First contiguous free range of >= n states after state 0."""
        used = sorted(
            (e["base"], e["base"] + e["n"]) for e in self._entries.values()
        )
        cursor = 1
        for start, end in used:
            if start - cursor >= n:
                return cursor
            cursor = max(cursor, end)
        if self.max_states - cursor >= n:
            return cursor
        return None

    def _evict_idle(self, need: int) -> None:
        """Drop zero-ref entries LRU-first until a `need`-state gap
        exists (or none are left). Evicted rows need no zeroing: no
        live row's state can point into an unreferenced entry."""
        idle = sorted(
            (k for k, e in self._entries.items() if e["refs"] == 0),
            key=lambda k: self._entries[k]["stamp"],
        )
        for key in idle:
            del self._entries[key]
            self.version += 1
            if self._find_gap(need) is not None:
                return
