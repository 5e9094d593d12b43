"""Continuous batching for the generation engine.

Port of `ggrmcp_tpu/serving/batching.py::ContinuousBatcher`: a slot pool
shares one KV cache (`max_batch_size` slots). Requests join free slots
between decode ticks:

- a prompt of at most `prefill_chunk` tokens takes FUSED admission —
  a [1, S] (one request) or [B, S] (a burst, rows at their slots'
  indices) prefill against a fresh mini cache, merged into the pool;
- a longer prompt takes CHUNKED admission — an [R, T, C] grid of C =
  prefill_chunk steps against a full-length mini cache, merged at the
  group's slots;
- every loop turn then runs one decode tick of `decode_steps_per_tick`
  steps for the whole pool, sampling through the per-row dynamic path
  under each row's grammar state.

Schema-constrained decoding (a request submitted with a
`CompiledGrammar`): the grammar takes a state range in the batcher's
`GrammarArena`; each slot carries its absolute DFA state (0 =
unconstrained) on the host, shipped with each tick, and every sample
(the admission's first token, each tick step) is masked under it and
advances it by a transition-table gather. While some live slot can jump
(`grammar.jump_max` > 0), a tick is one [B, 1 + jump_max] forward of
each row's pending token plus its forced run, then one masked sample.
The host walks the DFA over every emitted token: the accepting sink
finishes the request "grammar_complete", a forced run the walk does not
reproduce degrades the request to one-token decoding and replays it.

KV reuse, each behind the reference's switch and with its semantics:

- `prefix_cache_entries > 0`: a slot-granular pool of prompt prefixes
  (stored on a trickle admission, learned from a fused burst, upgraded
  on the serial bridge path); a hit seeds the admission mini cache and
  prefills only the suffix, a same-preamble wave in ONE group call;
- `prefill_interleave = "on"`: a long prompt arriving while slots decode
  holds a reserved slot and rides the decode ticks one [K, C] chunk of
  a carried mini cache at a time, so no slot stalls for a whole prefill;
- `paged_kv = "on"`: the pool becomes one page arena with block tables
  (models/llama.py::PagedKVCache) and a host allocator
  (serving/pages.py): page-aligned prefix sharing with refcounts,
  copy-on-write at the divergent page, a typed "overloaded" shed when
  the arena is exhausted;
- `paged_kv_host_bytes > 0`: the host page tier (serving/host_pool.py)
  behind the arena: eviction demotes page contents to host RAM (one
  device-to-host gather), a prefix hit on a demoted page restores it
  (one host-to-device write) instead of recomputing it, and a
  preempted request's pages are parked there.

The paged arena also exports and imports prompt pages
(`export_prompt_kv` / `import_prompt_kv`, the TransferKV plane of a
disaggregated prefill / decode fleet). External work on the arena
enters through `run_host_op`, a queue the loop drains between ticks in
its one executor stream, which is what makes an export or an import
atomic against eviction.

Multi-LoRA (serving.lora): each slot carries its adapter row (0 =
base), shipped with every forward of every route; the arena's
residency pin (`adapter_lease`) is held until the request's terminal
chunk, released at preemption and reacquired at the resume. The
prefix pool holds base-model K/V only; paged chains key on the stable
adapter name, so same-adapter requests share pages and different
adapters never do.

The control plane, each with the reference's semantics:

- the flight recorder (serving.observability, on by default): a record
  of every tick, its duration partitioned into admit / sync / dispatch
  / wait / host, and of every request at its terminal chunk, feeding
  the latency histograms; the SLO and tenant ledgers (serving.slo) fed
  from the same terminal hook; the memory ledger's components;
- the scheduler (serving.scheduler.enabled): class priority lanes with
  VTC fair share in place of the FIFO queue, demote-don't-kill
  preemption of lower-class slots and the per-round prefill budget;
- queue_deadline_ms (a queued request times out) and p50_budget_ms (an
  admission round's rows capped while slots decode);
- failpoints (utils/failpoints.py) at the reference's hook sites.

Speculative decoding (batching.speculative=on with the engine's draft):
every tick is one draft / verify round (ops/speculative.py::spec_tick)
— gamma draft steps against a draft slot pool beside the shared cache,
one (gamma+1)-position target verify, each row advancing by its
accepted count plus one. Every admission route prefills the admitted
rows' prompts into the draft pool too, one position behind the target.

Ring KV (serving.kv_ring, sliding-window models): the shared cache and
the admission minis hold the engine's ring_capacity positions, every
cache-extending forward writes them mod that capacity, and a request is
bounded by the model's RoPE range instead of the cache. Long prompts
admit in groups of equal chunk count (see _prefill_into_slots).

Device work runs in the default executor (never on the event loop),
one call at a time; ticks are synchronous. Every copy between
a mini cache, the prefix pool and the
pool goes through `quant.kv_map`, so an int8 KV cache (the engine's
`kv_dtype`) moves values and scales alike.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
from collections import deque
from typing import AsyncIterator, Optional

import numpy as np
import torch

from ggrmcp_tpu_torch.core.config import (
    BatchingConfig,
    GrammarConfig,
    resolve_decode_steps,
)
from ggrmcp_tpu_torch.grammar.compiler import CompiledGrammar
from ggrmcp_tpu_torch.grammar.runtime import GrammarArena, GrammarHandle
from ggrmcp_tpu_torch.models import llama as llama_mod
from ggrmcp_tpu_torch.ops import attention as attention_mod
from ggrmcp_tpu_torch.ops import quant
from ggrmcp_tpu_torch.ops.sampling import (
    SamplingConfig,
    forced_run_lookup,
    masked_sample_dynamic,
    trivial_grammar_tables,
)
from ggrmcp_tpu_torch.ops.speculative import spec_tick
from ggrmcp_tpu_torch.parallel.collectives import Sharded
from ggrmcp_tpu_torch.serving.engine import (
    build_kernels,
    bucket_len,
    fit_request,
)
from ggrmcp_tpu_torch.serving import tensors
from ggrmcp_tpu_torch.serving.adapter_arena import AdapterExhaustedError
from ggrmcp_tpu_torch.serving.flight_recorder import (
    PHASE_NAMES,
    FlightRecorder,
    PhaseTimer,
)
from ggrmcp_tpu_torch.serving.host_pool import HostPagePool
from ggrmcp_tpu_torch.serving.pages import PageAllocator, PageExhaustedError
from ggrmcp_tpu_torch.serving.scheduler import (
    Scheduler,
    SchedulerQueue,
    retry_after_for,
)
from ggrmcp_tpu_torch.serving.slo import SloAccount, TenantTable
from ggrmcp_tpu_torch.utils import failpoints, regions, tracing
from ggrmcp_tpu_torch.utils.stats import pct

logger = logging.getLogger("ggrmcp.torch.batching")


class KVTransferError(RuntimeError):
    """A KV page export or import the arena cannot serve (paging off,
    no indexed pages for the prompt, a geometry or dtype mismatch). The
    sidecar maps it to a typed gRPC status: the transfer degrades, the
    request is never served from wrong pages."""


class OverloadedError(RuntimeError):
    """submit() refused a request: the admission queue is at its
    configured cap (batching.max_pending / max_queue_tokens). The
    sidecar maps it to gRPC RESOURCE_EXHAUSTED."""

    def __init__(self, message: str, reason: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.reason = reason  # "requests" | "tokens"
        self.retry_after_s = retry_after_s


class _PendingQueue:
    """FIFO admission queue with request and prompt-token depth; a
    replayed request re-enters at the front. Event-loop-thread only."""

    def __init__(self) -> None:
        self._items: deque = deque()
        self._tokens = 0
        self._event = asyncio.Event()

    def put_nowait(self, request: "_Request") -> None:
        self._items.append(request)
        self._tokens += len(request.prompt)
        self._event.set()

    def requeue_front(self, request: "_Request") -> None:
        self._items.appendleft(request)
        self._tokens += len(request.prompt)
        self._event.set()

    def _pop(self) -> "_Request":
        request = self._items.popleft()
        self._tokens -= len(request.prompt)
        return request

    def get_nowait(self) -> "_Request":
        if not self._items:
            raise asyncio.QueueEmpty
        return self._pop()

    async def get(self) -> "_Request":
        while not self._items:
            self._event.clear()
            await self._event.wait()
        return self._pop()

    def qsize(self) -> int:
        return len(self._items)

    def empty(self) -> bool:
        return not self._items

    @property
    def token_count(self) -> int:
        return self._tokens


@dataclasses.dataclass
class _Slot:
    active: bool = False
    request: Optional["_Request"] = None
    generated: int = 0
    max_new: int = 0
    # Held by an interleaved admission in progress: not decoding yet,
    # not free either (_free_slots skips it until _activate_slot).
    reserved: bool = False


@dataclasses.dataclass
class _IlvRow:
    """One admitting row of the interleave mini cache: host-side progress
    of a long prompt advancing one chunk per tick (prefill_interleave)."""

    request: "_Request"
    slot: int
    n: int  # prompt length
    progress: int = 0  # tokens already written into the mini row


@dataclasses.dataclass
class _Request:
    prompt: list[int]
    max_new: int
    sampling: SamplingConfig
    seed: int
    out: asyncio.Queue = dataclasses.field(default_factory=asyncio.Queue)
    cancelled: bool = False
    # Unary consumers get ONE terminal chunk; `acc` holds every emitted
    # token (the payload for unary consumers, the replay prefix for all).
    unary: bool = False
    acc: list[int] = dataclasses.field(default_factory=list)
    retries: int = 0
    absorbed: int = 0  # acc tokens already folded into `prompt` by replays
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    queue_ms: float = 0.0
    # Flight record: the gateway trace id, the prompt length before any
    # replay fold, and the first tick the request decoded in (-1 = never
    # admitted).
    trace_id: str = ""
    n_prompt: int = 0
    first_tick: int = -1
    # Tenant and QoS class (the SLO ledgers; the scheduler's lanes).
    tenant: str = ""
    qos_class: str = ""
    # True while demoted and parked (a resume completes one preempt
    # cycle); preemptions so far, and resume attempts that found the
    # adapter arena full (bounded by scheduler.resume_retry_limit).
    parked: bool = False
    preempts: int = 0
    sched_retries: int = 0
    # LoRA: the adapter row (0 = base), the stable adapter name the
    # paged chains key on ("" = base; rows are reused after eviction),
    # and the arena pin held until the terminal chunk (None = boot-time
    # adapters or base).
    adapter: int = 0
    adapter_key: str = ""
    adapter_lease: object = None
    # Grammar: the arena residency (None = unconstrained), the host DFA
    # state after the last emitted token, whether the arena reference
    # was returned, and whether a refused forced run degraded the
    # request to one-token decoding.
    grammar: Optional[GrammarHandle] = None
    gcur: int = 0
    g_released: bool = False
    jump_degraded: bool = False


class _Turn:
    """One serving-loop turn: from a tick's end (its record's last
    phase mark), or the loop's start, to the next tick's dispatch. Its
    children (`batcher.yield`, `batcher.host_ops`, `batcher.admit`,
    `batcher.wait_work`) are perf_counter stamps, put on the wall axis
    through the (t_wall, t_mono) pair the turn starts from when the next
    tick's record opens; the rest of the turn is executor hops."""

    __slots__ = ("p0", "wall", "mono", "after", "children")
    MAX_CHILDREN = 256  # past it, a turn's children are not kept

    def __init__(self, p0: float, wall: float, mono: float, after: int):
        self.p0, self.wall, self.mono, self.after = p0, wall, mono, after
        self.children: list = []

    @classmethod
    def now(cls, after: int) -> "_Turn":
        mono = time.perf_counter()
        return cls(mono, time.time(), mono, after)

    def child(self, name: str, p0: float, p1: float, **attrs) -> None:
        if len(self.children) < self.MAX_CHILDREN:
            self.children.append((name, p0, p1, attrs))

    def record(self, p_end: float) -> None:
        """Keep the turn, ending at `p_end`, and its children."""
        tracer = tracing.tracer
        turn = tracer.record(
            "batcher.turn", self.wall + (self.p0 - self.mono),
            (p_end - self.p0) * 1e3, after_tick=self.after)
        for name, p0, p1, attrs in self.children:
            tracer.record(name, self.wall + (p0 - self.mono),
                          (p1 - p0) * 1e3, parent_id=turn.span_id, **attrs)


# The ledger components reported as ServingStats memory_*_bytes.
_LEDGER_COMPONENTS = (
    "weights", "lora", "kv_arena", "block_tables", "draft_cache",
    "prefix_pool", "ilv_mini", "grammar_arena", "tick_state",
)
# counter_stats' host-tier fields while paging is off (the allocator
# reports them when on).
_HOST_TIER_ZEROS = {
    "kv_host_entries": 0, "kv_host_bytes_used": 0,
    "kv_host_budget_bytes": 0, "kv_host_file_entries": 0,
    "kv_host_file_bytes": 0, "kv_host_demotions": 0,
    "kv_host_restores": 0, "kv_host_bytes_demoted": 0,
    "kv_host_bytes_restored": 0, "kv_host_restore_failures": 0,
}


def _host_tensor(x) -> torch.Tensor:
    """A host page array (numpy, a bf16 numpy array of the reference's
    ml_dtypes kind, or a tensor) as a writable CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(x.view(np.int16))).view(
            torch.bfloat16)
    return torch.from_numpy(np.require(x, requirements=["C", "W"]))


def _head_blocks(leaf: Sharded) -> list[tuple[torch.Tensor, slice]]:
    """(stored part, the KV heads it holds) of every distinct part of a
    page-arena leaf sharded over tensor: [L, N + 1, P, KVH/t, Dh] blocks
    in head order, or the whole heads of a replicated one."""
    t = leaf.factors[-2]
    per = leaf.shape[3] // t
    out, seen = [], set()
    for i, part in enumerate(leaf.parts):
        if id(part) not in seen:
            seen.add(id(part))
            blk = leaf.mesh.coord(i)["tensor"] if t > 1 else 0
            out.append((part, slice(blk * per, (blk + 1) * per)))
    return out


def _arena_gather(leaf, idx: torch.Tensor) -> torch.Tensor:
    """Arena pages `idx` of one leaf to the host as the page codec's
    [L, n, P, KVH, Dh]: a sharded arena's KV heads concatenated in head
    order (every head once)."""
    if not isinstance(leaf, Sharded):
        return leaf.index_select(1, idx.to(leaf.device)).cpu()
    blocks = {hs.start: part for part, hs in _head_blocks(leaf)}
    return torch.cat([blocks[h].index_select(1, idx.to(blocks[h].device))
                      .cpu() for h in sorted(blocks)], dim=3)


def _arena_write(leaf, idx: torch.Tensor, payload: torch.Tensor) -> None:
    """Write [L, n, P, KVH, Dh] host pages into arena pages `idx` of one
    leaf: each part of a sharded arena takes its own KV heads."""
    if not isinstance(leaf, Sharded):
        leaf.index_copy_(1, idx.to(leaf.device),
                         payload.to(leaf.device, leaf.dtype))
        return
    for part, heads in _head_blocks(leaf):
        part.index_copy_(1, idx.to(part.device),
                         payload[:, :, :, heads].to(part.device, part.dtype))


class ContinuousBatcher:
    """Slot-based continuous batching over a shared KV cache (contiguous,
    a ring, or a page arena under paged_kv). `ledger_scope` names this
    pool's memory-ledger components (a length tier's "tier-<max_seq>")."""

    # counter_stats() keys that merge across tiers by MAX (engine-level
    # facts every tier reports alike), not by sum.
    MAX_STAT_KEYS = (
        "admit_ms_max", "tp_chips", "mesh_devices", "mesh_shape",
        "mesh_spec_downgrades", "memory_weights_bytes", "memory_lora_bytes",
        "lora_adapters_registered", "lora_adapters_resident",
        "lora_rows_total", "lora_loads", "lora_evictions", "lora_hits",
        "lora_load_ms", "lora_shed",
    )

    def __init__(self, engine, cfg: Optional[BatchingConfig] = None,
                 eos_id: int = 2, ledger_scope: str = ""):
        self.engine = engine
        self.cfg = cfg or BatchingConfig()
        self.eos_id = eos_id
        self.device = engine.device
        b = self.cfg.max_batch_size
        self.slots = [_Slot() for _ in range(b)]
        self.pending = _PendingQueue()
        self._task: Optional[asyncio.Task] = None
        # [(request, chunk)] a tick emits, delivered once its record is
        # settled (None outside a tick).
        self._tick_out: Optional[list] = None
        self._wake = asyncio.Event()
        self._stopping = False
        self._steps_per_tick = resolve_decode_steps(self.cfg)
        # Speculative ticks: batching.speculative=on AND a draft on the
        # engine (on without one logs and runs the plain tick, as the
        # reference does).
        spec_mode = self.cfg.speculative == "on"
        self._spec = spec_mode and getattr(engine, "draft_cfg", None) is not None
        if spec_mode and not self._spec:
            logger.warning(
                "batching.speculative=on but no serving.speculative_draft "
                "is configured; falling back to the plain tick"
            )
        self._gamma = (
            max(1, int(engine.serving.speculative_gamma)) if self._spec else 0
        )
        self._ring = getattr(engine, "ring_capacity", None) is not None
        # Model family: a MoE forward also takes the validity mask, so
        # padding, idle slots and idle interleave rows never compete for
        # expert capacity (routing is batch-global).
        self._is_moe = getattr(engine, "fam", llama_mod) is not llama_mod
        gcfg = getattr(engine.serving, "grammar", None) or GrammarConfig()
        jump_max = int(gcfg.jump_max) if gcfg.enabled else 0
        # The reference's gates: the jump window does not compose with a
        # ring cache (its clobber bound was sized for the prefill chunk),
        # and junk window positions would compete for MoE experts.
        if jump_max and self._ring:
            logger.warning(
                "grammar.jump_max > 0 does not compose with kv_ring; "
                "falling back to one-token constrained decoding"
            )
            jump_max = 0
        if jump_max and self._is_moe:
            logger.warning(
                "grammar.jump_max > 0 is dense-family only; falling "
                "back to one-token constrained decoding"
            )
            jump_max = 0
        self._jump_max = jump_max
        # A tick may run up to advance - 1 positions past a slot's
        # max_new before the host masks the extra tokens: every request
        # reserves that much cache (pipelined ticks are off). A plain
        # tick advances steps_per_tick positions; a grammar-carrying
        # request reserves the jump window instead (1 + jump_max). A
        # spec tick writes gamma + 1 positions for every request (forced
        # runs ride the draft's proposal there, not a wider window).
        if self._spec:
            advance = jump_advance = self._gamma + 1
        else:
            advance = self._steps_per_tick
            jump_advance = max(advance, 1 + jump_max)
        self._reserve = advance - 1
        self._jump_reserve = jump_advance - 1
        if self._spec and self._ring:
            # core/config.py mirrors this; a batcher built directly must
            # hit the same wall.
            raise ValueError(
                "batching.speculative does not compose with kv_ring"
            )
        if self._ring:
            engine_chunk = engine.serving.batching.prefill_chunk
            if self.cfg.prefill_chunk > engine_chunk:
                # The capacity was sized for the engine config's chunk; a
                # wider chunk would break the clobber bound mid-admission.
                raise ValueError(
                    f"batcher prefill_chunk ({self.cfg.prefill_chunk}) "
                    f"exceeds the ring engine's ({engine_chunk}); the "
                    f"ring capacity was sized for the engine's chunk"
                )
            self.max_seq = engine.ring_capacity
            # A request is bounded by the RoPE range, not the ring.
            self._fit_limit = engine.cfg.max_seq_len
        else:
            self.max_seq = min(self.cfg.kv_cache_max_seq,
                               engine.cfg.max_seq_len)
            self._fit_limit = self.max_seq
        # Paged KV (paged_kv=on): the shared cache is a page arena with
        # block tables; the host allocator owns the tables (uploaded to
        # the device before a tick when dirty).
        self._paged = self.cfg.paged_kv == "on"
        if self._paged:
            # core/config.py mirrors these; a batcher built directly
            # must hit the same walls.
            if self._ring:
                raise ValueError("paged_kv does not compose with kv_ring")
            if self.cfg.prefix_cache_entries:
                raise ValueError(
                    "paged_kv supersedes the slot-granular prefix pool; "
                    "set prefix_cache_entries to 0"
                )
            page = max(1, int(self.cfg.paged_kv_page_size))
            if self.max_seq % page:
                raise ValueError(
                    f"paged_kv_page_size ({page}) must divide the cache "
                    f"max_seq ({self.max_seq})"
                )
            self._page_size = page
            self._table_width = self.max_seq // page
            self._n_pages = (
                int(self.cfg.paged_kv_pages or 0) or b * self._table_width
            )
            self.pages: Optional[PageAllocator] = PageAllocator(
                self._n_pages, page, slots=b, table_width=self._table_width,
            )
            self._tables_dirty = False
        else:
            self.pages = None
        self.cache = self._make_shared_cache()
        # Spec mode: the draft's slot pool beside the shared cache, and a
        # request clamps to the draft's RoPE range too. prev_tokens is
        # each slot's last committed token: a round's first draft feed
        # is [prev, cur], keeping the draft cache one position behind.
        if self._spec:
            self._fit_limit = min(self._fit_limit,
                                  engine.draft_cfg.max_seq_len)
            self.dcache = engine.make_draft_cache(b, self.max_seq)
        else:
            self.dcache = None
        self.prev_tokens = np.zeros((b,), np.int64)
        # True while a draft-pool admission is in flight: a failure then
        # rebuilds the draft pool.
        self._dcache_at_risk = False
        # Spec accounting: ticks, proposals, acceptances (ServingStats
        # spec_*; accepted / drafted is the realized acceptance rate).
        self.spec_ticks = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        # The host page tier (paged_kv_host_bytes > 0): the allocator
        # owns placement; _demote_fetch / _restore_write are its device
        # halves, run inside this batcher's serialized executor stream.
        self.host_pool: Optional[HostPagePool] = None
        if self._paged and self.cfg.paged_kv_host_bytes > 0:
            self.host_pool = HostPagePool(
                int(self.cfg.paged_kv_host_bytes),
                geometry=self._kv_page_geometry(),
                file_path=self.cfg.paged_kv_host_path or "",
                file_budget_bytes=int(self.cfg.paged_kv_host_file_bytes),
            )
            self.pages.attach_host(self.host_pool, self._demote_fetch,
                                   self._restore_write)
        # Serialized host ops (run_host_op): (fn, future) pairs the loop
        # drains between ticks in its one executor stream.
        self._host_ops: deque = deque()
        # The loop's current turn (None with the recorder off), and the
        # routes of the admission round a span is kept for (None when
        # none is).
        self._turn: Optional[_Turn] = None
        self._admit_routes: Optional[dict] = None
        # True while a device call that writes the SHARED cache is in
        # flight; admission failure rebuilds the cache only when set.
        self._cache_at_risk = False
        # Host-mirrored per-slot state, shipped to the device each tick.
        self.cur_tokens = np.zeros((b,), np.int64)
        self.temps = np.zeros((b,), np.float32)
        self.top_ks = np.zeros((b,), np.int64)
        self.top_ps = np.ones((b,), np.float32)
        self.seeds = np.zeros((b,), np.int64)
        self.adapter_ids = np.zeros((b,), np.int64)  # per-slot LoRA row
        self.step_counter = 0
        # Grammar: per-slot absolute DFA state (the state the slot's
        # next sample is masked under) and jump enable, host mirrors
        # shipped with each tick; the arena's tables and their device
        # twins (_grammar_tables).
        self.gstates = np.zeros((b,), np.int64)
        self.jump_ok = np.zeros((b,), bool)
        self.arena = GrammarArena(
            gcfg.arena_states if gcfg.enabled else 2,
            engine.cfg.vocab_size, jump_max=jump_max,
        )
        self._g_allow, self._g_trans = trivial_grammar_tables(
            engine.cfg.vocab_size, self.device
        )
        width = self.arena.jump_tokens.shape[1]
        self._g_jlen = torch.zeros((1,), dtype=torch.int32, device=self.device)
        self._g_jtok = torch.zeros((1, width), dtype=torch.int32,
                                   device=self.device)
        self._g_jstate = torch.zeros_like(self._g_jtok)
        self._g_full = False  # the one-state tables until a grammar lands
        self._g_dev_version = self.arena.version
        self.grammar_tokens = 0
        self.grammar_jump_tokens = 0
        self.grammar_jump_runs = 0
        self.grammar_jump_fallbacks = 0
        # Prefix pool: entries shaped like mini-cache rows, so a hit is
        # one copy into the admission mini. Host maps (keys, LRU stamps)
        # are touched only inside the executor calls.
        pe = self.cfg.prefix_cache_entries
        self._pfx_max = min(self.cfg.prefix_cache_max_seq, self.max_seq)
        self._pfx_min = max(1, self.cfg.prefix_cache_min_seq)
        # A storable prompt needs _pfx_min + 1 tokens AND must be
        # admissible (fit_request's bound).
        poolable = (
            self._pfx_min + 1 <= self.max_seq - self._reserve - 2
            and not self._ring  # pooled prefixes assume a contiguous layout
        )
        if pe > 0 and poolable:
            self._pfx_pool = engine.make_cache(pe, self._pfx_max)
            self._pfx_keys: list[Optional[np.ndarray]] = [None] * pe
            self._pfx_used = [0] * pe  # LRU stamps
            self._pfx_clock = 0
        else:
            self._pfx_pool = None
        self.prefix_hits = 0
        self.prefix_misses = 0
        # Interleave (prefill_interleave=on): K admitting rows of a
        # carried [K, S_max] mini cache, further long prompts queued.
        self._ilv_k = (
            max(1, int(self.cfg.prefill_interleave_rows))
            if self.cfg.prefill_interleave == "on" else 0
        )
        self._ilv_rows: list[Optional[_IlvRow]] = [None] * self._ilv_k
        self._ilv_pending: deque = deque()
        self._ilv_mini = None  # lazily _make_mini(K, max_seq)
        self.interleaved_chunks = 0
        self.interleaved_admissions = 0
        self.timing = {
            "tick_dispatch_ms": 0.0, "tick_collect_ms": 0.0,
            "admit_ms": 0.0, "admit_ms_max": 0.0,
            "ticks": 0, "admit_rounds": 0,
        }
        self._lat_records: deque = deque(maxlen=4096)
        self._stall_records: deque = deque(maxlen=4096)
        self._slot_last_emit: list = [None] * b
        self.shed = 0
        self.replayed = 0
        self.replay_exhausted = 0
        # Admission routing counts (fused rows / chunked rows).
        self.fused_admissions = 0
        self.chunked_admissions = 0
        # EMA of one admitted row's prefill cost (ms), the p50_budget_ms
        # cap's estimate; pessimistic until measured.
        self._admit_ema_ms = 50.0
        self.timed_out = 0
        serving = engine.serving
        # The flight recorder, and the SLO and tenant ledgers fed from
        # the same terminal hook (off with the recorder).
        self.recorder = FlightRecorder(serving.observability)
        self.slo = SloAccount(serving.slo, obs_enabled=self.recorder.enabled,
                              bounds=self.recorder._bounds)
        self.tenants = TenantTable(serving.slo, enabled=self.slo.enabled)
        # The scheduler replaces the FIFO queue with its lanes (same
        # interface) and decides preemption once per loop turn.
        self.sched_cfg = serving.scheduler
        self.sched: Optional[Scheduler] = None
        if self.sched_cfg.enabled:
            self.sched = Scheduler(self.sched_cfg, slo=self.slo,
                                   tenants=self.tenants)
            self.pending = SchedulerQueue(self.sched_cfg,
                                          tenants=self.tenants)
        # Tick phases: cumulative ms per phase over recorded ticks, and
        # the admission time since the last tick (the next tick's admit
        # phase).
        self.phase_ms = dict.fromkeys(PHASE_NAMES, 0.0)
        self._admit_phase_ms = 0.0
        # The memory ledger's components; suppliers read the live
        # attributes, so a rebuilt cache is accounted at the next read.
        ledger = engine.ledger
        scope = ledger_scope
        ledger.register("kv_arena", lambda: (
            self.cache.k, self.cache.v, self.cache.length), scope=scope)
        ledger.register("block_tables",
                        lambda: getattr(self.cache, "table", None),
                        scope=scope)
        ledger.register("draft_cache", lambda: self.dcache, scope=scope)
        ledger.register("prefix_pool", lambda: self._pfx_pool, scope=scope)
        ledger.register("ilv_mini", lambda: self._ilv_mini, scope=scope)
        ledger.register("grammar_arena", self._grammar_device_tables,
                        scope=scope)
        # The tick's token and grammar state ride from the host each
        # tick: nothing persists on the device.
        ledger.register("tick_state", lambda: None, scope=scope)
        # The host tier's bytes are host memory: the ledger's host side.
        ledger.register_host("host_pool", lambda: (
            self.host_pool.memory_info() if self.host_pool is not None
            else None), scope=scope)

    # -- host <-> device helpers -----------------------------------------

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _valid(self, true_len: torch.Tensor, offs, width: int):
        """MoE validity of a [R, width] step at per-row offsets `offs` (an
        int or an [R] tensor): position < the row's prompt length (0 for
        padding rows). None for the dense family, which ignores it."""
        if not self._is_moe:
            return None
        if isinstance(offs, torch.Tensor):
            offs = offs.long()[:, None]
        pos = offs + torch.arange(width, device=self.device)[None, :]
        return pos < true_len.long()[:, None]

    def _lora_idx(self, ids: np.ndarray) -> Optional[torch.Tensor]:
        """Per-row adapter rows for a forward, or None when every row is
        base (the host knows): the delta of row 0 is exactly zero, so
        skipping the gather changes no value."""
        if not self.engine.lora_enabled or not ids.any():
            return None
        return self._t(ids)

    def _temps(self, temps: np.ndarray) -> Optional[torch.Tensor]:
        """Per-row temperatures for a sampling call, or None when no row
        samples: the all-greedy call skips the draw (the host knows)."""
        return self._t(temps) if (temps > 0.0).any() else None

    def _sample(self, logits, seeds, step, temps, ks, ps, gs):
        """Grammar-masked sample of each row under its state `gs`:
        (tokens [B], next states [B]); `temps` None = all rows greedy."""
        return masked_sample_dynamic(
            logits, seeds, step, temps, ks, ps, gs,
            self._g_allow, self._g_trans,
        )

    def _grammar_tables(self) -> None:
        """Bring the device tables up to the arena's version. Until the
        first grammar is resident they are the one-state accept-all
        tables (no row can hold another state). The first insert
        allocates the fixed [arena_states, V] tables, zero like the
        arena's, with row 0 accept-all; from then on only the rows each
        insert wrote are uploaded (evictions write nothing)."""
        if self.arena.version == self._g_dev_version:
            return
        spans, version = self.arena.take_dirty()
        if spans and not self._g_full:
            a = self.arena
            s, v, w = a.max_states, a.vocab_size, a.jump_tokens.shape[1]
            dev = self.device
            self._g_allow = torch.zeros((s, v), dtype=torch.bool, device=dev)
            self._g_allow[0] = True
            self._g_trans = torch.zeros((s, v), dtype=torch.int32, device=dev)
            self._g_jlen = torch.zeros((s,), dtype=torch.int32, device=dev)
            self._g_jtok = torch.zeros((s, w), dtype=torch.int32, device=dev)
            self._g_jstate = torch.zeros((s, w), dtype=torch.int32,
                                         device=dev)
            self._g_full = True
        for start, end, *rows in spans:
            for dst, src in zip(self._grammar_device_tables(), rows):
                dst[start:end] = torch.from_numpy(src).to(self.device)
        self._g_dev_version = version

    def _grammar_device_tables(self) -> tuple:
        """(allow, trans, jump_len, jump_tokens, jump_states) on the
        device, in `GrammarArena.take_dirty`'s order."""
        return (self._g_allow, self._g_trans, self._g_jlen, self._g_jtok,
                self._g_jstate)

    def grammar_table_bytes(self) -> int:
        return sum(t.nbytes for t in self._grammar_device_tables())

    def _g0(self, request: "_Request") -> int:
        """The absolute state a (re-)admission samples its first token
        under: the grammar's start state, walked through the tokens a
        replay folded into the prompt."""
        if request.grammar is None:
            return 0
        state = request.grammar.start
        for token in request.acc[:request.absorbed]:
            state = self.arena.step(state, int(token))
        return state

    def _grammar_release(self, request: "_Request") -> None:
        """Return a terminal request's arena reference, once."""
        if request.grammar is not None and not request.g_released:
            request.g_released = True
            self.arena.release(request.grammar)

    def _release_holds(self, request: "_Request") -> None:
        """Return what a request that leaves holds: its grammar arena
        reference and its adapter arena pin (a leaked pin would exempt a
        row from eviction forever). Both releases are idempotent."""
        self._grammar_release(request)
        if request.adapter_lease is not None:
            self.engine.adapter_arena.release(request.adapter_lease)

    def _reserve_for(self, constrained: bool) -> int:
        """The tick overshoot a request's cache extent must cover: the
        jump window for a grammar-carrying request, the plain tick's
        otherwise (equal when jump is off)."""
        return self._jump_reserve if constrained else self._reserve

    def _make_mini(self, rows: int, length: int) -> llama_mod.KVCache:
        """Admission mini cache in the engine's KV dtype (its spec
        downgrades uncounted, as the reference's unsharded one)."""
        return self.engine.make_cache(rows, length, site=None)

    def _make_shared_cache(self):
        """The shared cache of this batcher's shape: the initial build and
        every failure rebuild go through here."""
        if self._paged:
            return self.engine.make_paged_cache(
                len(self.slots), self.max_seq, self._n_pages,
                self._page_size,
            )
        return self.engine.make_cache(len(self.slots), self.max_seq)

    def _sync_tables(self) -> None:
        """Upload the host block tables when they changed since the last
        upload (a copy: the host tables keep changing). Only the decode
        tick reads the device tables; admission merges index pages from
        the host tables directly (_paged_put)."""
        if self._paged and self._tables_dirty:
            self.cache.table = torch.tensor(self.pages.tables,
                                            device=self.device)
            self._tables_dirty = False

    # -- device bodies ----------------------------------------------------

    def _merge(self, merge, src, dst=None) -> None:
        """Copy `src`'s K/V into `dst` (the pool by default) in place
        through `merge(dst_leaf, src_leaf)`; `kv_map` applies it to an
        int8 cache's values and scales alike."""
        dst = self.cache if dst is None else dst
        quant.kv_map(merge, dst.k, src.k)
        quant.kv_map(merge, dst.v, src.v)

    def _merge_rows(self, mini, rows, slots, lens, start: int = 0) -> None:
        """The one row merge of every admission route: mini rows `rows`
        (host list) become the pool's slots `slots` with lengths `lens`.
        Contiguous: whole rows are copied. Paged: _paged_put writes only
        positions [start, len) (start > 0 = the paged prefix admission's
        shared-page boundary). Padding rows of a group are never listed —
        the reference's out-of-range scatter drops them."""
        dst = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        if self._paged:
            self._paged_put(mini, rows, slots, lens, start)
        else:
            src = torch.as_tensor(rows, dtype=torch.long, device=self.device)
            cap = mini.capacity

            def merge(pool, m):
                # A shard's leaf may sit on another card than the indices.
                dev = pool.device
                pool[:, dst.to(dev), :cap] = m[:, src.to(dev), :cap]
                return pool

            self._merge(merge, mini)
        self.cache.length[dst] = self._t(np.asarray(lens, np.int32))

    def _paged_put(self, mini, rows, slots, lens, start: int) -> None:
        """Paged counterpart of the row merge: write mini row rows[i]'s
        positions [start, lens[i]) into slot slots[i]'s pages. The
        positions below `start` are SHARED pages (immutable, refcounted)
        and are never written. The pages come from the host tables — the
        authoritative mapping the device tables are a snapshot of."""
        p = self._page_size
        src_row, src_pos, dst_page = [], [], []
        for row, sl, n in zip(rows, slots, lens):
            pos = np.arange(start, int(n))
            pages = self.pages.tables[sl, pos // p]
            keep = pages != self.pages.sentinel
            src_row.append(np.full(int(keep.sum()), row))
            src_pos.append(pos[keep])
            dst_page.append(pages[keep])
        src_row = self._t(np.concatenate(src_row).astype(np.int64))
        pos = np.concatenate(src_pos).astype(np.int64)
        src_pos, dst_off = self._t(pos), self._t(pos % p)
        dst_page = self._t(np.concatenate(dst_page).astype(np.int64))

        def put(arena, m):
            dev = arena.device
            arena[:, dst_page.to(dev), dst_off.to(dev)] = m[
                :, src_row.to(dev), src_pos.to(dev)].to(arena.dtype)
            return arena

        self._merge(put, mini)

    # -- KV page export / import (the TransferKV plane) --------------------

    def clamp_prompt(self, prompt: list[int], max_new: int,
                     constrained: bool = False) -> list[int]:
        """The prompt exactly as an admission for (prompt, max_new) will
        see it (fit_request keeps the tail). The prefill leg of a
        disaggregated call admits and exports THIS prompt, with the
        request's real max_new and grammar flag, so that its chain is
        the one the decode replica's identically clamped admission looks
        up."""
        clamped, _ = fit_request(
            prompt, max_new, self._fit_limit - self._reserve_for(constrained)
        )
        return clamped

    def _arena_leaves(self) -> list[tuple[str, torch.Tensor]]:
        """(name, [L, N + 1, P, KVH, Dh] leaf) of the page arena: k and
        v, and an int8 arena's k_scale and v_scale. On a mesh a leaf is
        `Sharded` over tensor by KV head; `_arena_gather` and
        `_arena_write` move whole heads in and out of it."""
        out = []
        for name, leaf in (("k", self.cache.k), ("v", self.cache.v)):
            if isinstance(leaf, quant.QuantizedTensor):
                out += [(name, leaf.q), (name + "_scale", leaf.scale)]
            else:
                out.append((name, leaf))
        return out

    def _gather_pages(self, pages: list[int]) -> dict:
        """One indexed gather per arena leaf, each brought to the host
        by one copy: {name: [L, n, P, KVH, Dh] CPU tensor}."""
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        return {name: _arena_gather(leaf, idx)
                for name, leaf in self._arena_leaves()}

    def export_prompt_kv(self, prompt: list[int], adapter: str = "") -> dict:
        """Gather the indexed full-page KV of `prompt` from the arena to
        the host (the prefill-role half of disaggregated serving; run
        via run_host_op, whose serialized stream makes the lookup and
        the gather atomic against eviction). Returns {pages, page_size,
        k, v[, k_scale, v_scale]} with [L, n, P, KVH, Dh] CPU tensors
        (an int8 arena ships values and scales, half the bytes). Raises
        KVTransferError when paging is off or the index holds no page
        of this prompt. `adapter`: the key domain the chain was
        registered under ("" = base)."""
        if not self._paged:
            raise KVTransferError("kv export requires batching.paged_kv=on")
        pages = self.pages.chain_pages(prompt, adapter=adapter)
        if not pages:
            raise KVTransferError(
                "no indexed pages for this prompt (evicted before "
                "export, or the prompt is shorter than one page)"
            )
        return {"pages": len(pages), "page_size": self._page_size,
                **self._gather_pages(pages)}

    def import_prompt_kv(self, prompt: list[int], start_page: int, k, v,
                         k_scale=None, v_scale=None,
                         adapter: str = "") -> tuple[int, int]:
        """Land one TransferKV chunk in the arena (the decode-role half;
        run via run_host_op): allocate and index the chunk's pages on
        the host (pages.import_chain: refcount 0, LRU-stamped,
        evictable) and write their contents into the arena. Returns
        (pages imported, pages already present). Raises
        KVTransferError on a geometry or dtype mismatch and
        PageExhaustedError when the arena cannot hold the chunk."""
        if not self._paged:
            raise KVTransferError("kv import requires batching.paged_kv=on")
        k, v = _host_tensor(k), _host_tensor(v)
        self._check_payload(k, v, k_scale)
        placed = self.pages.import_chain(prompt, start_page,
                                         int(k.shape[1]), adapter=adapter)
        present = int(k.shape[1]) - len(placed)
        if not placed:
            return 0, present
        dst = [p for _, p in placed]
        src = torch.as_tensor([j - start_page for j, _ in placed],
                              dtype=torch.long)
        scales = [None if t is None else _host_tensor(t)[:, src]
                  for t in (k_scale, v_scale)]
        self._write_arena_pages(dst, k[:, src], v[:, src], *scales)
        return len(placed), present

    def _check_payload(self, k, v, k_scale) -> None:
        """Page payloads must match the arena: int8 or not, and [L, P,
        KVH, Dh] geometry."""
        arena_k = self.cache.k
        quantized = isinstance(arena_k, quant.QuantizedTensor)
        if quantized != (k_scale is not None):
            raise KVTransferError(
                "kv dtype mismatch: sender and receiver must both use "
                "int8 KV or neither (serving.kv_cache_dtype)"
            )
        ref = arena_k.q if quantized else arena_k
        want = (ref.shape[0],) + tuple(ref.shape[2:])  # [L, P, KVH, Dh]
        got = (k.shape[0],) + tuple(k.shape[2:])
        if got != want or tuple(v.shape) != tuple(k.shape):
            raise KVTransferError(
                f"kv page geometry mismatch: got {got}, arena wants "
                f"{want} (layers, page_size, kv_heads, head_dim)"
            )

    def _write_arena_pages(self, dst: list[int], k, v, k_scale=None,
                           v_scale=None) -> None:
        """Host-to-device write of [L, n, P, KVH, Dh] page contents into
        arena pages `dst`: the ONE device write of the TransferKV import
        and the host-tier restore. Geometry and dtype are checked again
        here (the restore has no other gate). The copies come from
        pageable memory on the stream every admission uses, so a later
        gather reads the new contents."""
        k, v = _host_tensor(k), _host_tensor(v)
        self._check_payload(k, v, k_scale)
        idx = torch.as_tensor(dst, dtype=torch.long, device=self.device)
        payload = {"k": k, "v": v}
        if k_scale is not None:
            payload["k_scale"] = _host_tensor(k_scale)
            payload["v_scale"] = _host_tensor(v_scale)
        for name, leaf in self._arena_leaves():
            _arena_write(leaf, idx, payload[name])

    # -- host-tier hooks (serving/host_pool.py via pages.attach_host) -----

    def _kv_page_geometry(self) -> str:
        """Page shape and dtype signature guarding the host pool's file
        tier, in the reference's spelling ("LxPxKVHxDh:bfloat16", and
        ":int8" for an int8 arena), so a file written by either package
        reads as the same geometry in the other."""
        leaf = self.cache.k
        quantized = isinstance(leaf, quant.QuantizedTensor)
        ref = leaf.q if quantized else leaf
        shape = (ref.shape[0],) + tuple(ref.shape[2:])
        dtype = str(ref.dtype).replace("torch.", "")
        return "x".join(str(d) for d in shape) + f":{dtype}" + (
            ":int8" if quantized else ""
        )

    def _demote_fetch(self, pages: list[int]) -> list[bytes]:
        """Device-to-host gather and pack of arena pages about to be
        evicted (the allocator's demotion half): one gather per leaf for
        the whole victim set, one packed KVPagePayload per page (the
        codec TransferKV ships pages with)."""
        got = self._gather_pages(pages)
        quantized = "k_scale" in got
        return [
            tensors.pack_kv_pages(
                got["k"][:, i:i + 1], got["v"][:, i:i + 1],
                got["k_scale"][:, i:i + 1] if quantized else None,
                got["v_scale"][:, i:i + 1] if quantized else None,
            )
            for i in range(len(pages))
        ]

    def _restore_write(self, pages: list[int], blobs: list[bytes]) -> None:
        """Unpack and write restored host-tier pages (the allocator's
        restore half), all in one batched write. Raises on the
        host_restore_fail failpoint or any unpack or geometry error: the
        allocator then degrades the admission, typed, to recompute."""
        failpoints.evaluate("host_restore_fail")
        parts: dict[str, list] = {"k": [], "v": [], "k_scale": [],
                                  "v_scale": []}
        for blob in blobs:
            for name, arr in zip(parts, tensors.unpack_kv_pages(blob)):
                if arr is not None:
                    parts[name].append(_host_tensor(arr))
        if parts["k_scale"] and len(parts["k_scale"]) != len(parts["k"]):
            raise KVTransferError(
                "mixed int8/unquantized payloads in one restore set"
            )
        cat = {name: torch.cat(arrs, dim=1) if arrs else None
               for name, arrs in parts.items()}
        self._write_arena_pages(pages, cat["k"], cat["v"], cat["k_scale"],
                                cat["v_scale"])

    def _admit_full_impl(self, params, tokens, true_len, valid_rows,
                         seeds, temps, ks, ps, gs, adapters=None):
        """Burst admission: `tokens` is a full [B, S] batch with each
        admitted prompt at its slot's row; `valid_rows` (host list) are
        the admitted rows. One [B, S] prefill against a fresh mini cache,
        first-token sample, then the admitted rows' K/V and lengths are
        copied into the pool (other rows keep their state). `adapters`:
        each row's LoRA row (None = all base), on every route. Rows not
        admitted have length 0."""
        r, s = tokens.shape
        mini = self._make_mini(r, s)
        logits, mini = self.engine.prefill_forward(
            params, tokens, mini, adapters, self._valid(true_len, 0, s))
        idx = torch.clamp(true_len.long() - 1, min=0)
        last = logits[torch.arange(r, device=self.device), idx]
        first, _ = self._sample(last, seeds, 0, temps, ks, ps, gs)
        lens = true_len.tolist()
        self._merge_rows(mini, valid_rows, valid_rows,
                         [lens[i] for i in valid_rows])
        return first

    def _admit_single_impl(self, params, tokens, true_len, slot,
                           seeds, temps, ks, ps, gs, adapters=None):
        """One request (row shapes [1, S]) into slot `slot`."""
        mini = self._make_mini(1, tokens.shape[1])
        logits, mini = self.engine.prefill_forward(
            params, tokens, mini, adapters,
            self._valid(true_len, 0, tokens.shape[1]))
        n = int(true_len[0])
        last = logits[:, max(n - 1, 0)]
        first, _ = self._sample(last, seeds, 0, temps, ks, ps, gs)
        self._merge_rows(mini, [0], [slot], [n])
        return first

    def _chunked_scan(self, params, tokens, true_len, mini, start: int = 0,
                      adapters=None):
        """Extend `mini` (which already holds `start` positions per row)
        by one [R, C] chunk per grid step and capture each row's logits
        at its final prompt position as it passes. Rows shorter than the
        grid process padding chunks whose K/V land past their final
        length (masked by length on merge; writes past the mini's end
        land in its scratch slot). Padding rows have length 0."""
        r, t_steps, c = tokens.shape
        final = torch.zeros((r, self.engine.cfg.vocab_size),
                            dtype=torch.float32, device=self.device)
        last = true_len.long() - 1
        for t in range(t_steps):
            off = start + t * c
            logits, mini = self.engine.decode_forward(
                params, tokens[:, t], mini, adapters, ring=self._ring,
                valid=self._valid(true_len, off, c),
            )
            idx = torch.clamp(last - off, 0, c - 1)
            sel = logits[torch.arange(r, device=self.device), idx]
            take = (last >= off) & (last < off + c)
            final = torch.where(take[:, None], sel, final)
        return final

    def _chunked_finish(self, mini, rows, slots, true_len, fl,
                        seeds, temps, ks, ps, gs, start: int = 0):
        """Sample each row's first token from `fl` and merge the real rows
        (`rows`, host list) of the [R, S_max] mini into `slots`."""
        first, _ = self._sample(fl, seeds, 0, temps, ks, ps, gs)
        lens = true_len.tolist()
        self._merge_rows(mini, rows, slots, [lens[r] for r in rows], start)
        return first

    def _admit_chunked_impl(self, params, tokens, true_len, rows, slots,
                            seeds, temps, ks, ps, gs, adapters=None):
        """Chunked admission of a group (no prefix): the [R, T, C] grid
        against a full-length [R, S_max] mini cache, then the merge and
        the first-token sample."""
        mini = self._make_mini(tokens.shape[0], self.max_seq)
        fl = self._chunked_scan(params, tokens, true_len, mini,
                                adapters=adapters)
        return self._chunked_finish(mini, rows, slots, true_len, fl,
                                    seeds, temps, ks, ps, gs)

    def _pfx_seeded_mini(self, rows: int, entry: int, start: int):
        """A full-length [rows, S_max] mini whose every row holds prefix
        pool entry `entry`, its length set to `start` (the suffix
        prefill then extends from there)."""
        mini = self._make_mini(rows, self.max_seq)
        m = self._pfx_max

        def load(mini_leaf, pool_leaf):
            mini_leaf[:, :, :m] = pool_leaf[:, entry:entry + 1, :m]
            return mini_leaf

        self._merge(load, self._pfx_pool, dst=mini)
        mini.length = torch.full((rows,), start, dtype=torch.int32,
                                 device=self.device)
        return mini

    def _admit_chunked_pfx_impl(self, params, tokens, true_len, rows, slots,
                                entry, start, seeds, temps, ks, ps, gs,
                                adapters=None):
        """Prefix-reuse admission: pool entry `entry` seeds the first
        `start` positions of EVERY row, then the [R, 1, W] suffix grid
        runs from `start` — one call admits a same-preamble wave."""
        mini = self._pfx_seeded_mini(tokens.shape[0], entry, start)
        fl = self._chunked_scan(params, tokens, true_len, mini, start,
                                adapters)
        return self._chunked_finish(mini, rows, slots, true_len, fl,
                                    seeds, temps, ks, ps, gs)

    def _paged_gathered_mini(self, gtables: np.ndarray, scan_start: int):
        """A full-length mini whose rows hold the arena pages of their
        gather tables (shared prefix, CoW source at the divergent entry),
        its length set to `scan_start`."""
        r = gtables.shape[0]
        mini = self._make_mini(r, self.max_seq)
        table = self._t(gtables.astype(np.int64))
        for leaf, arena in ((mini.k, self.cache.k), (mini.v, self.cache.v)):
            llama_mod.paged_view_layers(arena, table, out=leaf)
        mini.length = torch.full((r,), scan_start, dtype=torch.int32,
                                 device=self.device)
        return mini

    def _admit_paged_pfx_impl(self, params, tokens, true_len, rows, slots,
                              gtables, scan_start, merge_start,
                              seeds, temps, ks, ps, gs, adapters=None):
        """Paged prefix-reuse admission: gather each row's shared prefix
        into a full-width mini through the host-built gather tables, run
        the [R, T, C] suffix grid from `scan_start`, and write positions
        [merge_start, n) into the rows' OWN pages. Shared pages are read,
        never written; scan_start > merge_start is the copy-on-write case
        (the overlap's K/V ride the gather into the slot's own page)."""
        mini = self._paged_gathered_mini(gtables, scan_start)
        fl = self._chunked_scan(params, tokens, true_len, mini, scan_start,
                                adapters)
        return self._chunked_finish(mini, rows, slots, true_len, fl,
                                    seeds, temps, ks, ps, gs,
                                    start=merge_start)

    def _tick_impl(self, params, tokens, seeds, step, temps, ks, ps, gs,
                   adapters=None, active=None):
        """`decode_steps_per_tick` decode steps for the whole pool, each
        sampled under the rows' grammar states, which advance by a
        transition gather. Tokens a slot samples after its EOS / max_new
        are dropped on the host (_emit_chunk); their cache writes are
        masked by length when the slot is reused, and a write past the
        end of the cache lands in its scratch slot (scratch page when
        paged). `active` [B] (MoE): idle slots still compute but take no
        expert capacity. Returns (tokens [B, steps], states [B])."""
        out = []
        cur = tokens
        valid = None if active is None else active[:, None]
        for i in range(self._steps_per_tick):
            logits, _ = self.engine.decode_forward(
                params, cur[:, None], self.cache, adapters, ring=self._ring,
                valid=valid,
            )
            cur, gs = self._sample(logits[:, -1], seeds, step + i, temps,
                                   ks, ps, gs)
            out.append(cur)
        return torch.stack(out, dim=1), gs

    def _tick_jump_impl(self, params, tokens, seeds, step, temps, ks, ps,
                        gs, jump_ok, adapters=None):
        """The jump-ahead tick: ONE forward over a [B, 1 + jump_max]
        window (each row's pending token, then its forced run), one
        sample at the run's end masked under its landing state. Rows
        without a run (state 0, jump_ok False) read position 0, the
        plain tick's sample, and their other window positions are junk
        that only the length pointer hides: it advances by count =
        run_len + 1, the forward wrote 1 + jump_max (writes past the
        cache land in the scratch slot or page). Returns (emit [B, 1 +
        jump_max], count [B], states [B]); the host emits emit[i,
        :count[i]]."""
        run_len, run_tokens, landing = forced_run_lookup(
            gs, self._g_jlen, self._g_jtok, self._g_jstate, jump_ok)
        window = torch.cat([tokens[:, None], run_tokens], dim=1)
        length0 = self.cache.length
        logits, _ = self.engine.decode_forward(params, window, self.cache,
                                               adapters)
        rows = torch.arange(window.shape[0], device=self.device)
        nxt, gs = self._sample(logits[rows, run_len], seeds, step, temps, ks,
                               ps, landing)
        idx = torch.arange(window.shape[1], device=self.device)[None, :]
        emit = torch.where(
            idx < run_len[:, None],
            torch.cat([run_tokens, torch.zeros_like(run_tokens[:, :1])], 1),
            torch.where(idx == run_len[:, None], nxt.long()[:, None], 0),
        )
        count = run_len + 1
        self.cache.length = (length0 + count).to(torch.int32)
        return emit, count, gs

    def _chunk_extend(self, params, chunk, offs, c_true_len, c_adapters=None):
        """Extend the carried [K, S_max] interleave mini by one [K, C]
        chunk at the host-stamped offsets and gather each row's logits
        at its final prompt position within this chunk (idle rows have
        length 0)."""
        mini = self._ilv_mini
        mini.length = offs.to(torch.int32)
        c = chunk.shape[1]
        logits, _ = self.engine.decode_forward(
            params, chunk, mini, c_adapters, ring=self._ring,
            valid=self._valid(c_true_len, offs, c))
        idx = torch.clamp(c_true_len.long() - 1 - offs.long(), 0, c - 1)
        return logits[torch.arange(chunk.shape[0], device=self.device), idx]

    def _tick_chunk_impl(self, params, tokens, seeds, step, temps, ks, ps,
                         gs, chunk, offs, c_true_len, adapters=None,
                         c_adapters=None, active=None):
        """A decode tick for every slot AND one [K, C] prefill chunk for
        the admitting rows, in one executor call: an active slot's
        emission gaps by one chunk's compute, never a whole prefill.
        Idle rows run junk chunks at offset 0 (their next occupant
        re-stamps the offset). Returns (tokens [B, steps], states [B],
        sel [K, V])."""
        toks, gs = self._tick_impl(params, tokens, seeds, step, temps, ks,
                                   ps, gs, adapters, active)
        sel = self._chunk_extend(params, chunk, offs, c_true_len, c_adapters)
        return toks, gs, sel

    def _tick_jump_chunk_impl(self, params, tokens, seeds, step, temps, ks,
                              ps, gs, jump_ok, chunk, offs, c_true_len,
                              adapters=None, c_adapters=None):
        """The jump tick fused with one [K, C] interleave chunk, as
        _tick_chunk_impl fuses the plain tick. Returns (emit, count,
        states, sel)."""
        emit, count, gs = self._tick_jump_impl(
            params, tokens, seeds, step, temps, ks, ps, gs, jump_ok, adapters)
        sel = self._chunk_extend(params, chunk, offs, c_true_len, c_adapters)
        return emit, count, gs, sel

    def _tick_spec_impl(self, params, draft_params, prev, tokens, seeds,
                        step, temps, ks, ps, gs):
        """The speculative tick: gamma draft steps and one (gamma+1)-
        position verify for every slot (ops/speculative.spec_tick on this
        engine's forwards; the verify window through the kernel, see
        GenerationEngine.verify_flash). The forced-run tables ride along
        while jump-ahead is on: a forced run seeds the draft's proposal.
        Returns (emit [B, gamma+1], count [B], states [B])."""
        jargs = ((self._g_jlen, self._g_jtok) if self._jump_max
                 else (None, None))
        emit, count, _, _, gs = spec_tick(
            lambda t, c: self.engine.verify_forward(params, t, c),
            lambda t, c: self.engine.draft_forward(draft_params, t, c),
            prev, tokens, self.cache, self.dcache, self._gamma, seeds, step,
            temps, ks, ps, gs, self._g_allow, self._g_trans, *jargs,
        )
        return emit, count, gs

    def _tick_spec_chunk_impl(self, params, draft_params, prev, tokens,
                              seeds, step, temps, ks, ps, gs, chunk, offs,
                              c_true_len):
        """The speculative tick fused with one [K, C] interleave chunk,
        as _tick_chunk_impl fuses the plain tick (no adapters: the engine
        refuses LoRA with a draft). Returns (emit, count, states, sel)."""
        emit, count, gs = self._tick_spec_impl(
            params, draft_params, prev, tokens, seeds, step, temps, ks, ps,
            gs)
        sel = self._chunk_extend(params, chunk, offs, c_true_len)
        return emit, count, gs, sel

    def _spec_admit_impl(self, draft_params, tokens, true_len, slots) -> None:
        """Draft-side admission: a fresh draft prefill of the [R, S]
        right-padded prompts, the rows of `slots` (host list; padding
        rows past it are never merged) written into the draft pool at
        positions [0, S) with length true_len - 1, one position behind
        the target, so the first round's [prev, cur] feed rewrites the
        last prompt token's slot (same token, same position)."""
        r, s = tokens.shape
        mini = self.engine.make_draft_cache(r, s, site=None)
        self.engine.draft_forward(draft_params, tokens, mini)
        n = len(slots)
        dst = torch.as_tensor(slots, dtype=torch.long, device=self.device)

        def put(pool, m):
            pool[:, dst, :s] = m[:, :n, :s]
            return pool

        self._merge(put, mini, dst=self.dcache)
        self.dcache.length[dst] = torch.clamp(
            true_len[:n].to(torch.int32) - 1, min=0)

    def _ilv_finish_impl(self, row, slot, n, sel, seeds, temps, ks, ps, gs,
                         adapters=None):
        """Final-chunk completion of one interleaved admission: copy mini
        row `row` into the pool at `slot` with length `n` and sample the
        first token from that row's final-position logits."""
        self._merge_rows(self._ilv_mini, [row], [slot], [n])
        return self._sample(sel[row:row + 1], seeds, 0, temps, ks, ps, gs)[0]

    def _pfx_store_impl(self, src, row: int, entry: int, plen: int) -> None:
        """Copy the first `_pfx_max` positions of row `row` of `src` (a
        prefilled mini, or the shared cache: prefix K/V depend only on
        prefix tokens, so any admitted row holding the prefix is a valid
        source) into pool entry `entry`."""
        m = self._pfx_max

        def store(pool, src_leaf):
            pool[:, entry, :m] = src_leaf[:, row, :m]
            return pool

        self._merge(store, src, dst=self._pfx_pool)
        self._pfx_pool.length[entry] = plen

    # -- prefix-pool host side (executor-serialized) -----------------------

    @staticmethod
    def _lcp(a: np.ndarray, b: np.ndarray, limit: int) -> int:
        m = min(len(a), len(b), limit)
        neq = np.nonzero(a[:m] != b[:m])[0]
        return int(neq[0]) if neq.size else m

    def _pfx_plan(
        self, n: int, plen: int
    ) -> tuple[int, list[tuple[int, int]]]:
        """Prefill step geometry for an n-token prompt whose first `plen`
        positions are pooled: the reuse point `start` (0 = unusable) and
        the (offset, width) steps covering [start, n). Every step writes
        its whole [1, width] block, so offset + width stays inside the
        mini, and every non-final step is full of real tokens. A short
        suffix runs as ONE bucketed step whose start is lowered until it
        fits; a long one takes one bucketed BRIDGE step to the next chunk
        boundary, then the fixed chunk grid."""
        c = min(self.cfg.prefill_chunk, self.max_seq)
        if n - plen <= c:
            width = bucket_len(n - plen, maximum=self.max_seq)
            start = max(0, min(plen, self.max_seq - width))
            return start, [(start, bucket_len(n - start, maximum=self.max_seq))]
        boundary = (plen // c + 1) * c
        width = bucket_len(boundary - plen, maximum=self.max_seq)
        start = boundary - width
        if start >= 0:
            return start, [(start, width)] + [
                (off, c) for off in range(boundary, n, c)
            ]
        # Tiny chunk sizes: no alignment possible.
        return 0, [(off, c) for off in range(0, n, c)]

    def _pfx_lookup(self, prompt: list[int]) -> Optional[tuple[int, int]]:
        """Entry with the longest common prefix against `prompt` (capped
        at len(prompt) - 1: one suffix token must run for the sampling
        logits). A match whose plan start is 0 is not a hit: it neither
        refreshes the LRU stamp nor diverts the request from fused
        admission. Returns (entry, prefix_len) or None."""
        if self._pfx_pool is None or all(
            key is None for key in self._pfx_keys
        ):
            return None
        arr = np.asarray(prompt[: self._pfx_max], np.int32)
        limit = len(prompt) - 1
        best: Optional[tuple[int, int]] = None
        for e, key in enumerate(self._pfx_keys):
            if key is None:
                continue
            lcp = self._lcp(key, arr, limit)
            if lcp >= self._pfx_min and (best is None or lcp > best[1]):
                best = (e, lcp)
        if best is None or self._pfx_plan(len(prompt), best[1])[0] == 0:
            return None
        self._pfx_clock += 1
        self._pfx_used[best[0]] = self._pfx_clock
        return best

    def _pfx_covered(self, arr: np.ndarray, length: int) -> bool:
        """True if a pooled key already covers the first `length` tokens
        of `arr`."""
        if self._pfx_pool is None:
            return False
        return any(
            k is not None and len(k) >= length
            and self._lcp(k, arr, length) == length
            for k in self._pfx_keys
        )

    def _pfx_storable(self, prompt: list[int]) -> Optional[np.ndarray]:
        """The key this prompt's prefix would pool under, or None if too
        short."""
        if self._pfx_pool is None:
            return None
        plen = min(len(prompt) - 1, self._pfx_max)
        if plen < self._pfx_min:
            return None
        return np.asarray(prompt[:plen], np.int32)

    def _pfx_commit(self, key: np.ndarray, pool_fn) -> None:
        """Pick the entry (free, else LRU), run `pool_fn(entry)` to write
        it, evict any entry the new key subsumes. A failed write only
        skips the caching, and forgets the entry it may have half
        overwritten (the reference's pool is not donated and survives)."""
        free = [e for e, k in enumerate(self._pfx_keys) if k is None]
        entry = free[0] if free else min(
            range(len(self._pfx_keys)), key=lambda e: self._pfx_used[e]
        )
        try:
            pool_fn(entry)
            int(self._pfx_pool.length[entry])  # surfaces a device fault
        except Exception:
            logger.exception("prefix-pool store failed; entry not cached")
            self._pfx_keys[entry] = None
            return
        self._pfx_keys[entry] = key
        self._pfx_clock += 1
        self._pfx_used[entry] = self._pfx_clock
        for e, other in enumerate(self._pfx_keys):
            if (
                e != entry and other is not None
                and len(other) <= len(key)
                and self._lcp(other, key, len(key)) == len(other)
            ):
                # `key` extends `other`: the shorter entry can never
                # out-match the new one again.
                self._pfx_keys[e] = None

    def _pfx_learn_from_burst(
        self, slots_idx: list[int], batch: list[_Request]
    ) -> None:
        """After a fused burst, pool the prefix shared by the most rows,
        copied from one admitted row's cache slice — one extra device
        call, only when at least two rows share a poolable prefix (the
        agentic arrival shape: N sessions with one system prompt)."""
        if self._pfx_pool is None or len(batch) < 2:
            return
        # Base-model rows only: a cache slice computed under an adapter
        # must never seed the shared pool.
        slots_idx = [s for s, r in zip(slots_idx, batch) if r.adapter == 0]
        batch = [r for r in batch if r.adapter == 0]
        if len(batch) < 2:
            return
        prompts = [
            np.asarray(r.prompt[: self._pfx_max + 1], np.int32)
            for r in batch
        ]
        best: Optional[tuple[int, int, int]] = None  # (count, lcp, row)
        for i in range(len(prompts)):
            for j in range(i + 1, len(prompts)):
                a, b = prompts[i], prompts[j]
                # each sharer must keep >= 1 suffix token past the prefix
                lcp = self._lcp(
                    a, b, min(len(a) - 1, len(b) - 1, self._pfx_max)
                )
                if lcp < self._pfx_min:
                    continue
                key = a[:lcp]
                count = sum(
                    1 for p in prompts
                    if len(p) > lcp and np.array_equal(p[:lcp], key)
                )
                cand = (count, lcp, i)
                if best is None or cand[:2] > best[:2]:
                    best = cand
        if best is None:
            return
        _, lcp, row = best
        key = prompts[row][:lcp]
        if self._pfx_covered(key, lcp):
            return  # an existing entry already covers this prefix
        slot = slots_idx[row]
        self._pfx_commit(
            key, lambda entry: self._pfx_store_impl(
                self.cache, slot, entry, lcp)
        )

    def _prefill_chunked(
        self, slot_idx: int, request: _Request, pfx: tuple[int, int]
    ) -> None:
        """The serial BRIDGE path: a prefix hit whose suffix needs more
        than one step (_pfx_plan). The pooled K/V seed a [1, S_max] mini,
        the steps run one call each, the mini row is inserted and the
        first token sampled; a longer prefix than the hit's is pooled
        from the mini on the way."""
        prompt = request.prompt
        n = len(prompt)
        entry, plen = pfx
        # Lookup already rejected unusable matches: start > 0 here.
        start, steps = self._pfx_plan(n, plen)
        self.prefix_hits += 1
        mini = self._pfx_seeded_mini(1, entry, start)
        logits = None
        for off, width in steps:
            chunk = np.zeros((1, width), np.int64)
            piece = prompt[off: off + width]
            chunk[0, : len(piece)] = piece
            logits, _ = self.engine.decode_forward(
                self.engine.params, self._t(chunk), mini,
                self._lora_idx(np.array([request.adapter], np.int64)),
                valid=self._valid(self._t(np.array([n])), off, width))
        # Base rows only feed the pool (adapter'd K/V never seed it).
        key = self._pfx_storable(prompt) if request.adapter == 0 else None
        if key is not None and plen < len(key):
            self._pfx_commit(
                key, lambda e: self._pfx_store_impl(mini, 0, e, len(key))
            )
        self._cache_at_risk = True
        self._merge_rows(mini, [0], [slot_idx], [n])
        # The last real token sits at n - last_offset - 1 of the final step.
        sampling = self._row_params(1, [(0, request)])
        first, _ = self._sample(
            logits[:, n - steps[-1][0] - 1], sampling["seeds"], 0,
            sampling["temps"], sampling["ks"], sampling["ps"], sampling["gs"],
        )
        first_tok = int(first.cpu()[0])
        self._cache_at_risk = False
        self._activate_slot(slot_idx, request, first_tok)

    # -- public API ---------------------------------------------------------

    def warmup(self) -> None:
        build_kernels(self.device)

    def start(self) -> None:
        if self._task is None:
            self._stopping = False
            self._loop_ref = asyncio.get_running_loop()
            self._task = self._loop_ref.create_task(self._loop())

    async def stop(self) -> None:
        self._stopping = True
        self._wake.set()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        # Queued host ops fail loudly: a TransferKV handler awaiting an
        # import must get an error, not hang on a dead loop's future.
        while self._host_ops:
            _, fut = self._host_ops.popleft()
            if not fut.done():
                fut.set_exception(RuntimeError("batcher stopped"))
        # Release the host pool's file tier (appends are flushed per
        # record, so the warm-restart log is already durable).
        if self.host_pool is not None:
            self.host_pool.close()

    async def acquire_adapter(self, name: str):
        """Resolve an adapter NAME to a pinned arena row (registry mode,
        serving/adapter_arena.py); a load's factor write runs through
        the serialized run_host_op stream BETWEEN ticks. Returns the
        AdapterLease; pass it (and the name, as adapter_key) to
        submit(), which releases it on every terminal path. Typed
        failures propagate: UnknownAdapterError, AdapterExhaustedError,
        AdapterLoadError."""
        arena = getattr(self.engine, "adapter_arena", None)
        if arena is None:
            raise RuntimeError(
                "no dynamic adapter arena (serving.lora.registry unset); "
                "resolve names via engine.resolve_adapter"
            )
        return await self.run_host_op(lambda: arena.acquire(name))

    def release_adapter(self, lease) -> None:
        """Return an acquired lease that never reached submit() (a shed
        or a validation failure on the caller's side). Idempotent."""
        if lease is not None:
            self.engine.adapter_arena.release(lease)

    async def run_host_op(self, fn):
        """Run `fn()` (host and device work) in the batcher's serialized
        executor stream, between ticks and admission rounds, never
        concurrent with them: the entry point for external work on the
        arena (KV page export and import, adapter loads). Returns fn's
        result or raises its exception. The loop must be running."""
        if self._task is None or self._stopping:
            raise RuntimeError("batcher is not running")
        fut = asyncio.get_running_loop().create_future()
        self._host_ops.append((fn, fut))
        self._wake.set()
        return await fut

    async def _drain_host_ops(self, loop) -> None:
        """Run the queued host ops in FIFO order, one executor call each.
        A failure resolves its caller's future and never kills the
        loop."""
        while self._host_ops:
            fn, fut = self._host_ops.popleft()
            try:
                result = await loop.run_in_executor(None, fn)
            except asyncio.CancelledError:
                if not fut.done():
                    fut.set_exception(RuntimeError("batcher stopped"))
                raise  # batcher shutdown cancels the loop task
            except Exception as exc:  # noqa: BLE001 — delivered, not dropped
                if not fut.done():
                    fut.set_exception(exc)
            else:
                if not fut.done():
                    fut.set_result(result)

    def submit(
        self,
        prompt: list[int],
        max_new: int,
        sampling: SamplingConfig,
        seed: int = 0,
        unary: bool = False,
        grammar: Optional[CompiledGrammar] = None,
        trace_id: str = "",
        tenant: str = "",
        qos_class: str = "",
        adapter: int = 0,
        adapter_key: str = "",
        adapter_lease=None,
    ) -> AsyncIterator[tuple[list[int], Optional[str]]]:
        """Enqueue a request; yields (token_ids_chunk, finish_reason)
        pairs, finish_reason set on the final chunk (`unary=True`: one
        terminal chunk with all tokens). The cap check and the enqueue
        run HERE, eagerly. Raises OverloadedError when max_pending or
        max_queue_tokens would be exceeded (its `retry_after_s` is the
        class's). A paged arena that cannot hold the request at admission
        finishes it with "overloaded". `grammar`: every token must
        satisfy it; the request finishes "grammar_complete" at its
        accepting sink, and GrammarCapacityError is raised here when the
        arena cannot host another schema. `trace_id` joins the request's
        flight records to the gateway's trace; `tenant` and `qos_class`
        are its SLO identity (and its scheduler lane). `adapter`: the
        LoRA row (0 = base; names resolve through engine.resolve_adapter,
        or acquire_adapter under the arena, which also yields
        `adapter_lease`, the pin this request holds until its terminal
        chunk); `adapter_key`: the stable name the paged chains key
        on."""
        # Range-check the row: an index past the factor stacks would
        # fail inside a tick, not here.
        n_adapters = self.engine.n_adapter_rows()
        if not 0 <= adapter <= n_adapters:
            raise ValueError(
                f"adapter id {adapter} out of range (0..{n_adapters})"
            )
        if adapter and not adapter_key:
            if adapter_lease is not None:
                adapter_key = adapter_lease.name
            elif self.engine.adapter_arena is None:
                # Boot-time rows are 1:1 with names: a row-derived key is
                # a stable domain.
                adapter_key = f"row:{adapter}"
            else:
                # Arena rows are reused after eviction: a row-derived
                # key would alias one tenant's KV to another's.
                raise ValueError(
                    "dynamic adapter arena: submit needs adapter_key "
                    "(or the AdapterLease from acquire_adapter); row "
                    "ids are not stable KV-keying identities"
                )
        prompt, max_new = fit_request(
            prompt, max_new,
            self._fit_limit - self._reserve_for(grammar is not None),
        )
        cap = self.cfg.max_pending
        if cap > 0 and self.pending.qsize() >= cap:
            self._shed_at_submit(tenant, qos_class)
            raise OverloadedError(
                f"admission queue full ({cap} requests pending)",
                reason="requests",
                retry_after_s=retry_after_for(self.sched_cfg, qos_class),
            )
        tcap = self.cfg.max_queue_tokens
        if (
            tcap > 0 and not self.pending.empty()
            and self.pending.token_count + len(prompt) > tcap
        ):
            self._shed_at_submit(tenant, qos_class)
            raise OverloadedError(
                f"admission queue token budget full ({tcap} tokens)",
                reason="tokens",
                retry_after_s=retry_after_for(self.sched_cfg, qos_class),
            )
        # Arena residency after the caps: a shed request holds no rows.
        handle = self.arena.acquire(grammar) if grammar is not None else None
        request = _Request(
            prompt=prompt, max_new=max_new, sampling=sampling, seed=seed,
            unary=unary, grammar=handle, trace_id=trace_id,
            n_prompt=len(prompt), tenant=tenant, qos_class=qos_class,
            adapter=adapter, adapter_key=adapter_key,
            adapter_lease=adapter_lease,
        )
        request.t_submit = time.perf_counter()
        self.pending.put_nowait(request)
        self._wake.set()
        return self._consume(request)

    def _shed_at_submit(self, tenant: str, qos_class: str) -> None:
        """A submit-time shed: no request exists, but the SLO and tenant
        ledgers still count it (unevaluated)."""
        self.shed += 1
        self.slo.record_shed(qos_class)
        self.tenants.record_shed(tenant)

    async def _consume(
        self, request: _Request
    ) -> AsyncIterator[tuple[list[int], Optional[str]]]:
        try:
            while True:
                ids, reason = await request.out.get()
                yield ids, reason
                if reason is not None:
                    return
        finally:
            request.cancelled = True

    def cache_bytes(self) -> int:
        """KV bytes: the pool (or the page arena and its block tables),
        the prefix pool, the interleave mini once allocated and the draft
        pool, an int8 cache's scales included."""
        total = self.cache.k.nbytes + self.cache.v.nbytes
        if self._paged:
            total += self.cache.table.nbytes
        for extra in (self._pfx_pool, self._ilv_mini, self.dcache):
            if extra is not None:
                total += extra.k.nbytes + extra.v.nbytes
        return total

    def stats(self) -> dict:
        """Counters, latency percentiles, the flight recorder's
        histograms and the SLO / tenant fragments for GetServingStats
        (the reference's field names; fields of unported features stay
        at their defaults)."""
        return {
            **self.counter_stats(),
            **self.lat_percentiles(self.lat_snapshot()),
            **self.stall_percentiles(self.stall_snapshot()),
            **self.recorder.histogram_stats(),
            **self.slo.stats(),
            **self.tenants.stats(),
        }

    def lat_snapshot(self) -> list[tuple[float, float]]:
        """Recent (queue_ms, service_ms) records (the tiered facade
        concatenates them across tiers)."""
        return list(self._lat_records)

    def stall_snapshot(self) -> list[float]:
        """Recent decode-stall samples (ms between two emissions to a
        live slot), concatenated across tiers like lat_snapshot."""
        return list(self._stall_records)

    @staticmethod
    def stall_percentiles(records: list[float]) -> dict:
        return {
            "decode_stall_ms_p50": pct(records, 0.5),
            "decode_stall_ms_p99": pct(records, 0.99),
            "decode_stall_ms_max": round(max(records), 2) if records else 0.0,
        }

    @staticmethod
    def lat_percentiles(records: list[tuple[float, float]]) -> dict:
        qs = [r[0] for r in records]
        ss = [r[1] for r in records]
        return {
            "queue_ms_p50": pct(qs, 0.5), "queue_ms_p99": pct(qs, 0.99),
            "service_ms_p50": pct(ss, 0.5), "service_ms_p99": pct(ss, 0.99),
        }

    def counter_stats(self) -> dict:
        """The scalar counters of stats()."""
        t = self.timing
        return {
            **self._memory_stats(),
            **self.engine.lora_stats(),
            **self.engine.mesh_stats(),
            "active_slots": self._active_count(),
            "total_slots": len(self.slots),
            "queued_requests": self.pending.qsize(),
            "queued_tokens": self.pending.token_count,
            "kv_cache_bytes": self.cache_bytes(),
            "prefix_cache_hits": self.prefix_hits,
            "prefix_cache_misses": self.prefix_misses,
            "decode_steps": self.step_counter,
            "timed_out": self.timed_out,
            "shed_requests": self.shed,
            "replayed_requests": self.replayed,
            "replay_exhausted": self.replay_exhausted,
            **(
                self.sched.counter_stats(parked=self.pending.parked_count())
                if self.sched is not None else {
                    "sched_preemptions": 0, "sched_resumes": 0,
                    "sched_preempt_failures": 0, "sched_parked": 0,
                    "sched_budget_deferrals": 0,
                }
            ),
            **(self.pages.stats() if self._paged else {
                "kv_pages_total": 0, "kv_pages_in_use": 0,
                "kv_pages_shared": 0, "paged_prefix_hits": 0,
                "paged_cow_copies": 0, "paged_pages_reused": 0,
                "paged_pages_admitted": 0, **_HOST_TIER_ZEROS,
            }),
            "interleaved_chunks": self.interleaved_chunks,
            "interleaved_admissions": self.interleaved_admissions,
            "grammar_masked_tokens": self.grammar_tokens,
            "grammar_states_in_use": self.arena.states_in_use(),
            "grammar_jump_tokens": self.grammar_jump_tokens,
            "grammar_jump_runs": self.grammar_jump_runs,
            "grammar_jump_fallbacks": self.grammar_jump_fallbacks,
            "spec_ticks": self.spec_ticks,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "ticks": t["ticks"],
            "tick_collects": t["ticks"],  # every tick is collected at once
            "admit_rounds": t["admit_rounds"],
            "tick_dispatch_ms": round(t["tick_dispatch_ms"], 2),
            "tick_collect_ms": round(t["tick_collect_ms"], 2),
            "admit_ms": round(t["admit_ms"], 2),
            # Cumulative ms per tick phase over recorded ticks; the five
            # sum to the ticks' summed duration_ms.
            **{
                f"tick_phase_{p}_ms": round(self.phase_ms[p], 2)
                for p in PHASE_NAMES
            },
            "admit_ms_max": round(t["admit_ms_max"], 2),
        }

    def _memory_stats(self) -> dict:
        """ServingStats memory_*_bytes from the ledger (all 0 when it is
        off)."""
        comp = self.engine.ledger.component_bytes(max_age_s=1.0)
        return {
            f"memory_{name}_bytes": comp.get(("", name), 0)
            for name in _LEDGER_COMPONENTS
        }

    def _ledger_tick_snapshot(self) -> dict:
        """component -> bytes for a tick record (TTL-cached)."""
        comp = self.engine.ledger.component_bytes(max_age_s=1.0)
        return {name: b for (_, name), b in comp.items() if b}

    def flight_snapshot(
        self,
        max_ticks: int = 128,
        max_requests: int = 128,
        trace_id: str = "",
        tenant: str = "",
    ) -> tuple[list, list]:
        """(tick records, request records), oldest first: those a trace
        id took part in when given; `tenant` narrows the request records
        (ticks are shared between tenants)."""
        ticks = self.recorder.tick_snapshot()
        requests = self.recorder.request_snapshot()
        if trace_id:
            ticks = [t for t in ticks if trace_id in t.trace_ids]
            requests = [r for r in requests if r.trace_id == trace_id]
        if tenant:
            requests = [r for r in requests if r.tenant == tenant]
        return ticks[-max(1, max_ticks):], requests[-max(1, max_requests):]

    def request_record(self, trace_id: str):
        """The newest request record of a trace id."""
        return self.recorder.request_record(trace_id)

    # -- the loop -----------------------------------------------------------

    def _free_slots(self) -> list[int]:
        return [
            i for i, s in enumerate(self.slots)
            if not s.active and not s.reserved
        ]

    def _active_count(self) -> int:
        return sum(s.active for s in self.slots)

    def _ilv_busy(self) -> bool:
        """Interleaved admissions in flight (rows chunking or queued for
        a row): the loop keeps ticking for them even with no active
        decode slot."""
        return any(r is not None for r in self._ilv_rows) or bool(
            self._ilv_pending
        )

    async def _loop(self) -> None:
        loop = asyncio.get_running_loop()
        if self.recorder.enabled:
            self._turn = _Turn.now(self.timing["ticks"])
        while not self._stopping:
            if self._host_ops:
                p0 = time.perf_counter()
                await self._drain_host_ops(loop)
                self._turn_child("batcher.host_ops", p0)
            if self.sched is not None:
                await self._maybe_preempt(loop)
            await self._admit()
            if self._active_count() == 0 and not self._ilv_busy():
                # Clear BEFORE checking pending: a submit() landing after
                # the check still leaves its set() visible to wait().
                self._wake.clear()
                if not self.pending.empty() or self._host_ops:
                    continue
                await self._waiting(self._wake.wait())
                continue
            try:
                await loop.run_in_executor(None, self._tick_step)
            except asyncio.CancelledError:
                raise  # batcher shutdown cancels the loop task
            except Exception:
                logger.exception("decode tick failed; replaying active slots")
                self._recover_after_tick_failure()
                if self.recorder.enabled:
                    self._turn = _Turn.now(self.timing["ticks"])
            p0 = time.perf_counter()
            await asyncio.sleep(0)  # noqa: ASYNC115 — let handlers drain queues
            self._turn_child("batcher.yield", p0)

    def _turn_child(self, name: str, p0: float, **attrs) -> None:
        """A child of the current turn, from `p0` to now."""
        turn = self._turn
        if turn is not None:
            turn.child(name, p0, time.perf_counter(), **attrs)

    async def _waiting(self, awaitable):
        """`await awaitable` with nothing to decode: the turn's
        `batcher.wait_work`."""
        p0 = time.perf_counter()
        try:
            return await awaitable
        finally:
            self._turn_child("batcher.wait_work", p0)

    def _deliver(self, request: _Request, item) -> None:
        """Executor → loop edge: asyncio.Queue is not thread-safe. Every
        terminal chunk passes here, so it records the request's end."""
        if item[1] is not None:
            self._record_terminal(request, item[1])
        self._loop_ref.call_soon_threadsafe(request.out.put_nowait, item)

    def _record_terminal(self, request: _Request, reason: str) -> None:
        """A request's end, on every path that delivers a terminal chunk:
        return its grammar arena reference and its adapter arena pin
        (a leaked pin would exempt a row from eviction forever), then
        feed the SLO and tenant ledgers
        and the flight recorder (all off with the recorder). A request
        never admitted is unevaluated; TPOT needs two tokens."""
        self._release_holds(request)
        if not self.recorder.enabled:
            return
        if request.first_tick >= 0:
            last_tick = max(request.first_tick, self.timing["ticks"])
        else:
            last_tick = -1
        outcome = ""
        if self.slo.enabled:
            now = time.perf_counter()
            tokens = len(request.acc)
            admitted = bool(request.t_admit)
            outcome = self.slo.record_terminal(
                request.qos_class, reason,
                admitted=admitted,
                ttft_ms=(
                    max(0.0, (request.t_first - request.t_submit) * 1000.0)
                    if request.t_first else None
                ),
                tpot_ms=(
                    (now - request.t_first) * 1000.0 / (tokens - 1)
                    if request.t_first and tokens > 1 else None
                ),
                e2e_ms=max(0.0, (now - request.t_submit) * 1000.0),
            )
            self.tenants.record_terminal(
                request.tenant,
                admitted=admitted,
                prompt_tokens=request.n_prompt,
                decode_tokens=tokens,
                queue_ms=(
                    max(0.0, (request.t_admit - request.t_submit) * 1000.0)
                    if request.t_admit else 0.0
                ),
            )
        self.recorder.record_request(
            request.trace_id, request.t_submit, request.t_admit,
            request.t_first, request.n_prompt, len(request.acc),
            reason, request.first_tick, last_tick,
            constrained=request.grammar is not None,
            tenant=request.tenant,
            qos_class=request.qos_class,
            slo_violated=outcome == "violated",
        )

    def _replay_or_fail(self, request: _Request) -> None:
        """One victim of a failed device call: with retry budget left,
        requeue it at the head with its emitted tokens folded into the
        prompt (the consumer never sees a duplicate); otherwise finish
        it with "error"."""
        if request.cancelled:
            self._deliver(request, ([], "cancelled"))
            return
        if request.retries >= self.cfg.tick_retry_limit:
            self.replay_exhausted += 1
            self._deliver(request, ([], "error"))
            return
        request.retries += 1
        self.replayed += 1
        fresh = request.acc[request.absorbed:]
        if fresh:
            request.prompt = list(request.prompt) + [int(t) for t in fresh]
            request.max_new -= len(fresh)
            request.absorbed = len(request.acc)
        request.t_submit = time.perf_counter()
        self.pending.requeue_front(request)
        self._wake.set()

    # -- preemption (serving/scheduler.py) ----------------------------------

    async def _maybe_preempt(self, loop) -> None:
        """One scheduling decision per loop turn, on the loop thread: if
        no slot is free and the highest-priority waiter is at risk
        (Scheduler.should_preempt), demote the policy's victims in the
        executor."""
        if self._free_slots():
            return
        head = self.pending.head_waiter()
        if head is None:
            return
        waiter_class, wait_s = head
        if not self.sched.should_preempt(waiter_class, wait_s):
            return
        active = [
            (i, s.request.qos_class, s.request.tenant)
            for i, s in enumerate(self.slots)
            if s.active and s.request is not None
        ]
        victims = self.sched.victims(waiter_class, active)
        if not victims:
            return
        try:
            await loop.run_in_executor(None, self._preempt_slots, victims)
        except asyncio.CancelledError:
            raise  # batcher shutdown cancels the loop task
        except Exception:
            # _preempt_slots degrades per slot and should never raise;
            # if it does, the slots' state is unknown: replay them all.
            logger.exception("preemption failed; recovering")
            self._recover_after_tick_failure()

    def _park_slot(self, slot_idx: int) -> None:
        """Free a slot whose request leaves it without finishing."""
        slot = self.slots[slot_idx]
        slot.active = False
        slot.request = None
        self.jump_ok[slot_idx] = False
        self.temps[slot_idx] = 0.0
        self.adapter_ids[slot_idx] = 0
        self.gstates[slot_idx] = 0
        self._slot_last_emit[slot_idx] = None

    def _preempt_slots(self, victims: list[int]) -> None:
        """Demote-don't-kill (executor thread): fold each victim's
        emitted tokens into its prompt (the replay fold, without burning
        a retry: preemption is policy, not failure), park its valid
        pages as evictable cache on the paged arena, free the slot and
        park the request in its class's resume lane, its adapter pin
        released. The grammar handle
        stays; the resuming admission re-derives the DFA state (_g0), so
        greedy tokens through a preempt cycle equal the uninterrupted
        run's. The `sched_preempt_fail` failpoint degrades typed: the
        victim keeps decoding and sched_preempt_failures counts it."""
        for sl in victims:
            slot = self.slots[sl]
            request = slot.request
            if not slot.active or request is None or request.cancelled:
                continue  # finished while the decision was made
            try:
                failpoints.evaluate("sched_preempt_fail")
                fresh = request.acc[request.absorbed:]
                if fresh:
                    request.prompt = (
                        list(request.prompt) + [int(t) for t in fresh]
                    )
                    request.max_new -= len(fresh)
                    request.absorbed = len(request.acc)
                if self._paged:
                    # With a host tier attached, the parked chain is
                    # copied to the host, and the resume restores it.
                    self.pages.demote_for_preempt(
                        sl, request.prompt, adapter=request.adapter_key)
                    self._tables_dirty = True
            except failpoints.FailpointError:
                self.sched.preempt_failures += 1
                logger.warning("preemption failed for slot %d (injected); "
                               "victim keeps decoding", sl)
                continue
            except Exception:
                # Past the failpoint the work is host bookkeeping only:
                # an error here leaves the slot's pages untrustworthy,
                # so the request replays through the failure path.
                logger.exception("preemption failed for slot %d", sl)
                self.sched.preempt_failures += 1
                if self._paged:
                    self.pages.free_slot(sl)
                    self._tables_dirty = True
                self._park_slot(sl)
                self._loop_ref.call_soon_threadsafe(
                    self._replay_or_fail, request)
                continue
            # Release the arena pin so the row may evict while the
            # request is parked; the resume reacquires (maybe another
            # row: the stable adapter_key keeps the KV domain).
            if request.adapter_lease is not None:
                self.engine.adapter_arena.release(request.adapter_lease)
                request.adapter_lease = None
            self._park_slot(sl)
            request.preempts += 1
            request.parked = True
            # A fresh queue clock: parked time is the scheduler's, and
            # queue_deadline_ms must not expire an admitted request.
            request.t_submit = time.perf_counter()
            self.sched.preemptions += 1
            self._loop_ref.call_soon_threadsafe(
                self._park_preempted, request)

    def _park_preempted(self, request: _Request) -> None:
        """Loop-thread tail of a preemption: the request enters the head
        of its class's resume lane."""
        if request.cancelled:
            self._deliver(request, ([], "cancelled"))
            return
        self.pending.park_preempted(request)
        self._wake.set()

    def _resume_reacquire(
        self, slots_idx: list[int], batch: list[_Request]
    ) -> None:
        """Executor-side pre-pass of _prefill_into_slots (scheduler on):
        a resuming request whose adapter pin was released at preemption
        reacquires a row here, inside the serialized stream where the
        arena's factor write is safe, before any block table is built.
        Rows that cannot reacquire are FILTERED from the batch in place:
        a full arena re-parks the request, bounded by
        scheduler.resume_retry_limit attempts before a typed
        "overloaded" shed; an adapter that is gone or fails to load
        ends the request "error"."""
        arena = getattr(self.engine, "adapter_arena", None)
        keep_slots: list[int] = []
        keep_batch: list[_Request] = []
        for sl, request in zip(slots_idx, batch):
            if (
                request.preempts > 0
                and request.adapter_key
                and request.adapter_lease is None
                and arena is not None
            ):
                try:
                    lease = arena.acquire(request.adapter_key)
                except AdapterExhaustedError:
                    request.sched_retries += 1
                    if request.sched_retries > int(
                        self.sched_cfg.resume_retry_limit
                    ):
                        self.shed += 1
                        self._deliver(request, ([], "overloaded"))
                    else:
                        self._loop_ref.call_soon_threadsafe(
                            self._repark, request)
                    continue
                except Exception:
                    logger.exception("resume: adapter %r reacquire failed",
                                     request.adapter_key)
                    self._deliver(request, ([], "error"))
                    continue
                request.adapter_lease = lease
                # The row may differ from the one before the preemption;
                # adapter_key, not the row, keys the KV chains.
                request.adapter = lease.row
            keep_slots.append(sl)
            keep_batch.append(request)
        slots_idx[:] = keep_slots
        batch[:] = keep_batch

    def _repark(self, request: _Request) -> None:
        """Loop-thread re-park after a failed resume attempt: the BACK
        of the class's resume lane, so sibling parked requests get their
        attempt first."""
        if request.cancelled:
            self._deliver(request, ([], "cancelled"))
            return
        self.pending.put_nowait(request)
        self._wake.set()

    def _sweep_expired_pending(self) -> None:
        """Before admission, every loop turn: queued requests older than
        queue_deadline_ms (since submit, or since their last replay or
        preemption) finish "timeout"; abandoned ones leave the queue."""
        ddl = self.cfg.queue_deadline_ms
        if ddl <= 0 or self.pending.empty():
            return
        now = time.perf_counter()
        keep: list[_Request] = []
        while True:
            try:
                request = self.pending.get_nowait()
            except asyncio.QueueEmpty:
                break
            if request.cancelled:
                self._release_holds(request)  # consumer gone
                continue
            if (now - request.t_submit) * 1000.0 > ddl:
                self.timed_out += 1
                self._deliver(request, ([], "timeout"))
            else:
                keep.append(request)
        for request in keep:  # a full drain and re-put keeps the order
            self.pending.put_nowait(request)

    def _reset_shared_cache(self) -> None:
        """Rebuild the shared cache from zeros; a paged arena's host
        allocator forgets every page and index entry with it (victims
        replay through admission, which re-maps and re-registers)."""
        if self._paged:
            self.pages.reset()
            self._tables_dirty = True
        self.cache = self._make_shared_cache()

    def _recover_after_tick_failure(self) -> None:
        """A failed tick leaves the pool's K/V unknown: replay every
        active request from its prompt + emitted tokens on a fresh cache
        (of the engine's KV dtype). In-flight interleaved admissions die
        with the tick's mini; they have emitted nothing, so they replay
        from their prompt (and burn a retry, or a poisonous prompt would
        requeue forever)."""
        for slot in self.slots:
            if slot.active and slot.request is not None:
                self._replay_or_fail(slot.request)
            slot.active = False
            slot.request = None
            slot.reserved = False
        # Grammar states reset with the slots: each victim re-derives
        # its state from its replay prefix at re-admission (_g0). A
        # victim keeps its adapter row and lease through the replay.
        self.gstates[:] = 0
        self.jump_ok[:] = False
        self.adapter_ids[:] = 0
        for st in list(self._ilv_rows) + list(self._ilv_pending):
            if st is not None:
                self._replay_or_fail(st.request)
        self._ilv_rows = [None] * self._ilv_k
        self._ilv_pending.clear()
        self._ilv_mini = None
        self._slot_last_emit = [None] * len(self.slots)
        self._reset_shared_cache()
        if self._spec:
            # The draft pool is as unknown as the shared cache: every
            # victim re-prefills its draft row at re-admission.
            self._new_draft_pool()

    def _new_draft_pool(self) -> None:
        """A zeroed draft pool (after a failed tick or a failed draft
        admission). Zero draft rows only cost acceptance: exact match and
        rejection sampling never emit a token the target would not."""
        self.prev_tokens[:] = 0
        self._dcache_at_risk = False
        self.dcache = self.engine.make_draft_cache(len(self.slots),
                                                   self.max_seq)

    async def _admit(self) -> int:
        """Drain pending requests into free slots: one batch per round,
        capped at the free slots, each round ONE executor call. While
        slots decode, p50_budget_ms caps a round's rows and the
        scheduler's prefill budget its prompt tokens (one capped round
        per call)."""
        self._sweep_expired_pending()
        admitted = 0
        deadline = time.monotonic() + self.cfg.max_queue_delay_ms / 1000.0
        loop = asyncio.get_running_loop()
        capped = False
        prefill_budget = (
            int(self.sched_cfg.prefill_budget_tokens)
            if self.sched is not None else 0
        )
        tok_sum = 0
        while self._free_slots() and not capped:
            batch: list[_Request] = []
            budget = len(self._free_slots())
            if self.cfg.p50_budget_ms > 0 and self._active_count() > 0:
                # A round may stall the decoding slots by at most
                # p50_budget_ms / 4: as many rows as the per-row cost
                # estimate fits.
                stall_ms = self.cfg.p50_budget_ms / 4.0
                cap = max(1, int(stall_ms / max(self._admit_ema_ms, 1e-3)))
                if cap < budget:
                    budget = cap
                    capped = True
            while len(batch) < budget:
                try:
                    timeout = deadline - time.monotonic()
                    if timeout <= 0 or admitted + len(batch) >= len(self.slots):
                        break
                    if (
                        self._active_count() > 0 or admitted > 0 or batch
                        or self._ilv_busy()
                    ):
                        # Don't stall running decodes (or in-flight
                        # interleaved chunk work) for stragglers.
                        request = self.pending.get_nowait()
                    else:
                        request = await self._waiting(asyncio.wait_for(
                            self.pending.get(), timeout=timeout
                        ))
                except (asyncio.TimeoutError, asyncio.QueueEmpty):
                    break
                if request.cancelled:
                    self._release_holds(request)  # consumer gone
                    continue
                ddl = self.cfg.queue_deadline_ms
                if ddl > 0 and (
                    time.perf_counter() - request.t_submit
                ) * 1000.0 > ddl:
                    # Expired in the queue: no prefill for it.
                    self.timed_out += 1
                    self._deliver(request, ([], "timeout"))
                    continue
                if (
                    prefill_budget > 0
                    and self._active_count() > 0
                    and (batch or admitted)
                    and tok_sum + len(request.prompt) > prefill_budget
                ):
                    # Over this round's budget: it pops first next turn.
                    # At least one request per call is admitted, so a
                    # prompt larger than the budget is never starved.
                    self.pending.requeue_front(request)
                    self.sched.budget_deferrals += 1
                    capped = True
                    break
                batch.append(request)
                tok_sum += len(request.prompt)
            if not batch:
                break
            slots_idx = self._free_slots()[: len(batch)]
            try:
                await loop.run_in_executor(
                    None, self._admit_round, slots_idx, batch
                )
            except asyncio.CancelledError:
                raise  # batcher shutdown cancels the loop task
            except Exception:
                logger.exception("batched prefill failed for slots %s",
                                 slots_idx)
                cache_dead = self._cache_at_risk
                if self._dcache_at_risk:
                    self._new_draft_pool()
                activated = {
                    id(s.request) for s in self.slots
                    if s.active and s.request is not None
                }
                for request in batch:
                    if id(request) not in activated:
                        self._deliver(request, ([], "error"))
                if self._paged and not cache_dead:
                    # The arena survived, but the failed rows' tables
                    # must not leak their pages, and their eagerly
                    # indexed, never-prefilled pages leave the index.
                    for sl, request in zip(slots_idx, batch):
                        if id(request) not in activated:
                            self.pages.free_slot(sl, discard_index=True)
                            self._tables_dirty = True
                if cache_dead:
                    # The pool may be half-written: replay bystanders.
                    # In-flight interleaved rows are left running, as in
                    # the reference.
                    self._cache_at_risk = False
                    for slot in self.slots:
                        if slot.active and slot.request is not None:
                            self._replay_or_fail(slot.request)
                        slot.active = False
                        slot.request = None
                    self.gstates[:] = 0
                    self.jump_ok[:] = False
                    self.adapter_ids[:] = 0
                    self._slot_last_emit = [None] * len(self.slots)
                    self._reset_shared_cache()
                continue
            admitted += len(batch)
        return admitted

    def _admit_round(
        self, slots_idx: list[int], batch: list[_Request]
    ) -> None:
        """One admission round, `_prefill_into_slots`, kept as the turn's
        `batcher.admit` span: its rows, their prompts' lengths, the routes
        (`_admit_routes`) and the attention kernel's launches; while a
        profiler records, the round's `moe.ffn` regions."""
        turn = self._turn
        window = regions.open_window(("moe.ffn",)) if self._is_moe else None
        if turn is None and window is None:
            return self._prefill_into_slots(slots_idx, batch)
        lens = [len(r.prompt) for r in batch]
        launches = attention_mod.flash_attention.launches
        self._admit_routes = routes = {}
        profiled = tracing.profiler_range("batcher.admit")
        p0 = time.perf_counter()
        try:
            self._prefill_into_slots(slots_idx, batch)
        finally:
            self._admit_routes = None
            if profiled is not None:
                profiled.__exit__(None, None, None)
            if turn is not None:
                turn.child(
                    "batcher.admit", p0, time.perf_counter(),
                    rows=len(batch), lens=lens,
                    launches=attention_mod.flash_attention.launches
                    - launches,
                    **routes)
            if window is not None:
                window.close({"moe.ffn": self._moe_attrs(
                    routes.get("tokens", 0))})

    def _moe_attrs(self, tokens: int) -> dict:
        """A `moe.ffn` span's work, from host lengths: the valid tokens
        a layer routes and the (token, expert) pairs of every layer."""
        cfg = self.engine.cfg
        return dict(tokens=tokens, pairs=tokens * cfg.experts_per_token
                    * cfg.num_layers)

    @torch.no_grad()
    def _prefill_into_slots(
        self, slots_idx: list[int], batch: list[_Request]
    ) -> None:
        """Route each admission. Paged mode first builds every row's
        block table (sharing the longest indexed page-aligned prefix,
        shedding "overloaded" when the arena cannot hold it); rows with
        reuse group by suffix geometry into paged prefix calls. The rest:
        prefix-pool hits group by step geometry into one call each (a
        multi-step bridge plan takes the serial path), long prompts take
        the interleave queue while slots decode or one chunked group
        call, short prompts fuse into one prefill call. The round's time
        becomes the next tick's admit phase and, per prefilled row, the
        p50_budget_ms cost estimate."""
        # Failpoints: admission latency (admit_slow, armed with ms=) and
        # admission failure (admit_fail), before any device call.
        failpoints.evaluate("admit_slow")
        failpoints.evaluate("admit_fail")
        if self.sched is not None:
            # Resume pre-pass: reacquire released adapter pins (and drop
            # the rows that cannot) before any table or row is touched.
            self._resume_reacquire(slots_idx, batch)
            if not batch:
                return
        t0 = time.perf_counter()
        self._grammar_tables()
        fused_slots: list[int] = []
        fused_batch: list[_Request] = []
        pfx_groups: dict[tuple, list[tuple[int, _Request]]] = {}
        long_rows: list[tuple[int, _Request]] = []
        paged_groups: dict[tuple, list] = {}
        # Interleave only while decode (or earlier chunk work) is in
        # flight: on an idle pool one chunked call is strictly better.
        ilv = self._ilv_k > 0 and (
            self._active_count() > 0 or self._ilv_busy()
        )
        trickle = len(batch) == 1
        rows = list(zip(slots_idx, batch))
        queued = 0  # rows sent to the interleave queue (no prefill here)
        bridged: list[int] = []  # prompt tokens past a multi-step prefix
        if self._paged:
            rows = self._paged_prepass(rows, ilv, paged_groups)
        shed_rows = len(batch) - len(rows) - sum(
            len(g) for g in paged_groups.values())
        for sl, req in rows:
            # The prefix pool holds base-model K/V only: adapter'd
            # requests neither consult nor feed it (nor count a miss).
            base = req.adapter == 0
            pfx = self._pfx_lookup(req.prompt) if base else None
            if pfx is None and self._pfx_pool is not None and base:
                # Every pool-enabled miss counts, fused admissions too.
                self.prefix_misses += 1
            if pfx is not None:
                entry, plen = pfx
                start, steps = self._pfx_plan(len(req.prompt), plen)
                if len(steps) == 1:
                    # Bucketed widths: same-preamble waves share a key
                    # even when question lengths differ.
                    key = (entry, start, steps[0][1])
                    pfx_groups.setdefault(key, []).append((sl, req))
                else:
                    bridged.append(len(req.prompt) - plen)
                    self._prefill_chunked(sl, req, pfx)
            elif len(req.prompt) > self.cfg.prefill_chunk:
                if ilv:
                    # The slot is held; the prefill rides the ticks.
                    self.slots[sl].reserved = True
                    self._ilv_pending.append(
                        _IlvRow(req, sl, len(req.prompt)))
                    self.interleaved_admissions += 1
                    queued += 1
                else:
                    long_rows.append((sl, req))
            else:
                fused_slots.append(sl)
                fused_batch.append(req)
        if long_rows and self._ring:
            # A ring row must not run padding chunks past its own last
            # chunk: their writes wrap onto positions still inside its
            # window (capacity W + C - 1 covers one chunk's overshoot,
            # not several). So ring groups share their chunk count.
            c = min(self.cfg.prefill_chunk, self.max_seq)
            by_steps: dict[int, list] = {}
            for row in long_rows:
                by_steps.setdefault(-(-len(row[1].prompt) // c), []).append(row)
            for group in by_steps.values():
                self._admit_chunked_group(group)
        elif long_rows:
            self._admit_chunked_group(long_rows)
        for (entry, start, width), group in pfx_groups.items():
            self._admit_chunked_group(group, pfx=(entry, start, width))
        if fused_batch:
            self._prefill_fused(fused_slots, fused_batch)
        # Paged groups LAST: a group may gather pages a cold call above
        # just wrote (eager same-round registration); device work runs
        # in issue order, so the writes land first.
        for key, group in paged_groups.items():
            self._admit_paged_group(group, *key)
        if self._spec:
            # The draft side of every slot this round activated (fused,
            # chunked, prefix and paged routes alike; interleave-queued
            # rows at their final chunk): one call a round.
            self._spec_admit_rows(list(zip(slots_idx, batch)))
        if trickle and batch[0].adapter == 0 and (
                self.slots[slots_idx[0]].request is batch[0]):
            # First sighting of a poolable prefix on a trickle admission:
            # pool it from the admitted row's cache slice.
            req = batch[0]
            key = self._pfx_storable(req.prompt)
            if key is not None and not self._pfx_covered(key, len(key)):
                slot = slots_idx[0]
                self._pfx_commit(key, lambda entry: self._pfx_store_impl(
                    self.cache, slot, entry, len(key)))
        if self._admit_routes is not None:
            # The round's routes, and the prompt tokens it computed:
            # whole prompts fused or chunked, the suffix past a prefix.
            pfx_rows = [len(r.prompt) - start for (_, start, _), g
                        in pfx_groups.items() for _, r in g] + bridged
            paged_rows = [len(r.prompt) - scan for (_, scan, _, _), g
                          in paged_groups.items() for _, r, _ in g]
            self._admit_routes.update(
                fused=len(fused_batch), chunked=len(long_rows),
                prefix=len(pfx_rows), paged=len(paged_rows), queued=queued,
                shed=shed_rows,
                tokens=sum(len(r.prompt) for r in fused_batch)
                + sum(len(r.prompt) for _, r in long_rows)
                + sum(pfx_rows) + sum(paged_rows))
        dt = (time.perf_counter() - t0) * 1000.0
        self.timing["admit_ms"] += dt
        self.timing["admit_ms_max"] = max(self.timing["admit_ms_max"], dt)
        self.timing["admit_rounds"] += 1
        self._admit_phase_ms += dt
        # Interleave-queued and shed rows ran no prefill: their ~zero
        # cost must not let the p50_budget_ms cap admit larger rounds.
        prefilled = len(batch) - queued - shed_rows
        if prefilled:
            self._admit_ema_ms = 0.7 * self._admit_ema_ms + 0.3 * dt / prefilled

    def _paged_prepass(self, rows, ilv: bool, paged_groups: dict):
        """Build every row's block table (pages.admit: the longest indexed
        page-aligned prefix refcount-shared, a copy-on-write source for
        the divergent page, exclusive pages for prompt + max_new + tick
        overshoot). Rows with reuse join `paged_groups` by suffix
        geometry; an exhausted arena sheds the row "overloaded" (admit is
        all-or-nothing: resident tables are untouched). Cold rows index
        their full pages NOW (eager register), so same-round rows share
        them — sound because their calls run before the paged groups,
        except interleave-bound rows, prefilled over future ticks.
        Returns the cold rows."""
        c = min(self.cfg.prefill_chunk, self.max_seq)
        cold: list[tuple[int, _Request]] = []
        for sl, req in rows:
            try:
                # Failpoint: page_exhausted forces the exhaustion path.
                failpoints.evaluate("page_exhausted")
                # Sharing is scoped to the adapter's key domain: the
                # chain root folds the stable adapter name.
                adm = self.pages.admit(
                    sl, req.prompt,
                    len(req.prompt) + req.max_new
                    + self._reserve_for(req.grammar is not None) + 1,
                    adapter=req.adapter_key,
                )
            except (PageExhaustedError, failpoints.FailpointError):
                self.shed += 1
                self._deliver(req, ([], "overloaded"))
                continue
            self._tables_dirty = True
            if adm.scan_start > 0:
                self.prefix_hits += 1
                suffix = len(req.prompt) - adm.scan_start
                if suffix <= c:
                    t_steps = 1
                    width = bucket_len(suffix, maximum=self.max_seq)
                else:
                    t_steps, width = -(-suffix // c), c
                key = (adm.merge_start, adm.scan_start, t_steps, width)
                paged_groups.setdefault(key, []).append((sl, req, adm))
            else:
                self.prefix_misses += 1
                cold.append((sl, req))
                if not (ilv and len(req.prompt) > self.cfg.prefill_chunk):
                    self.pages.register(sl, req.prompt,
                                        adapter=req.adapter_key)
        return cold

    def _spec_admit_rows(self, rows: list[tuple[int, _Request]]) -> None:
        """Draft-side admission of newly activated slots: one bucketed
        [R, S] draft prefill into the draft pool, then the prev-token
        mirrors. Runs after the target side in the same executor call, so
        the next tick sees the draft one position behind the target. A
        failure here costs acceptance only (the handler rebuilds the pool
        through _dcache_at_risk)."""
        rows = [(sl, req) for sl, req in rows
                if self.slots[sl].request is req]  # still live
        if not self._spec or not rows:
            return
        r = min(len(self.slots), bucket_len(len(rows), minimum=1))
        s = bucket_len(max(len(req.prompt) for _, req in rows),
                       maximum=self.max_seq)
        tokens = np.zeros((r, s), np.int64)
        true_len = np.ones((r,), np.int64)
        for j, (_, req) in enumerate(rows):
            tokens[j, : len(req.prompt)] = req.prompt
            true_len[j] = len(req.prompt)
        self._dcache_at_risk = True
        self._spec_admit_impl(self.engine.draft_params, self._t(tokens),
                              self._t(true_len), [sl for sl, _ in rows])
        int(self.dcache.length[0])  # surfaces a device fault here
        self._dcache_at_risk = False
        for sl, req in rows:
            self.prev_tokens[sl] = int(req.prompt[-1])

    def _row_params(self, n: int, rows) -> dict:
        """Per-row sampling arrays, admission grammar states and adapter
        rows for an admission call; `rows` pairs (row index, request)."""
        seeds = np.zeros((n,), np.int64)
        temps = np.zeros((n,), np.float32)
        ks = np.zeros((n,), np.int64)
        ps = np.ones((n,), np.float32)
        gs = np.zeros((n,), np.int64)
        adapters = np.zeros((n,), np.int64)
        for row, req in rows:
            seeds[row] = req.seed & 0xFFFFFFFF
            temps[row] = req.sampling.temperature
            ks[row] = req.sampling.top_k
            ps[row] = req.sampling.top_p
            gs[row] = self._g0(req)
            adapters[row] = req.adapter
        return dict(seeds=self._t(seeds), temps=self._temps(temps),
                    ks=self._t(ks), ps=self._t(ps), gs=self._t(gs),
                    adapters=self._lora_idx(adapters))

    def _group_inputs(self, rows, r: int, t_steps: int, c: int, start: int):
        """[R, T, C] tokens (each prompt from `start`), true lengths and
        sampling arrays of a group call; rows past len(rows) pad
        with length 0."""
        tokens = np.zeros((r, t_steps * c), np.int64)
        true_len = np.zeros((r,), np.int64)
        for j, row in enumerate(rows):
            piece = row[1].prompt[start:]
            tokens[j, : len(piece)] = piece
            true_len[j] = len(row[1].prompt)
        sampling = self._row_params(
            r, [(j, row[1]) for j, row in enumerate(rows)])
        return (self._t(tokens.reshape(r, t_steps, c)), self._t(true_len),
                sampling)

    def _admit_chunked_group(
        self,
        rows: list[tuple[int, _Request]],
        pfx: Optional[tuple[int, int, int]] = None,
    ) -> None:
        """ONE chunked call admitting `rows` (slot, request). pfx =
        (entry, start, width): every row reuses pool entry K/V up to
        `start` and prefills one [R, 1, width] suffix step, R = 1 (a
        trickle) or B (a wave); otherwise the full prompts run an [R, T,
        prefill_chunk] grid from position 0, R the group size bucketed to
        a power of two. Padding rows run but are never merged."""
        b = len(self.slots)
        if pfx is None:
            c = min(self.cfg.prefill_chunk, self.max_seq)
            n_max = max(len(req.prompt) for _, req in rows)
            t_steps = max(1, -(-n_max // c))
            start = 0
            r = min(b, bucket_len(len(rows), minimum=1))
        else:
            entry, start, c = pfx
            t_steps = 1
            r = 1 if len(rows) == 1 else b
        tokens, true_len, sampling = self._group_inputs(
            rows, r, t_steps, c, start)
        real = list(range(len(rows)))
        slots = [sl for sl, _ in rows]
        self._cache_at_risk = True
        if pfx is None:
            first = self._admit_chunked_impl(
                self.engine.params, tokens, true_len, real, slots, **sampling)
        else:
            self.prefix_hits += len(rows)
            first = self._admit_chunked_pfx_impl(
                self.engine.params, tokens, true_len, real, slots, entry,
                start, **sampling)
        first = first.cpu().numpy()
        self._cache_at_risk = False
        self.chunked_admissions += len(rows)
        for j, (sl, req) in enumerate(rows):
            self._activate_slot(sl, req, int(first[j]))

    def _admit_paged_group(
        self, rows: list, merge_start: int, scan_start: int, t_steps: int,
        width: int,
    ) -> None:
        """ONE call admitting a group of paged prefix reuses that share
        suffix geometry (a same-preamble wave lands in one group). Row
        count bucketed as for chunked groups; padding rows gather through
        an all-sentinel table and are never merged."""
        b = len(self.slots)
        r = min(b, bucket_len(len(rows), minimum=1))
        gtables = np.full((r, self._table_width), self._n_pages, np.int32)
        for j, (_, _, adm) in enumerate(rows):
            gtables[j] = adm.gather_row
        tokens, true_len, sampling = self._group_inputs(
            rows, r, t_steps, width, scan_start)
        self._cache_at_risk = True
        first = self._admit_paged_pfx_impl(
            self.engine.params, tokens, true_len, list(range(len(rows))),
            [sl for sl, _, _ in rows], gtables, scan_start, merge_start,
            **sampling,
        ).cpu().numpy()
        self._cache_at_risk = False
        self.chunked_admissions += len(rows)
        for j, (sl, req, _) in enumerate(rows):
            self._activate_slot(sl, req, int(first[j]))

    def _prefill_fused(
        self, slots_idx: list[int], batch: list[_Request]
    ) -> None:
        """One fused call: the single-row program for one request (and
        for each of a pair), the full-pool program for a larger burst
        (row index == slot index). A burst then pools its most shared
        prefix (_pfx_learn_from_burst)."""
        if 1 < len(batch) <= 2:
            # Two serial single-row calls beat one full-pool prefill.
            for slot_idx, req in zip(slots_idx, batch):
                self._prefill_fused([slot_idx], [req])
            self._pfx_learn_from_burst(slots_idx, batch)
            return
        s = bucket_len(
            max(len(req.prompt) for req in batch), maximum=self.max_seq
        )
        single = len(batch) == 1
        n = 1 if single else len(self.slots)
        rows = [0] if single else list(slots_idx)
        tokens = np.zeros((n, s), np.int64)
        true_len = np.zeros((n,), np.int64)
        for row, req in zip(rows, batch):
            tokens[row, : len(req.prompt)] = req.prompt
            true_len[row] = len(req.prompt)
        sampling = self._row_params(n, list(zip(rows, batch)))
        self._cache_at_risk = True
        if single:
            first = self._admit_single_impl(
                self.engine.params, self._t(tokens), self._t(true_len),
                slots_idx[0], **sampling,
            )
        else:
            first = self._admit_full_impl(
                self.engine.params, self._t(tokens), self._t(true_len),
                rows, **sampling,
            )
        first = first.cpu().numpy()
        self._cache_at_risk = False
        self.fused_admissions += len(batch)
        for row, slot_idx, req in zip(rows, slots_idx, batch):
            self._activate_slot(slot_idx, req, int(first[row]))
        if not single:
            self._pfx_learn_from_burst(slots_idx, batch)

    def _activate_slot(
        self, slot_idx: int, request: _Request, first_tok: int
    ) -> None:
        slot = self.slots[slot_idx]
        slot.active = True
        slot.request = request
        slot.generated = 0
        slot.max_new = request.max_new
        slot.reserved = False
        request.t_admit = time.perf_counter()
        request.queue_ms = (request.t_admit - request.t_submit) * 1000.0
        if request.parked:
            # A resume completes one preempt cycle.
            request.parked = False
            if self.sched is not None:
                self.sched.resumes += 1
        # The first tick this request decodes in is the next one (tick
        # records count from 1 on the same counter).
        request.first_tick = self.timing["ticks"] + 1
        self.recorder.note_admit()
        self.cur_tokens[slot_idx] = first_tok
        # The emit tracker starts at the admission state (_emit_chunk
        # walks it through first_tok); the slot's next sample is masked
        # under the state after first_tok.
        g0 = self._g0(request)
        request.gcur = g0
        self.gstates[slot_idx] = (
            self.arena.step(g0, first_tok) if request.grammar is not None
            else 0
        )
        self.jump_ok[slot_idx] = bool(
            self._jump_max and request.grammar is not None
            and not request.jump_degraded
        )
        self.temps[slot_idx] = request.sampling.temperature
        self.top_ks[slot_idx] = request.sampling.top_k
        self.top_ps[slot_idx] = request.sampling.top_p
        self.seeds[slot_idx] = request.seed & 0xFFFFFFFF
        self.adapter_ids[slot_idx] = request.adapter
        if self._paged:
            # The prompt's full pages now hold valid K/V: index them
            # (under the request's adapter domain) before the emit (a
            # one-token request finishes inside it, and its pages should
            # stay as reusable cache).
            self.pages.register(slot_idx, request.prompt,
                                adapter=request.adapter_key)
        self._emit_chunk(slot_idx, [first_tok])

    # -- ticks --------------------------------------------------------------

    def _ilv_fill_rows(self) -> None:
        """Claim queued chunk work items into free interleave rows."""
        for r in range(self._ilv_k):
            if self._ilv_rows[r] is None and self._ilv_pending:
                self._ilv_rows[r] = self._ilv_pending.popleft()

    def _ilv_chunk_inputs(self):
        """Host-stamped [K, C] chunk, offsets, prompt lengths and adapter
        rows of the chunk half of a tick (idle rows: zeros at offset 0,
        length 0, base)."""
        k = self._ilv_k
        c = min(self.cfg.prefill_chunk, self.max_seq)
        chunk = np.zeros((k, c), np.int64)
        offs = np.zeros((k,), np.int64)
        c_tl = np.zeros((k,), np.int64)
        c_adapt = np.zeros((k,), np.int64)
        for r, st in enumerate(self._ilv_rows):
            if st is None:
                continue
            piece = st.request.prompt[st.progress: st.progress + c]
            chunk[r, : len(piece)] = piece
            offs[r] = st.progress
            c_tl[r] = st.n
            c_adapt[r] = st.request.adapter
        return chunk, offs, c_tl, c_adapt

    def _ilv_advance(self, sel) -> None:
        """Advance every admitting row by the chunk just run and finish
        the rows whose final chunk it was."""
        c = min(self.cfg.prefill_chunk, self.max_seq)
        done: list[int] = []
        for r, st in enumerate(self._ilv_rows):
            if st is None:
                continue
            self.interleaved_chunks += 1
            st.progress += c
            if st.progress >= st.n:
                done.append(r)
        for r in done:
            self._ilv_finish_row(r, sel)

    def _ilv_finish_row(self, r: int, sel) -> None:
        """Complete interleave row `r`: merge its mini row into the pool,
        sample the first token from `sel[r]`, activate the held slot."""
        st = self._ilv_rows[r]
        req = st.request
        sampling = self._row_params(1, [(0, req)])
        first = self._ilv_finish_impl(r, st.slot, st.n, sel, **sampling)
        first_tok = int(first.cpu()[0])
        self._ilv_rows[r] = None
        self._activate_slot(st.slot, req, first_tok)
        if self._spec:
            self._spec_admit_rows([(st.slot, req)])

    def _tick_record(self, active: int):
        """Open this tick's flight record (None with the recorder off),
        seeded with the admission time since the previous tick as its
        admit phase; its PhaseTimer starts now, and ends the loop's
        turn."""
        admit_ms, self._admit_phase_ms = self._admit_phase_ms, 0.0
        if not self.recorder.enabled:
            return None
        trace_ids = list(dict.fromkeys(
            s.request.trace_id for s in self.slots
            if s.active and s.request is not None and s.request.trace_id
        ))
        rec = self.recorder.tick_start(
            seq=self.timing["ticks"] + 1,
            active=active,
            interleaved_rows=0,
            trace_ids=trace_ids,
            shed=self.shed,
            replayed=self.replayed,
            timed_out=self.timed_out,
            kv_pages_in_use=self.pages.in_use() if self._paged else 0,
            admit_ms=admit_ms,
            memory=self._ledger_tick_snapshot(),
        )
        turn, self._turn = self._turn, None
        if turn is not None:
            turn.record(rec.t_mono)
        return rec

    def _decode_window(self, owners: list, offs=None, c_tl=None):
        """While a profiler records, the tick's region window and the
        attributes its spans carry, from the host's state: each live
        row's cached length (prompt + generated) for `attn.decode`, the
        valid tokens (live rows, and those of the interleave chunk at
        `offs`..`c_tl`) for `moe.ffn`. (None, None) otherwise."""
        window = regions.open_window(("attn.decode", "moe.ffn"))
        if window is None:
            return None, None
        lengths = [len(r.prompt) + self.slots[i].generated
                   for i, r in enumerate(owners) if r is not None]
        attrs = {"attn.decode": dict(lengths=lengths)}
        if self._is_moe:
            tokens = len(lengths) * self._steps_per_tick
            if offs is not None:
                c = min(self.cfg.prefill_chunk, self.max_seq)
                tokens += int(np.clip(c_tl - offs, 0, c).sum())
            attrs["moe.ffn"] = self._moe_attrs(tokens)
        return window, attrs

    def _tick_step(self) -> None:
        """`_tick_body`, with the chunks it emits delivered after the
        tick's flight record is settled: a consumer woken by its terminal
        chunk (and a caller that then stops the batcher) reads histograms
        that include this tick."""
        self._tick_out = []
        try:
            self._tick_body()
        finally:
            out, self._tick_out = self._tick_out, None
            for request, item in out:
                self._deliver(request, item)

    @torch.no_grad()
    def _tick_body(self) -> None:
        """One decode tick (fused with one [K, C] prefill chunk while
        interleaved admissions are in flight): dispatch, pull the tokens,
        finish the admitting rows whose last chunk this was, emit. The
        jump tick replaces the plain one while some live slot can jump;
        its sample's step advances the counter by 1 + jump_max.

        Its record's phases: sync (host state to the device), dispatch
        (the eager launches), wait (the blocking pull of the tokens:
        device time not hidden behind the launches, plus the copy), host
        (interleave finishes, emission and bookkeeping)."""
        # Failpoint: a fault here stands for a failed device call; the
        # loop replays the victims.
        failpoints.evaluate("tick_fail")
        spec = self._spec
        jump = bool(not spec and self._jump_max and self.jump_ok.any())
        step0 = self.step_counter
        # A spec round processes gamma + 1 target positions; its RNG tag
        # (step0 + 1) stays unique across ticks.
        self.step_counter += (
            self._gamma + 1 if spec
            else 1 + self._jump_max if jump else self._steps_per_tick
        )
        owners = [s.request if s.active else None for s in self.slots]
        rec = self._tick_record(sum(r is not None for r in owners))
        # The launch and collect counters read these marks, recorded or
        # not.
        phases = rec.phases if rec is not None else PhaseTimer()
        chunk = self._ilv_busy()
        if chunk:
            self._ilv_fill_rows()
            if rec is not None:
                rec.interleaved_rows = sum(
                    r is not None for r in self._ilv_rows)
        self._sync_tables()
        self._grammar_tables()
        args = (
            self.engine.params, self._t(self.cur_tokens),
            self._t(self.seeds), step0 + 1, self._temps(self.temps),
            self._t(self.top_ks), self._t(self.top_ps),
            self._t(self.gstates),
        )
        kw = {"adapters": self._lora_idx(self.adapter_ids)}
        if self._is_moe:
            # Only the plain tick serves MoE (spec and jump are off).
            kw["active"] = self._t(np.array([r is not None for r in owners]))
        if spec:
            args = (args[0], self.engine.draft_params,
                    self._t(self.prev_tokens)) + args[1:]
        if jump:
            args += (self._t(self.jump_ok),)
        sel = counts_dev = offs = c_tl = None
        if chunk:
            if self._ilv_mini is None:
                self._ilv_mini = self._make_mini(self._ilv_k, self.max_seq)
            chunk_arr, offs, c_tl, c_adapt = self._ilv_chunk_inputs()
            c_args = (self._t(chunk_arr), self._t(offs), self._t(c_tl))
            kw["c_adapters"] = self._lora_idx(c_adapt)
        window, window_attrs = self._decode_window(owners, offs, c_tl)
        phases.mark("sync")
        if chunk:
            if spec:
                toks_dev, counts_dev, gs_dev, sel = (
                    self._tick_spec_chunk_impl(*args, *c_args))
            elif jump:
                toks_dev, counts_dev, gs_dev, sel = (
                    self._tick_jump_chunk_impl(*args, *c_args, **kw))
            else:
                toks_dev, gs_dev, sel = self._tick_chunk_impl(
                    *args, *c_args, **kw)
        elif spec:
            toks_dev, counts_dev, gs_dev = self._tick_spec_impl(*args)
        elif jump:
            toks_dev, counts_dev, gs_dev = self._tick_jump_impl(*args, **kw)
        else:
            toks_dev, gs_dev = self._tick_impl(*args, **kw)
        phases.mark("dispatch")
        toks = toks_dev.cpu().numpy()
        counts = None if counts_dev is None else counts_dev.cpu().numpy()
        gs = gs_dev.cpu().numpy()
        phases.mark("wait")
        self.timing["tick_dispatch_ms"] += (
            phases.acc["sync"] + phases.acc["dispatch"])
        self.timing["tick_collect_ms"] += phases.acc["wait"]
        if window is not None:
            window.close(window_attrs)
        self.timing["ticks"] += 1
        drafted = accepted = 0
        if spec:
            # Counted before any emission: a consumer woken by a terminal
            # chunk reads counters that include this tick.
            live = [i for i, r in enumerate(owners) if r is not None]
            drafted = self._gamma * len(live)
            accepted = sum(int(counts[i]) - 1 for i in live)
            self.spec_ticks += 1
            self.spec_drafted += drafted
            self.spec_accepted += accepted
        if chunk:
            self._ilv_advance(sel)
        finished = jump_tokens = jump_runs = 0
        for i, request in enumerate(owners):
            if request is None:
                continue
            if self.slots[i].request is not request:
                continue
            c = toks.shape[1] if counts is None else int(counts[i])
            if spec:
                # The last committed token before the correction.
                self.prev_tokens[i] = (
                    toks[i, c - 2] if c >= 2 else self.cur_tokens[i])
            elif counts is not None and c > 1:
                if not self._jump_validate(request, toks[i, : c - 1]):
                    self._jump_degrade(i, request)
                    continue
                jump_tokens += c - 1
                jump_runs += 1
            self.cur_tokens[i] = toks[i, c - 1]
            self.gstates[i] = gs[i]
            self._emit_chunk(i, toks[i, :c])
            if self.slots[i].request is not request:
                finished += 1
        self.grammar_jump_tokens += jump_tokens
        self.grammar_jump_runs += jump_runs
        self.recorder.tick_done(rec, finished, spec_drafted=drafted,
                                spec_accepted=accepted,
                                jump_tokens=jump_tokens, jump_runs=jump_runs)
        if rec is not None:
            for phase in PHASE_NAMES:
                self.phase_ms[phase] += getattr(rec, f"phase_{phase}_ms")
            self._turn = _Turn(rec.phases.last, rec.t_wall, rec.t_mono,
                               rec.seq)

    def _jump_validate(self, request: _Request, run) -> bool:
        """A jump tick's forced run for one row must be the run the HOST
        arena walk gives at the request's current state: a corrupted
        device table or landing state is caught before a token of it
        reaches the consumer. The grammar_jump_fail failpoint refuses
        the run as such a corruption would."""
        try:
            failpoints.evaluate("grammar_jump_fail")
        except failpoints.FailpointError:
            return False
        return [int(t) for t in run] == self.arena.forced_run(request.gcur)

    def _jump_degrade(self, slot_idx: int, request: _Request) -> None:
        """A refused forced run degrades the request, counted, to
        one-token constrained decoding: its row advanced through the
        refused run, so the slot parks and the request replays through
        admission from prompt + delivered tokens with jump_ok False."""
        self.grammar_jump_fallbacks += 1
        request.jump_degraded = True
        logger.warning("jump-ahead: forced run refused for slot %d; "
                       "replaying it with one-token decoding", slot_idx)
        self._park_slot(slot_idx)
        if self._paged:
            self.pages.free_slot(slot_idx)
            self._tables_dirty = True
        self._loop_ref.call_soon_threadsafe(self._replay_or_fail, request)

    def _emit_chunk(self, slot_idx: int, tokens) -> None:
        """Deliver a tick's tokens for one slot: truncate at EOS or the
        slot's max_new budget, finish the slot if either was hit."""
        slot = self.slots[slot_idx]
        request = slot.request
        if request is None:
            return
        finished_reason = None
        ids: list[int] = []
        for raw_token in tokens:
            token = int(raw_token)
            if token == self.eos_id:
                # Under a grammar EOS is allowed only in accepting states.
                finished_reason = "stop"
                break
            ids.append(token)
            slot.generated += 1
            if request.grammar is not None:
                # The host DFA walk: the accepting sink (nothing may
                # follow) ends a constrained generation.
                request.gcur = self.arena.step(request.gcur, token)
                self.grammar_tokens += 1
                if self.arena.is_sink(request.gcur):
                    finished_reason = "grammar_complete"
                    break
            if slot.generated >= slot.max_new:
                finished_reason = "length"
                break
        if request.cancelled:
            finished_reason = finished_reason or "cancelled"
            ids = []
        now = time.perf_counter()
        if request.t_first == 0.0:
            request.t_first = now
        last = self._slot_last_emit[slot_idx]
        if last is not None:
            self._stall_records.append((now - last) * 1000.0)
        self._slot_last_emit[slot_idx] = (
            None if finished_reason is not None else now
        )
        if finished_reason is not None:
            # Park the slot BEFORE delivering the terminal chunk.
            slot.active = False
            slot.request = None
            self._lat_records.append(
                (request.queue_ms, (now - request.t_admit) * 1000.0)
            )
            self.temps[slot_idx] = 0.0
            self.adapter_ids[slot_idx] = 0
            self.gstates[slot_idx] = 0
            self.jump_ok[slot_idx] = False
            if self._paged:
                # Release the slot's page references (indexed pages stay
                # resident as evictable reuse cache); its row now maps
                # to the sentinel, so its junk decode writes land in the
                # scratch page.
                self.pages.free_slot(slot_idx)
                self._tables_dirty = True
        request.acc.extend(ids)
        if request.unary:
            item = (request.acc, finished_reason)
            if finished_reason is None:
                return
        else:
            item = (ids, finished_reason)
        if self._tick_out is not None:
            self._tick_out.append((request, item))
        else:
            self._deliver(request, item)
