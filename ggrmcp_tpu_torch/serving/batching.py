"""Continuous batching for the generation engine, default path.

Port of `ggrmcp_tpu/serving/batching.py::ContinuousBatcher` under the
default `BatchingConfig`: one contiguous KV slot pool shared by
`max_batch_size` slots. Requests join free slots between decode ticks:

- a prompt of at most `prefill_chunk` tokens takes FUSED admission —
  a [1, S] (one request) or [B, S] (a burst, rows at their slots'
  indices) prefill against a fresh mini cache, merged into the pool;
- a longer prompt takes CHUNKED admission — an [R, T, C] grid of C =
  prefill_chunk steps against a full-length mini cache, merged at the
  group's slots;
- every loop turn then runs one decode tick of `decode_steps_per_tick`
  steps for the whole pool, sampling through the per-row dynamic path
  with grammar state 0.

Device work runs in the default executor (never on the event loop),
one call at a time. Paged KV, the prefix pool, interleave, speculative
ticks, grammar, LoRA, the scheduler, SLO accounting and the flight
recorder are not ported yet (core/config.py rejects their settings).
Every copy between a mini cache and the pool goes through `quant.kv_map`,
so an int8 KV cache (the engine's `kv_dtype`) moves values and scales
alike.
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

from ggrmcp_tpu_torch.core.config import BatchingConfig, resolve_decode_steps
from ggrmcp_tpu_torch.ops import quant
from ggrmcp_tpu_torch.ops.sampling import (
    SamplingConfig,
    masked_sample_dynamic,
    trivial_grammar_tables,
)
from ggrmcp_tpu_torch.serving.engine import (
    build_kernels,
    bucket_len,
    fit_request,
)

logger = logging.getLogger("ggrmcp.torch.batching")


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


def _pct(values: list[float], q: float) -> float:
    """Nearest-rank percentile (ceil-based), 0.0 for no samples."""
    if not values:
        return 0.0
    ordered = sorted(values)
    rank = max(1, int(np.ceil(q * len(ordered))))
    return round(ordered[rank - 1], 2)


class ContinuousBatcher:
    """Slot-based continuous batching over a shared contiguous KV cache."""

    def __init__(self, engine, cfg: Optional[BatchingConfig] = None,
                 eos_id: int = 2):
        self.engine = engine
        self.cfg = cfg or BatchingConfig()
        self.eos_id = eos_id
        self.device = engine.device
        b = self.cfg.max_batch_size
        self.slots = [_Slot() for _ in range(b)]
        self.pending = _PendingQueue()
        self._task: Optional[asyncio.Task] = None
        self._wake = asyncio.Event()
        self._stopping = False
        self._steps_per_tick = resolve_decode_steps(self.cfg)
        # A tick may run up to steps_per_tick - 1 positions past a
        # slot's max_new before the host masks the extra tokens: every
        # request reserves that much cache (pipelined ticks are off).
        self._reserve = self._steps_per_tick - 1
        self.max_seq = min(self.cfg.kv_cache_max_seq, engine.cfg.max_seq_len)
        self.cache = engine.make_cache(b, self.max_seq)
        # True while a device call that writes the SHARED cache is in
        # flight; admission failure rebuilds the cache only when set.
        self._cache_at_risk = False
        # Host-mirrored per-slot state, shipped to the device each tick.
        self.cur_tokens = np.zeros((b,), np.int64)
        self.temps = np.zeros((b,), np.float32)
        self.top_ks = np.zeros((b,), np.int64)
        self.top_ps = np.ones((b,), np.float32)
        self.seeds = np.zeros((b,), np.int64)
        self.step_counter = 0
        self._g_allow, self._g_trans = trivial_grammar_tables(
            engine.cfg.vocab_size, self.device
        )
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

    # -- host <-> device helpers -----------------------------------------

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sample(self, logits, seeds, step, temps, ks, ps) -> torch.Tensor:
        tokens, _ = masked_sample_dynamic(
            logits, seeds, step, temps, ks, ps,
            torch.zeros(logits.shape[0], dtype=torch.int64,
                        device=self.device),
            self._g_allow, self._g_trans,
        )
        return tokens

    # -- device bodies ----------------------------------------------------

    def _merge(self, merge, mini) -> None:
        """Copy a mini cache's K/V into the pool in place through
        `merge(pool_leaf, mini_leaf)`; `kv_map` applies it to an int8
        cache's values and scales alike."""
        quant.kv_map(merge, self.cache.k, mini.k)
        quant.kv_map(merge, self.cache.v, mini.v)

    def _admit_full_impl(self, params, tokens, true_len, valid_rows,
                         seeds, temps, ks, ps):
        """Burst admission: `tokens` is a full [B, S] batch with each
        admitted prompt at its slot's row; `valid_rows` (host list) are
        the admitted rows. One [B, S] prefill against a fresh mini cache,
        first-token sample, then the admitted rows' K/V and lengths are
        copied into the pool (other rows keep their state)."""
        r, s = tokens.shape
        mini = self.engine.make_cache(r, s)
        logits, mini = self.engine.prefill_forward(params, tokens, mini)
        idx = torch.clamp(true_len.long() - 1, min=0)
        last = logits[torch.arange(r, device=self.device), idx]
        first = self._sample(last, seeds, 0, temps, ks, ps)
        rows = torch.as_tensor(valid_rows, dtype=torch.long,
                               device=self.device)

        def merge(pool, m):
            pool[:, rows, :s] = m[:, rows, :s]
            return pool

        self._merge(merge, mini)
        self.cache.length[rows] = true_len[rows].to(torch.int32)
        return first

    def _admit_single_impl(self, params, tokens, true_len, slot,
                           seeds, temps, ks, ps):
        """One request (row shapes [1, S]) into slot `slot`."""
        s = tokens.shape[1]
        mini = self.engine.make_cache(1, s)
        logits, mini = self.engine.prefill_forward(params, tokens, mini)
        last = logits[:, max(int(true_len[0]) - 1, 0)]
        first = self._sample(last, seeds, 0, temps, ks, ps)

        def merge(pool, m):
            pool[:, slot, :s] = m[:, 0, :s]
            return pool

        self._merge(merge, mini)
        self.cache.length[slot] = true_len[0]
        return first

    def _chunked_scan(self, params, tokens, true_len, mini):
        """Extend `mini` by one [R, C] chunk per grid step and capture
        each row's logits at its final prompt position as it passes.
        Rows shorter than the grid process padding chunks whose K/V
        land past their final length (masked by length on merge; writes
        past the mini's end land in its scratch slot)."""
        r, t_steps, c = tokens.shape
        final = torch.zeros((r, self.engine.cfg.vocab_size),
                            dtype=torch.float32, device=self.device)
        last = true_len.long() - 1
        for t in range(t_steps):
            off = t * c
            logits, mini = self.engine.decode_forward(
                params, tokens[:, t], mini
            )
            idx = torch.clamp(last - off, 0, c - 1)
            sel = logits[torch.arange(r, device=self.device), idx]
            take = (last >= off) & (last < off + c)
            final = torch.where(take[:, None], sel, final)
        return final

    def _admit_chunked_impl(self, params, tokens, true_len, rows, slots,
                            seeds, temps, ks, ps):
        """Chunked admission of a group: the [R, T, C] grid against a
        full-length [R, S_max] mini cache, first-token sample, then the
        real rows (`rows`, host list) are copied into the pool at
        `slots`. Padding rows are never copied — the reference's
        out-of-range scatter drops them, here they are not indexed."""
        r = tokens.shape[0]
        mini = self.engine.make_cache(r, self.max_seq)
        final = self._chunked_scan(params, tokens, true_len, mini)
        first = self._sample(final, seeds, 0, temps, ks, ps)
        src = torch.as_tensor(rows, dtype=torch.long, device=self.device)
        dst = torch.as_tensor(slots, dtype=torch.long, device=self.device)

        def merge(pool, m):
            pool[:, dst] = m[:, src]
            return pool

        self._merge(merge, mini)
        self.cache.length[dst] = true_len[src].to(torch.int32)
        return first

    def _tick_impl(self, params, tokens, seeds, step, temps, ks, ps):
        """`decode_steps_per_tick` decode steps for the whole pool.
        Tokens a slot samples after its EOS / max_new are dropped on
        the host (_emit_chunk); their cache writes are masked by length
        when the slot is reused, and a write past the end of the cache
        lands in its scratch slot. Returns tokens [B, steps]."""
        out = []
        cur = tokens
        for i in range(self._steps_per_tick):
            logits, _ = self.engine.decode_forward(
                params, cur[:, None], self.cache
            )
            cur = self._sample(logits[:, -1], seeds, step + i, temps, ks, ps)
            out.append(cur)
        return torch.stack(out, dim=1)

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

    def submit(
        self,
        prompt: list[int],
        max_new: int,
        sampling: SamplingConfig,
        seed: int = 0,
        unary: bool = False,
    ) -> AsyncIterator[tuple[list[int], Optional[str]]]:
        """Enqueue a request; yields (token_ids_chunk, finish_reason)
        pairs, finish_reason set on the final chunk (`unary=True`: one
        terminal chunk with all tokens). The cap check and the enqueue
        run HERE, eagerly. Raises OverloadedError when max_pending or
        max_queue_tokens would be exceeded."""
        prompt, max_new = fit_request(
            prompt, max_new, self.max_seq - self._reserve
        )
        cap = self.cfg.max_pending
        if cap > 0 and self.pending.qsize() >= cap:
            self.shed += 1
            raise OverloadedError(
                f"admission queue full ({cap} requests pending)",
                reason="requests",
            )
        tcap = self.cfg.max_queue_tokens
        if (
            tcap > 0 and not self.pending.empty()
            and self.pending.token_count + len(prompt) > tcap
        ):
            self.shed += 1
            raise OverloadedError(
                f"admission queue token budget full ({tcap} tokens)",
                reason="tokens",
            )
        request = _Request(
            prompt=prompt, max_new=max_new, sampling=sampling, seed=seed,
            unary=unary,
        )
        request.t_submit = time.perf_counter()
        self.pending.put_nowait(request)
        self._wake.set()
        return self._consume(request)

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
        """K/V bytes of the pool, an int8 cache's scales included."""
        return self.cache.k.nbytes + self.cache.v.nbytes

    def stats(self) -> dict:
        """Counters and latency percentiles for GetServingStats (the
        reference's field names; fields of unported features stay 0)."""
        t = self.timing
        lat = list(self._lat_records)
        stalls = list(self._stall_records)
        qs = [r[0] for r in lat]
        ss = [r[1] for r in lat]
        return {
            "active_slots": self._active_count(),
            "total_slots": len(self.slots),
            "queued_requests": self.pending.qsize(),
            "queued_tokens": self.pending.token_count,
            "kv_cache_bytes": self.cache_bytes(),
            "memory_kv_arena_bytes": self.cache.nbytes(),
            "memory_weights_bytes": self.engine.weight_bytes(),
            "decode_steps": self.step_counter,
            "timed_out": 0,
            "shed_requests": self.shed,
            "replayed_requests": self.replayed,
            "replay_exhausted": self.replay_exhausted,
            "ticks": t["ticks"],
            "tick_collects": t["ticks"],  # every tick is collected at once
            "admit_rounds": t["admit_rounds"],
            "tick_dispatch_ms": round(t["tick_dispatch_ms"], 2),
            "tick_collect_ms": round(t["tick_collect_ms"], 2),
            "admit_ms": round(t["admit_ms"], 2),
            "admit_ms_max": round(t["admit_ms_max"], 2),
            "queue_ms_p50": _pct(qs, 0.5), "queue_ms_p99": _pct(qs, 0.99),
            "service_ms_p50": _pct(ss, 0.5), "service_ms_p99": _pct(ss, 0.99),
            "decode_stall_ms_p50": _pct(stalls, 0.5),
            "decode_stall_ms_p99": _pct(stalls, 0.99),
            "decode_stall_ms_max": round(max(stalls), 2) if stalls else 0.0,
            "tp_chips": 1,
            "mesh_devices": 1,
            "mesh_shape": str(self.device),
        }

    # -- the loop -----------------------------------------------------------

    def _free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if not s.active]

    def _active_count(self) -> int:
        return sum(s.active for s in self.slots)

    async def _loop(self) -> None:
        loop = asyncio.get_running_loop()
        while not self._stopping:
            await self._admit()
            if self._active_count() == 0:
                # Clear BEFORE checking pending: a submit() landing after
                # the check still leaves its set() visible to wait().
                self._wake.clear()
                if not self.pending.empty():
                    continue
                await self._wake.wait()
                continue
            try:
                await loop.run_in_executor(None, self._tick_step)
            except asyncio.CancelledError:
                raise  # batcher shutdown cancels the loop task
            except Exception:
                logger.exception("decode tick failed; replaying active slots")
                self._recover_after_tick_failure()
            await asyncio.sleep(0)  # noqa: ASYNC115 — let handlers drain queues

    def _deliver(self, request: _Request, item) -> None:
        """Executor → loop edge: asyncio.Queue is not thread-safe."""
        self._loop_ref.call_soon_threadsafe(request.out.put_nowait, item)

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

    def _recover_after_tick_failure(self) -> None:
        """A failed tick leaves the pool's K/V unknown: replay every
        active request from its prompt + emitted tokens on a fresh
        cache (of the engine's KV dtype)."""
        for slot in self.slots:
            if slot.active and slot.request is not None:
                self._replay_or_fail(slot.request)
            slot.active = False
            slot.request = None
        self._slot_last_emit = [None] * len(self.slots)
        self.cache = self.engine.make_cache(len(self.slots), self.max_seq)

    async def _admit(self) -> int:
        """Drain pending requests into free slots: one batch per round,
        capped at the free slots, each round ONE executor call."""
        admitted = 0
        deadline = time.monotonic() + self.cfg.max_queue_delay_ms / 1000.0
        loop = asyncio.get_running_loop()
        while self._free_slots():
            batch: list[_Request] = []
            budget = len(self._free_slots())
            while len(batch) < budget:
                try:
                    timeout = deadline - time.monotonic()
                    if timeout <= 0 or admitted + len(batch) >= len(self.slots):
                        break
                    if self._active_count() > 0 or admitted > 0 or batch:
                        # Don't stall running decodes for stragglers.
                        request = self.pending.get_nowait()
                    else:
                        request = await asyncio.wait_for(
                            self.pending.get(), timeout=timeout
                        )
                except (asyncio.TimeoutError, asyncio.QueueEmpty):
                    break
                if request.cancelled:
                    continue
                batch.append(request)
            if not batch:
                break
            slots_idx = self._free_slots()[: len(batch)]
            try:
                await loop.run_in_executor(
                    None, self._prefill_into_slots, slots_idx, batch
                )
            except asyncio.CancelledError:
                raise  # batcher shutdown cancels the loop task
            except Exception:
                logger.exception("batched prefill failed for slots %s",
                                 slots_idx)
                cache_dead = self._cache_at_risk
                activated = {
                    id(s.request) for s in self.slots
                    if s.active and s.request is not None
                }
                for request in batch:
                    if id(request) not in activated:
                        self._deliver(request, ([], "error"))
                if cache_dead:
                    # The pool may be half-written: replay bystanders.
                    self._cache_at_risk = False
                    self._recover_after_tick_failure()
                continue
            admitted += len(batch)
        return admitted

    @torch.no_grad()
    def _prefill_into_slots(
        self, slots_idx: list[int], batch: list[_Request]
    ) -> None:
        """Route each admission: prompts of at most prefill_chunk tokens
        fuse into one prefill call, longer prompts go to one chunked
        group call."""
        t0 = time.perf_counter()
        fused: list[tuple[int, _Request]] = []
        long_rows: list[tuple[int, _Request]] = []
        for sl, req in zip(slots_idx, batch):
            if len(req.prompt) > self.cfg.prefill_chunk:
                long_rows.append((sl, req))
            else:
                fused.append((sl, req))
        if long_rows:
            self._admit_chunked_group(long_rows)
        if fused:
            self._prefill_fused([s for s, _ in fused], [r for _, r in fused])
        dt = (time.perf_counter() - t0) * 1000.0
        self.timing["admit_ms"] += dt
        self.timing["admit_ms_max"] = max(self.timing["admit_ms_max"], dt)
        self.timing["admit_rounds"] += 1

    def _row_params(self, n: int, rows) -> dict:
        """Per-row sampling arrays for an admission call; `rows` pairs
        (row index, request)."""
        seeds = np.zeros((n,), np.int64)
        temps = np.zeros((n,), np.float32)
        ks = np.zeros((n,), np.int64)
        ps = np.ones((n,), np.float32)
        for row, req in rows:
            seeds[row] = req.seed & 0xFFFFFFFF
            temps[row] = req.sampling.temperature
            ks[row] = req.sampling.top_k
            ps[row] = req.sampling.top_p
        return dict(seeds=self._t(seeds), temps=self._t(temps),
                    ks=self._t(ks), ps=self._t(ps))

    def _admit_chunked_group(self, rows: list[tuple[int, _Request]]) -> None:
        """ONE chunked call admitting `rows` (slot, request): the full
        prompts run an [R, T, prefill_chunk] grid from position 0; R is
        the group size bucketed to a power of two (padding rows run but
        are never merged)."""
        b = len(self.slots)
        c = min(self.cfg.prefill_chunk, self.max_seq)
        n_max = max(len(req.prompt) for _, req in rows)
        t_steps = max(1, -(-n_max // c))
        r = min(b, bucket_len(len(rows), minimum=1))
        tokens = np.zeros((r, t_steps * c), np.int64)
        true_len = np.ones((r,), np.int64)
        for j, (_, req) in enumerate(rows):
            tokens[j, : len(req.prompt)] = req.prompt
            true_len[j] = len(req.prompt)
        self._cache_at_risk = True
        first = self._admit_chunked_impl(
            self.engine.params, self._t(tokens.reshape(r, t_steps, c)),
            self._t(true_len), list(range(len(rows))),
            [sl for sl, _ in rows],
            **self._row_params(r, list(enumerate(req for _, req in rows))),
        ).cpu().numpy()
        self._cache_at_risk = False
        self.chunked_admissions += len(rows)
        for j, (sl, req) in enumerate(rows):
            self._activate_slot(sl, req, int(first[j]))

    def _prefill_fused(
        self, slots_idx: list[int], batch: list[_Request]
    ) -> None:
        """One fused call: the single-row program for one request (and
        for each of a pair), the full-pool program for a larger burst
        (row index == slot index)."""
        if 1 < len(batch) <= 2:
            # Two serial single-row calls beat one full-pool prefill.
            for slot_idx, req in zip(slots_idx, batch):
                self._prefill_fused([slot_idx], [req])
            return
        s = bucket_len(
            max(len(req.prompt) for req in batch), maximum=self.max_seq
        )
        single = len(batch) == 1
        n = 1 if single else len(self.slots)
        rows = [0] if single else list(slots_idx)
        tokens = np.zeros((n, s), np.int64)
        true_len = np.ones((n,), np.int64)
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

    def _activate_slot(
        self, slot_idx: int, request: _Request, first_tok: int
    ) -> None:
        slot = self.slots[slot_idx]
        slot.active = True
        slot.request = request
        slot.generated = 0
        slot.max_new = request.max_new
        request.t_admit = time.perf_counter()
        request.queue_ms = (request.t_admit - request.t_submit) * 1000.0
        self.cur_tokens[slot_idx] = first_tok
        self.temps[slot_idx] = request.sampling.temperature
        self.top_ks[slot_idx] = request.sampling.top_k
        self.top_ps[slot_idx] = request.sampling.top_p
        self.seeds[slot_idx] = request.seed & 0xFFFFFFFF
        self._emit_chunk(slot_idx, [first_tok])

    @torch.no_grad()
    def _tick_step(self) -> None:
        """One decode tick: dispatch, pull the tokens, emit them."""
        t0 = time.perf_counter()
        step0 = self.step_counter
        self.step_counter += self._steps_per_tick
        owners = [s.request if s.active else None for s in self.slots]
        toks_dev = self._tick_impl(
            self.engine.params, self._t(self.cur_tokens),
            self._t(self.seeds), step0 + 1, self._t(self.temps),
            self._t(self.top_ks), self._t(self.top_ps),
        )
        t1 = time.perf_counter()
        toks = toks_dev.cpu().numpy()
        t2 = time.perf_counter()
        self.timing["tick_dispatch_ms"] += (t1 - t0) * 1000.0
        self.timing["tick_collect_ms"] += (t2 - t1) * 1000.0
        self.timing["ticks"] += 1
        for i, request in enumerate(owners):
            if request is None or self.slots[i].request is not request:
                continue
            self.cur_tokens[i] = toks[i, -1]
            self._emit_chunk(i, toks[i])

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
                finished_reason = "stop"
                break
            ids.append(token)
            slot.generated += 1
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
        request.acc.extend(ids)
        if request.unary:
            if finished_reason is not None:
                self._deliver(request, (request.acc, finished_reason))
        else:
            self._deliver(request, (ids, finished_reason))
