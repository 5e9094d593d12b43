"""Engine flight recorder: bounded rings of per-tick and per-request
lifecycle records plus fixed-bucket latency histograms.

The postmortem layer (SURVEY.md §5.1): the batcher's existing
counters say HOW MUCH happened; this module records WHAT happened —
what the batcher did at tick N (composition, duration, lifecycle-event
deltas, participating trace ids) and why THIS request was slow
(t_submit → t_admit → t_first_token → t_finish, from which ttft_ms /
queue_ms / e2e_ms / decode_tps derive). One trace id walks gateway span
→ request record → tick records.

The histograms are the aggregatable counterpart of the in-process
p50/p99 gauges ServingStats has carried since round 4: fixed log-spaced
bucket counters (core/config.py::LATENCY_BUCKET_BOUNDS_MS) that the
gateway renders as true Prometheus `_bucket`/`_sum`/`_count` series, so
PromQL can sum across backends and compute windowed quantiles — which
point-in-time snapshot percentiles fundamentally cannot do.

Threading: records are appended from the batcher's serialized executor
calls and (for queue-side terminal events) the event loop; deque
appends are atomic under the GIL and the histogram increments take a
micro-lock. Snapshots are lock-free list() copies — same stale-read
contract as the rest of the batcher's counters. Disabled
(observability.enabled=false), every hook is one attribute check.
"""

from __future__ import annotations

import bisect
import dataclasses
import threading
import time
from collections import deque
from typing import Optional

from ggrmcp_tpu_torch.core.config import ObservabilityConfig

# The tick phases the per-tick PhaseTimer attributes, in wall-clock
# order within a tick: admit (queue drain + admission prefill since the
# previous dispatch), sync (host-state snapshots — block tables,
# cur/prev tokens, grammar tables), dispatch (building + launching the
# jitted tick), wait (the blocking token collect: device wait +
# transfer, plus the deliberate in-flight lag under pipelined ticks),
# host (emission, finish handling, allocator bookkeeping). The phases
# PARTITION a tick's duration_ms: their sum equals it by construction
# (contiguous perf_counter marks), which is what makes "this tick lost
# 3.1 ms to host-side table sync" a trustworthy statement.
PHASE_NAMES = ("admit", "sync", "dispatch", "wait", "host")

# The latencies the recorder distributes: the four lifecycle histograms
# (ServingStatsResponse 34-45), one histogram per tick phase (fields
# 67-81), and the inter-token-latency (TPOT) histogram (106-108) —
# per finished request, the mean gap between consecutive token
# emissions, derived from the existing first/last lifecycle stamps.
# Keys double as the stats() field prefixes:
# <name>_bucket / <name>_sum / <name>_count.
HISTOGRAM_NAMES = ("ttft_ms", "e2e_ms", "queue_ms", "tick_duration_ms") + tuple(
    f"tick_phase_{p}_ms" for p in PHASE_NAMES
) + ("tpot_ms",)


class PhaseTimer:
    """Contiguous segment timer: mark(phase) charges the time since the
    previous mark to `phase`. Because segments are contiguous from t0,
    the accumulated phases always sum to (last - t0) exactly — the
    closure property the tick-phase acceptance test asserts. Repeated
    marks of the same phase accumulate."""

    __slots__ = ("t0", "last", "acc")

    def __init__(self) -> None:
        self.t0 = self.last = time.perf_counter()
        self.acc: dict = {}

    def mark(self, phase: str) -> None:
        now = time.perf_counter()
        self.acc[phase] = (
            self.acc.get(phase, 0.0) + (now - self.last) * 1000.0
        )
        self.last = now


@dataclasses.dataclass
class TickRecord:
    """One decode tick as dispatched (fields mirror protos/serving.proto
    TickRecord; `finished`/`duration_ms` are completed at collect)."""

    seq: int
    t_wall: float
    t_mono: float
    active_slots: int
    admitted: int
    interleaved_rows: int
    shed_total: int
    replayed_total: int
    timed_out_total: int
    trace_ids: list
    duration_ms: float = 0.0
    finished: int = 0
    source: str = ""
    # Speculative tick (batching.speculative=on): draft tokens proposed
    # and accepted on THIS tick — the per-tick acceptance trace (0/0 on
    # plain ticks). Completed at collect, like finished/duration_ms.
    spec_drafted: int = 0
    spec_accepted: int = 0
    # Jump-ahead tick (grammar.jump_max > 0): forced tokens emitted by
    # multi-token advances on THIS tick and runs advanced (0/0 on
    # plain/spec ticks) — the per-tick jump trace beside the spec
    # acceptance one. Completed at collect, like finished/duration_ms.
    jump_tokens: int = 0
    jump_runs: int = 0
    # Paged KV arena occupancy at dispatch (batching.paged_kv=on; 0
    # off): resident pages — live + reuse-cached — so a tick window
    # shows page pressure next to its admissions/finishes.
    kv_pages_in_use: int = 0
    # Tick-phase attribution (PHASE_NAMES): where this tick's
    # duration_ms went — admit/sync/dispatch/wait/host partition it, so
    # the five always sum to duration_ms (PhaseTimer closure). admit is
    # seeded at dispatch (executor admission time since the previous
    # dispatch); the rest are stamped by contiguous marks and completed
    # at collect, like finished/duration_ms.
    phase_admit_ms: float = 0.0
    phase_sync_ms: float = 0.0
    phase_dispatch_ms: float = 0.0
    phase_wait_ms: float = 0.0
    phase_host_ms: float = 0.0
    # Device-memory ledger snapshot at dispatch (component -> bytes;
    # empty when the ledger is off) — the timeline's counter-track
    # source (proto memory_components/memory_component_bytes).
    memory: dict = dataclasses.field(default_factory=dict)
    # The live timer carrying this tick's contiguous marks (None when
    # the recorder is disabled); not part of the proto mirror.
    phases: Optional[PhaseTimer] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def to_dict(self) -> dict:
        return {
            "seq": self.seq,
            "tWall": round(self.t_wall, 6),
            "durationMs": round(self.duration_ms, 3),
            "activeSlots": self.active_slots,
            "admitted": self.admitted,
            "finished": self.finished,
            "interleavedRows": self.interleaved_rows,
            "shedTotal": self.shed_total,
            "replayedTotal": self.replayed_total,
            "timedOutTotal": self.timed_out_total,
            "traceIds": self.trace_ids,
            "source": self.source,
            "specDrafted": self.spec_drafted,
            "specAccepted": self.spec_accepted,
            "jumpTokens": self.jump_tokens,
            "jumpRuns": self.jump_runs,
            "kvPagesInUse": self.kv_pages_in_use,
            "phaseAdmitMs": round(self.phase_admit_ms, 3),
            "phaseSyncMs": round(self.phase_sync_ms, 3),
            "phaseDispatchMs": round(self.phase_dispatch_ms, 3),
            "phaseWaitMs": round(self.phase_wait_ms, 3),
            "phaseHostMs": round(self.phase_host_ms, 3),
            "memoryComponents": list(self.memory),
            "memoryComponentBytes": [
                int(b) for b in self.memory.values()
            ],
        }


@dataclasses.dataclass
class RequestRecord:
    """One request's lifecycle at its terminal chunk (protos/
    serving.proto RequestRecord)."""

    trace_id: str
    t_submit: float  # wall-clock epoch seconds
    queue_ms: float
    ttft_ms: float
    e2e_ms: float
    prompt_tokens: int
    tokens: int
    finish_reason: str
    decode_tps: float
    first_tick: int
    last_tick: int
    source: str = ""
    # Grammar-constrained decode (ggrmcp_tpu/grammar): this request's
    # tokens were DFA-masked — "why is this request's output shaped
    # like that" answered from the ring.
    constrained: bool = False
    # Tenant & SLO identity and verdict (serving/slo.py): who the
    # request belonged to, which QoS class judged it, and whether it
    # landed in the `violated` partition — carried on the record so
    # /debug/requests?tenant= and the timeline's violation instants
    # need no re-derivation of class targets.
    tenant: str = ""
    qos_class: str = ""
    slo_violated: bool = False

    def to_dict(self) -> dict:
        return {
            "traceId": self.trace_id,
            "tSubmit": round(self.t_submit, 6),
            "queueMs": round(self.queue_ms, 3),
            "ttftMs": round(self.ttft_ms, 3),
            "e2eMs": round(self.e2e_ms, 3),
            "promptTokens": self.prompt_tokens,
            "tokens": self.tokens,
            "finishReason": self.finish_reason,
            "decodeTps": round(self.decode_tps, 3),
            "firstTick": self.first_tick,
            "lastTick": self.last_tick,
            "source": self.source,
            "constrained": self.constrained,
            "tenant": self.tenant,
            "qosClass": self.qos_class,
            "sloViolated": self.slo_violated,
        }


class LatencyHistogram:
    """Fixed-bound latency histogram: per-bucket (NON-cumulative)
    counts with one overflow slot, plus sum/count — exactly the wire
    shape of the ServingStats *_bucket/_sum/_count fields. The gateway
    cumsums to Prometheus `le` semantics at render time."""

    __slots__ = ("bounds", "counts", "total", "sum")

    def __init__(self, bounds):
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.total = 0
        self.sum = 0.0

    def observe(self, ms: float) -> None:
        # bisect_left: an observation equal to a bound lands in that
        # bound's bucket (Prometheus le is inclusive).
        self.counts[bisect.bisect_left(self.bounds, ms)] += 1
        self.total += 1
        self.sum += ms


class FlightRecorder:
    """Rings + histograms for ONE batcher (each KV tier and the
    speculative micro-batcher own an instance; facades merge views)."""

    def __init__(self, cfg: Optional[ObservabilityConfig] = None,
                 source: str = ""):
        cfg = cfg or ObservabilityConfig()
        self.enabled = bool(cfg.enabled)
        self.source = source
        self._ticks: deque = deque(maxlen=max(1, int(cfg.tick_ring)))
        self._requests: deque = deque(maxlen=max(1, int(cfg.request_ring)))
        self._bounds = tuple(float(b) for b in cfg.bucket_bounds_ms)
        self._hists = {
            name: LatencyHistogram(self._bounds) for name in HISTOGRAM_NAMES
        }
        self._lock = threading.Lock()
        # Slots activated since the last tick record (consumed at the
        # next dispatch → TickRecord.admitted).
        self._admitted_since_tick = 0

    # -- batcher-side hooks -------------------------------------------------

    def note_admit(self) -> None:
        if self.enabled:
            self._admitted_since_tick += 1

    def tick_start(
        self,
        seq: int,
        active: int,
        interleaved_rows: int,
        trace_ids: list,
        shed: int,
        replayed: int,
        timed_out: int,
        kv_pages_in_use: int = 0,
        admit_ms: float = 0.0,
        memory: Optional[dict] = None,
    ) -> Optional[TickRecord]:
        """Record a tick at dispatch; returns the record so the caller
        can carry it alongside the in-flight device call and complete
        it at collect (tick_done). `admit_ms` seeds the record's admit
        phase (executor admission time since the previous dispatch);
        the remaining phases come from the record's PhaseTimer, whose
        t0 doubles as t_mono so the phase sum closes on duration_ms."""
        if not self.enabled:
            return None
        timer = PhaseTimer()
        rec = TickRecord(
            seq=seq,
            t_wall=time.time(),
            t_mono=timer.t0,
            phases=timer,
            phase_admit_ms=admit_ms,
            active_slots=active,
            admitted=self._admitted_since_tick,
            interleaved_rows=interleaved_rows,
            shed_total=shed,
            replayed_total=replayed,
            timed_out_total=timed_out,
            trace_ids=trace_ids,
            source=self.source,
            kv_pages_in_use=kv_pages_in_use,
            memory=memory or {},
        )
        self._admitted_since_tick = 0
        self._ticks.append(rec)
        return rec

    def tick_done(
        self,
        rec: Optional[TickRecord],
        finished: int,
        spec_drafted: int = 0,
        spec_accepted: int = 0,
        jump_tokens: int = 0,
        jump_runs: int = 0,
    ) -> None:
        """Complete a tick at its token collect: stamp the tick's
        duration (admit seed + the contiguous admit-to-host span;
        includes the deliberate one-tick lag under pipelining), settle
        the phase attribution (the final `host` mark covers emission
        and finish bookkeeping — the caller marked sync/dispatch/wait),
        how many requests finished on it, and — on speculative/jump
        ticks — the round's draft/accept or forced-run counts (the
        per-tick acceptance and jump traces)."""
        if rec is None:
            return
        if rec.phases is not None:
            rec.phases.mark("host")
            acc = rec.phases.acc
            rec.phase_sync_ms = acc.get("sync", 0.0)
            rec.phase_dispatch_ms = acc.get("dispatch", 0.0)
            rec.phase_wait_ms = acc.get("wait", 0.0)
            rec.phase_host_ms = acc.get("host", 0.0)
            # t_mono == the timer's t0, so this equals the phase sum
            # exactly (the closure contract the acceptance test pins).
            rec.duration_ms = rec.phase_admit_ms + (
                rec.phases.last - rec.t_mono
            ) * 1000.0
        else:
            rec.duration_ms = (time.perf_counter() - rec.t_mono) * 1000.0
        rec.finished = finished
        rec.spec_drafted = spec_drafted
        rec.spec_accepted = spec_accepted
        rec.jump_tokens = jump_tokens
        rec.jump_runs = jump_runs
        with self._lock:
            self._hists["tick_duration_ms"].observe(rec.duration_ms)
            for phase in PHASE_NAMES:
                self._hists[f"tick_phase_{phase}_ms"].observe(
                    getattr(rec, f"phase_{phase}_ms")
                )

    def record_request(
        self,
        trace_id: str,
        t_submit: float,  # perf_counter stamp from _Request.t_submit
        t_admit: float,
        t_first: float,
        prompt_tokens: int,
        tokens: int,
        finish_reason: str,
        first_tick: int,
        last_tick: int,
        constrained: bool = False,
        tenant: str = "",
        qos_class: str = "",
        slo_violated: bool = False,
    ) -> None:
        """Record a request's terminal chunk; derives ttft/queue/e2e
        and feeds the histograms. Stamps that never happened (a timeout
        that was never admitted) stay 0 in the record and are skipped
        by their histograms — a queue-death must not pollute the TTFT
        distribution with zeros."""
        if not self.enabled:
            return
        now = time.perf_counter()
        # Clamped at 0: a tick-failure replay resets t_submit (the
        # queue-deadline clock) while t_first keeps its original stamp,
        # so the splits can otherwise go negative for replayed requests.
        queue_ms = max(0.0, (t_admit - t_submit) * 1000.0) if t_admit else 0.0
        ttft_ms = max(0.0, (t_first - t_submit) * 1000.0) if t_first else 0.0
        e2e_ms = max(0.0, (now - t_submit) * 1000.0)
        decode_s = (now - t_first) if t_first else 0.0
        rec = RequestRecord(
            trace_id=trace_id,
            t_submit=time.time() - e2e_ms / 1000.0,
            queue_ms=queue_ms,
            ttft_ms=ttft_ms,
            e2e_ms=e2e_ms,
            prompt_tokens=prompt_tokens,
            tokens=tokens,
            finish_reason=finish_reason,
            decode_tps=(tokens / decode_s) if decode_s > 1e-9 else 0.0,
            first_tick=first_tick,
            last_tick=last_tick,
            source=self.source,
            constrained=constrained,
            tenant=tenant,
            qos_class=qos_class,
            slo_violated=slo_violated,
        )
        self._requests.append(rec)
        with self._lock:
            if t_first:
                self._hists["ttft_ms"].observe(ttft_ms)
            if t_admit:
                self._hists["queue_ms"].observe(queue_ms)
            self._hists["e2e_ms"].observe(e2e_ms)
            if t_first and tokens > 1:
                # TPOT: mean inter-token gap over the decode span,
                # derived from the stamps already taken — one
                # observation per multi-token request (a single-token
                # request has no gaps and is skipped, exactly like a
                # never-admitted timeout skips TTFT).
                self._hists["tpot_ms"].observe(
                    decode_s * 1000.0 / (tokens - 1)
                )

    # -- snapshots ----------------------------------------------------------

    def tick_snapshot(self) -> list:
        return list(self._ticks)

    def request_snapshot(self) -> list:
        return list(self._requests)

    def request_record(self, trace_id: str) -> Optional[RequestRecord]:
        """Latest record for a trace id (the span-attribution lookup),
        newest first."""
        if not trace_id:
            return None
        for rec in reversed(self._requests):
            if rec.trace_id == trace_id:
                return rec
        return None

    def histogram_stats(self) -> dict:
        """The ServingStats histogram fields (proto 33-45 and the
        per-phase triplets 67-81), keyed by exact proto field name so
        ServingStatsResponse(**stats) drift fails loudly."""
        out = {"latency_bucket_bounds_ms": list(self._bounds)}
        with self._lock:
            for name, hist in self._hists.items():
                out[f"{name}_bucket"] = list(hist.counts)
                out[f"{name}_sum"] = hist.sum
                out[f"{name}_count"] = hist.total
        return out

    @staticmethod
    def merge_histogram_stats(parts: list) -> dict:
        """Elementwise merge of histogram_stats() dicts (the tiered
        facade and the sidecar's batcher+spec merge): bucket counts and
        sums add; the shared bounds pass through (every recorder in one
        process is built from the same ObservabilityConfig)."""
        parts = [p for p in parts if p]
        if not parts:
            return {}
        out = {"latency_bucket_bounds_ms": parts[0]["latency_bucket_bounds_ms"]}
        for name in HISTOGRAM_NAMES:
            key = f"{name}_bucket"
            counts = [0] * len(parts[0][key])
            for p in parts:
                for i, c in enumerate(p[key]):
                    counts[i] += c
            out[key] = counts
            out[f"{name}_sum"] = sum(p[f"{name}_sum"] for p in parts)
            out[f"{name}_count"] = sum(p[f"{name}_count"] for p in parts)
        return out
