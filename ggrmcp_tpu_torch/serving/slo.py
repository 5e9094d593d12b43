"""Tenant & SLO accounting plane: per-class latency objectives,
per-tenant token attribution, goodput and burn-rate surfaces.

The measurement substrate for SLO-aware scheduling (ROADMAP item 2,
docs/observability.md "SLO accounting"). Two ledgers, both fed from the
batcher's terminal-chunk hook (the same place the flight recorder's
request ring is written):

- SloAccount: per-QoS-class goodput in DistServe's sense (Zhong et
  al., OSDI'24) — a request counts as `met` only when it finished
  normally within BOTH its class's TTFT and TPOT p99 targets. Every
  terminal event lands in exactly one of met/violated/unevaluated, so
  the three partition total_requests EXACTLY per class — the same
  closure discipline (tick phases sum to tick duration, memory
  components sum to live bytes) applied to conformance counting.
  Beside the partition: per-class TTFT/TPOT/e2e histograms (same
  bounds as the top-level latency histograms, so one dashboard
  vocabulary) and an SRE-style multi-window burn rate (violation rate
  over a trailing window / the 0.01 error budget a p99 objective
  implies — fast window pages, slow window confirms).

- TenantTable: S-LoRA/VTC-style virtual token counters per tenant —
  weighted prompt+decode service totals plus admission/shed/queue-wait
  tallies. Cardinality-bounded: at most `slo.tenant_top_k` tracked
  tenants; admitting a new tenant beyond the bound folds the
  least-recently-active one into the explicit OVERFLOW_TENANT bucket,
  so counters CONSERVE across eviction while label growth never
  exceeds the bound (never unbounded label growth — the Prometheus
  cardinality lesson applied before the first incident, though the
  per-tenant axis is deliberately exported on /debug/slo only, not as
  metric labels).

Classification is pure measurement: an unknown/empty qos_class falls
back to `slo.default_class` and an unknown tenant is simply a new
ledger row — the accounting plane never rejects or reorders a request.
Disabled (serving.slo.enabled=false or observability off), every hook
is one attribute check and stats() returns nothing.

Threading: hooks run from the batcher's serialized executor calls and
the event loop (queue-side terminal events), like the flight
recorder's; increments take the same micro-lock discipline and stats()
snapshots under it.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Optional

from ggrmcp_tpu_torch.core.config import (
    LATENCY_BUCKET_BOUNDS_MS,
    DEFAULT_SLO_CLASSES,
    SloConfig,
)
from ggrmcp_tpu_torch.serving.flight_recorder import LatencyHistogram

# A p99 objective leaves a 1% error budget: burn rate 1.0 = violating
# at exactly the sustainable rate, >1 = eating budget faster than the
# objective allows (Google SRE workbook ch. 5).
ERROR_BUDGET = 0.01

# The eviction fold bucket: tenants LRU-evicted from the bounded table
# merge their counters here. '~' sorts after every sane tenant id and
# is invalid in most naming schemes — collisions with a real tenant
# would merely merge ledgers, never crash.
OVERFLOW_TENANT = "~overflow"

# Terminal reasons that mean the request finished normally — the only
# outcomes eligible for `met`. Everything else that happened AFTER
# admission (timeout, error, cancelled, overloaded replay-exhaustion)
# is a violation: service was attempted and the tenant did not get a
# good answer within any target.
NORMAL_FINISHES = frozenset(
    {"stop", "length", "stop_string", "grammar_complete"}
)


def windowed_delta(prev, cur) -> Optional[list]:
    """Element-wise delta between two CUMULATIVE counter vectors, with
    counter-regression reset: returns None when `prev` is unusable —
    missing, a different shape (bucket-bound config change), or any
    counter went backwards (process restart) — and the caller must
    re-baseline instead of reporting a garbage negative delta. The
    windowed-histogram discipline shared by fleet.py's TtftWindow and
    the burn-rate computation here."""
    if prev is None or len(prev) != len(cur):
        return None
    if any(c < p for c, p in zip(cur, prev)):
        return None
    return [c - p for c, p in zip(cur, prev)]


class _ClassAccount:
    """One QoS class's ledger: the goodput partition, the latency
    histogram triplet, and the burn-rate snapshot ring."""

    __slots__ = (
        "name", "ttft_target_ms", "tpot_target_ms",
        "met", "violated", "unevaluated", "sheds",
        "ttft", "tpot", "e2e", "ring",
    )

    def __init__(self, name, ttft_target_ms, tpot_target_ms, bounds):
        self.name = name
        self.ttft_target_ms = float(ttft_target_ms)
        self.tpot_target_ms = float(tpot_target_ms)
        self.met = 0
        self.violated = 0
        self.unevaluated = 0
        # Submit-time sheds, per class (a SUBSET of unevaluated): the
        # 429 path's class breakdown, so "who absorbs the damage under
        # overload" is a counter, not an inference.
        self.sheds = 0
        self.ttft = LatencyHistogram(bounds)
        self.tpot = LatencyHistogram(bounds)
        self.e2e = LatencyHistogram(bounds)
        # (t_mono, violated_cum, total_cum) snapshots, ~1 s coalesced,
        # pruned past the longest burn window — the baseline store the
        # windowed burn deltas are taken against.
        self.ring: deque = deque()

    @property
    def total(self) -> int:
        return self.met + self.violated + self.unevaluated

    def window_delta(self, now: float, window_s: float):
        """(violated_delta, total_delta) over the trailing window:
        current cumulative counters minus the latest snapshot at or
        before the window start. No snapshot that old means every
        recorded event is inside the window — baseline (0, 0)."""
        v0 = t0 = 0
        for t, v, tot in reversed(self.ring):
            if t <= now - window_s:
                v0, t0 = v, tot
                break
        d = windowed_delta([v0, t0], [self.violated, self.total])
        return (d[0], d[1]) if d else (0, 0)


class SloAccount:
    """Per-batcher SLO ledger over the configured QoS classes. Every
    configured class is exported on every stats() call (zero-traffic
    classes export zeros) so the label set downstream is stable."""

    def __init__(
        self,
        cfg: Optional[SloConfig] = None,
        obs_enabled: bool = True,
        bounds=None,
        clock=time.monotonic,
    ):
        cfg = cfg or SloConfig()
        # Obs-off wins: the terminal hook this plane rides lives in the
        # flight-recorder path, and "observability off" must mean no
        # storage and no computation anywhere (the recorder's contract).
        self.enabled = bool(cfg.enabled) and bool(obs_enabled)
        self.default_class = str(cfg.default_class)
        self.windows = tuple(float(w) for w in cfg.burn_windows_s)
        self._max_window = max(self.windows) if self.windows else 0.0
        self._clock = clock
        self._lock = threading.Lock()
        bounds = tuple(
            float(b)
            for b in (bounds if bounds is not None else LATENCY_BUCKET_BOUNDS_MS)
        )
        classes = cfg.classes or DEFAULT_SLO_CLASSES
        self.classes = {
            str(name): _ClassAccount(
                str(name),
                float(targets.get("ttft_p99_ms", 0) or 0),
                float(targets.get("tpot_p99_ms", 0) or 0),
                bounds,
            )
            for name, targets in classes.items()
        }
        if self.default_class not in self.classes:
            # Config.validate() enforces membership; direct construction
            # (tests, library use) gets the first class instead of a
            # KeyError on the hot path.
            self.default_class = next(iter(self.classes))

    # -- classification -----------------------------------------------------

    def resolve(self, qos_class: str) -> str:
        """Unknown/empty class names degrade to the default class —
        measurement never rejects a request."""
        return qos_class if qos_class in self.classes else self.default_class

    def record_terminal(
        self,
        qos_class: str,
        finish_reason: str,
        *,
        admitted: bool,
        ttft_ms: Optional[float] = None,
        tpot_ms: Optional[float] = None,
        e2e_ms: float = 0.0,
    ) -> str:
        """Classify one terminal event into the goodput partition and
        observe its latencies into the class histograms. Returns the
        partition the event landed in ("met"/"violated"/"unevaluated";
        "" when disabled) so the caller can stamp the request record.

        - never admitted (no activation stamp — submit-time shed or a
          queue death): `unevaluated`. There is no latency to judge; a
          queue-death must not pollute the class TTFT distribution any
          more than the top-level one (flight_recorder discipline).
        - admitted, finished normally: `met` iff TTFT and TPOT are both
          within the class targets (TPOT only judged when a decode
          interval exists, i.e. >= 2 tokens).
        - admitted, died (timeout/error/cancelled/overloaded):
          `violated` — typed, never silently dropped from the total.
        """
        if not self.enabled:
            return ""
        c = self.classes[self.resolve(qos_class)]
        with self._lock:
            if not admitted:
                c.unevaluated += 1
                outcome = "unevaluated"
            else:
                if ttft_ms is not None:
                    c.ttft.observe(ttft_ms)
                if tpot_ms is not None:
                    c.tpot.observe(tpot_ms)
                c.e2e.observe(e2e_ms)
                if finish_reason in NORMAL_FINISHES and (
                    ttft_ms is None or ttft_ms <= c.ttft_target_ms
                ) and (tpot_ms is None or tpot_ms <= c.tpot_target_ms):
                    c.met += 1
                    outcome = "met"
                else:
                    c.violated += 1
                    outcome = "violated"
            self._stamp(c)
        return outcome

    def record_shed(self, qos_class: str) -> None:
        """Submit-time shed (OverloadedError raised before the request
        object exists): one `unevaluated` — the shed request still
        counts toward its class total, typed, never dropped."""
        if not self.enabled:
            return
        c = self.classes[self.resolve(qos_class)]
        with self._lock:
            c.unevaluated += 1
            c.sheds += 1
            self._stamp(c)

    def uncount_shed(self, qos_class: str) -> None:
        """Reverse one record_shed: the tiered facade's overflow probe
        — a small tier's refusal that a larger sibling absorbed is not
        a caller-visible shed, and the same un-count the facade applies
        to tier.shed keeps the class totals equal to requests actually
        refused (the eventual terminal event lands in the absorbing
        tier's ledger)."""
        if not self.enabled:
            return
        c = self.classes[self.resolve(qos_class)]
        with self._lock:
            if c.unevaluated > 0:
                c.unevaluated -= 1
            if c.sheds > 0:
                c.sheds -= 1
            self._stamp(c)

    # -- scheduler read API -------------------------------------------------

    def burn_rate(self, qos_class: str, window_s: Optional[float] = None) -> float:
        """Current burn rate for one class over one window (default:
        the FASTEST configured window — the scheduler wants the
        early-warning signal, not the long-term trend). 0.0 when
        disabled or when the window holds no baseline yet, so callers
        can compare against a threshold without None-guards."""
        if not self.enabled or not self.windows:
            return 0.0
        w = float(window_s) if window_s is not None else min(self.windows)
        c = self.classes[self.resolve(qos_class)]
        now = self._clock()
        with self._lock:
            dv, dt = c.window_delta(now, w)
        return (dv / dt) / ERROR_BUDGET if dt > 0 else 0.0

    def ttft_target_ms(self, qos_class: str) -> float:
        """The class's TTFT objective (ms) — the scheduler's head-wait
        yardstick. 0.0 when disabled (callers treat 0 as 'no target')."""
        if not self.enabled:
            return 0.0
        return float(self.classes[self.resolve(qos_class)].ttft_target_ms)

    def _stamp(self, c: _ClassAccount) -> None:
        """Append/refresh the burn baseline ring (lock held). ~1 s
        coalescing bounds the ring at ~max_window entries; pruning
        keeps ONE snapshot at/before the window edge as the baseline."""
        now = self._clock()
        if c.ring and now - c.ring[-1][0] < 1.0:
            c.ring[-1] = (c.ring[-1][0], c.violated, c.total)
        else:
            c.ring.append((now, c.violated, c.total))
        cutoff = now - self._max_window
        while len(c.ring) >= 2 and c.ring[1][0] <= cutoff:
            c.ring.popleft()

    # -- export -------------------------------------------------------------

    def stats(self) -> dict:
        """ServingStats fragment: the repeated slo_classes entries
        (proto field names, ready for ServingStatsResponse(**stats))
        plus the scalar cross-class totals. Empty when disabled —
        stores and computes nothing."""
        if not self.enabled:
            return {}
        now = self._clock()
        entries = []
        met_total = violated_total = uneval_total = 0
        with self._lock:
            for name in sorted(self.classes):
                c = self.classes[name]
                burns = []
                for w in self.windows:
                    dv, dt = c.window_delta(now, w)
                    burns.append(
                        (dv / dt) / ERROR_BUDGET if dt > 0 else 0.0
                    )
                entries.append({
                    "name": c.name,
                    "ttft_p99_target_ms": c.ttft_target_ms,
                    "tpot_p99_target_ms": c.tpot_target_ms,
                    "met": c.met,
                    "violated": c.violated,
                    "unevaluated": c.unevaluated,
                    "sheds": c.sheds,
                    "total_requests": c.total,
                    "ttft_ms_bucket": list(c.ttft.counts),
                    "ttft_ms_sum": c.ttft.sum,
                    "ttft_ms_count": c.ttft.total,
                    "tpot_ms_bucket": list(c.tpot.counts),
                    "tpot_ms_sum": c.tpot.sum,
                    "tpot_ms_count": c.tpot.total,
                    "e2e_ms_bucket": list(c.e2e.counts),
                    "e2e_ms_sum": c.e2e.sum,
                    "e2e_ms_count": c.e2e.total,
                    "burn_window_s": list(self.windows),
                    "burn_rate": burns,
                })
                met_total += c.met
                violated_total += c.violated
                uneval_total += c.unevaluated
        return {
            "slo_classes": entries,
            "slo_met_total": met_total,
            "slo_violated_total": violated_total,
            "slo_unevaluated_total": uneval_total,
        }

    @staticmethod
    def merged_stats(accounts: list) -> dict:
        """Aggregate several per-tier accounts (the tiered facade):
        partition counters and histogram buckets sum elementwise per
        class; burn rates recombine EXACTLY by summing each account's
        per-window (violated, total) deltas before dividing — a
        weighted merge, not an average of rates (averaging would let a
        quiet tier dilute a burning one)."""
        accounts = [a for a in accounts if a is not None and a.enabled]
        if not accounts:
            return {}
        parts = [a.stats() for a in accounts]
        now = [a._clock() for a in accounts]
        merged: dict = {}
        order: list = []
        for part in parts:
            for entry in part["slo_classes"]:
                name = entry["name"]
                if name not in merged:
                    merged[name] = {
                        k: (list(v) if isinstance(v, list) else v)
                        for k, v in entry.items()
                    }
                    order.append(name)
                    continue
                m = merged[name]
                for key in ("met", "violated", "unevaluated", "sheds",
                            "total_requests", "ttft_ms_sum",
                            "ttft_ms_count", "tpot_ms_sum",
                            "tpot_ms_count", "e2e_ms_sum",
                            "e2e_ms_count"):
                    m[key] += entry[key]
                for key in ("ttft_ms_bucket", "tpot_ms_bucket",
                            "e2e_ms_bucket"):
                    if len(m[key]) == len(entry[key]):
                        m[key] = [
                            a + b for a, b in zip(m[key], entry[key])
                        ]
        # Exact burn recombination from per-account window deltas.
        windows = accounts[0].windows
        for name in order:
            burns = []
            for w in windows:
                dv = dt = 0
                for a, t in zip(accounts, now):
                    c = a.classes.get(name)
                    if c is None:
                        continue
                    with a._lock:
                        adv, adt = c.window_delta(t, w)
                    dv += adv
                    dt += adt
                burns.append((dv / dt) / ERROR_BUDGET if dt > 0 else 0.0)
            merged[name]["burn_window_s"] = list(windows)
            merged[name]["burn_rate"] = burns
        return {
            "slo_classes": [merged[name] for name in order],
            "slo_met_total": sum(p["slo_met_total"] for p in parts),
            "slo_violated_total": sum(
                p["slo_violated_total"] for p in parts
            ),
            "slo_unevaluated_total": sum(
                p["slo_unevaluated_total"] for p in parts
            ),
        }


class _Tenant:
    """One tenant's VTC ledger row."""

    __slots__ = (
        "prompt_tokens", "decode_tokens", "weighted_tokens",
        "admitted", "shed", "finished", "queue_ms_sum", "requests",
    )

    def __init__(self):
        self.prompt_tokens = 0
        self.decode_tokens = 0
        self.weighted_tokens = 0.0
        self.admitted = 0
        self.shed = 0
        self.finished = 0
        self.queue_ms_sum = 0.0
        self.requests = 0

    def fold_into(self, other: "_Tenant") -> None:
        other.prompt_tokens += self.prompt_tokens
        other.decode_tokens += self.decode_tokens
        other.weighted_tokens += self.weighted_tokens
        other.admitted += self.admitted
        other.shed += self.shed
        other.finished += self.finished
        other.queue_ms_sum += self.queue_ms_sum
        other.requests += self.requests


class TenantTable:
    """Cardinality-bounded per-tenant VTC accounting (S-LoRA/VTC
    fairness counters): at most `top_k` tracked tenants in an LRU
    OrderedDict; a new tenant beyond the bound evicts the
    least-recently-ACTIVE one by folding its counters into the
    OVERFLOW_TENANT row — conservation, never loss. The overflow row
    lives outside the LRU (it can never be evicted into itself)."""

    def __init__(
        self,
        cfg: Optional[SloConfig] = None,
        enabled: bool = True,
    ):
        cfg = cfg or SloConfig()
        self.enabled = bool(enabled) and bool(cfg.enabled)
        self.top_k = max(1, int(cfg.tenant_top_k))
        self.prompt_weight = float(cfg.vtc_prompt_weight)
        self.decode_weight = float(cfg.vtc_decode_weight)
        self.evictions = 0
        self._lock = threading.Lock()
        self._rows: OrderedDict = OrderedDict()
        self._overflow = _Tenant()

    def _row(self, tenant: str) -> _Tenant:
        """LRU-touch the tenant's row, evicting into overflow at the
        bound (lock held)."""
        if tenant == OVERFLOW_TENANT:
            return self._overflow
        row = self._rows.get(tenant)
        if row is not None:
            self._rows.move_to_end(tenant)
            return row
        while len(self._rows) >= self.top_k:
            _, victim = self._rows.popitem(last=False)
            victim.fold_into(self._overflow)
            self.evictions += 1
        row = _Tenant()
        self._rows[tenant] = row
        return row

    # -- batcher hooks ------------------------------------------------------

    def record_terminal(
        self,
        tenant: str,
        *,
        admitted: bool,
        prompt_tokens: int = 0,
        decode_tokens: int = 0,
        queue_ms: float = 0.0,
    ) -> None:
        """One terminal chunk: token attribution (prompt tokens only
        when the request was actually prefilled) + lifecycle tallies."""
        if not self.enabled:
            return
        with self._lock:
            row = self._row(tenant or "default")
            row.requests += 1
            row.finished += 1
            if admitted:
                row.admitted += 1
                row.prompt_tokens += int(prompt_tokens)
                row.queue_ms_sum += float(queue_ms)
            row.decode_tokens += int(decode_tokens)
            row.weighted_tokens += (
                self.prompt_weight * (int(prompt_tokens) if admitted else 0)
                + self.decode_weight * int(decode_tokens)
            )

    def record_shed(self, tenant: str) -> None:
        if not self.enabled:
            return
        with self._lock:
            row = self._row(tenant or "default")
            row.requests += 1
            row.shed += 1

    def uncount_shed(self, tenant: str) -> None:
        """Reverse one record_shed (tiered overflow probe — see
        SloAccount.uncount_shed)."""
        if not self.enabled:
            return
        with self._lock:
            row = self._row(tenant or "default")
            if row.requests > 0:
                row.requests -= 1
            if row.shed > 0:
                row.shed -= 1

    # -- scheduler read API -------------------------------------------------

    def shares(self) -> dict:
        """Normalized VTC share per tenant (weighted tokens / grand
        total), `~overflow` included when it has absorbed anything.
        Shares sum to 1.0 whenever any weighted tokens exist (all-zero
        table → all-zero shares), so the scheduler's fair-share order
        conserves exactly what the accounting conserves. Cheap: one
        lock hold to snapshot, arithmetic outside it. Empty dict when
        disabled — the scheduler degrades to per-class FIFO."""
        if not self.enabled:
            return {}
        with self._lock:
            entries = [
                (name, row.weighted_tokens)
                for name, row in self._rows.items()
            ]
            if self._overflow.requests or self._overflow.weighted_tokens:
                entries.append(
                    (OVERFLOW_TENANT, self._overflow.weighted_tokens)
                )
        total = sum(w for _, w in entries)
        if total <= 0:
            return {name: 0.0 for name, _ in entries}
        return {name: w / total for name, w in entries}

    # -- export -------------------------------------------------------------

    def stats(self) -> dict:
        """ServingStats fragment: the repeated tenants entries (proto
        field names; heaviest first by weighted tokens, overflow last)
        + occupancy/eviction scalars. Empty when disabled."""
        if not self.enabled:
            return {}
        with self._lock:
            rows = [
                (name, _tenant_dict(name, row))
                for name, row in self._rows.items()
            ]
            tracked = len(self._rows)
            evictions = self.evictions
            overflow = (
                _tenant_dict(OVERFLOW_TENANT, self._overflow)
                if self._overflow.requests else None
            )
        rows.sort(key=lambda kv: (-kv[1]["weighted_tokens"], kv[0]))
        tenants = [d for _, d in rows]
        if overflow is not None:
            tenants.append(overflow)
        return {
            "tenants": tenants,
            "slo_tenants_tracked": tracked,
            "slo_tenant_evictions": evictions,
        }

    @staticmethod
    def merged_stats(tables: list, top_k: Optional[int] = None) -> dict:
        """Aggregate several per-tier tables: counters sum by tenant
        id. The merged view re-applies the cardinality bound (smallest
        weighted rows fold into overflow) so the export never exceeds
        top_k + 1 entries regardless of tier count."""
        tables = [t for t in tables if t is not None and t.enabled]
        if not tables:
            return {}
        if top_k is None:
            top_k = max(t.top_k for t in tables)
        merged: dict = {}
        evictions = 0
        for t in tables:
            part = t.stats()
            evictions += part["slo_tenant_evictions"]
            for entry in part["tenants"]:
                cur = merged.get(entry["tenant"])
                if cur is None:
                    merged[entry["tenant"]] = dict(entry)
                else:
                    for key, val in entry.items():
                        if key != "tenant":
                            cur[key] += val
        overflow = merged.pop(OVERFLOW_TENANT, None)
        rows = sorted(
            merged.values(),
            key=lambda d: (-d["weighted_tokens"], d["tenant"]),
        )
        if len(rows) > top_k:
            if overflow is None:
                overflow = _tenant_dict(OVERFLOW_TENANT, _Tenant())
            for entry in rows[top_k:]:
                for key, val in entry.items():
                    if key != "tenant":
                        overflow[key] += val
            rows = rows[:top_k]
        if overflow is not None:
            rows.append(overflow)
        return {
            "tenants": rows,
            "slo_tenants_tracked": len(merged),
            "slo_tenant_evictions": evictions,
        }


def _tenant_dict(name: str, row: _Tenant) -> dict:
    return {
        "tenant": name,
        "prompt_tokens": row.prompt_tokens,
        "decode_tokens": row.decode_tokens,
        "weighted_tokens": row.weighted_tokens,
        "admitted": row.admitted,
        "shed": row.shed,
        "finished": row.finished,
        "queue_ms_sum": row.queue_ms_sum,
        "requests": row.requests,
    }
