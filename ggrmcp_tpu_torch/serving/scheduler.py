"""Preemptive SLO-aware scheduler: QoS priority + VTC fair share +
demote-don't-kill preemption.

The admission path today is FCFS: one tenant's batch burst starves
every interactive caller equally, and overload degrades by 429ing.
This module puts a scheduler in front of the batcher's admission pop:

- **SchedulerQueue** — a drop-in replacement for the batcher's
  `_PendingQueue` (same interface, same single-consumer event
  discipline) that orders the backlog by QoS class priority
  (interactive > batch > background, per `scheduler.classes`) and,
  inside each class, by per-tenant VTC fair share: the tenant with the
  SMALLEST normalized weighted-token share (`TenantTable.shares()`)
  pops first — the fairness metric of Sheng et al.'s Virtual Token
  Counter (OSDI 2024), consumed live instead of merely exported.
  Replays keep their absolute head-of-line privilege (a tick-failure
  victim was already admitted once), and preempted requests resume
  ahead of their class's fresh arrivals (their KV investment is
  parked, not burned).

- **Scheduler** — the policy object the batcher loop consults once per
  cycle: *should the head waiter preempt, and whom?* Triggered when a
  higher class's head-of-line wait crosses a fraction of its TTFT
  objective, or when its fast-window burn rate (`SloAccount`) says the
  objective is about to breach. Victims are the lowest-priority active
  slots, heaviest VTC share first — preempting the tenant that has
  already consumed the most capacity is the fairness-preserving
  choice. Preemption itself (KV demote to the host tier, adapter lease
  release, slot park) is the batcher's job; this object only decides.

- **retry_after_for** — the per-class 429 backoff ladder. Background
  sheds back off geometrically longer than interactive ones, so the
  retry storm cooperates with the scheduler's priority order instead
  of fighting it. Derived from config alone: works even with the
  scheduler disabled.

Everything here is event-loop-thread state (like `_PendingQueue`); the
only cross-thread reads are `TenantTable.shares()` / `SloAccount`
burn-rate, which take their own locks.
"""

from __future__ import annotations

import asyncio
import time
from collections import OrderedDict, deque
from typing import Iterable, Optional


def retry_after_for(cfg, qos_class: str) -> float:
    """Per-QoS-class Retry-After (seconds): `base * factor**priority`,
    where priority 0 is the first (most latency-sensitive) class in
    `scheduler.classes`. Unknown/empty class names get the LAST
    class's (longest) backoff — an unlabeled caller is by definition
    not latency-sensitive. Falls back to the flat 1 s contract when no
    scheduler config exists at all (old callers, partial test rigs).
    """
    if cfg is None:
        return 1.0
    classes = list(getattr(cfg, "classes", ())) or ["interactive"]
    try:
        idx = classes.index(qos_class)
    except ValueError:
        idx = len(classes) - 1
    base = float(getattr(cfg, "retry_after_base_s", 1.0))
    factor = float(getattr(cfg, "retry_after_factor", 2.0))
    return base * (factor ** idx)


class SchedulerQueue:
    """Priority + fair-share admission queue, interface-compatible with
    the batcher's `_PendingQueue` (put_nowait / requeue_front /
    get_nowait / get / qsize / empty / token_count), so the batcher
    swaps it in when `scheduler.enabled` without touching the admission
    loop's control flow.

    Lane structure, in pop order:

    1. a global FRONT deque — tick-failure replays (`requeue_front`).
       Already-admitted work must never wait behind the backlog,
       whatever its class: this preserves the replay discipline's
       bit-identity guarantee verbatim.
    2. per class, in priority order:
       a. the class's RESUME deque — preempted requests parked by the
          batcher. They re-enter ahead of fresh arrivals of the same
          class (their demoted KV is waiting on the host tier).
       b. the class's fair-share lanes: OrderedDict[tenant, deque].
          Pop picks the tenant with the minimum VTC share from a
          TTL-cached `TenantTable.shares()` snapshot (unknown tenant
          == share 0.0 == most favored: a brand-new tenant has
          consumed nothing). Ties break by lane age (first-arrived
          tenant first) so ordering is deterministic for tests.

    `put_nowait` routes by request state: currently `parked` → resume
    lane, `retries > 0` → front (the expiry sweep drains and re-puts
    via put_nowait; a replay must not lose its privilege in the
    round-trip — and a RESUMED request that later tick-fails is a
    replay again, which is why routing keys on the live `parked` flag,
    not the cumulative preempt count), else class/tenant lane.
    Requests whose class is not in `scheduler.classes` schedule at the
    LAST class's priority.
    """

    def __init__(self, cfg, tenants=None) -> None:
        self.cfg = cfg
        self.tenants = tenants  # TenantTable or None
        self.classes: list = list(getattr(cfg, "classes", ())) or [
            "interactive"
        ]
        self._front: deque = deque()
        self._resume: dict = {name: deque() for name in self.classes}
        self._lanes: dict = {
            name: OrderedDict() for name in self.classes
        }
        self._count = 0
        self._tokens = 0
        self._event = asyncio.Event()
        # TTL-cached shares snapshot: one lock-held dict copy per
        # `shares_ttl_s`, not per pop — fairness needs freshness on the
        # order of a scheduling epoch, not a mutex per token.
        self._shares: dict = {}
        self._shares_at = float("-inf")
        self._shares_ttl = float(getattr(cfg, "shares_ttl_s", 0.05))

    # -- routing ------------------------------------------------------------

    def _class_of(self, request) -> str:
        qos = getattr(request, "qos_class", "") or ""
        return qos if qos in self._lanes else self.classes[-1]

    def _tenant_of(self, request) -> str:
        # Same defaulting as TenantTable, so the shares lookup hits the
        # row the accounting actually wrote.
        return getattr(request, "tenant", "") or "default"

    def put_nowait(self, request) -> None:
        if getattr(request, "parked", False):
            self._resume[self._class_of(request)].append(request)
        elif getattr(request, "retries", 0) > 0:
            self._front.append(request)
        else:
            lanes = self._lanes[self._class_of(request)]
            tenant = self._tenant_of(request)
            lane = lanes.get(tenant)
            if lane is None:
                lane = lanes[tenant] = deque()
            lane.append(request)
        self._count += 1
        self._tokens += len(request.prompt)
        self._event.set()

    def requeue_front(self, request) -> None:
        """Head-of-queue insert for replayed requests: they were
        already admitted once and must not wait behind the backlog
        (or shed — replays bypass the caps by design)."""
        self._front.appendleft(request)
        self._count += 1
        self._tokens += len(request.prompt)
        self._event.set()

    def park_preempted(self, request) -> None:
        """Park a preempted request at the head of its class's resume
        lane: among preempted peers, most-recently-victimized resumes
        first (its host-tier pages are hottest)."""
        self._resume[self._class_of(request)].appendleft(request)
        self._count += 1
        self._tokens += len(request.prompt)
        self._event.set()

    # -- fair-share pick ----------------------------------------------------

    def _shares_snapshot(self) -> dict:
        if self.tenants is None:
            return {}
        now = time.monotonic()
        if now - self._shares_at >= self._shares_ttl:
            self._shares = self.tenants.shares()
            self._shares_at = now
        return self._shares

    def _pop(self):
        if self._front:
            request = self._front.popleft()
        else:
            request = None
            for name in self.classes:
                resume = self._resume[name]
                if resume:
                    request = resume.popleft()
                    break
                lanes = self._lanes[name]
                if not lanes:
                    continue
                shares = self._shares_snapshot()
                # Min share wins; enumerate index (lane age) breaks
                # ties deterministically in first-arrival order.
                tenant = min(
                    (
                        (shares.get(t, 0.0), i, t)
                        for i, t in enumerate(lanes)
                    )
                )[2]
                lane = lanes[tenant]
                request = lane.popleft()
                if not lane:
                    del lanes[tenant]
                break
            if request is None:  # pragma: no cover — guarded by callers
                raise asyncio.QueueEmpty
        self._count -= 1
        self._tokens -= len(request.prompt)
        return request

    # -- _PendingQueue interface --------------------------------------------

    def get_nowait(self):
        if not self._count:
            raise asyncio.QueueEmpty
        return self._pop()

    async def get(self):
        # Single-consumer wait: no await between the emptiness check
        # and clear(), so a concurrent put's set() cannot be lost.
        while not self._count:
            self._event.clear()
            await self._event.wait()
        return self._pop()

    def qsize(self) -> int:
        return self._count

    def empty(self) -> bool:
        return not self._count

    @property
    def token_count(self) -> int:
        return self._tokens

    # -- scheduler introspection --------------------------------------------

    def head_waiter(self) -> Optional[tuple]:
        """(qos_class, wait_s) of the highest-priority waiting request,
        or None. Replays in the front lane are excluded: a tick-failure
        victim re-enters freed slots on the next admission anyway, and
        letting it trigger preemption would preempt to make room for
        capacity that already exists. Within a class the OLDEST head
        across resume + tenant lanes is the waiter (preemption keys on
        worst-case wait, not on whichever lane pops next)."""
        now = time.perf_counter()
        for name in self.classes:
            heads = []
            resume = self._resume[name]
            if resume:
                heads.append(resume[0])
            for lane in self._lanes[name].values():
                if lane:
                    heads.append(lane[0])
            if heads:
                oldest = min(heads, key=lambda r: r.t_submit)
                return (name, now - oldest.t_submit)
        return None

    def parked_count(self) -> int:
        """Requests currently demoted-and-parked (the sched_parked
        gauge: every entry holds host-tier KV waiting on one batched
        H2D restore)."""
        return sum(len(lane) for lane in self._resume.values())

    def class_depths(self) -> dict:
        """Queued request count per class (resume + fair lanes; front
        replays excluded) — debug/metrics surface."""
        out = {}
        for name in self.classes:
            n = len(self._resume[name])
            n += sum(len(lane) for lane in self._lanes[name].values())
            out[name] = n
        return out


class Scheduler:
    """The preemption policy + counters. Owns no queue and touches no
    slot: the batcher loop asks `should_preempt(...)` once per cycle
    and `victims(...)` for the demote list; the mechanics (KV demote,
    lease release, slot park, replay fold) stay in the batcher where
    the serialized-executor discipline lives. Counters are plain ints
    read by `counter_stats()` under the same single-writer rules as
    the batcher's own."""

    def __init__(self, cfg, slo=None, tenants=None) -> None:
        self.cfg = cfg
        self.slo = slo  # SloAccount or None
        self.tenants = tenants  # TenantTable or None
        self.classes: list = list(getattr(cfg, "classes", ())) or [
            "interactive"
        ]
        # Counters (proto: sched_*). preemptions/resumes are a cycle:
        # steady state has resumes == preemptions - currently-parked
        # (the parked gauge is read live off the queue's resume lanes,
        # never double-entry bookkept here — a parked request that dies
        # in queue must not strand the gauge).
        self.preemptions = 0  # slots demoted + parked
        self.resumes = 0  # parked requests re-activated
        self.preempt_failures = 0  # preempt op failed (typed, victim unharmed)
        self.budget_deferrals = 0  # admissions deferred by prefill budget

    def _priority(self, qos_class: str) -> int:
        try:
            return self.classes.index(qos_class)
        except ValueError:
            return len(self.classes) - 1

    def should_preempt(self, waiter_class: str, wait_s: float) -> bool:
        """Preempt when the head waiter's class is (a) already waiting
        a configured fraction of its own TTFT objective — the
        deterministic trigger, independent of traffic history — or (b)
        burning its error budget faster than `preempt_burn_threshold`
        on the fastest window — the early-warning trigger. A class
        with no TTFT target (slo disabled / target 0) can only trigger
        via burn."""
        if not self.cfg.preemption:
            return False
        if self._priority(waiter_class) >= len(self.classes) - 1:
            # The lowest class never preempts: there is nobody below
            # it to demote.
            return False
        if self.slo is not None:
            target_ms = self.slo.ttft_target_ms(waiter_class)
            if target_ms > 0 and wait_s * 1000.0 >= (
                self.cfg.preempt_wait_fraction * target_ms
            ):
                return True
            if (
                self.slo.burn_rate(waiter_class)
                >= self.cfg.preempt_burn_threshold
            ):
                return True
        return False

    def victims(
        self,
        waiter_class: str,
        active: Iterable[tuple],
    ) -> list[int]:
        """Pick up to `max_preempts_per_turn` victim slots for one
        waiter. `active` is an iterable of (slot_idx, qos_class,
        tenant) for every active decoding slot. Eligible victims run
        STRICTLY below the waiter's class; among them, lowest class
        first, then largest VTC share (the tenant that has consumed
        the most yields first — fairness-preserving), then highest
        slot index (arbitrary but deterministic)."""
        limit = int(self.cfg.max_preempts_per_turn)
        if limit <= 0:
            return []
        wi = self._priority(waiter_class)
        shares = self.tenants.shares() if self.tenants is not None else {}
        cand = [
            (pi, shares.get(tenant or "default", 0.0), idx)
            for idx, qos, tenant in active
            if (pi := self._priority(qos)) > wi
        ]
        cand.sort(key=lambda c: (-c[0], -c[1], -c[2]))
        return [idx for _, _, idx in cand[:limit]]

    def counter_stats(self, parked: int = 0) -> dict:
        """ServingStats scalar fragment (summable across tiers).
        `parked` is the live queue gauge (SchedulerQueue.parked_count)
        — the queue owns it, this object only exports it."""
        return {
            "sched_preemptions": self.preemptions,
            "sched_resumes": self.resumes,
            "sched_preempt_failures": self.preempt_failures,
            "sched_parked": parked,
            "sched_budget_deferrals": self.budget_deferrals,
        }
