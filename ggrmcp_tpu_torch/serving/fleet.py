"""Self-healing elastic fleet: the supervised control loop over replica
child processes (ROADMAP item 5, docs/fleet.md).

Everything below closes the observe→decide→act loop that earlier work
left open: routing reads per-replica load, drain is graceful, roles
flip via drain→restart→rediscover, shed/429 is typed — but nothing ever
*acted* on any of it. The `FleetSupervisor` here does, supervisor-tree
style (Erlang/OTP's restart-with-backoff discipline):

  observe  the non-blocking ServingStats snapshot + per-replica
           health/liveness probes (process poll + gRPC health), plus
           gateway signals: shed-counter rises, windowed TTFT p99 vs
           `fleet.slo_ttft_p99_ms`, queue depth.
  decide   typed, hysteresis-gated policies — scale-up on sustained
           shed/SLO pressure, drain+retire on sustained idle, and
           *heal*: a replica whose health flaps past
           `fleet.flap_threshold` or whose process exits is drained
           (when the pool floor allows), killed, and restarted with
           exponential backoff + jitter — all under a max-churn budget
           (`fleet.max_actions_per_window`) so the supervisor provably
           cannot flap itself. Every decision is a typed `FleetAction`
           with a reason; nothing is an implicit side effect.
  act      spawn/drain/undrain/kill/restart through the existing
           /admin/drain + discovery machinery (ServiceDiscoverer
           add_backend/remove_backend/set_draining), with role
           re-stamping on restart (rediscovery re-reads serving.role)
           so prefill/decode fleets heal too.

Two hard invariants, both enforced in decide() and property-tested
(tests/test_fleet.py):

  * the pool NEVER drains below `fleet.min_replicas` — including
    during heal actions (a flapping last replica restarts in place,
    un-drained, instead of draining the pool empty); and
  * no signal sequence can produce more state-changing actions per
    `fleet.action_window_s` than `fleet.max_actions_per_window`
    (floor-restoring spawns are the one deliberate exception — an
    empty pool is worse than a churny one, and they are counted).

The supervisor is deterministic and framework-free: decide() is a pure
function of the observed signals, an injected clock, and a seeded RNG
(jitter); the asyncio run loop just drives run_once() on
`fleet.decide_interval_s`. `pause()`/`resume()` (POST /admin/fleet)
freeze decisions without losing observation state.

Replica child processes are spawned via `ProcessReplicaFactory` — by
default `python -m ggrmcp_tpu_torch.serving.fleet`, the sidecar worker in
this module (prints ``TARGET=<target>`` once serving, then blocks until
killed; knobs ride GGRMCP_FLEET_WORKER_* env vars). Chaos drills SIGKILL
these real processes (tests/test_fleet.py, GGRMCP_BENCH_FLEET) — the
failpoint registry (`replica_crash`, `health_flap`) drives the
deterministic half of the same drills.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import os
import random
import signal
import sys
import time
from collections import deque
from typing import Any, Callable, Mapping, Optional

from ggrmcp_tpu_torch.core.config import (
    BatchingConfig,
    FleetConfig,
    ServingConfig,
    config_from_dict,
)
from ggrmcp_tpu_torch.serving.slo import windowed_delta

logger = logging.getLogger("ggrmcp.serving.fleet")

# Counter names exported as gateway_fleet_* metrics — iterate THIS
# tuple (gateway/metrics.py _FLEET_HELP renders help from it), so
# "added a counter, forgot the metric" is impossible; the fleet suite
# asserts the invariant.
COUNTER_NAMES = (
    "spawns", "drains", "undrains", "kills", "restarts", "retires",
    "give_ups", "flap_heals", "suppressed_churn", "suppressed_floor",
    "spawn_failures",
)

# FleetAction kinds that charge the churn budget: the state-changing
# verbs. Completing an already-budgeted retire (its kill) and pure
# bookkeeping (suppress/give_up records) do not double-charge.
BUDGETED_KINDS = frozenset({"spawn", "drain", "restart"})


class FleetFloorError(RuntimeError):
    """An action would take the serving pool below fleet.min_replicas.

    Raised only by external callers driving the supervisor directly
    (the decide() loop never emits such an action — it suppresses and
    counts instead); typed so an operator script draining by hand gets
    the invariant by name, not a stack trace."""


@dataclasses.dataclass
class FleetAction:
    """One supervisor decision. `kind` is the verb (spawn | drain |
    undrain | kill | restart | retire | give_up | suppress), `target`
    the replica it applies to ("" for pool-level actions like spawn),
    `reason` the human-readable why. Appended to the bounded action
    log whether or not apply() later fails (`ok`/`error` record the
    outcome) — the log is the audit trail, not a success list."""

    kind: str
    target: str
    reason: str
    at: float = 0.0  # wall-clock epoch seconds, stamped at decide time
    ok: bool = True
    error: str = ""
    # Replacement target minted by a successful spawn/restart apply.
    result: str = ""

    def as_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ReplicaObs:
    """One replica's observed state for a supervisor step."""

    target: str
    alive: bool = True      # child process running
    healthy: bool = True    # gRPC health probe
    draining: bool = False
    queued: float = 0.0     # admission-queue depth (requests)
    active: float = 0.0     # decode slots generating
    slots: float = 0.0      # decode slot capacity (0 = unreported)
    shed_total: float = 0.0  # cumulative shed_requests counter
    ttft_p99_ms: float = 0.0  # windowed backend TTFT p99 (0 = no data)


# Utilization-aware idle: with slot capacities reported, the pool is
# "idle" when nothing queues AND the capacity left after retiring the
# largest replica still covers the current active load with 2x
# headroom — so a trough's trickle of traffic can release a replica
# without risking an immediate re-shed. Without capacity data the idle
# test degrades to the strict zero-activity form.
IDLE_HEADROOM = 2.0


@dataclasses.dataclass
class _Member:
    """Supervisor-internal per-replica state machine.

    states: serving → (retiring | healing | restarting) → gone.
      serving     taking traffic.
      retiring    drained for scale-down; killed at retire_at.
      healing     drained (or floor-pinned) for a flap heal; restarted
                  at heal_at.
      restarting  process observed dead; restart fires when the
                  backoff deadline passes.
    """

    target: str
    state: str = "serving"
    # An apply (restart) is in flight for this member — decide must
    # not issue another action for it (background_actions mode; the
    # member object is discarded when the apply lands).
    busy: bool = False
    restarts: int = 0          # consecutive restart attempts
    backoff_until: float = 0.0
    retire_at: float = 0.0
    heal_at: float = 0.0
    drained: bool = False      # we drained it (vs operator drain)
    last_healthy: Optional[bool] = None
    flaps: deque = dataclasses.field(default_factory=deque)  # edge times
    ok_since: float = 0.0      # alive+healthy continuously since


class FleetSupervisor:
    """The control loop. `source` is the actuation/observation plane —
    any object with:

        async observe() -> list[ReplicaObs]   (managed replicas only)
        async spawn(reason) -> target
        async drain(target) / undrain(target)
        async kill(target)                    (hard-stop + deregister)
        async restart(target) -> new target   (kill + spawn)

    `GatewayFleetAdapter` below implements it over the gateway's
    discoverer + ProcessReplicaFactory; tests drive fakes. `clock` and
    `rng` are injectable for deterministic tests."""

    def __init__(
        self,
        cfg: FleetConfig,
        source: Any,
        clock: Callable[[], float] = time.monotonic,
        rng: Optional[random.Random] = None,
        background_actions: bool = False,
    ):
        self.cfg = cfg
        self.source = source
        self.clock = clock
        self._rng = rng or random.Random(0)
        # background_actions=True applies spawn/restart in their own
        # tasks so a slow replica boot (tens of seconds of JAX warmup
        # on a contended host) cannot wedge the control loop — the
        # fleet bench's trough showed exactly that: a spike-tail spawn
        # blocking run_once through the whole scale-down window. Off
        # by default: the deterministic test harness (and any caller
        # driving decide/apply by hand) wants strictly serial applies.
        self.background_actions = background_actions
        self._bg_tasks: set[asyncio.Task] = set()
        self._pending_spawns = 0
        self.paused = False
        self.counters: dict[str, int] = dict.fromkeys(COUNTER_NAMES, 0)
        self.actions: deque[FleetAction] = deque(maxlen=cfg.action_log)
        self._members: dict[str, _Member] = {}
        # Sliding churn-budget window: times of budgeted actions.
        self._budget_times: deque[float] = deque()
        # Hysteresis clocks (None = signal not currently asserted).
        self._pressure_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        # Shed-rise detection: last PER-TARGET shed counter seen
        # (summing across a changing membership would fabricate a rise
        # when a replica joins or mask one when a retiree's count
        # leaves the sum), and when any counter last rose (rises latch
        # pressure for shed_hold_s — the ServingStats snapshot
        # refreshes slower than the decide loop ticks, so a per-step
        # rise test alone would reset the sustain clock between
        # refreshes).
        self._shed_prev: dict[str, float] = {}
        self._shed_rise_at: Optional[float] = None
        self._task: Optional[asyncio.Task] = None

    # -- pause/resume (POST /admin/fleet) ---------------------------------

    def pause(self) -> None:
        if not self.paused:
            logger.warning("fleet supervisor PAUSED (no actions fire)")
        self.paused = True

    def resume(self) -> None:
        if self.paused:
            logger.warning("fleet supervisor resumed")
        self.paused = False

    # -- observability -----------------------------------------------------

    def snapshot(self) -> dict[str, Any]:
        """State for /stats, /debug/requests and gateway_fleet_*."""
        return {
            "paused": self.paused,
            "min_replicas": self.cfg.min_replicas,
            "max_replicas": self.cfg.max_replicas,
            "pending_spawns": self._pending_spawns,
            "replicas": [
                {
                    "target": m.target,
                    "state": m.state,
                    "restarts": m.restarts,
                    "drained": m.drained,
                    "flap_edges": len(m.flaps),
                }
                for m in sorted(self._members.values(), key=lambda m: m.target)
            ],
            "counters": dict(self.counters),
            "actions": [a.as_dict() for a in reversed(self.actions)],
        }

    # -- pool accounting ---------------------------------------------------

    def _serving_count(self) -> int:
        """Replicas currently placeable: not drained and not observed
        dead. A floor-pinned healing member (flap heal without the
        drain) still takes traffic until its restart fires, so it
        counts — the floor invariant is about PLACEABLE replicas, not
        internal states."""
        return sum(
            1 for m in self._members.values()
            if m.state in ("serving", "healing") and not m.drained
        )

    def _expected_count(self) -> int:
        """Replicas that are, or will come back, serving: everything
        except the ones on their way OUT (retiring), plus spawns still
        in flight (background_actions) — the number the min_replicas
        floor spawn tops up against and max_replicas caps."""
        return self._pending_spawns + sum(
            1 for m in self._members.values() if m.state != "retiring"
        )

    def _can_drain(self) -> bool:
        """True when draining ONE more serving replica keeps the pool
        at or above min_replicas — the invariant the drain-of-last-
        replica satellite pins (tests/test_fleet.py property suite)."""
        return self._serving_count() - 1 >= self.cfg.min_replicas

    def _backoff(self, attempt: int) -> float:
        base = min(
            self.cfg.backoff_max_s,
            self.cfg.backoff_base_s * (2.0 ** attempt),
        )
        return base * (1.0 + self.cfg.backoff_jitter * self._rng.random())

    def _budget_ok(self, now: float) -> bool:
        window = self.cfg.action_window_s
        while self._budget_times and now - self._budget_times[0] > window:
            self._budget_times.popleft()
        return len(self._budget_times) < self.cfg.max_actions_per_window

    def _emit(
        self, actions: list[FleetAction], kind: str, target: str,
        reason: str, now: float, counter: Optional[str] = None,
    ) -> FleetAction:
        action = FleetAction(kind=kind, target=target, reason=reason,
                             at=time.time())
        actions.append(action)
        self.actions.append(action)
        if kind in BUDGETED_KINDS:
            self._budget_times.append(now)
        if counter:
            self.counters[counter] += 1
        logger.warning(
            "fleet action: %s %s (%s)", kind, target or "<pool>", reason
        )
        return action

    def _suppress(
        self, actions: list[FleetAction], target: str, reason: str,
        now: float, counter: str,
    ) -> None:
        # Dedup consecutive identical suppressions: a budget-starved
        # step repeats every decide_interval_s and would otherwise
        # flood the bounded action ring; the counter still counts every
        # suppressed step.
        if self.actions:
            last = self.actions[-1]
            if (
                last.kind == "suppress"
                and last.target == target
                and last.reason == reason
            ):
                self.counters[counter] += 1
                return
        self._emit(actions, "suppress", target, reason, now, counter)

    # -- decide ------------------------------------------------------------

    def decide(self, obs: list[ReplicaObs]) -> list[FleetAction]:
        """The pure decision step: update hysteresis/flap state from
        one observation round and return the typed actions due now.
        Observation state updates even while paused (so resume doesn't
        act on a frozen past), but a paused supervisor emits nothing."""
        now = self.clock()
        by_target = {o.target: o for o in obs}
        # Membership sync: adopt observed replicas we don't know,
        # forget members the source no longer reports (killed out of
        # band — the audit trail is the source's problem there).
        for target in by_target:
            if target not in self._members:
                self._members[target] = _Member(target=target, ok_since=now)
        for target in list(self._members):
            if target not in by_target:
                del self._members[target]

        self._track_flaps(by_target, now)
        pressure, idle = self._track_pool_signals(obs, now)

        if self.paused:
            return []

        actions: list[FleetAction] = []
        self._heal_pass(by_target, now, actions)
        self._floor_pass(now, actions)
        self._scale_up_pass(pressure, now, actions)
        self._scale_down_pass(idle, now, actions)
        return actions

    def _track_flaps(
        self, by_target: dict[str, ReplicaObs], now: float
    ) -> None:
        window = self.cfg.flap_window_s
        for member in self._members.values():
            o = by_target[member.target]
            healthy = o.healthy and o.alive
            if member.last_healthy is not None and healthy != member.last_healthy:
                member.flaps.append(now)
            member.last_healthy = healthy
            while member.flaps and now - member.flaps[0] > window:
                member.flaps.popleft()
            if healthy:
                if member.ok_since == 0.0:
                    member.ok_since = now
                # A full quiet flap-window forgives past restarts: the
                # consecutive-failure counter (and with it the backoff
                # ladder) resets only once the replica has proven out.
                if (
                    member.restarts
                    and not member.flaps
                    and now - member.ok_since >= window
                ):
                    member.restarts = 0
            else:
                member.ok_since = 0.0

    def _track_pool_signals(
        self, obs: list[ReplicaObs], now: float
    ) -> tuple[bool, bool]:
        """Update the pressure/idle hysteresis clocks; returns whether
        each signal has SUSTAINED past its gate this step."""
        shed_prev = self._shed_prev
        self._shed_prev = {o.target: o.shed_total for o in obs}
        if any(
            o.shed_total > shed_prev[o.target]
            for o in obs if o.target in shed_prev
        ):
            self._shed_rise_at = now
        shed_pressure = (
            self._shed_rise_at is not None
            and now - self._shed_rise_at <= self.cfg.shed_hold_s
        )
        ttft_breach = any(
            o.ttft_p99_ms > self.cfg.slo_ttft_p99_ms for o in obs
        )
        pressure_now = shed_pressure or ttft_breach
        placeable = [o for o in obs if o.alive and not o.draining]
        total_active = sum(o.active for o in placeable)
        slotted = [o for o in placeable if o.slots > 0]
        if len(slotted) >= 2 and len(slotted) == len(placeable):
            # Capacity left after retiring the LARGEST replica must
            # cover the live load with IDLE_HEADROOM to spare.
            slack = sum(o.slots for o in slotted) - max(
                o.slots for o in slotted
            )
            low_util = total_active * IDLE_HEADROOM <= slack
        else:
            low_util = total_active == 0
        idle_now = (
            bool(obs)
            and not pressure_now
            and all(o.queued == 0 for o in obs)
            and low_util
        )

        if pressure_now:
            if self._pressure_since is None:
                self._pressure_since = now
        else:
            self._pressure_since = None
        if idle_now:
            if self._idle_since is None:
                self._idle_since = now
        else:
            self._idle_since = None

        pressure = (
            self._pressure_since is not None
            and now - self._pressure_since >= self.cfg.scale_up_sustain_s
        )
        idle = (
            self._idle_since is not None
            and now - self._idle_since >= self.cfg.scale_down_sustain_s
        )
        return pressure, idle

    def _heal_pass(
        self,
        by_target: dict[str, ReplicaObs],
        now: float,
        actions: list[FleetAction],
    ) -> None:
        for member in list(self._members.values()):
            o = by_target[member.target]
            if member.busy:
                continue  # an apply is already in flight for it
            if member.state == "retiring":
                # Kill when drained traffic finished or grace expired.
                if (o.queued == 0 and o.active == 0) or now >= member.retire_at:
                    self._emit(
                        actions, "kill", member.target,
                        "retire: drain complete", now, "kills",
                    )
                    self.counters["retires"] += 1
                    del self._members[member.target]
                continue
            if member.state == "healing":
                if now >= member.heal_at:
                    if not self._budget_ok(now):
                        self._suppress(
                            actions, member.target,
                            "heal restart awaiting churn budget",
                            now, "suppressed_churn",
                        )
                        continue
                    self._emit(
                        actions, "restart", member.target,
                        "heal: health flapped past threshold",
                        now, "restarts",
                    )
                    member.busy = True
                    member.restarts += 1
                    member.backoff_until = now + self._backoff(member.restarts)
                continue
            if not o.alive:
                if member.state != "restarting":
                    member.state = "restarting"
                    member.backoff_until = now + self._backoff(member.restarts)
                    member.ok_since = 0.0
                if member.restarts >= self.cfg.restart_max_attempts:
                    self._emit(
                        actions, "give_up", member.target,
                        f"exceeded restart_max_attempts="
                        f"{self.cfg.restart_max_attempts}",
                        now, "give_ups",
                    )
                    del self._members[member.target]
                    continue
                if now >= member.backoff_until:
                    if not self._budget_ok(now):
                        self._suppress(
                            actions, member.target,
                            "dead-replica restart awaiting churn budget",
                            now, "suppressed_churn",
                        )
                        continue
                    self._emit(
                        actions, "restart", member.target,
                        f"process exited (attempt "
                        f"{member.restarts + 1})", now, "restarts",
                    )
                    member.busy = True
                    member.restarts += 1
                    member.backoff_until = now + self._backoff(member.restarts)
                continue
            # Alive: flap detection.
            if len(member.flaps) >= self.cfg.flap_threshold:
                if not self._budget_ok(now):
                    self._suppress(
                        actions, member.target,
                        "flap heal awaiting churn budget",
                        now, "suppressed_churn",
                    )
                    continue
                member.flaps.clear()
                member.state = "healing"
                if self._can_drain():
                    member.drained = True
                    self._emit(
                        actions, "drain", member.target,
                        "heal: flapping — draining before restart",
                        now, "drains",
                    )
                    self.counters["flap_heals"] += 1
                    member.heal_at = now + self.cfg.drain_grace_s
                else:
                    # Floor-pinned: restarting in place keeps the pool
                    # at min_replicas; draining it would empty the pool
                    # (the drain-of-last-replica satellite).
                    self.counters["flap_heals"] += 1
                    self.counters["suppressed_floor"] += 1
                    member.heal_at = now

    def _floor_pass(
        self, now: float, actions: list[FleetAction]
    ) -> None:
        """Top the pool back up to min_replicas. Deliberately budget-
        exempt (an empty pool is worse than a churny one) but counted —
        the spawns still appear in the window so steady-state churn
        accounting stays honest."""
        missing = self.cfg.min_replicas - self._expected_count()
        for _ in range(max(0, missing)):
            self._emit(
                actions, "spawn", "",
                "pool below fleet.min_replicas", now, "spawns",
            )

    def _scale_up_pass(
        self, pressure: bool, now: float, actions: list[FleetAction]
    ) -> None:
        if not pressure:
            return
        # Spawns already emitted this step (floor top-up) count against
        # the ceiling — members only materialize at apply time.
        pending = sum(1 for a in actions if a.kind == "spawn")
        if self._expected_count() + pending >= self.cfg.max_replicas:
            self._pressure_since = None  # re-arm; ceiling reached
            return
        if not self._budget_ok(now):
            self._suppress(
                actions, "", "scale-up awaiting churn budget",
                now, "suppressed_churn",
            )
            return
        self._emit(
            actions, "spawn", "",
            "sustained shed/SLO pressure "
            f">= {self.cfg.scale_up_sustain_s:g}s", now, "spawns",
        )
        # Re-arm: the next spawn needs a FULL fresh sustain period, so
        # one sustained episode can never double-spawn.
        self._pressure_since = None

    def _scale_down_pass(
        self, idle: bool, now: float, actions: list[FleetAction]
    ) -> None:
        if not idle:
            return
        self._idle_since = None  # re-arm whether or not we act
        if not self._can_drain():
            self.counters["suppressed_floor"] += 1
            return
        if not self._budget_ok(now):
            self._suppress(
                actions, "", "scale-down awaiting churn budget",
                now, "suppressed_churn",
            )
            return
        # Retire the lexically-last serving replica: deterministic, and
        # with the default factory (ephemeral ports ascending) it is
        # the newest spawn — LIFO keeps the warm elders.
        candidates = sorted(
            m.target for m in self._members.values()
            if m.state == "serving" and not m.drained
        )
        target = candidates[-1]
        member = self._members[target]
        member.state = "retiring"
        member.drained = True
        member.retire_at = now + self.cfg.drain_grace_s
        self._emit(
            actions, "drain", target,
            f"sustained idle >= {self.cfg.scale_down_sustain_s:g}s — "
            "retiring", now, "drains",
        )

    # -- act ---------------------------------------------------------------

    async def run_once(self) -> list[FleetAction]:
        """One observe→decide→act round."""
        obs = await self.source.observe()
        actions = self.decide(obs)
        for action in actions:
            await self._apply(action)
        return actions

    async def _apply(self, action: FleetAction) -> None:
        if self.background_actions and action.kind in ("spawn", "restart"):
            # Replica boots take tens of seconds; applied inline they
            # would freeze observe/decide (and with it every OTHER
            # policy — heal, retire) for the duration. The pending
            # count keeps the floor/ceiling math honest meanwhile.
            self._pending_spawns += 1

            async def run() -> None:
                try:
                    await self._apply_now(action)
                finally:
                    self._pending_spawns -= 1

            task = asyncio.get_running_loop().create_task(run())
            self._bg_tasks.add(task)
            task.add_done_callback(self._bg_tasks.discard)
            return
        await self._apply_now(action)

    async def _apply_now(self, action: FleetAction) -> None:
        try:
            if action.kind == "spawn":
                target = await self.source.spawn(action.reason)
                action.target = target
                action.result = target
                self._members[target] = _Member(
                    target=target, ok_since=self.clock()
                )
            elif action.kind == "drain":
                await self.source.drain(action.target)
            elif action.kind == "undrain":
                await self.source.undrain(action.target)
            elif action.kind in ("kill", "give_up"):
                await self.source.kill(action.target)
            elif action.kind == "restart":
                old = self._members.pop(action.target, None)
                target = await self.source.restart(action.target)
                action.result = target
                member = _Member(target=target, ok_since=self.clock())
                if old is not None:
                    # Consecutive-failure memory survives the identity
                    # change: a crash loop keeps escalating its backoff
                    # instead of resetting through the fresh target.
                    member.restarts = old.restarts
                    member.backoff_until = old.backoff_until
                self._members[target] = member
            # "suppress" is bookkeeping only.
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # noqa: BLE001 — act failures are data
            action.ok = False
            action.error = str(exc)
            if action.kind == "spawn":
                self.counters["spawn_failures"] += 1
            logger.error(
                "fleet action %s %s FAILED: %s",
                action.kind, action.target or "<pool>", exc,
            )

    # -- asyncio loop ------------------------------------------------------

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        for task in list(self._bg_tasks):
            task.cancel()
        if self._bg_tasks:
            # Cancelled spawns kill their half-started child (the
            # factory's CancelledError arm), so nothing leaks.
            await asyncio.gather(*self._bg_tasks, return_exceptions=True)
            self._bg_tasks.clear()

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.cfg.decide_interval_s)
            try:
                await self.run_once()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — the loop must survive
                logger.exception("fleet supervisor step failed")


# ---------------------------------------------------------------------------
# Windowed TTFT p99 from the cumulative ServingStats histograms
# ---------------------------------------------------------------------------


def hist_p99(bounds: list[float], counts: list[float]) -> float:
    """Nearest-rank p99 (upper bucket bound) from histogram counts —
    counts[i] observations <= bounds[i], counts[-1] the overflow. 0.0
    when empty. Overflow observations report the last bound (an
    underestimate, but a bounded one — and any value past the last
    bound already screams)."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    rank = max(1, int(0.99 * total + 0.999999))
    cum = 0.0
    for i, c in enumerate(counts):
        cum += c
        if cum >= rank:
            return float(bounds[i]) if i < len(bounds) else float(bounds[-1])
    return float(bounds[-1])


class TtftWindow:
    """Per-target windowed TTFT p99 from consecutive cumulative
    snapshots: the delta of bucket counts between observes is the
    window's histogram (serving/slo.py windowed_delta — the shared
    cumulative-counter discipline this class originated). A counter
    regression (backend restart) resets the baseline. Returns the LAST
    computed window p99 while no new observations arrive (an idle pool
    shouldn't read as SLO-clean one step and breaching the next on
    stale data)."""

    def __init__(self) -> None:
        self._prev: dict[str, list[float]] = {}
        self._last_p99: dict[str, float] = {}

    def update(self, target: str, entry: dict[str, Any]) -> float:
        bounds = [float(b) for b in entry.get("latencyBucketBoundsMs", [])]
        counts = [float(c) for c in entry.get("ttftMsBucket", [])]
        if not bounds or len(counts) != len(bounds) + 1:
            return self._last_p99.get(target, 0.0)
        delta = windowed_delta(self._prev.get(target), counts)
        if delta is None:
            # Unusable baseline (first observe, bound-config change, or
            # counter regression): re-baseline, keep the last p99.
            self._prev[target] = counts
            return self._last_p99.get(target, 0.0)
        if sum(delta) > 0:
            self._prev[target] = counts
            self._last_p99[target] = hist_p99(bounds, delta)
        return self._last_p99.get(target, 0.0)

    def forget(self, target: str) -> None:
        self._prev.pop(target, None)
        self._last_p99.pop(target, None)


# ---------------------------------------------------------------------------
# Replica child processes
# ---------------------------------------------------------------------------


class ReplicaProcess:
    """One spawned replica child: asyncio subprocess + its dialable
    target. SIGKILL-level kill only — graceful shutdown is the drain
    machinery's job, and by the time the supervisor kills, the replica
    is drained or already misbehaving."""

    def __init__(self, proc: asyncio.subprocess.Process, target: str):
        self.proc = proc
        self.target = target

    @property
    def pid(self) -> int:
        return self.proc.pid

    def alive(self) -> bool:
        return self.proc.returncode is None

    def kill(self) -> None:
        if self.proc.returncode is None:
            try:
                self.proc.kill()
            except ProcessLookupError:
                pass

    async def wait(self) -> int:
        return await self.proc.wait()


def default_worker_argv() -> list[str]:
    """The stock replica worker: this module's __main__ (a sidecar
    that prints TARGET= and serves until killed)."""
    return [sys.executable, "-m", "ggrmcp_tpu_torch.serving.fleet"]


class ProcessReplicaFactory:
    """Spawns replica workers and resolves their dialable target from
    the ``TARGET=<target>`` line the worker prints once serving —
    the same handshake the bench replica phases use. `argv`/`env`
    override the stock sidecar worker (tests spawn
    examples/hello_server.py for sub-second replicas)."""

    def __init__(
        self,
        argv: Optional[list[str]] = None,
        env: Optional[dict[str, str]] = None,
        ready_timeout_s: float = 600.0,
        cwd: Optional[str] = None,
    ):
        self.argv = argv or default_worker_argv()
        self.env = env
        self.ready_timeout_s = ready_timeout_s
        self.cwd = cwd

    async def spawn(self) -> ReplicaProcess:
        proc = await asyncio.create_subprocess_exec(
            *self.argv,
            env=self.env if self.env is not None else dict(os.environ),
            cwd=self.cwd,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.DEVNULL,
        )
        try:
            line = await asyncio.wait_for(
                proc.stdout.readline(), timeout=self.ready_timeout_s
            )
        except asyncio.TimeoutError:
            proc.kill()
            await proc.wait()
            raise RuntimeError(
                f"replica worker not ready within {self.ready_timeout_s}s"
            )
        except asyncio.CancelledError:
            # A cancelled spawn (shutdown mid-action) must not orphan
            # the half-started child.
            proc.kill()
            raise
        text = line.decode().strip()
        if not text.startswith("TARGET="):
            proc.kill()
            await proc.wait()
            raise RuntimeError(f"replica worker bad handshake: {text!r}")
        return ReplicaProcess(proc, text.removeprefix("TARGET="))


# ---------------------------------------------------------------------------
# Gateway adapter: observe/act over the discoverer + child processes
# ---------------------------------------------------------------------------


class GatewayFleetAdapter:
    """FleetSupervisor source over a live gateway: child processes from
    `factory`, membership/drain/health through the ServiceDiscoverer
    (add_backend/remove_backend/set_draining — restarts rediscover, so
    role re-stamping rides the existing path), load signals from the
    non-blocking ServingStats snapshot."""

    def __init__(
        self,
        discoverer: Any,
        factory: ProcessReplicaFactory,
        probe_timeout_s: float = 2.0,
        stats_max_age_s: float = 2.0,
    ):
        self.discoverer = discoverer
        self.factory = factory
        self.probe_timeout_s = probe_timeout_s
        # Snapshot freshness the control loop needs (tighter than the
        # /metrics default — shed deltas are the scale-up signal).
        self.stats_max_age_s = stats_max_age_s
        self.procs: dict[str, ReplicaProcess] = {}
        self._ttft = TtftWindow()

    # -- observe -----------------------------------------------------------

    async def observe(self) -> list[ReplicaObs]:
        self.discoverer._maybe_refresh_serving_stats(self.stats_max_age_s)
        entries, _age = self.discoverer._stats_view()
        by_target = {
            e.get("target"): e for e in entries if "error" not in e
        }
        backends = {b.target: b for b in self.discoverer.backends}
        obs: list[ReplicaObs] = []
        for target, proc in self.procs.items():
            backend = backends.get(target)
            healthy = False
            draining = False
            if backend is not None:
                draining = backend.draining
                try:
                    healthy = await asyncio.wait_for(
                        backend.health_check(), self.probe_timeout_s
                    )
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — probe failure = down
                    healthy = False
            entry = by_target.get(target, {})

            def num(key: str) -> float:
                try:
                    return float(entry.get(key, 0))
                except (TypeError, ValueError):
                    return 0.0

            obs.append(ReplicaObs(
                target=target,
                alive=proc.alive(),
                healthy=healthy,
                draining=draining,
                queued=num("queuedRequests"),
                active=num("activeSlots"),
                slots=num("totalSlots"),
                shed_total=num("shedRequests"),
                ttft_p99_ms=self._ttft.update(target, entry),
            ))
        return obs

    # -- act ---------------------------------------------------------------

    async def spawn(self, reason: str) -> str:
        proc = await self.factory.spawn()
        self.procs[proc.target] = proc
        try:
            await self.discoverer.add_backend(proc.target)
        except asyncio.CancelledError:
            raise
        except Exception:
            # A replica the gateway cannot dial is dead weight with a
            # live process attached — reap it before re-raising.
            self.procs.pop(proc.target, None)
            proc.kill()
            raise
        return proc.target

    async def drain(self, target: str) -> None:
        self.discoverer.set_draining(target, True)

    async def undrain(self, target: str) -> None:
        self.discoverer.set_draining(target, False)

    async def kill(self, target: str) -> None:
        proc = self.procs.pop(target, None)
        if proc is not None:
            proc.kill()
            await proc.wait()
        self._ttft.forget(target)
        await self.discoverer.remove_backend(target)

    async def restart(self, target: str) -> str:
        await self.kill(target)
        return await self.spawn(f"restart of {target}")

    async def close(self) -> None:
        """Reap every child (gateway shutdown)."""
        for proc in self.procs.values():
            proc.kill()
        for proc in self.procs.values():
            await proc.wait()
        self.procs.clear()


# ---------------------------------------------------------------------------
# The replica worker (python -m ggrmcp_tpu_torch.serving.fleet)
# ---------------------------------------------------------------------------

# A worker starts the port's `Sidecar` on an ephemeral port, prints
# `TARGET=<target>` once it serves, and serves until it is killed. Its
# settings, in order:
# - the reference's spawn knobs, GGRMCP_FLEET_WORKER_{MODEL, ROLE, SLOTS,
#   MAXSEQ, PENDING, PAGED, PAGES}, with the reference's defaults
#   (tiny-llama, mixed, 4 slots, 512 positions, one decode step a tick, 8
#   pending, paged off, 192 pages when paged is on);
# - the port's handshake, which the gateway's `_start_fleet` sets and
#   which goes over the knobs: the whole `serving` section as JSON in
#   GGRMCP_FLEET_WORKER_TORCH_SERVING, the device in
#   GGRMCP_FLEET_WORKER_TORCH_DEVICE, the weights' seed in
#   GGRMCP_FLEET_WORKER_TORCH_SEED and the gateway's pid in
#   GGRMCP_FLEET_WORKER_TORCH_PARENT. The GGRMCP_FLEET_WORKER_ prefix is
#   one the environment layer skips.
#
# Without a device the worker asks for the card and raises when there is
# none; it never serves on the CPU unless told to. GGRMCP_FAILPOINTS arms
# `replica_crash` and `health_flap` in the worker as in any sidecar of the
# port (utils/failpoints.py reads it at import). On Linux the worker sets
# PR_SET_PDEATHSIG, so that the kernel kills it when the gateway that
# spawned it dies: a worker holds a model's weights on the card.

# The handshake: the serving section, device and seed the gateway's
# supervisor hands its workers.
ENV_SERVING = "GGRMCP_FLEET_WORKER_TORCH_SERVING"
ENV_DEVICE = "GGRMCP_FLEET_WORKER_TORCH_DEVICE"
ENV_SEED = "GGRMCP_FLEET_WORKER_TORCH_SEED"
# The gateway's pid: a worker whose parent is no longer that process was
# orphaned before it could arm PR_SET_PDEATHSIG.
ENV_PARENT = "GGRMCP_FLEET_WORKER_TORCH_PARENT"


def worker_serving_config(env: Mapping[str, str]) -> ServingConfig:
    """The worker's serving settings from `env`: the handshake's section
    when present (its socket and port cleared: a worker takes an
    ephemeral TCP port), else the reference worker's knobs and
    defaults."""
    section = env.get(ENV_SERVING)
    if section:
        serving = config_from_dict({"serving": json.loads(section)}).serving
        return dataclasses.replace(serving, uds_path="", port=0)
    paged = env.get("GGRMCP_FLEET_WORKER_PAGED", "off")
    return ServingConfig(
        model=env.get("GGRMCP_FLEET_WORKER_MODEL", "tiny-llama"),
        role=env.get("GGRMCP_FLEET_WORKER_ROLE", "mixed"),
        batching=BatchingConfig(
            max_batch_size=int(env.get("GGRMCP_FLEET_WORKER_SLOTS", "4")),
            kv_cache_max_seq=int(
                env.get("GGRMCP_FLEET_WORKER_MAXSEQ", "512")),
            decode_steps_per_tick=1,
            max_pending=int(env.get("GGRMCP_FLEET_WORKER_PENDING", "8")),
            paged_kv=paged,
            **({"paged_kv_pages": int(
                env.get("GGRMCP_FLEET_WORKER_PAGES", "192"))}
               if paged == "on" else {}),
        ),
    )


def handshake_environ(serving: ServingConfig, device=None,
                      seed: int = 0) -> dict:
    """The handshake variables that make a worker serve `serving` on
    `device` (None: the card) with weights from `seed`, as a child of
    this process."""
    env = {ENV_SERVING: json.dumps(dataclasses.asdict(serving)),
           ENV_SEED: str(seed), ENV_PARENT: str(os.getpid())}
    if device is not None:
        env[ENV_DEVICE] = str(device)
    return env


def _die_with_parent(env: Mapping[str, str]) -> None:
    """PR_SET_PDEATHSIG (1) with SIGKILL, then exit if the parent the
    handshake named is already gone (it died before the signal was
    armed)."""
    if not sys.platform.startswith("linux"):
        return
    import ctypes

    ctypes.CDLL(None, use_errno=True).prctl(1, int(signal.SIGKILL))
    parent = env.get(ENV_PARENT)
    if parent and os.getppid() != int(parent):
        sys.exit(1)


async def _worker_main(env: Optional[Mapping[str, str]] = None) -> None:
    """One replica: start on an ephemeral port, print TARGET=<target>,
    serve until killed."""
    from ggrmcp_tpu_torch.serving.sidecar import Sidecar

    env = os.environ if env is None else env
    _die_with_parent(env)
    serving = worker_serving_config(env)
    sidecar = Sidecar(serving, seed=int(env.get(ENV_SEED, "0")),
                      device=env.get(ENV_DEVICE) or None)
    await sidecar.start(0)
    print(f"TARGET={sidecar.target}", flush=True)
    await asyncio.Event().wait()  # the supervisor kills the process


def main() -> None:
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    asyncio.run(_worker_main())


if __name__ == "__main__":
    main()
