"""Deterministic fault injection for the serving plane.

Gray-failure literature (Huang et al., HotOS '17) says the faults that
kill production systems are the partial, transient ones — a tick that
fails once, an admission that stalls, a reconnect that flaps. Those
paths are unreachable from normal tests, so this module makes them a
first-class, *deterministic* input: named failpoints evaluated at fixed
host-side hook sites, armed by count (`every=N`), bounded (`times=K`),
and either raising `FailpointError` or sleeping (`ms=X`).

Arming:
  - env:    GGRMCP_FAILPOINTS=tick_fail:every=7,admit_slow:ms=50
  - config: serving.failpoints (same syntax; armed at engine init)
  - code:   failpoints.arm("tick_fail", every=7)  (chaos tests)

Spec syntax: comma-separated `name:key=val` segments; a segment without
a `:` is a further `key=val` for the preceding name, so
`tick_fail:every=3,times=2,admit_slow:ms=50` arms tick_fail(every=3,
times=2) and admit_slow(ms=50). A point with `ms` set sleeps (latency
injection); one without raises (fault injection).

Hook sites (the names the serving plane evaluates):
  tick_fail      ContinuousBatcher._tick_step — before tick dispatch
  admit_fail     ContinuousBatcher._prefill_into_slots — admission round
  admit_slow     same site, latency variant (arm with ms=)
  page_exhausted same site, per paged-KV row — forces the page
                 allocator's exhaustion path (typed RESOURCE_EXHAUSTED
                 shed; batching.paged_kv=on only)
  grammar_jump_fail ContinuousBatcher._jump_validate — collect-side
                 validation of a jump-ahead forced run: the run is
                 refused as if the device landing state were bad, the
                 slot degrades typed to plain one-token constrained
                 decoding (grammar_jump_fallbacks counter; replay
                 re-prefills the emitted prefix) and the greedy output
                 stays schema-valid and bit-identical
                 (tests/test_grammar_jump.py)
  adapter_load_fail AdapterArena._load — before a registered LoRA
                 adapter's factors are read + installed H2D: the load
                 "fails" typed (AdapterLoadError → gRPC ABORTED at the
                 sidecar), the reserved row returns to the free list,
                 and the request sheds or retries on a replica holding
                 the adapter — never silently serving base weights
                 (tests/test_lora_arena.py)
  kv_transfer_fail Sidecar._prefill_and_ship — before the disaggregated
                 prefill leg exports/ships KV pages: the transfer
                 "fails" typed (gRPC ABORTED) and the gateway retries
                 the request on a mixed replica with bit-identical
                 greedy output (tests/test_disagg.py)
  reconnect_fail ServiceDiscoverer._try_reconnect — before dialing
  backend_down   ServiceDiscoverer.invoke_*_by_tool — after routing,
                 before the gRPC call: the routed replica "dies" (call
                 fails typed, Backend.healthy flips False so the router
                 skips it until the watchdog revives it) — the
                 replica-kill half of the drain/kill chaos suite
                 (tests/test_router.py)
  replica_crash  Sidecar.generate/generate_stream — PROCESS-level:
                 when due, the worker logs and aborts the whole
                 process (os._exit(86)) — arm with every=N for "worker
                 dies after N calls". The fleet supervisor's heal path
                 (serving/fleet.py) is what notices and restarts it;
                 this is the deterministic half of the SIGKILL chaos
                 drills (tests/test_fleet.py)
  health_flap    HealthService.check/check_sync — the gRPC health
                 probe answers NOT_SERVING when due: every=2 makes the
                 probe alternate healthy/unhealthy, the flap shape
                 fleet.flap_threshold healing triggers on — real
                 flapping at the probe surface, not just
                 ConnectionErrors

Evaluation is cheap when nothing is armed (one dict lookup) and
deterministic given the call sequence: `every=N` fires on the Nth,
2Nth, ... evaluation of that name. Counters are lock-protected — hook
sites run on executor threads.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Optional

logger = logging.getLogger("ggrmcp.torch.failpoints")


class FailpointError(RuntimeError):
    """The injected fault. Deliberately a RuntimeError subclass so every
    hook site's existing broad failure handling treats it exactly like
    a real device/transport error — that equivalence is what the chaos
    suite tests."""

    def __init__(self, name: str, hit: int):
        super().__init__(f"injected fault at failpoint {name!r} (hit {hit})")
        self.name = name
        self.hit = hit


@dataclasses.dataclass
class _Point:
    name: str
    every: int = 1  # fire on every Nth evaluation
    times: int = 0  # max fires (0 = unlimited)
    ms: float = 0.0  # > 0: sleep instead of raising
    hits: int = 0
    fires: int = 0


class FailpointRegistry:
    """Process-wide named failpoints. One module-level instance
    (`registry`) is shared by every hook site; chaos tests arm/reset it
    around each scenario."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._points: dict[str, _Point] = {}

    def arm(
        self, name: str, every: int = 1, times: int = 0, ms: float = 0.0
    ) -> None:
        if every < 1:
            raise ValueError(f"failpoint {name!r}: every must be >= 1")
        if times < 0 or ms < 0:
            raise ValueError(f"failpoint {name!r}: times/ms must be >= 0")
        with self._lock:
            self._points[name] = _Point(name, every=every, times=times, ms=ms)
        logger.warning(
            "failpoint armed: %s (every=%d times=%d ms=%g)",
            name, every, times, ms,
        )

    def arm_spec(self, spec: str) -> None:
        """Arm from the GGRMCP_FAILPOINTS / serving.failpoints syntax.
        Raises ValueError on malformed specs — a chaos config with a
        typo must fail loudly, not silently inject nothing."""
        for name, params in parse_spec(spec):
            self.arm(name, **params)

    def disarm(self, name: Optional[str] = None) -> None:
        """Disarm one point, or everything (name=None) — chaos tests
        reset the shared registry in their finally blocks."""
        with self._lock:
            if name is None:
                self._points.clear()
            else:
                self._points.pop(name, None)

    def active(self) -> dict[str, dict]:
        """Armed points with their hit/fire counters (observability)."""
        with self._lock:
            return {
                p.name: {
                    "every": p.every, "times": p.times, "ms": p.ms,
                    "hits": p.hits, "fires": p.fires,
                }
                for p in self._points.values()
            }

    def evaluate(self, name: str) -> None:
        """Hook-site entry: count one evaluation of `name`; if it is
        armed and due, sleep (ms points) or raise FailpointError."""
        with self._lock:
            point = self._points.get(name)
            if point is None:
                return
            point.hits += 1
            due = (
                point.hits % point.every == 0
                and (point.times == 0 or point.fires < point.times)
            )
            if not due:
                return
            point.fires += 1
            hit = point.hits
            sleep_s = point.ms / 1000.0
        # Act outside the lock: a sleeping failpoint must not serialize
        # every other hook site behind it.
        if sleep_s > 0:
            time.sleep(sleep_s)
            return
        raise FailpointError(name, hit)


def parse_spec(spec: str) -> list[tuple[str, dict]]:
    """Parse `name:key=val,key=val,name2:key=val` into
    [(name, params), ...]. Comma-separated segments bind to the most
    recent `name:`-prefixed segment."""
    out: list[tuple[str, dict]] = []
    current: Optional[tuple[str, dict]] = None
    for raw_segment in spec.split(","):
        segment = raw_segment.strip()
        if not segment:
            continue
        if ":" in segment:
            name, _, rest = segment.partition(":")
            current = (name.strip(), {})
            out.append(current)
            segment = rest.strip()
            if not segment:
                continue
        elif current is None:
            # A bare name arms an every-evaluation raising point.
            out.append((segment, {}))
            continue
        if "=" not in segment:
            raise ValueError(f"bad failpoint segment {segment!r} in {spec!r}")
        key, _, val = segment.partition("=")
        key = key.strip()
        if current is None or key not in ("every", "times", "ms"):
            raise ValueError(f"unknown failpoint param {key!r} in {spec!r}")
        current[1][key] = float(val) if key == "ms" else int(val)
    return out


# The process-wide registry every hook site evaluates against.
registry = FailpointRegistry()
evaluate = registry.evaluate

_env_spec = os.environ.get("GGRMCP_FAILPOINTS", "")
if _env_spec:
    registry.arm_spec(_env_spec)
