"""Load-aware replica routing for the gateway's DP replica pools.

Grows the per-tool round-robin cursors that used to live inline in
`ServiceDiscoverer._route` into a pluggable routing plane
(gateway.routing config, docs/routing.md). The discoverer still owns
membership (which backends serve a tool, health, drain state); this
module owns PLACEMENT: given the placeable candidates for one call,
pick the replica.

Three policies:

- ``round_robin``: the historical behavior, bit-for-bit — one
  itertools.count cursor per tool, index = next(cursor) % len(candidates)
  (a single shared counter would let interleaved multi-tool traffic pin
  each tool to one replica).

- ``least_loaded``: score every candidate from the ServingStats snapshot
  the discoverer's background task refreshes (score = pending queue
  depth + EWMA TTFT), place on the cheapest. The snapshot is read, never
  awaited — routing NEVER blocks on a gRPC fan-out; when the snapshot is
  stale (wedged refresh, dead sidecars) the policy degrades loudly to
  round-robin rather than stalling or flapping on garbage.

- ``affinity``: rendezvous (highest-random-weight) hashing of a stable
  per-call key over the candidate set. Same key → same replica across
  unrelated membership churn (removing a non-chosen replica never remaps
  a key — the property plain `hash % n` lacks), so one replica
  accumulates a session's paged-KV prefix pages instead of every replica
  cold-prefilling them (the SGLang/Preble insight: cache-aware routing
  beats round-robin when prefix reuse is high). Affinity is a
  PREFERENCE: when the chosen replica's score exceeds
  ``spill_threshold``, the call spills to the least-loaded replica and
  the spill is counted.

Disaggregated prefill/decode fleets (serving.role, docs/routing.md):
replicas declare a role through ServingStats; the discoverer stamps it
onto each Backend at discovery time (roles are static per replica
process), so the hot path reads an attribute, never a snapshot.
Prefill-role replicas are excluded from
ordinary placement (_role_filtered); long-prompt requests take a
two-leg plan (plan_disagg) — prefill leg on a prefill replica (which
ships the prompt's KV pages to the decode replica via the sidecar
TransferKV RPC), decode leg through the ordinary pick() so affinity
keeps protecting the decode replica's page index. A failed transfer
retries typed on a mixed replica (pick_fallback, counted). A
pure-mixed fleet takes none of these branches and routes bit-for-bit
like the pre-role gateway.

Deprecated prefill steering (``steer_prefill=on``): the pre-role
heuristic that preferred replicas with the smallest admit-phase share.
Rejected typed (RoleConfigError) the moment any replica declares a
non-mixed role — the heuristic and the real split must not fight.

Observability: per-backend counters (routing_picks, affinity_hits,
affinity_spills, drain_rejects) exported as gateway_routing_* metrics
and surfaced in /stats and /debug/requests (gateway/metrics.py
_ROUTING_HELP is the descriptor table).
"""

from __future__ import annotations

import hashlib
import itertools
import json
import logging
from typing import Any, Callable, Optional, Sequence

from ggrmcp_tpu_torch.core.config import ROUTING_POLICIES, RoutingConfig

logger = logging.getLogger("ggrmcp.rpc.router")

# Score units: one queued request costs 1.0; EWMA TTFT contributes
# ttft_ms / TTFT_MS_PER_POINT. 100 ms of TTFT ≈ one queue slot keeps
# the two signals on comparable scales for the default spill threshold.
TTFT_MS_PER_POINT = 100.0
# EWMA smoothing over per-refresh TTFT window means: high enough to
# follow load shifts within a few snapshot periods (~5 s each), low
# enough that one noisy window doesn't thrash placement.
EWMA_ALPHA = 0.3

# The per-backend counter names (also the gateway_routing_* metric
# suffixes — gateway/metrics.py renders help from _ROUTING_HELP).
COUNTER_NAMES = (
    "routing_picks", "affinity_hits", "affinity_spills", "drain_rejects",
    "disagg_prefills", "disagg_decodes", "disagg_fallbacks",
)


class RoleConfigError(ValueError):
    """steer_prefill=on met a fleet with declared replica roles. The
    heuristic and the real split must not fight over placement, so the
    combination is rejected typed, naming the migration — at config
    validation when both live in one tree, and here at pick time when
    the roles arrive over the wire from independently configured
    replicas."""

    def __init__(self) -> None:
        super().__init__(
            "gateway.routing.steer_prefill=on is superseded by replica "
            "roles: this fleet declares non-'mixed' serving.role "
            "replicas, which do the real prefill/decode split "
            "(page-granular KV shipping). Drop steer_prefill and use "
            "gateway.routing.disagg (docs/routing.md role-split "
            "runbook)"
        )


def derive_affinity_key(
    tool_name: str,
    arguments: Any,
    headers: Optional[Sequence[tuple[str, str]]],
    preamble_bytes: int,
) -> Optional[bytes]:
    """The stable routing key, strongest-cohort first: the call's LoRA
    adapter id when one applies (the ``adapter`` argument the gateway
    resolved from binding/header, else the forwarded ``x-adapter-id``)
    — HRW on the adapter id keeps an adapter's arena row AND its
    key-domain prefix pages co-resident on ONE replica, so a thousand
    tenants cost one load each fleet-wide instead of one per replica
    (docs/multi_lora.md; an overloaded home still spills, counted).
    Then the caller's ``x-session-id`` header (explicit session
    pinning), else the tool name + the first N bytes of the canonically
    serialized request (sorted-key JSON — the shared system-prompt
    preamble lands in those bytes, so same-preamble sessions share a
    key). None when no key can be derived (router falls back to
    load-based placement)."""
    adapter = ""
    if isinstance(arguments, dict):
        value = arguments.get("adapter")
        if isinstance(value, str):
            adapter = value
    if not adapter and headers:
        for key, value in headers:
            if key.lower() == "x-adapter-id" and value:
                adapter = value
                break
    if adapter:
        return b"a:" + adapter.encode("utf-8", "surrogatepass")
    if headers:
        for key, value in headers:
            if key.lower() == "x-session-id" and value:
                return b"s:" + value.encode("utf-8", "surrogatepass")
    try:
        serialized = json.dumps(
            arguments, sort_keys=True, ensure_ascii=False
        ).encode("utf-8", "surrogatepass")
    except (TypeError, ValueError):
        return None
    return (
        b"p:" + tool_name.encode() + b"|" + serialized[:preamble_bytes]
    )


def estimate_prefill_tokens(arguments: Any) -> int:
    """Cheap upper-bound estimate of a call's prefill work for the
    experimental steering policy: the prompt's byte length (exact for
    the hermetic byte tokenizer; an overestimate of roughly 4x for BPE
    vocabularies — the threshold knob absorbs the scale)."""
    if arguments is None:
        return 0
    if isinstance(arguments, dict):
        prompt = arguments.get("prompt")
        if isinstance(prompt, str):
            return len(prompt.encode("utf-8", "surrogatepass"))
    try:
        return len(json.dumps(arguments)) // 4
    except (TypeError, ValueError):
        return 0


class ReplicaRouter:
    """Placement policy over one call's candidate replicas.

    ``stats_view`` is a zero-arg callable returning ``(entries, age_s)``
    — the discoverer's cached ServingStats snapshot (camelCase protojson
    entries each carrying "target") and its age in seconds. The router
    only ever READS it; refresh scheduling stays with the discoverer.
    """

    def __init__(
        self,
        cfg: Optional[RoutingConfig] = None,
        stats_view: Optional[Callable[[], tuple[list[dict], float]]] = None,
    ):
        self.cfg = cfg or RoutingConfig()
        if self.cfg.policy not in ROUTING_POLICIES:
            raise ValueError(
                f"unknown routing policy {self.cfg.policy!r}; "
                f"supported: {', '.join(ROUTING_POLICIES)}"
            )
        self._stats_view = stats_view or (lambda: ([], float("inf")))
        # Per-tool round-robin cursors (see module docstring).
        self._rr: dict[str, itertools.count] = {}
        self._counters: dict[str, dict[str, int]] = {}
        # EWMA TTFT per target, fed from per-refresh histogram deltas.
        self._ewma_ttft: dict[str, float] = {}
        self._ttft_prev: dict[str, tuple[float, float]] = {}
        # Loud-degrade latch: warn once per staleness episode, not once
        # per call (a wedged refresh would otherwise flood the log).
        self._stale_warned = False
        # Same latch for the all-prefill-pool degenerate fleet.
        self._all_prefill_warned = False

    # -- properties the hot path gates on --------------------------------

    @property
    def policy(self) -> str:
        return self.cfg.policy

    @property
    def wants_affinity_key(self) -> bool:
        """True when the invoke path should derive the per-call routing
        key. Gated so the default round_robin path never pays the
        json.dumps (bitwise behavior-compatibility with the pre-router
        hot path)."""
        return self.cfg.policy == "affinity"

    @property
    def wants_prefill_estimate(self) -> bool:
        return self.cfg.steer_prefill == "on"

    # -- counters ---------------------------------------------------------

    def _counter(self, target: str) -> dict[str, int]:
        counter = self._counters.get(target)
        if counter is None:
            counter = dict.fromkeys(COUNTER_NAMES, 0)
            self._counters[target] = counter
        return counter

    def note_drain_reject(self, target: str) -> None:
        """One placement routed AWAY from this backend because it is
        draining (counted by the discoverer at candidate-filter time)."""
        self._counter(target)["drain_rejects"] += 1

    def snapshot(self) -> dict[str, Any]:
        """Counters + policy for /stats, /debug/requests and the
        gateway_routing_* metrics."""
        return {
            "policy": self.cfg.policy,
            "backends": {
                target: dict(counters)
                for target, counters in sorted(self._counters.items())
            },
        }

    # -- scoring ----------------------------------------------------------

    def _scores(self, candidates: Sequence[Any]) -> Optional[dict[str, float]]:
        """Load score per candidate target from the stats snapshot, or
        None when the snapshot is unusable (stale, or no candidate
        appears in it) — the caller then degrades to round-robin.
        Unhealthy/draining backends never reach here: the discoverer
        filters candidates before placement, so they are excluded from
        scoring by construction."""
        entries, age_s = self._stats_view()
        if age_s > self.cfg.stale_stats_max_age_s:
            if not self._stale_warned:
                logger.warning(
                    "routing: ServingStats snapshot is stale (%.0fs > "
                    "%.0fs); %s degrades to round-robin until the "
                    "refresh recovers",
                    age_s, self.cfg.stale_stats_max_age_s, self.cfg.policy,
                )
                self._stale_warned = True
            return None
        if self._stale_warned:
            logger.info("routing: ServingStats snapshot fresh again")
            self._stale_warned = False
        by_target = {
            e.get("target"): e for e in entries if "error" not in e
        }
        scores: dict[str, float] = {}
        matched = False
        for backend in candidates:
            entry = by_target.get(backend.target)
            if entry is None:
                # A backend without ServingStats (plain gRPC upstream)
                # scores as unloaded; the `matched` gate below ensures
                # a pool with NO stats at all falls back to round-robin
                # instead of always picking the first target.
                scores[backend.target] = 0.0
                continue
            matched = True
            queued = _num(entry.get("queuedRequests", 0))
            scores[backend.target] = (
                queued
                + self._update_ewma(backend.target, entry) / TTFT_MS_PER_POINT
            )
        return scores if matched else None

    def _update_ewma(self, target: str, entry: dict) -> float:
        """EWMA of the per-refresh TTFT window mean, fed from the
        cumulative ttft histogram sum/count pair (new observations since
        the previous snapshot form one window)."""
        total = _num(entry.get("ttftMsSum", 0.0))
        count = _num(entry.get("ttftMsCount", 0))
        prev_total, prev_count = self._ttft_prev.get(target, (0.0, 0.0))
        if count > prev_count:
            window = (total - prev_total) / (count - prev_count)
            prev_ewma = self._ewma_ttft.get(target)
            self._ewma_ttft[target] = (
                window if prev_ewma is None
                else EWMA_ALPHA * window + (1.0 - EWMA_ALPHA) * prev_ewma
            )
            self._ttft_prev[target] = (total, count)
        elif count < prev_count:  # backend restarted: counters reset
            self._ttft_prev[target] = (total, count)
            self._ewma_ttft[target] = (total / count) if count else 0.0
        return self._ewma_ttft.get(target, 0.0)

    def _prefill_light(
        self, candidates: Sequence[Any]
    ) -> Optional[list[Any]]:
        """The prefill-light half of the candidates: those whose
        cumulative admit-phase share of tick time (the recorder's phase
        scalars; admit = queue drain + admission prefill) is at or
        below the candidate median. None when phase data is absent."""
        entries, age_s = self._stats_view()
        if age_s > self.cfg.stale_stats_max_age_s:
            return None
        by_target = {
            e.get("target"): e for e in entries if "error" not in e
        }
        shares: dict[str, float] = {}
        for backend in candidates:
            entry = by_target.get(backend.target)
            if entry is None:
                continue
            phases = [
                _num(entry.get(key, 0.0))
                for key in (
                    "tickPhaseAdmitMs", "tickPhaseSyncMs",
                    "tickPhaseDispatchMs", "tickPhaseWaitMs",
                    "tickPhaseHostMs",
                )
            ]
            total = sum(phases)
            if total > 0:
                shares[backend.target] = phases[0] / total
        if len(shares) < 2:
            return None  # nothing to discriminate between
        cutoff = sorted(shares.values())[(len(shares) - 1) // 2]
        light = [
            b for b in candidates if shares.get(b.target, 0.0) <= cutoff
        ]
        return light or None

    # -- replica roles (disaggregated prefill/decode fleets) ---------------
    #
    # Roles are STATIC per replica process (serving.role config): the
    # discoverer reads each backend's role once at discovery time (one
    # GetServingStats on the cold path) and stamps it on the Backend —
    # so the hot path reads an attribute, never a snapshot, and a
    # pure-mixed fleet routes bit-for-bit like the pre-role gateway. A
    # role change is a drain → restart → rediscover cycle
    # (docs/routing.md role-flip runbook), exactly like a method-set
    # change.

    @staticmethod
    def _role_of(backend: Any) -> str:
        return getattr(backend, "role", "mixed") or "mixed"

    def _role_filtered(self, candidates: Sequence[Any]) -> Sequence[Any]:
        """Exclude prefill-role replicas from ordinary (single-leg)
        placement: a dedicated prefill replica serves prefill legs, not
        decode traffic — that isolation is the whole point of the
        split. No-op on a pure-mixed fleet. An all-prefill candidate
        set degrades loudly to the full set: serving wrong-role traffic
        beats serving nothing."""
        if all(self._role_of(b) == "mixed" for b in candidates):
            return candidates
        if self.cfg.steer_prefill == "on":
            raise RoleConfigError()
        serving = [
            b for b in candidates if self._role_of(b) != "prefill"
        ]
        if not serving:
            if not self._all_prefill_warned:
                logger.warning(
                    "routing: every placeable replica declares "
                    "role=prefill; placing decode traffic on them "
                    "anyway (add decode or mixed replicas)"
                )
                self._all_prefill_warned = True
            return candidates
        self._all_prefill_warned = False
        return serving

    def plan_disagg(
        self,
        tool_name: str,
        candidates: Sequence[Any],
        est_prefill_tokens: int,
        affinity_key: Optional[bytes] = None,
    ) -> Optional[tuple[Any, Any]]:
        """(prefill replica, decode replica) for a long-prompt request
        in a role-split fleet, or None to take the ordinary
        single-replica path. The prefill leg places least-loaded over
        the prefill-role replicas; the decode leg is the ordinary
        pick() over the decode-capable ones, so session/prefix affinity
        keeps protecting the decode replica's page index."""
        if (
            self.cfg.disagg == "off"
            or len(candidates) < 2
            or est_prefill_tokens < self.cfg.disagg_min_prompt_tokens
        ):
            return None
        roles = {b.target: self._role_of(b) for b in candidates}
        if self.cfg.steer_prefill == "on" and any(
            r != "mixed" for r in roles.values()
        ):
            raise RoleConfigError()
        prefills = [
            b for b in candidates if roles[b.target] == "prefill"
        ]
        # Dedicated decode replicas take the decode leg; mixed replicas
        # only when none exist (they are the fallback pool — keeping
        # them out of the steady-state leg keeps their arenas free for
        # retries and short traffic).
        decodes = [
            b for b in candidates if roles[b.target] == "decode"
        ] or [
            b for b in candidates if roles[b.target] != "prefill"
        ]
        if not prefills or not decodes:
            return None
        prefill = self._pick_least_loaded(
            tool_name + "\x00prefill", prefills
        )
        decode = self.pick(
            tool_name, decodes, affinity_key=affinity_key
        )
        self._counter(prefill.target)["routing_picks"] += 1
        self._counter(prefill.target)["disagg_prefills"] += 1
        self._counter(decode.target)["disagg_decodes"] += 1
        return prefill, decode

    def pick_fallback(
        self, tool_name: str, candidates: Sequence[Any]
    ) -> Any:
        """The typed retry target after a failed prefill leg or KV
        transfer: a mixed replica when one exists (it can run the whole
        request), else any decode-capable one, else anything — the
        request must finish correctly somewhere, and the fallback is
        counted, never silent."""
        mixed = [
            b for b in candidates if self._role_of(b) == "mixed"
        ]
        pool = mixed or [
            b for b in candidates if self._role_of(b) != "prefill"
        ] or list(candidates)
        chosen = self._pick_least_loaded(tool_name, pool)
        self._counter(chosen.target)["routing_picks"] += 1
        self._counter(chosen.target)["disagg_fallbacks"] += 1
        return chosen

    # -- placement --------------------------------------------------------

    def pick(
        self,
        tool_name: str,
        candidates: Sequence[Any],
        affinity_key: Optional[bytes] = None,
        est_prefill_tokens: int = 0,
    ) -> Any:
        """Choose the serving replica among `candidates` (non-empty,
        already filtered to connected + healthy-or-last-resort +
        non-draining by the discoverer). Objects only need a `.target`
        attribute. Prefill-role replicas are additionally excluded here
        (_role_filtered) — they serve prefill legs, placed by
        plan_disagg, not ordinary traffic."""
        candidates = self._role_filtered(candidates)
        policy = self.cfg.policy
        chosen = None
        if policy == "affinity" and affinity_key is not None:
            chosen = self._pick_affinity(tool_name, candidates, affinity_key)
        elif policy in ("least_loaded", "affinity"):
            # least_loaded proper, or affinity with no derivable key.
            chosen = self._pick_least_loaded(
                tool_name, candidates, est_prefill_tokens
            )
        else:
            chosen = self._pick_round_robin(
                tool_name, self._steered(candidates, est_prefill_tokens)
            )
        self._counter(chosen.target)["routing_picks"] += 1
        return chosen

    def _steered(
        self, candidates: Sequence[Any], est_prefill_tokens: int
    ) -> Sequence[Any]:
        """Experimental prefill steering: narrow heavy-prefill requests
        to the prefill-light half of the pool. A no-op unless the flag
        is on, the request is past the threshold, and phase data exists."""
        if (
            self.cfg.steer_prefill != "on"
            or est_prefill_tokens < self.cfg.steer_prefill_min_tokens
            or len(candidates) < 2
        ):
            return candidates
        light = self._prefill_light(candidates)
        return light if light else candidates

    def _pick_round_robin(
        self, tool_name: str, candidates: Sequence[Any]
    ) -> Any:
        cursor = self._rr.setdefault(tool_name, itertools.count())
        return candidates[next(cursor) % len(candidates)]

    def _pick_least_loaded(
        self,
        tool_name: str,
        candidates: Sequence[Any],
        est_prefill_tokens: int = 0,
    ) -> Any:
        candidates = self._steered(candidates, est_prefill_tokens)
        scores = self._scores(candidates)
        if scores is None:
            # Loud degrade (logged in _scores): stale or absent stats
            # must never stall placement.
            return self._pick_round_robin(tool_name, candidates)
        # Deterministic tie-break by target string: equal scores place
        # identically on every gateway process, so a fleet of gateways
        # converges instead of each flapping its own way.
        return min(candidates, key=lambda b: (scores[b.target], b.target))

    def _pick_affinity(
        self, tool_name: str, candidates: Sequence[Any], key: bytes
    ) -> Any:
        home = self._hrw(key, candidates)
        threshold = self.cfg.spill_threshold
        if threshold > 0 and len(candidates) > 1:
            scores = self._scores(candidates)
            if scores is not None and scores[home.target] > threshold:
                least = min(
                    candidates, key=lambda b: (scores[b.target], b.target)
                )
                if least.target != home.target:
                    self._counter(home.target)["affinity_spills"] += 1
                    return least
        self._counter(home.target)["affinity_hits"] += 1
        return home

    @staticmethod
    def _hrw(key: bytes, candidates: Sequence[Any]) -> Any:
        """Rendezvous hashing: weight every candidate by a keyed hash, take
        the max. Removing any non-chosen member never remaps the key;
        adding a member only steals the keys it now wins — exactly the
        stability a replica-resident prefix cache needs."""
        best = None
        best_weight = -1
        for backend in candidates:
            digest = hashlib.blake2b(
                key + b"\x00" + backend.target.encode(), digest_size=8
            ).digest()
            weight = int.from_bytes(digest, "big")
            if weight > best_weight or (
                weight == best_weight
                and best is not None
                and backend.target < best.target
            ):
                best, best_weight = backend, weight
        return best


def _num(value: Any) -> float:
    """protojson renders int64 as strings and doubles as numbers; a
    missing field arrives as 0. float() takes all three."""
    try:
        return float(value)
    except (TypeError, ValueError):
        return 0.0
