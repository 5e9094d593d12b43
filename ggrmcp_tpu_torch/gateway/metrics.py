"""Gateway metrics: real Prometheus counters/histograms.

The reference's MetricsMiddleware computed and discarded durations and
its /metrics endpoint returned an ad-hoc JSON dump
(pkg/server/middleware.go:214-233, handler.go:367-376 — acknowledged
stubs). Here metrics are first-class: prometheus_client counters,
histograms and gauges, exposed in text format at /metrics, with the
JSON stats dump preserved at /stats for reference parity.

Backend (ServingStats) export is DESCRIPTOR-DRIVEN: every scalar field
of ServingStatsResponse becomes a `gateway_backend_<field>` gauge, and
every `<name>_bucket`/`_sum`/`_count` field triplet becomes a genuine
`gateway_backend_<name>` Prometheus histogram with per-target buckets
(rendered by a custom collector from the latest snapshot, cumulative
`le` semantics). Fields 24-32 used to be hand-synced to a literal gauge
list; generating from the proto makes "added a field, forgot the gauge"
impossible, and tests/test_observability.py asserts the invariant.
"""

from __future__ import annotations

try:
    from prometheus_client import (
        CONTENT_TYPE_LATEST,
        CollectorRegistry,
        Counter,
        Gauge,
        Histogram,
        generate_latest,
    )
    from prometheus_client.core import (
        GaugeMetricFamily,
        HistogramMetricFamily,
    )

    HAVE_PROMETHEUS = True
except Exception:  # pragma: no cover - baked into the image, but be safe
    HAVE_PROMETHEUS = False

from ggrmcp_tpu_torch.rpc.pb import serving_pb2


_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.15, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)

# Help strings for the descriptor-driven backend gauges; fields without
# an entry fall back to a generic line (the proto comment remains the
# authoritative doc). Keep entries for the fields operators dashboard.
_SERVING_HELP = {
    "active_slots": "decode slots generating",
    "total_slots": "decode slot pool size",
    "queued_requests": "requests waiting for a slot",
    "kv_cache_bytes": "KV-cache HBM bytes",
    "prefix_cache_hits": "prefix cache hits",
    "prefix_cache_misses": "prefix cache misses",
    "decode_steps": "fused decode steps issued",
    "speculative_calls": "speculative device calls",
    "speculative_requests": "requests served speculatively",
    "speculative_drafted": "side micro-batcher draft tokens proposed",
    "speculative_accepted": "side micro-batcher draft tokens accepted",
    "ticks": "decode ticks dispatched",
    "tick_collects": "decode tick token collects",
    "admit_rounds": "admission rounds run",
    "tick_dispatch_ms": "cumulative host-side tick launch time (ms)",
    "tick_collect_ms":
        "cumulative blocking token-pull time (device wait + transfer, ms)",
    "admit_ms": "cumulative admission-round wall time (ms)",
    "admit_ms_max": "worst single admission round (ms)",
    "queue_ms_p50": "median admission-queue wait, recent requests (ms)",
    "queue_ms_p99": "p99 admission-queue wait, recent requests (ms)",
    "service_ms_p50": "median on-device service time, recent requests (ms)",
    "service_ms_p99": "p99 on-device service time, recent requests (ms)",
    "spec_ticks": "continuous-batcher speculative draft/verify ticks",
    "spec_drafted": "draft tokens proposed by the spec tick",
    "spec_accepted": "draft tokens accepted by the spec tick",
    "interleaved_chunks": "prefill chunks fused into decode ticks",
    "interleaved_admissions":
        "requests admitted via tick-interleaved prefill",
    "decode_stall_ms_p50":
        "median gap between a live slot's token emissions",
    "decode_stall_ms_p99":
        "p99 gap between a live slot's token emissions",
    "decode_stall_ms_max":
        "worst gap between a live slot's token emissions",
    "queued_tokens": "prompt tokens held by queued requests",
    "timed_out": "requests expired in queue past queue_deadline_ms",
    "shed_requests":
        "submits refused by bounded admission (OverloadedError)",
    "replayed_requests":
        "requests requeued with a replay prefix after a failed tick",
    "replay_exhausted":
        "requests that exhausted tick_retry_limit and errored",
    "grammar_compiles": "schema-to-DFA grammar compiles",
    "grammar_cache_hits": "grammar compile-cache hits",
    "grammar_masked_tokens":
        "tokens emitted under an active grammar mask",
    "grammar_states_in_use":
        "DFA states resident in the grammar table arena",
    "grammar_jump_tokens":
        "forced tokens emitted by jump-ahead runs (no forward pass)",
    "grammar_jump_runs": "forced multi-token jump-ahead runs collapsed",
    "grammar_jump_fallbacks":
        "jump runs refused by validation (slot degraded to one-token "
        "constrained decoding)",
    "kv_pages_total": "paged KV arena size in pages",
    "kv_pages_in_use":
        "paged KV pages resident (live + reuse-cached)",
    "kv_pages_shared": "paged KV pages refcount-shared by 2+ slots",
    "paged_prefix_hits":
        "admissions that reused shared prefix pages or a CoW source",
    "paged_cow_copies": "divergent-page copy-on-writes",
    "paged_pages_reused":
        "prefix pages served from the shared index at admission",
    "paged_pages_admitted":
        "total pages admitted (reused/admitted = page-level reuse "
        "fraction)",
    "tp_chips": "mesh tensor-axis size decode ticks shard over",
    "mesh_devices": "devices in the serving mesh",
    "mesh_spec_downgrades":
        "sharding specs downgraded to replication (0 = true TP serving)",
    "tick_phase_admit_ms":
        "cumulative tick time in queue drain + admission prefill (ms)",
    "tick_phase_sync_ms":
        "cumulative tick time in host-state snapshots (tables/tokens/"
        "grammar, ms)",
    "tick_phase_dispatch_ms":
        "cumulative tick time building + launching the jitted tick (ms)",
    "tick_phase_wait_ms":
        "cumulative tick time in device wait + transfer (ms)",
    "tick_phase_host_ms":
        "cumulative tick time in emission/finish bookkeeping (ms)",
    # Disaggregated prefill/decode serving (serving.role): the
    # sidecar→sidecar KV page-shipping plane. The role itself is a
    # string field and exports info-style beside mesh_shape.
    "kv_transfers_sent":
        "completed outbound KV page transfers (prefill role)",
    "kv_transfers_received":
        "completed inbound KV page transfers (decode role)",
    "kv_transfer_failures":
        "outbound KV transfers failed typed (each one a gateway retry "
        "on a mixed replica)",
    "kv_transfer_pages_sent": "KV pages shipped to peer sidecars",
    "kv_transfer_pages_received":
        "KV pages imported from peer sidecars",
    "kv_transfer_bytes_sent": "KV transfer wire bytes sent",
    "kv_transfer_bytes_received": "KV transfer wire bytes received",
    # Device-memory ledger (serving/memory_ledger.py): per-component
    # bytes derived from the live arrays. These render as ONE labeled
    # family — gateway_backend_memory_bytes{target, component} — via
    # the memory collector, not as per-field gauges; the help entries
    # here keep the proto-drift contract (every scalar field named).
    "memory_weights_bytes":
        "ledger: target + draft model parameter bytes (LoRA excluded)",
    "memory_lora_bytes": "ledger: stacked LoRA adapter factor bytes",
    "memory_kv_arena_bytes":
        "ledger: shared KV slot pool / paged page arena bytes",
    "memory_block_tables_bytes":
        "ledger: paged per-slot device block-table bytes",
    "memory_draft_cache_bytes":
        "ledger: speculative draft slot-pool KV bytes",
    "memory_prefix_pool_bytes":
        "ledger: slot-granular prefix-pool KV bytes (paged off)",
    "memory_ilv_mini_bytes":
        "ledger: interleaved-admission mini-cache bytes",
    "memory_grammar_arena_bytes":
        "ledger: device grammar DFA allow/transition table bytes",
    "memory_tick_state_bytes":
        "ledger: per-slot device twins (cur/prev tokens, grammar "
        "states)",
    # Compile watcher (serving/compile_watcher.py): XLA compiles in the
    # sidecar process — the silent perf killer as counters.
    "compile_count": "XLA compiles observed since process start",
    "compile_ms": "cumulative XLA compile wall time (ms)",
    "compile_cache_hits": "persistent compile-cache hits",
    "compile_cache_misses": "persistent compile-cache misses",
    "compile_post_warmup":
        "steady-state recompiles after the warmup mark (must stop "
        "growing once first traffic settles)",
    # Host-tier KV page pool (batching.paged_kv_host_bytes,
    # docs/paged_kv.md "Host tier"): DRAM behind the HBM page arena.
    # (paged_pages_reused + kv_host_restores) / paged_pages_admitted
    # is the effective hit rate — admission pages not recomputed.
    "kv_host_entries": "host-tier KV pages resident in RAM",
    "kv_host_bytes_used": "host-tier RAM pool bytes in use",
    "kv_host_budget_bytes":
        "host-tier RAM pool byte budget (paged_kv_host_bytes)",
    "kv_host_file_entries":
        "host-tier pages persisted in the mmap'd file tier",
    "kv_host_file_bytes": "host-tier file-tier log bytes",
    "kv_host_demotions":
        "arena pages demoted D2H to the host tier instead of "
        "discarded",
    "kv_host_restores":
        "demoted pages restored H2D on a prefix hit instead of "
        "recomputed",
    "kv_host_bytes_demoted": "payload bytes demoted D2H (cumulative)",
    "kv_host_bytes_restored": "payload bytes restored H2D (cumulative)",
    "kv_host_restore_failures":
        "admissions whose restore failed and degraded typed to "
        "recompute (bit-identical output, just slower)",
    # Multi-LoRA adapter arena (serving/adapter_arena.py,
    # docs/multi_lora.md): registry-backed dynamic adapters paged in
    # and out of a fixed device working set.
    # lora_hits / (lora_hits + lora_loads) is the arena hit rate;
    # lora_adapters_resident vs lora_rows_total is the occupancy gauge.
    "lora_adapters_registered":
        "adapters discoverable in the disk registry (runtime scan — "
        "no restart to add a tenant)",
    "lora_adapters_resident":
        "arena rows holding an adapter (pinned + LRU-cached)",
    "lora_rows_total":
        "device-resident adapter rows (serving.lora.arena_rows)",
    "lora_loads":
        "adapter factor loads from the registry (one batched H2D "
        "write each, serialized between ticks)",
    "lora_evictions": "refcount-0 adapter rows evicted under churn",
    "lora_hits": "adapter acquisitions served by a resident row",
    "lora_load_ms":
        "cumulative adapter load wall time (disk read + H2D install, "
        "ms)",
    "lora_shed":
        "adapter acquisitions shed typed with every row pinned "
        "(RESOURCE_EXHAUSTED -> HTTP 429)",
    # SLO accounting plane (serving/slo.py, docs/observability.md):
    # cross-class totals; the per-class partition and burn rates export
    # through the class-labeled families (_SloCollector), the
    # per-tenant table through /debug/slo only (unbounded label
    # cardinality has no place in Prometheus).
    "slo_met_total":
        "requests that finished normally within BOTH their class's "
        "TTFT and TPOT targets (goodput numerator, all classes)",
    "slo_violated_total":
        "requests that missed a latency target or finished abnormally "
        "after admission (all classes)",
    "slo_unevaluated_total":
        "requests shed before admission — counted, never silently "
        "dropped (met+violated+unevaluated == total, all classes)",
    "slo_tenants_tracked":
        "distinct tenants currently holding a row in the bounded "
        "attribution table (excl. the ~overflow bucket)",
    "slo_tenant_evictions":
        "tenant rows LRU-folded into the ~overflow bucket under "
        "cardinality churn (counters conserve)",
    # Preemptive SLO-aware scheduler (serving/scheduler.py,
    # docs/scheduling.md): demote-don't-kill preemption cycle + the
    # Sarathi prefill-budget knob. All zeros when serving.scheduler is
    # off.
    "sched_preemptions":
        "victim slots demoted, not killed: KV parked to the host "
        "tier, adapter lease released, request parked in its class's "
        "resume lane",
    "sched_resumes":
        "parked requests re-activated (pages restored with one "
        "batched H2D or recomputed — greedy output bit-identical "
        "either way)",
    "sched_preempt_failures":
        "preempt ops that degraded typed — the victim keeps decoding "
        "unharmed, never a silent loss",
    "sched_parked":
        "requests currently demoted-and-parked (resume-lane depth; "
        "each holds host-tier KV awaiting restore)",
    "sched_budget_deferrals":
        "admissions pushed to the next cycle by the Sarathi-style "
        "prefill token budget (scheduler.prefill_budget_tokens)",
}

_SERVING_HIST_HELP = {
    "ttft_ms": "backend time-to-first-token (ms), true histogram",
    "e2e_ms": "backend submit-to-terminal-chunk latency (ms)",
    "queue_ms": "backend admission-queue wait (ms)",
    "tick_duration_ms": "decode tick dispatch-to-collect latency (ms)",
    "tick_phase_admit_ms": "per-tick admit-phase time (ms)",
    "tick_phase_sync_ms": "per-tick host-state-sync time (ms)",
    "tick_phase_dispatch_ms": "per-tick jitted-dispatch time (ms)",
    "tick_phase_wait_ms": "per-tick device-wait time (ms)",
    "tick_phase_host_ms": "per-tick host-postprocess time (ms)",
    "tpot_ms":
        "per-request mean inter-token latency (TPOT, ms) — the "
        "streaming-smoothness complement of TTFT",
}

# Replica-routing counter help (rpc/router.py COUNTER_NAMES): the
# gateway-side complement of the backend ServingStats descriptors.
# Every router counter exports as gateway_routing_<name>{target} —
# built by iterating THIS table, so "added a counter, forgot the
# metric" is impossible (the routing suite asserts the invariant).
_ROUTING_HELP = {
    "routing_picks":
        "calls the router placed on this backend (any policy)",
    "affinity_hits":
        "affinity placements that landed on the rendezvous-chosen home",
    "affinity_spills":
        "affinity placements diverted off an overloaded home replica "
        "(score > gateway.routing.spill_threshold)",
    "drain_rejects":
        "placements routed AWAY from this backend while it was draining",
    "disagg_prefills":
        "disaggregated prefill legs placed on this (prefill-role) "
        "backend",
    "disagg_decodes":
        "disaggregated decode legs placed on this backend (pages "
        "arrived via TransferKV; prefill skipped)",
    "disagg_fallbacks":
        "whole-request retries placed on this backend after a typed "
        "KV-transfer failure",
}

# Fleet-supervisor counter help (serving/fleet.py COUNTER_NAMES): each
# exports as gateway_fleet_<name> (pool-level — the supervisor is one
# loop, not per-target). Built by iterating THIS table, so "added a
# counter, forgot the metric" is impossible; tests/test_fleet.py
# asserts the table stays in sync with fleet.COUNTER_NAMES.
_FLEET_HELP = {
    "spawns": "replicas spawned (scale-up, floor top-up, restarts' "
              "spawn half is counted under restarts)",
    "drains": "replicas drained by the supervisor (retire or flap heal)",
    "undrains": "supervisor un-drain actions",
    "kills": "replica processes hard-killed",
    "restarts": "replica restart actions (dead process or flap heal)",
    "retires": "replicas retired after a completed scale-down drain",
    "give_ups": "replicas abandoned after restart_max_attempts "
                "consecutive failed restarts",
    "flap_heals": "heal cycles triggered by fleet.flap_threshold "
                  "health transitions",
    "suppressed_churn": "decisions withheld by the "
                        "fleet.max_actions_per_window churn budget",
    "suppressed_floor": "drains withheld by the fleet.min_replicas "
                        "floor (incl. floor-pinned in-place heals)",
    "spawn_failures": "spawn/restart actions whose replica never "
                      "came up",
}

# Per-phase histogram bases render as ONE family with a `phase` label
# (gateway_backend_tick_phase_ms{target, phase}) so a dashboard can
# overlay a tick's phases; everything else renders per-name.
_PHASE_HIST_PREFIX = "tick_phase_"

# Memory-ledger fields (`memory_<component>_bytes`) render as ONE
# family with a `component` label — gateway_backend_memory_bytes
# {target, component} — so a dashboard stacks a replica's HBM
# partition on one chart and `sum by (target)` is the total. They are
# EXCLUDED from the per-field gauge set (serving_gauge_names), exactly
# like the phase histograms are excluded from per-name render.
_MEMORY_FIELD_RE = "memory_"
_MEMORY_FIELD_SUFFIX = "_bytes"

# /debug/ticks field help, keyed by TickRecord proto field name. Every
# scalar numeric TickRecord field must be named here — graftlint's
# proto-drift family enforces it (stale entries flagged), so the
# timeline and the tick ring cannot silently drift from the proto. The
# gateway serves this table (camelCased) as the `fields` key of the
# /debug/ticks body.
_TICK_HELP = {
    "seq": "tick sequence number within its source batcher (1-based)",
    "t_wall": "wall-clock epoch seconds at dispatch",
    "t_mono": "monotonic stamp the duration/phases derive from",
    "duration_ms":
        "attributed tick time: admit + sync + dispatch + wait + host",
    "active_slots": "slots decoding at dispatch",
    "admitted": "slots activated since the previous tick",
    "finished": "requests finished at this tick's collect",
    "interleaved_rows": "prefill chunk rows fused into this tick",
    "shed_total": "cumulative shed counter snapshotted at dispatch",
    "replayed_total": "cumulative replay counter snapshotted at dispatch",
    "timed_out_total":
        "cumulative queue-timeout counter snapshotted at dispatch",
    "spec_drafted": "draft tokens proposed on this tick (spec mode)",
    "spec_accepted": "draft tokens accepted on this tick (spec mode)",
    "kv_pages_in_use": "paged KV arena pages resident at dispatch",
    "phase_admit_ms": "queue drain + admission prefill preceding the tick",
    "phase_sync_ms":
        "host-state snapshots (block tables, tokens, grammar tables)",
    "phase_dispatch_ms": "building + launching the jitted tick",
    "phase_wait_ms":
        "device wait + transfer (incl. pipelined in-flight lag)",
    "phase_host_ms": "emission, finish handling, allocator bookkeeping",
    "jump_tokens":
        "forced tokens emitted by jump-ahead runs on this tick",
    "jump_runs": "jump-ahead forced runs collapsed on this tick",
}


def tick_field_help() -> dict:
    """The _TICK_HELP descriptor table keyed the way /debug/ticks
    records are keyed (camelCase protojson)."""
    return {_snake_to_camel(k): v for k, v in _TICK_HELP.items()}


def _snake_to_camel(name: str) -> str:
    head, *rest = name.split("_")
    return head + "".join(part.title() for part in rest)


def _is_repeated(field) -> bool:
    # protobuf >= 5 deprecates FieldDescriptor.label in favor of the
    # is_repeated property; support both without tripping the warning.
    rep = getattr(field, "is_repeated", None)
    if rep is not None:
        return bool(rep)
    return field.label == field.LABEL_REPEATED


def serving_histogram_names() -> list[str]:
    """Histogram base names derived from the ServingStatsResponse
    descriptor: every repeated `<base>_bucket` field declares one (its
    `_sum`/`_count` scalars and the shared bounds field belong to it,
    not to the gauge set)."""
    desc = serving_pb2.ServingStatsResponse.DESCRIPTOR
    return [
        f.name[: -len("_bucket")]
        for f in desc.fields
        if _is_repeated(f) and f.name.endswith("_bucket")
    ]


def serving_memory_component_names() -> list[str]:
    """Ledger component names derived from the descriptor: every
    scalar `memory_<component>_bytes` field declares one — rendered as
    the component label of the gateway_backend_memory_bytes family."""
    desc = serving_pb2.ServingStatsResponse.DESCRIPTOR
    return [
        f.name[len(_MEMORY_FIELD_RE):-len(_MEMORY_FIELD_SUFFIX)]
        for f in desc.fields
        if not _is_repeated(f)
        and f.name.startswith(_MEMORY_FIELD_RE)
        and f.name.endswith(_MEMORY_FIELD_SUFFIX)
    ]


def serving_gauge_names() -> list[str]:
    """Gauge names derived from the descriptor: every NUMERIC scalar
    (non-repeated) field that is not part of a histogram triplet.
    String fields (mesh_shape) carry identity, not magnitude — they
    export as labels on the info series instead (serving_info_names);
    memory-ledger fields export through the component-labeled family
    (serving_memory_component_names), not as per-field gauges."""
    desc = serving_pb2.ServingStatsResponse.DESCRIPTOR
    hist_members = set()
    for base in serving_histogram_names():
        hist_members.update((f"{base}_sum", f"{base}_count"))
    memory_fields = {
        f"{_MEMORY_FIELD_RE}{name}{_MEMORY_FIELD_SUFFIX}"
        for name in serving_memory_component_names()
    }
    return [
        f.name
        for f in desc.fields
        if not _is_repeated(f)
        and f.name not in hist_members
        and f.name not in memory_fields
        and f.cpp_type != f.CPPTYPE_STRING
    ]


def serving_info_names() -> list[str]:
    """String-typed scalar fields: exported Prometheus-info-style —
    `gateway_backend_serving_mesh_info{target, mesh_shape} 1` — so the
    mesh identity is joinable in PromQL without faking a number."""
    desc = serving_pb2.ServingStatsResponse.DESCRIPTOR
    return [
        f.name
        for f in desc.fields
        if not _is_repeated(f) and f.cpp_type == f.CPPTYPE_STRING
    ]


class _ServingHistogramCollector:
    """Renders the backends' latest ServingStats histogram snapshot as
    real Prometheus histogram families (`gateway_backend_<name>` with
    `_bucket{le=...}`/`_sum`/`_count` series per target). A custom
    collector because prometheus_client's Histogram cannot be set from
    pre-aggregated bucket counts — and the counts here are authoritative
    on the backend, the gateway only re-exposes them."""

    def __init__(self) -> None:
        # target -> base name -> (bounds tuple, counts list, sum)
        self.snap: dict[str, dict[str, tuple]] = {}

    @staticmethod
    def _le_buckets(bounds, counts):
        """Cumulative le-bucket pairs from non-cumulative counts (one
        overflow slot past the bounds)."""
        buckets = []
        cum = 0
        for bound, count in zip(bounds, counts):
            cum += count
            buckets.append((str(float(bound)), cum))
        cum += sum(counts[len(bounds):])
        buckets.append(("+Inf", cum))
        return buckets

    def collect(self):
        names = serving_histogram_names()
        for name in names:
            if name.startswith(_PHASE_HIST_PREFIX):
                continue  # grouped into the phase-labeled family below
            family = HistogramMetricFamily(
                f"gateway_backend_{name}",
                f"Backend ServingStats: "
                f"{_SERVING_HIST_HELP.get(name, name)}",
                labels=["target"],
            )
            for target in sorted(self.snap):
                data = self.snap[target].get(name)
                if data is None:
                    continue
                bounds, counts, total_sum = data
                family.add_metric(
                    [target], self._le_buckets(bounds, counts), total_sum
                )
            yield family
        phased = [n for n in names if n.startswith(_PHASE_HIST_PREFIX)]
        if phased:
            # One family, phase-labeled: the tick-budget decomposition
            # overlays on a single chart and PromQL can window
            # quantiles per phase (sum by (phase, le)).
            family = HistogramMetricFamily(
                "gateway_backend_tick_phase_ms",
                "Backend ServingStats: per-tick phase attribution (ms) "
                "— admit/sync/dispatch/wait/host partition each tick's "
                "duration",
                labels=["target", "phase"],
            )
            for target in sorted(self.snap):
                for name in phased:
                    data = self.snap[target].get(name)
                    if data is None:
                        continue
                    bounds, counts, total_sum = data
                    phase = name[len(_PHASE_HIST_PREFIX):-len("_ms")]
                    family.add_metric(
                        [target, phase],
                        self._le_buckets(bounds, counts),
                        total_sum,
                    )
            yield family

    def update(self, target: str, per_backend_entry: dict) -> bool:
        """Parse one protojson ServingStats entry into the snapshot;
        returns False when the entry carries no histogram data (an old
        backend or histograms disabled) so the caller can drop the
        target instead of exporting empty families."""
        bounds = per_backend_entry.get("latencyBucketBoundsMs")
        if not bounds:
            self.snap.pop(target, None)
            return False
        bounds = tuple(float(b) for b in bounds)
        per: dict[str, tuple] = {}
        for name in serving_histogram_names():
            counts = [
                int(float(c))
                for c in per_backend_entry.get(
                    _snake_to_camel(f"{name}_bucket"), []
                )
            ]
            if len(counts) != len(bounds) + 1:
                # Zero observations (protojson omits empty repeated
                # fields) or a bounds/counts length mismatch: render a
                # well-formed all-zero histogram rather than a torn one.
                counts = [0] * (len(bounds) + 1)
            per[name] = (
                bounds,
                counts,
                float(per_backend_entry.get(
                    _snake_to_camel(f"{name}_sum"), 0.0
                )),
            )
        self.snap[target] = per
        return True

    def remove(self, target: str) -> None:
        self.snap.pop(target, None)


class _ServingMemoryCollector:
    """Renders the backends' memory-ledger snapshot as ONE labeled
    family — gateway_backend_memory_bytes{target, component} — from
    the scalar memory_<component>_bytes ServingStats fields. A custom
    collector (like the histogram one) because the component set is a
    label dimension, not a metric-name dimension: `sum by (target)` is
    the replica's total accounted HBM, and a stacked-area panel of the
    components is the byte twin of the tick-phase chart."""

    def __init__(self) -> None:
        # target -> component -> bytes
        self.snap: dict[str, dict[str, float]] = {}

    def collect(self):
        family = GaugeMetricFamily(
            "gateway_backend_memory_bytes",
            "Backend ServingStats: device-memory ledger bytes per "
            "component (serving/memory_ledger.py — all zero when "
            "observability is off)",
            labels=["target", "component"],
        )
        for target in sorted(self.snap):
            for component, value in sorted(self.snap[target].items()):
                family.add_metric([target, component], value)
        yield family

    def update(self, target: str, per_backend_entry: dict) -> None:
        self.snap[target] = {
            name: float(per_backend_entry.get(
                _snake_to_camel(
                    f"{_MEMORY_FIELD_RE}{name}{_MEMORY_FIELD_SUFFIX}"
                ), 0
            ))
            for name in serving_memory_component_names()
        }

    def remove(self, target: str) -> None:
        self.snap.pop(target, None)


# The three per-class histogram metrics and their SloClassStats proto
# field prefixes — one {target, class, metric}-labeled family instead
# of three per-class name families, so a dashboard overlays a class's
# TTFT/TPOT/e2e on one chart and PromQL windows quantiles per class
# with `sum by (class, metric, le)`.
_SLO_METRICS = ("ttft", "tpot", "e2e")


class _SloCollector:
    """Renders the backends' per-class SLO snapshot (ServingStats
    `slo_classes` — serving/slo.py) as class-labeled families:

    - gateway_backend_class_latency_ms{target, class, metric} — real
      histograms (metric = ttft|tpot|e2e), bucketed on the backend
      with the flight recorder's shared bounds
    - gateway_backend_slo_requests{target, class, outcome} — the
      goodput partition (outcome = met|violated|unevaluated; the three
      sum to the class's total requests EXACTLY)
    - gateway_backend_slo_burn_rate{target, class, window} — SRE
      multi-window error-budget burn (window = seconds, e.g. "300")
    - gateway_backend_slo_sheds{target, class} — submit-time 429s by
      class (a subset of unevaluated): who absorbs the damage under
      overload, judged against the per-class Retry-After ladder
    - gateway_backend_slo_target_ms{target, class, metric} — the
      configured p99 targets (metric = ttft|tpot), exported so alert
      rules and dashboards read objectives from the SAME scrape as the
      observations

    A custom collector because the class set is a label dimension and
    the histograms arrive pre-bucketed. The per-tenant table is
    deliberately NOT exported here — tenant is an unbounded label; it
    lives on /debug/slo."""

    def __init__(self) -> None:
        # target -> list of parsed class dicts
        self.snap: dict[str, list[dict]] = {}

    def collect(self):
        hist = HistogramMetricFamily(
            "gateway_backend_class_latency_ms",
            "Backend SLO plane: per-QoS-class latency (ms) by metric "
            "(ttft|tpot|e2e) — serving/slo.py terminal-chunk "
            "classification",
            labels=["target", "class", "metric"],
        )
        requests = GaugeMetricFamily(
            "gateway_backend_slo_requests",
            "Backend SLO plane: per-class goodput partition "
            "(outcome = met|violated|unevaluated; outcomes sum to the "
            "class total exactly)",
            labels=["target", "class", "outcome"],
        )
        burn = GaugeMetricFamily(
            "gateway_backend_slo_burn_rate",
            "Backend SLO plane: error-budget burn rate over the "
            "trailing window (1.0 = burning exactly the budget; "
            "window label is seconds)",
            labels=["target", "class", "window"],
        )
        sheds = GaugeMetricFamily(
            "gateway_backend_slo_sheds",
            "Backend SLO plane: submit-time sheds (429s) by class — a "
            "subset of the unevaluated partition",
            labels=["target", "class"],
        )
        target_ms = GaugeMetricFamily(
            "gateway_backend_slo_target_ms",
            "Backend SLO plane: configured per-class p99 latency "
            "objectives (metric = ttft|tpot)",
            labels=["target", "class", "metric"],
        )
        for target in sorted(self.snap):
            for cls in self.snap[target]:
                name = cls["name"]
                for metric in _SLO_METRICS:
                    bounds, counts, total_sum = cls["hist"][metric]
                    hist.add_metric(
                        [target, name, metric],
                        _ServingHistogramCollector._le_buckets(
                            bounds, counts
                        ),
                        total_sum,
                    )
                for outcome in ("met", "violated", "unevaluated"):
                    requests.add_metric(
                        [target, name, outcome], cls[outcome]
                    )
                for window_s, rate in cls["burn"]:
                    burn.add_metric(
                        [target, name, f"{window_s:g}"], rate
                    )
                sheds.add_metric([target, name], cls["sheds"])
                for metric, value in (
                    ("ttft", cls["ttft_target_ms"]),
                    ("tpot", cls["tpot_target_ms"]),
                ):
                    target_ms.add_metric([target, name, metric], value)
        yield hist
        yield requests
        yield burn
        yield sheds
        yield target_ms

    def update(self, target: str, per_backend_entry: dict) -> None:
        """Parse one protojson ServingStats entry's sloClasses list
        (camelCase keys; int64 counters arrive as strings). Entries
        with no SLO data (old backend or observability off) clear the
        target so nothing stale exports."""
        classes = per_backend_entry.get("sloClasses") or []
        bounds = tuple(
            float(b)
            for b in per_backend_entry.get("latencyBucketBoundsMs", [])
        )
        parsed: list[dict] = []
        for cls in classes:
            per_metric: dict[str, tuple] = {}
            for metric in _SLO_METRICS:
                counts = [
                    int(float(c))
                    for c in cls.get(f"{metric}MsBucket", [])
                ]
                if len(counts) != len(bounds) + 1:
                    # Zero observations (protojson omits empty repeated
                    # fields) or torn bounds: well-formed all-zero.
                    counts = [0] * (len(bounds) + 1)
                per_metric[metric] = (
                    bounds,
                    counts,
                    float(cls.get(f"{metric}MsSum", 0.0)),
                )
            parsed.append({
                "name": str(cls.get("name", "")),
                "hist": per_metric,
                "met": float(cls.get("met", 0)),
                "violated": float(cls.get("violated", 0)),
                "unevaluated": float(cls.get("unevaluated", 0)),
                "sheds": float(cls.get("sheds", 0)),
                "burn": list(zip(
                    (float(w) for w in cls.get("burnWindowS", [])),
                    (float(r) for r in cls.get("burnRate", [])),
                )),
                "ttft_target_ms": float(cls.get("ttftP99TargetMs", 0)),
                "tpot_target_ms": float(cls.get("tpotP99TargetMs", 0)),
            })
        if parsed:
            self.snap[target] = parsed
        else:
            self.snap.pop(target, None)

    def remove(self, target: str) -> None:
        self.snap.pop(target, None)


class GatewayMetrics:
    """All gateway-side instruments, on a private registry."""

    def __init__(self) -> None:
        if not HAVE_PROMETHEUS:
            self.registry = None
            return
        self.registry = CollectorRegistry()
        self.http_requests = Counter(
            "gateway_http_requests_total",
            "HTTP requests by method/path/status",
            ["method", "path", "status"],
            registry=self.registry,
        )
        self.http_latency = Histogram(
            "gateway_http_request_seconds",
            "HTTP request latency",
            ["path"],
            buckets=_LATENCY_BUCKETS,
            registry=self.registry,
        )
        self.rpc_requests = Counter(
            "gateway_jsonrpc_requests_total",
            "JSON-RPC requests by method and outcome",
            ["rpc_method", "outcome"],
            registry=self.registry,
        )
        self.tool_calls = Counter(
            "gateway_tool_calls_total",
            "Tool invocations by tool and outcome",
            ["tool", "outcome"],
            registry=self.registry,
        )
        self.tool_latency = Histogram(
            "gateway_tool_call_seconds",
            "End-to-end tool call latency",
            ["tool"],
            buckets=_LATENCY_BUCKETS,
            registry=self.registry,
        )
        self.sessions_active = Gauge(
            "gateway_sessions_active",
            "Live sessions",
            registry=self.registry,
        )
        self.backends_healthy = Gauge(
            "gateway_backends_healthy",
            "Healthy backend count",
            registry=self.registry,
        )
        self.rate_limited = Counter(
            "gateway_rate_limited_total",
            "Requests rejected by rate limiting",
            ["scope"],  # global | session
            registry=self.registry,
        )
        # Model-plane gauges, scraped from each TPU sidecar backend's
        # ServingStats RPC at /metrics time (zeros until first scrape;
        # absent for backends without the RPC). The set is generated
        # from the proto descriptor — EVERY scalar ServingStats field
        # exports, by construction.
        self.serving_gauges = {
            name: Gauge(
                f"gateway_backend_{name}",
                f"Backend ServingStats: "
                f"{_SERVING_HELP.get(name, f'{name} (see protos/serving.proto)')}",
                ["target"],
                registry=self.registry,
            )
            for name in serving_gauge_names()
        }
        # Mesh identity, info-style: value is always 1, the labels
        # carry the strings (mesh_shape). Derived from the descriptor's
        # string fields, like the gauges from its numeric ones.
        self.serving_mesh_info = Gauge(
            "gateway_backend_serving_mesh_info",
            "Backend serving-mesh identity (labels carry the info; "
            "join on target with the tp_chips / mesh_spec_downgrades "
            "gauges)",
            ["target", *serving_info_names()],
            registry=self.registry,
        )
        self._mesh_info_labels: dict[str, tuple] = {}
        # True backend latency histograms (ttft/e2e/queue/tick
        # duration): pre-bucketed on the backend by the flight
        # recorder, re-exposed here with real `le` series so PromQL
        # can aggregate across backends and compute window quantiles.
        self.serving_histograms = _ServingHistogramCollector()
        self.registry.register(self.serving_histograms)
        # Device-memory ledger family: {target, component}-labeled
        # bytes, the HBM partition beside the time partition above.
        self.serving_memory = _ServingMemoryCollector()
        self.registry.register(self.serving_memory)
        # SLO plane: class-labeled latency/goodput/burn families
        # (serving/slo.py per-class accounts, re-exposed like the
        # histograms above — authoritative counts live on the backend).
        self.serving_slo = _SloCollector()
        self.registry.register(self.serving_slo)
        # Replica-routing placement counters (rpc/router.py), set from
        # the discoverer's snapshot at scrape time like the serving
        # gauges above. Gauges rather than Counters because the
        # authoritative counts live on the router; the gateway only
        # re-exposes the latest snapshot.
        self.routing_gauges = {
            name: Gauge(
                # routing_picks → gateway_routing_picks; the rest gain
                # the gateway_routing_ prefix (affinity_hits → ...).
                f"gateway_routing_{name.removeprefix('routing_')}",
                f"Replica routing: {help_text}",
                ["target"],
                registry=self.registry,
            )
            for name, help_text in _ROUTING_HELP.items()
        }
        self.routing_policy_info = Gauge(
            "gateway_routing_policy_info",
            "Active gateway.routing.policy (label carries the policy)",
            ["policy"],
            registry=self.registry,
        )
        self._routing_policy_seen = None
        # Fleet-supervisor counters + pool gauges (serving/fleet.py),
        # set from the supervisor snapshot at scrape time. Absent (all
        # zero) without a supervisor attached.
        self.fleet_gauges = {
            name: Gauge(
                f"gateway_fleet_{name}",
                f"Fleet supervisor: {help_text}",
                registry=self.registry,
            )
            for name, help_text in _FLEET_HELP.items()
        }
        self.fleet_replicas = Gauge(
            "gateway_fleet_replicas",
            "Supervised replicas by state "
            "(serving|retiring|healing|restarting)",
            ["state"],
            registry=self.registry,
        )
        self.fleet_paused = Gauge(
            "gateway_fleet_paused",
            "1 while the fleet supervisor is paused (POST /admin/fleet)",
            registry=self.registry,
        )
        # The overload early-warning gauge: admission-queue depth per
        # backend in both units (unit="requests" | "tokens") — watch
        # this against batching.max_pending / max_queue_tokens to see
        # shedding thresholds approach BEFORE 429s start.
        self.batcher_pending_depth = Gauge(
            "gateway_batcher_pending_depth",
            "Backend admission-queue depth (unit=requests|tokens)",
            ["target", "unit"],
            registry=self.registry,
        )
        # labels() re-validates and re-hashes label values every call
        # (~6 µs each, ×5 per request); label children are cached here.
        # Cardinality is bounded by tool/method/status counts.
        self._children: dict[tuple, object] = {}
        # Targets currently exporting serving gauges (for stale removal).
        self._serving_targets: set[str] = set()

    # -- recording helpers (no-ops without prometheus) ----------------------

    def _child(self, metric, *labels):
        key = (id(metric), *labels)
        child = self._children.get(key)
        if child is None:
            child = metric.labels(*labels)
            self._children[key] = child
        return child

    def observe_http(self, method: str, path: str, status: int, seconds: float):
        if self.registry is None:
            return
        self._child(self.http_requests, method, path, str(status)).inc()
        self._child(self.http_latency, path).observe(seconds)

    def observe_rpc(self, rpc_method: str, outcome: str):
        if self.registry is None:
            return
        self._child(self.rpc_requests, rpc_method, outcome).inc()

    def observe_tool_call(self, tool: str, outcome: str, seconds: float):
        if self.registry is None:
            return
        self._child(self.tool_calls, tool, outcome).inc()
        self._child(self.tool_latency, tool).observe(seconds)

    def rate_limit_hit(self, scope: str):
        if self.registry is None:
            return
        self._child(self.rate_limited, scope).inc()

    def set_gauges(self, sessions: int, healthy_backends: int):
        if self.registry is None:
            return
        self.sessions_active.set(sessions)
        self.backends_healthy.set(healthy_backends)

    def set_serving_stats(self, per_backend: list[dict]) -> None:
        """Record ServingStats entries (from
        ServiceDiscoverer.get_backend_serving_stats: camelCase protojson
        keys plus 'target'). Every gauge is set unconditionally —
        protojson omits zero-valued proto3 scalars, and a skipped set
        would freeze a drained counter at its last busy reading. Targets
        that disappeared or now error are removed entirely so a dead
        backend never keeps exporting stale values."""
        if self.registry is None:
            return
        live: set[str] = set()
        for entry in per_backend:
            target = entry.get("target", "unknown")
            if "error" in entry:
                continue
            live.add(target)
            for name, gauge in self.serving_gauges.items():
                value = entry.get(_snake_to_camel(name), 0)
                # float, not int: protojson renders int64 counters as
                # strings and doubles as numbers — float() takes both,
                # and the millisecond stall gauges carry fractions.
                self._child(gauge, target).set(float(value))
            info = tuple(
                str(entry.get(_snake_to_camel(name), ""))
                for name in serving_info_names()
            )
            prev = self._mesh_info_labels.get(target)
            if prev is not None and prev != info:
                # A backend's mesh identity changed (restart with a new
                # topology): retire the stale label set or both export.
                try:
                    self.serving_mesh_info.remove(target, *prev)
                except KeyError:
                    pass
            self._mesh_info_labels[target] = info
            self.serving_mesh_info.labels(target, *info).set(1)
            self.serving_histograms.update(target, entry)
            self.serving_memory.update(target, entry)
            self.serving_slo.update(target, entry)
            for unit, key in (("requests", "queuedRequests"),
                              ("tokens", "queuedTokens")):
                self._child(
                    self.batcher_pending_depth, target, unit
                ).set(float(entry.get(key, 0)))
        for target in self._serving_targets - live:
            for gauge in self.serving_gauges.values():
                try:
                    gauge.remove(target)
                except KeyError:
                    pass
                self._children.pop((id(gauge), target), None)
            self.serving_histograms.remove(target)
            self.serving_memory.remove(target)
            self.serving_slo.remove(target)
            prev = self._mesh_info_labels.pop(target, None)
            if prev is not None:
                try:
                    self.serving_mesh_info.remove(target, *prev)
                except KeyError:
                    pass
            for unit in ("requests", "tokens"):
                try:
                    self.batcher_pending_depth.remove(target, unit)
                except KeyError:
                    pass
                self._children.pop(
                    (id(self.batcher_pending_depth), target, unit), None
                )
        self._serving_targets = live

    def set_routing_stats(self, routing: dict) -> None:
        """Record the router snapshot (ServiceDiscoverer.
        get_routing_stats(): {"policy": ..., "backends": {target:
        {counter: n}}}) as gateway_routing_* gauges."""
        if self.registry is None:
            return
        policy = routing.get("policy", "")
        if policy and policy != self._routing_policy_seen:
            if self._routing_policy_seen is not None:
                try:
                    self.routing_policy_info.remove(
                        self._routing_policy_seen
                    )
                except KeyError:
                    pass
            self.routing_policy_info.labels(policy).set(1)
            self._routing_policy_seen = policy
        for target, counters in routing.get("backends", {}).items():
            for name, gauge in self.routing_gauges.items():
                self._child(gauge, target).set(float(counters.get(name, 0)))

    def set_fleet_stats(self, snapshot: dict) -> None:
        """Record the fleet supervisor snapshot
        (FleetSupervisor.snapshot(): counters + per-replica states +
        paused flag) as gateway_fleet_* series."""
        if self.registry is None:
            return
        counters = snapshot.get("counters", {})
        for name, gauge in self.fleet_gauges.items():
            gauge.set(float(counters.get(name, 0)))
        states: dict[str, int] = {}
        for replica in snapshot.get("replicas", []):
            state = replica.get("state", "serving")
            states[state] = states.get(state, 0) + 1
        for state in ("serving", "retiring", "healing", "restarting"):
            self._child(self.fleet_replicas, state).set(
                states.pop(state, 0)
            )
        for state, count in states.items():  # future-proof: unknown states
            self._child(self.fleet_replicas, state).set(count)
        self.fleet_paused.set(1 if snapshot.get("paused") else 0)

    def render(self) -> tuple[bytes, str]:
        """Prometheus text exposition."""
        if self.registry is None:
            return b"# prometheus_client unavailable\n", "text/plain"
        return generate_latest(self.registry), CONTENT_TYPE_LATEST
