"""Length-tiered KV cache: multiple slot pools with different sequence
capacities (VERDICT r1 #9 — KV-cache headroom).

The single contiguous pool costs HBM = B × S_max regardless of
occupancy, so 64 sessions and long contexts can't coexist. Tiering was
this repo's first answer: a few pools with static shapes (short×many,
long×few) keep every decode tick a fully tiled MXU program with zero
gather overhead. Since then the paged KV plane (batching.paged_kv=on,
docs/paged_kv.md) attacks the same waste at token granularity — pages
are allocated to a request's actual length and shared prefixes are
stored once — which covers most of what tiering bought, plus the
prefix-thrash regime tiers never addressed. The two compose: each tier
runs its own paged arena (a global paged_kv_pages budget is split
across tiers by KV volume below), though a single paged pool is
usually the simpler configuration now.

HBM = Σ slots_i × seq_i instead of B_total × S_global_max. Example for
llama-1b bf16 KV (16 layers × 8 kv-heads × 64): a flat 32×4096 pool is
2.1 GB; tiers [24×512, 8×4096] hold the same worst-case request and
56% of the slot count at 0.7 GB.

Admission routes each request to the smallest tier that fits
prompt + max_new + tick-overshoot; oversized requests go to the largest
tier and are clamped by its own fit_request (same policy as the flat
pool). Each tier is a full ContinuousBatcher (own cache, own tick, own host
mirrors — tiers share NO mutable host state, so their serialized
per-tier device calls may interleave freely; docs/threading.md).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import AsyncIterator, Optional

from ggrmcp_tpu_torch.core.config import BatchingConfig
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher, OverloadedError

logger = logging.getLogger("ggrmcp.torch.tiered")


class TieredBatcher:
    """ContinuousBatcher-compatible facade over per-tier pools."""

    def __init__(self, engine, cfg: BatchingConfig, eos_id: int = 2):
        assert cfg.kv_tiers, "TieredBatcher requires batching.kv_tiers"
        self.engine = engine
        self.cfg = cfg
        self.tiers: list[ContinuousBatcher] = []
        # Paged mode with an explicit global page budget: split it
        # across tiers proportional to each tier's KV volume
        # (slots × max_seq), so every tier keeps the same relative
        # headroom the contiguous pools had. 0 (auto) lets each tier
        # auto-size to slots × max_seq / page_size.
        paged = getattr(cfg, "paged_kv", "off") == "on"
        budget = int(getattr(cfg, "paged_kv_pages", 0) or 0)
        # The host tier's byte budget splits across tiers by the same
        # volume proportion (each tier owns an independent HostPagePool
        # — tiers share no mutable host state), and each tier's file
        # log gets its own suffixed path so warm restarts re-map
        # tier-for-tier.
        host_budget = int(getattr(cfg, "paged_kv_host_bytes", 0) or 0)
        host_path = getattr(cfg, "paged_kv_host_path", "") or ""
        host_file_budget = int(
            getattr(cfg, "paged_kv_host_file_bytes", 0) or 0
        )
        volumes = [int(t[0]) * int(t[1]) for t in cfg.kv_tiers]
        total_volume = sum(volumes) or 1
        for tier, volume in zip(cfg.kv_tiers, volumes):
            # [max_seq, slots] or [max_seq, slots, prefix_entries]:
            # the optional third element overrides the global prefix
            # pool size for THIS tier (0 = off). A tier whose workload
            # can't produce poolable prompts (e.g. a short headline
            # tier under the pool's min length) shouldn't pay the
            # pool's HBM or its warmup compiles — which are minutes
            # over a remote-compile TPU link.
            max_seq, slots = tier[0], tier[1]
            tier_cfg = dataclasses.replace(
                cfg, max_batch_size=int(slots),
                kv_cache_max_seq=int(max_seq), kv_tiers=[],
                prefix_cache_entries=(
                    int(tier[2]) if len(tier) > 2
                    else cfg.prefix_cache_entries
                ),
                paged_kv_pages=(
                    max(1, budget * volume // total_volume)
                    if paged and budget else 0
                ),
                paged_kv_host_bytes=(
                    max(1, host_budget * volume // total_volume)
                    if paged and host_budget else 0
                ),
                paged_kv_host_path=(
                    f"{host_path}.tier-{int(max_seq)}"
                    if paged and host_budget and host_path else ""
                ),
                paged_kv_host_file_bytes=(
                    max(1, host_file_budget * volume // total_volume)
                    if paged and host_budget and host_file_budget else 0
                ),
            )
            # The ledger scope matches the flight-recorder source
            # label, so "tier-512/kv_arena" in /debug/memory names the
            # same pool as the tier's tick records — one vocabulary
            # across the byte and time surfaces.
            tier_batcher = ContinuousBatcher(
                engine, tier_cfg, eos_id=eos_id,
                ledger_scope=f"tier-{int(max_seq)}",
            )
            # Tick seq counters are per-tier; the source label is what
            # keeps merged flight records unambiguous downstream.
            tier_batcher.recorder.source = f"tier-{int(max_seq)}"
            self.tiers.append(tier_batcher)
        logger.info(
            "tiered KV cache: %s",
            [(t.max_seq, len(t.slots)) for t in self.tiers],
        )

    def _route_tiers(
        self, prompt_len: int, max_new: int
    ) -> list[ContinuousBatcher]:
        """Tiers whose cache fits the request (incl. the tick-overshoot
        reserve the batcher subtracts in submit — tier._reserve, which
        doubles under pipelined ticks; routing on anything smaller
        silently truncates max_new in a tier whose bigger sibling
        would have served the request in full), smallest first.
        submit() prefers the head and OVERFLOWS down the list when a
        tier's bounded admission queue sheds — a full small tier spills
        into its larger siblings' headroom before the facade 429s."""
        fits = [
            tier for tier in self.tiers
            if prompt_len + max_new + 1 + tier._reserve <= tier.max_seq
        ]
        # Oversized requests: the largest pool's clamp policy applies.
        return fits or [self.tiers[-1]]

    def _route(self, prompt_len: int, max_new: int) -> ContinuousBatcher:
        """Smallest tier whose cache fits the request — the preferred
        target before any overflow-on-shed consideration."""
        return self._route_tiers(prompt_len, max_new)[0]

    # -- ContinuousBatcher interface ---------------------------------------

    def warmup(self) -> None:
        for tier in self.tiers:
            tier.warmup()

    def start(self) -> None:
        for tier in self.tiers:
            tier.start()

    async def stop(self) -> None:
        for tier in self.tiers:
            await tier.stop()

    def submit(
        self,
        prompt: list[int],
        max_new: int,
        sampling: SamplingConfig,
        seed: int = 0,
        unary: bool = False,
        adapter: int = 0,
        trace_id: str = "",
        grammar=None,
        adapter_key: str = "",
        adapter_lease=None,
        tenant: str = "",
        qos_class: str = "",
    ) -> AsyncIterator[tuple[list[int], Optional[str]]]:
        last_exc: Optional[OverloadedError] = None
        probed: list[ContinuousBatcher] = []
        for tier in self._route_tiers(len(prompt), max_new):
            try:
                it = tier.submit(
                    prompt, max_new, sampling, seed, unary=unary,
                    adapter=adapter, trace_id=trace_id, grammar=grammar,
                    adapter_key=adapter_key, adapter_lease=adapter_lease,
                    tenant=tenant, qos_class=qos_class,
                )
            except OverloadedError as exc:
                last_exc = exc
                probed.append(tier)
                continue
            # Overflow probes that a larger sibling absorbed are not
            # caller-visible sheds: un-count them so the aggregated
            # shed_requests equals requests actually refused — and the
            # SLO/tenant ledgers apply the same discipline (the
            # absorbing tier records the eventual terminal event, so a
            # leftover probe count would double-book the request).
            for tier in probed:
                tier.shed -= 1
                tier.slo.uncount_shed(qos_class)
                tier.tenants.uncount_shed(tenant)
            return it
        # Every fitting tier is at its admission cap: shed for real —
        # ONE refusal for the caller, so keep exactly one count.
        assert last_exc is not None
        for tier in probed[:-1]:
            tier.shed -= 1
            tier.slo.uncount_shed(qos_class)
            tier.tenants.uncount_shed(tenant)
        raise last_exc

    async def acquire_adapter(self, name: str):
        """Adapter-arena residency (serving/adapter_arena.py): the
        arena is ENGINE-level — every tier resolves against the same
        one — so the first tier's serialized host-op stream carries the
        load (the write produces new immutable arrays; other tiers'
        in-flight calls keep their dispatched references)."""
        return await self.tiers[0].acquire_adapter(name)

    def release_adapter(self, lease) -> None:
        self.tiers[0].release_adapter(lease)

    def cache_bytes(self) -> int:
        """Total KV-cache HBM across tiers (bench/stats reporting)."""
        return sum(t.cache_bytes() for t in self.tiers)

    def stall_snapshot(self) -> list[float]:
        """Concatenated per-tier decode-stall samples (same contract
        as each tier's stall_snapshot — bench/stats reporting)."""
        records: list = []
        for t in self.tiers:
            records.extend(t.stall_snapshot())
        return records

    def stats(self) -> dict:
        """Aggregated ServingStats across tiers: counters sum;
        queue/service (and decode-stall) percentiles are computed ONCE
        over the concatenated per-tier records (summing a p50 is
        meaningless, and per-tier percentile sorts would be wasted
        work on every scrape); histogram bucket counts merge
        elementwise (histograms, unlike percentiles, ARE summable —
        the whole point of exporting them)."""
        from ggrmcp_tpu_torch.serving.flight_recorder import FlightRecorder
        from ggrmcp_tpu_torch.serving.slo import SloAccount, TenantTable

        per_tier = [t.counter_stats() for t in self.tiers]
        records: list = []
        for t in self.tiers:
            records.extend(t.lat_snapshot())
        return {
            **{
                key: (
                    max(s[key] for s in per_tier)
                    if key in ContinuousBatcher.MAX_STAT_KEYS
                    else sum(s[key] for s in per_tier)
                )
                for key in per_tier[0]
            },
            **ContinuousBatcher.lat_percentiles(records),
            **ContinuousBatcher.stall_percentiles(self.stall_snapshot()),
            **FlightRecorder.merge_histogram_stats(
                [t.recorder.histogram_stats() for t in self.tiers]
            ),
            # SLO/tenant ledgers merge exactly, like the histograms:
            # partition counters and buckets sum per class/tenant, burn
            # rates recombine from per-tier window deltas (a weighted
            # merge, not an average of rates), and the merged tenant
            # view re-applies the cardinality bound.
            **SloAccount.merged_stats([t.slo for t in self.tiers]),
            **TenantTable.merged_stats([t.tenants for t in self.tiers]),
        }

    def flight_snapshot(
        self,
        max_ticks: int = 128,
        max_requests: int = 128,
        trace_id: str = "",
        tenant: str = "",
    ) -> tuple[list, list]:
        """Merged per-tier flight records, ordered by wall-clock stamp
        (tick seq counters are per-tier; `source` disambiguates)."""
        ticks: list = []
        requests: list = []
        for tier in self.tiers:
            t_ticks, t_requests = tier.flight_snapshot(
                max_ticks, max_requests, trace_id, tenant
            )
            ticks.extend(t_ticks)
            requests.extend(t_requests)
        ticks.sort(key=lambda r: r.t_wall)
        requests.sort(key=lambda r: r.t_submit)
        return ticks[-max(1, max_ticks):], requests[-max(1, max_requests):]

    def request_record(self, trace_id: str):
        for tier in self.tiers:
            rec = tier.request_record(trace_id)
            if rec is not None:
                return rec
        return None

    # Prefix-pool counters aggregate across tiers (each tier owns its
    # own pool — tiers share no mutable host state, docs/threading.md).
    @property
    def prefix_hits(self) -> int:
        return sum(t.prefix_hits for t in self.tiers)

    @property
    def prefix_misses(self) -> int:
        return sum(t.prefix_misses for t in self.tiers)
