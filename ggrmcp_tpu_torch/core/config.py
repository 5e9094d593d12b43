"""The port's configuration tree.

The gateway's sections (`ServerConfig` through `ToolsConfig`,
`RoutingConfig`, `GatewayConfig`, `LoggingConfig`, `MetricsConfig`) are
the reference's classes (`ggrmcp_tpu/core/config.py`), copied with their
fields, defaults and checks. `BatchingConfig`, `ServingConfig`,
`TrainingConfig` and their sections carry the fields this package reads,
under the reference's names and defaults, with the reference's checks.
A value the port does not serve raises ValueError naming the field,
never silently ignored. `load` reads a whole reference config file
(JSON, or YAML with PyYAML) and the GGRMCP_* environment over it, as the
reference does.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Optional

# Weight and KV-cache quantization modes ("" = the model dtype).
QUANTIZE_MODES = ("", "int8")


@dataclass
class BatchingConfig:
    max_batch_size: int = 32
    max_queue_delay_ms: float = 5.0
    max_decode_steps: int = 512
    prefill_chunk: int = 512
    kv_cache_max_seq: int = 4096
    # "auto" resolves to DECODE_STEPS_CUDA (resolve_decode_steps).
    decode_steps_per_tick: "int | str" = "auto"
    # "auto" and "off" both mean synchronous ticks in this package.
    pipeline_ticks: str = "auto"
    max_pending: int = 0
    max_queue_tokens: int = 0
    tick_retry_limit: int = 1
    # Slot-granular prefix (prompt-KV) pool; 0 entries = off.
    prefix_cache_entries: int = 0
    prefix_cache_max_seq: int = 512  # per-entry KV capacity (tokens)
    prefix_cache_min_seq: int = 64  # don't pool prefixes shorter than this
    # "on": long prompts arriving mid-decode ride the decode ticks one
    # [K <= prefill_interleave_rows, prefill_chunk] chunk at a time.
    prefill_interleave: str = "off"
    prefill_interleave_rows: int = 4
    # "on": one page arena + per-slot block tables with refcounted
    # page-aligned prefix sharing (serving/pages.py); supersedes the
    # prefix pool. 0 pages = max_batch_size * kv_cache_max_seq / page.
    paged_kv: str = "off"
    paged_kv_page_size: int = 16
    paged_kv_pages: int = 0
    # A queued request older than this (ms since submit) finishes
    # "timeout" before admission; 0 = off.
    queue_deadline_ms: float = 0.0
    # While slots decode, one admission round may stall them by at most
    # p50_budget_ms / 4 (rows capped by a per-row cost EMA); 0 = off.
    p50_budget_ms: float = 0.0
    # Host page tier (serving/host_pool.py): arena eviction demotes
    # refcount-0 indexed pages into this many bytes of host RAM and a
    # prefix hit restores them instead of recomputing; 0 = no tier.
    # `paged_kv_host_path` adds the append-only file tier behind it (a
    # restarted replica warms from it), capped at
    # `paged_kv_host_file_bytes` (0 = unbounded).
    paged_kv_host_bytes: int = 0
    paged_kv_host_path: str = ""
    paged_kv_host_file_bytes: int = 0
    # Length tiers (serving/tiered.py): [[max_seq, slots] or [max_seq,
    # slots, prefix_entries], ...] strictly ascending by max_seq, one
    # ContinuousBatcher per tier; [] = one pool.
    kv_tiers: list = field(default_factory=list)
    # "on" with serving.speculative_draft: every tick is one draft /
    # verify round (ops/speculative.py::spec_tick) over the slot pool.
    speculative: str = "off"

    def __post_init__(self) -> None:
        self._validate_kv_reuse()
        if self.speculative not in ("off", "on"):
            raise ValueError("batching.speculative must be 'off' or 'on'")
        if self.pipeline_ticks not in ("auto", "off"):
            raise ValueError(
                f"batching.pipeline_ticks={self.pipeline_ticks!r} is not "
                f"supported by the PyTorch port (auto | off: synchronous)"
            )
        steps = self.decode_steps_per_tick
        if steps != "auto" and (
            isinstance(steps, bool) or not isinstance(steps, int) or steps < 1
        ):
            raise ValueError(
                f"batching.decode_steps_per_tick={steps!r}: 'auto' or an "
                f"int >= 1"
            )
        if self.max_batch_size < 1 or self.prefill_chunk < 1:
            raise ValueError("batching.max_batch_size and prefill_chunk >= 1")
        if self.tick_retry_limit < 0:
            raise ValueError("batching.tick_retry_limit must be >= 0")
        if self.p50_budget_ms < 0:
            raise ValueError("p50_budget_ms must be >= 0 (0 = off)")
        if self.queue_deadline_ms < 0:
            raise ValueError("queue_deadline_ms must be >= 0 (0 = off)")
        self._validate_tiers()

    def _validate_tiers(self) -> None:
        """The reference's kv_tiers checks (Config.validate): entry
        shape, ascending order, the tick overshoot below the smallest
        tier, and the page size dividing every tier under paging."""
        tiers = self.kv_tiers
        if not tiers:
            return
        if not all(
            isinstance(t, (list, tuple)) and len(t) in (2, 3)
            and int(t[0]) > 0 and int(t[1]) > 0
            and (len(t) == 2 or int(t[2]) >= 0)
            for t in tiers
        ):
            raise ValueError(
                "batching.kv_tiers entries must be [max_seq, slots] "
                "or [max_seq, slots, prefix_entries] with positive "
                "max_seq/slots and prefix_entries >= 0"
            )
        seqs = [int(t[0]) for t in tiers]
        if seqs != sorted(seqs) or len(set(seqs)) != len(seqs):
            raise ValueError(
                "batching.kv_tiers must be strictly ascending by max_seq"
            )
        if resolve_decode_steps(self) >= seqs[0]:
            raise ValueError(
                "decode_steps_per_tick must be < the smallest tier's "
                "max_seq"
            )
        if self.paged_kv == "on":
            page = self.paged_kv_page_size
            for t in tiers:
                if int(t[0]) % page:
                    raise ValueError(
                        f"batching.paged_kv_page_size ({page}) must "
                        f"divide every tier max_seq (tier {int(t[0])})"
                    )
                if len(t) > 2 and int(t[2]) > 0:
                    raise ValueError(
                        "batching.paged_kv supersedes per-tier prefix "
                        "pools: kv_tiers prefix_entries must be 0 "
                        "under paging"
                    )

    def _validate_kv_reuse(self) -> None:
        """The reference's checks of these fields (Config.validate)."""
        if self.prefill_interleave not in ("off", "on"):
            raise ValueError(
                "batching.prefill_interleave must be one of off/on"
            )
        if self.prefill_interleave_rows < 1:
            raise ValueError("batching.prefill_interleave_rows must be >= 1")
        if self.paged_kv not in ("off", "on"):
            raise ValueError("batching.paged_kv must be 'off' or 'on'")
        if self.paged_kv_page_size < 1:
            raise ValueError("batching.paged_kv_page_size must be >= 1")
        if self.paged_kv_pages < 0:
            raise ValueError(
                "batching.paged_kv_pages must be >= 0 (0 = auto-size)"
            )
        if self.paged_kv == "on":
            if self.prefix_cache_entries:
                raise ValueError(
                    "batching.paged_kv supersedes the slot-granular "
                    "prefix pool: set prefix_cache_entries to 0 "
                    "(page-aligned prefix sharing is built into the "
                    "paged allocator — docs/paged_kv.md)"
                )
            page = self.paged_kv_page_size
            if self.kv_cache_max_seq % page:
                raise ValueError(
                    f"batching.paged_kv_page_size ({page}) must divide "
                    f"kv_cache_max_seq ({self.kv_cache_max_seq}): block "
                    f"tables map whole pages"
                )
        if self.paged_kv_host_bytes < 0:
            raise ValueError(
                "batching.paged_kv_host_bytes must be >= 0 (0 = no "
                "host tier)"
            )
        if self.paged_kv_host_file_bytes < 0:
            raise ValueError(
                "batching.paged_kv_host_file_bytes must be >= 0 "
                "(0 = unbounded log)"
            )
        if self.paged_kv_host_bytes and self.paged_kv != "on":
            raise ValueError(
                "batching.paged_kv_host_bytes requires paged_kv=on: "
                "the host tier demotes and restores PAGES"
            )
        if self.paged_kv_host_path and not self.paged_kv_host_bytes:
            raise ValueError(
                "batching.paged_kv_host_path is the file tier BEHIND "
                "the host RAM pool: set paged_kv_host_bytes > 0"
            )
        if self.paged_kv_host_file_bytes and not self.paged_kv_host_path:
            raise ValueError(
                "batching.paged_kv_host_file_bytes caps the file-tier "
                "log: set paged_kv_host_path"
            )
        if self.prefix_cache_entries < 0:
            raise ValueError("prefix_cache_entries must be >= 0")
        if self.prefix_cache_entries:
            if self.prefix_cache_min_seq < 1:
                raise ValueError("prefix_cache_min_seq must be >= 1")
            if self.prefix_cache_max_seq < self.prefix_cache_min_seq:
                raise ValueError(
                    "prefix_cache_max_seq must be >= prefix_cache_min_seq"
                )


# decode_steps_per_tick="auto" on CUDA. One step per tick: the port
# runs each decode step eagerly, so fusing k steps into a tick saves no
# device launch — only k-1 small host syncs — while every extra step
# would be computed past EOS / max_new and written as cache overshoot.
DECODE_STEPS_CUDA = 1


def resolve_decode_steps(batching: BatchingConfig) -> int:
    steps = batching.decode_steps_per_tick
    return DECODE_STEPS_CUDA if steps == "auto" else int(steps)


@dataclass
class GrammarConfig:
    """Schema-constrained decoding (ggrmcp_tpu_torch/grammar), the
    reference's fields, defaults and checks. Disabled, constrained
    requests are refused INVALID_ARGUMENT and the arena shrinks to the
    accept-all state."""

    enabled: bool = True
    # Per-schema DFA state budget (SchemaTooComplexError past it).
    max_states: int = 1024
    # Table arena rows shared by all live grammars (state 0 reserved);
    # device bytes arena_states x vocab x 5 (bool mask + int32 trans).
    arena_states: int = 4096
    # Sidecar LRU of compiled DFAs, keyed by canonical schema hash.
    cache_entries: int = 32
    # Jump-ahead: up to jump_max forced tokens plus one sampled token in
    # one [B, 1 + jump_max] forward; 0 = one-token constrained decoding.
    jump_max: int = 8

    def __post_init__(self) -> None:
        if self.max_states < 2:
            raise ValueError("grammar.max_states must be >= 2")
        if self.arena_states < self.max_states + 1:
            raise ValueError(
                "grammar.arena_states must be > grammar.max_states "
                "(state 0 is the reserved accept-all state)"
            )
        if self.cache_entries < 1:
            raise ValueError("grammar.cache_entries must be >= 1")
        if not 0 <= self.jump_max <= 16:
            raise ValueError(
                "grammar.jump_max must be in [0, 16] (0 disables "
                "jump-ahead; 16 is the compiler's forced-run cap)"
            )


# Latency histogram bucket upper bounds (ms), shared by the ttft, e2e,
# queue, tick and per-class histograms so that backends aggregate.
LATENCY_BUCKET_BOUNDS_MS = [
    1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0,
]


@dataclass
class ObservabilityConfig:
    """The flight recorder (serving/flight_recorder.py) and the memory
    ledger: bounded rings of tick and request records, fixed-bucket
    latency histograms. The reference's fields, defaults and checks;
    disabled, every hook is one attribute check."""

    enabled: bool = True
    tick_ring: int = 512
    request_ring: int = 2048
    # Strictly ascending; values past the last land in an overflow slot.
    bucket_bounds_ms: list = field(
        default_factory=lambda: list(LATENCY_BUCKET_BOUNDS_MS)
    )

    def __post_init__(self) -> None:
        if self.tick_ring < 1 or self.request_ring < 1:
            raise ValueError(
                "observability.tick_ring/request_ring must be >= 1"
            )
        try:
            bounds = [float(b) for b in self.bucket_bounds_ms]
        except (TypeError, ValueError):
            raise ValueError("observability.bucket_bounds_ms must be numbers")
        if not bounds or any(b <= 0 for b in bounds) or bounds != sorted(
            set(bounds)
        ):
            raise ValueError(
                "observability.bucket_bounds_ms must be strictly "
                "ascending positive values"
            )


# QoS classes and their p99 objectives (ms): time to first token and
# time per output token. A request counts toward goodput only when it
# meets both of its class's targets.
DEFAULT_SLO_CLASSES = {
    "interactive": {"ttft_p99_ms": 500.0, "tpot_p99_ms": 100.0},
    "batch": {"ttft_p99_ms": 5000.0, "tpot_p99_ms": 500.0},
    "background": {"ttft_p99_ms": 30000.0, "tpot_p99_ms": 2000.0},
}


@dataclass
class SloConfig:
    """Per-class goodput and burn rate, per-tenant VTC token accounting
    (serving/slo.py): pure measurement, fed at every terminal chunk.
    Needs observability.enabled (the recorder's hook feeds it)."""

    enabled: bool = True
    # Class of a request that names no (known) class.
    default_class: str = "interactive"
    # name -> {"ttft_p99_ms": float, "tpot_p99_ms": float}
    classes: dict = field(
        default_factory=lambda: {
            k: dict(v) for k, v in DEFAULT_SLO_CLASSES.items()
        }
    )
    # Burn-rate windows (s): violation rate over the window / 0.01.
    burn_windows_s: list = field(default_factory=lambda: [300.0, 3600.0])
    # At most this many tenants per batcher; the least recently active
    # folds into "~overflow".
    tenant_top_k: int = 64
    # VTC weighted tokens = prompt weight * prompt + decode weight * decode.
    vtc_prompt_weight: float = 1.0
    vtc_decode_weight: float = 2.0

    def __post_init__(self) -> None:
        if not isinstance(self.classes, dict) or not self.classes:
            raise ValueError(
                "serving.slo.classes must be a non-empty dict of "
                "class name -> {ttft_p99_ms, tpot_p99_ms}"
            )
        for cname, targets in self.classes.items():
            if not isinstance(cname, str) or not cname:
                raise ValueError(
                    "serving.slo.classes keys must be non-empty class names"
                )
            if not isinstance(targets, dict):
                raise ValueError(
                    f"serving.slo.classes[{cname!r}] must be a dict "
                    "with ttft_p99_ms/tpot_p99_ms"
                )
            unknown = set(targets) - {"ttft_p99_ms", "tpot_p99_ms"}
            if unknown:
                raise ValueError(
                    f"serving.slo.classes[{cname!r}]: unknown keys "
                    f"{sorted(unknown)}; supported: ttft_p99_ms, "
                    "tpot_p99_ms"
                )
            for key in ("ttft_p99_ms", "tpot_p99_ms"):
                try:
                    val = float(targets.get(key, 0))
                except (TypeError, ValueError):
                    val = -1.0
                if val <= 0:
                    raise ValueError(
                        f"serving.slo.classes[{cname!r}].{key} must be "
                        "a positive number of milliseconds"
                    )
        if self.default_class not in self.classes:
            raise ValueError(
                f"serving.slo.default_class {self.default_class!r} is not "
                f"in serving.slo.classes {sorted(self.classes)}"
            )
        try:
            windows = [float(w) for w in self.burn_windows_s]
        except (TypeError, ValueError):
            raise ValueError("serving.slo.burn_windows_s must be numbers")
        if not windows or any(w <= 0 for w in windows) or windows != sorted(
            set(windows)
        ):
            raise ValueError(
                "serving.slo.burn_windows_s must be strictly ascending "
                "positive window lengths (seconds)"
            )
        if self.tenant_top_k < 1:
            raise ValueError("serving.slo.tenant_top_k must be >= 1")
        if self.vtc_prompt_weight < 0 or self.vtc_decode_weight < 0:
            raise ValueError(
                "serving.slo.vtc_prompt_weight/vtc_decode_weight must "
                "be >= 0"
            )


@dataclass
class SchedulerConfig:
    """The preemptive SLO-aware scheduler (serving/scheduler.py): class
    priority lanes with VTC fair share inside a class, demote-don't-kill
    preemption, a per-round prefill token budget. Off, admission is
    FIFO; the per-class Retry-After ladder applies either way."""

    enabled: bool = False
    # Priority order, highest first; names from serving.slo.classes.
    classes: list = field(
        default_factory=lambda: ["interactive", "batch", "background"]
    )
    preemption: bool = True
    # Preempt when the top waiter's wait exceeds this fraction of its
    # class's TTFT target, or its fast-window burn rate reaches the
    # threshold.
    preempt_wait_fraction: float = 0.5
    preempt_burn_threshold: float = 1.0
    max_preempts_per_turn: int = 1
    resume_retry_limit: int = 8
    # Prompt tokens one admission round may prefill while slots decode;
    # 0 = off.
    prefill_budget_tokens: int = 0
    shares_ttl_s: float = 0.05
    # A shed's Retry-After: base * factor ** (class priority index).
    retry_after_base_s: float = 1.0
    retry_after_factor: float = 2.0

    def __post_init__(self) -> None:
        if not isinstance(self.classes, list) or not self.classes or not all(
            isinstance(c, str) and c for c in self.classes
        ):
            raise ValueError(
                "serving.scheduler.classes must be a non-empty list of "
                "class names, highest priority first"
            )
        if len(set(self.classes)) != len(self.classes):
            raise ValueError(
                "serving.scheduler.classes must not repeat a class name"
            )
        if not 0 < self.preempt_wait_fraction <= 10:
            raise ValueError(
                "serving.scheduler.preempt_wait_fraction must be in "
                "(0, 10] (fraction of the class TTFT target)"
            )
        if self.preempt_burn_threshold <= 0:
            raise ValueError(
                "serving.scheduler.preempt_burn_threshold must be > 0"
            )
        if self.max_preempts_per_turn < 0:
            raise ValueError(
                "serving.scheduler.max_preempts_per_turn must be >= 0"
            )
        if self.resume_retry_limit < 0:
            raise ValueError(
                "serving.scheduler.resume_retry_limit must be >= 0"
            )
        if self.prefill_budget_tokens < 0:
            raise ValueError(
                "serving.scheduler.prefill_budget_tokens must be >= 0 "
                "(0 disables the per-round prefill budget)"
            )
        if self.shares_ttl_s < 0:
            raise ValueError("serving.scheduler.shares_ttl_s must be >= 0")
        if self.retry_after_base_s <= 0 or self.retry_after_factor < 1:
            raise ValueError(
                "serving.scheduler.retry_after_base_s must be > 0 and "
                "retry_after_factor >= 1 (lower-priority classes must "
                "never be told to retry SOONER)"
            )


@dataclass
class LoraConfig:
    """Multi-LoRA serving (ops/lora.py), the reference's fields,
    defaults and checks. `adapters`: the boot-time adapter names, served
    as rows 1..N in list order (0 = the base model), their trained
    factors read from `{path}/{name}.npz` when present. `registry`: the
    dynamic mode (serving/adapter_arena.py), a directory of
    `{name}.npz` factor pairs scanned at request time, with
    `arena_rows` adapters resident on the device at once. Factor files
    hold float32 `a` [L, D, r] and `b` [L, r, (H + 2 KVH) * Dh],
    pre-scaled by alpha / r."""

    adapters: list = field(default_factory=list)
    rank: int = 8
    path: str = ""
    registry: str = ""
    arena_rows: int = 8

    def __post_init__(self) -> None:
        if self.registry and self.adapters:
            raise ValueError(
                "serving.lora.registry (dynamic arena) and lora.adapters "
                "(boot-time list) are mutually exclusive: move the "
                "static adapters' .npz files into the registry"
            )
        if (self.registry or self.adapters) and self.rank < 1:
            raise ValueError("serving.lora.rank must be >= 1")
        if self.arena_rows < 1:
            raise ValueError("serving.lora.arena_rows must be >= 1")


@dataclass
class MeshConfig:
    """The device mesh of the serving plane (parallel/mesh.py), the
    reference's fields and defaults. An axis size of 0 means "infer from
    the devices"; the axes are data / fsdp / tensor / sequence / expert /
    stage. `allow_cpu_fallback` is accepted and, as in the reference,
    read nowhere: the port never falls back to the CPU."""

    data: int = 1
    fsdp: int = 1
    tensor: int = 0  # 0 -> all remaining devices
    sequence: int = 1
    expert: int = 1
    stage: int = 1
    allow_cpu_fallback: bool = True

    def __post_init__(self) -> None:
        for axis in ("data", "fsdp", "tensor", "sequence", "expert", "stage"):
            if getattr(self, axis) < 0:
                raise ValueError(f"serving.mesh.{axis} must be >= 0")


@dataclass
class TrainingConfig:
    """`python -m ggrmcp_tpu_torch train` (models/trainer.py): the
    reference's fields, defaults and checks. `mesh` takes data, fsdp,
    tensor (and expert for MoE, stage for the pipeline) as serving
    does; the batch splits over data x fsdp."""

    model: str = "tiny-llama"
    steps: int = 100
    batch_size: int = 8
    seq_len: int = 128
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    mesh: MeshConfig = field(default_factory=MeshConfig)
    # Checkpoint root ("" = no persistence): each save writes
    # <dir>/step_N/state (the resume target) and <dir>/step_N/params
    # (what serving.checkpoint_path serves).
    checkpoint_dir: str = ""
    save_every_steps: int = 100
    resume: bool = True
    data_path: str = ""  # raw text file ("" = a synthetic token stream)
    log_every_steps: int = 10
    seed: int = 0

    def __post_init__(self) -> None:
        if not isinstance(self.mesh, MeshConfig):
            raise ValueError("training.mesh must be a MeshConfig")
        if self.steps < 1 or self.batch_size < 1:
            raise ValueError("training steps/batch_size must be >= 1")
        if self.seq_len < 2:
            raise ValueError(
                "training seq_len must be >= 2 (shift-by-one loss)")
        if self.log_every_steps < 1 or self.save_every_steps < 1:
            raise ValueError(
                "training log_every_steps/save_every_steps must be >= 1")


# Replica roles (serving.role). "mixed" serves whole requests;
# "prefill" replicas admit a long prompt, then ship its finished KV
# pages to a decode replica (sidecar-to-sidecar TransferKV); "decode"
# replicas admit those requests over the imported pages and skip their
# prefill.
SERVING_ROLES = ("mixed", "prefill", "decode")


@dataclass
class ServingConfig:
    model: str = "tiny-llama"
    # Depth cut of `model`: serve its first N layers at full width (0 =
    # the registry's depth). Random weights only: a card too small for
    # the whole stack still runs the published widths.
    num_layers: int = 0
    batching: BatchingConfig = field(default_factory=BatchingConfig)
    port: int = 50051
    # HF Llama/Mistral checkpoint directory; overrides `model`.
    hf_checkpoint_path: str = ""
    # HF tokenizer.json (needs the `tokenizers` package); "" = bytes.
    tokenizer_path: str = ""
    # Int8 weights ("" | "int8"), quantized by the engine at load.
    quantize: str = ""
    # Int8 KV cache ("" = the model dtype | "int8").
    kv_cache_dtype: str = ""
    # Random int8 weights drawn directly (perf staging; needs int8).
    synthetic_weights: bool = False
    grammar: GrammarConfig = field(default_factory=GrammarConfig)
    observability: ObservabilityConfig = field(
        default_factory=ObservabilityConfig
    )
    slo: SloConfig = field(default_factory=SloConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    # Fault injection (utils/failpoints.py), e.g. "tick_fail:every=7,
    # admit_slow:ms=50", armed at engine init; GGRMCP_FAILPOINTS arms the
    # same registry at import. Chaos testing only.
    failpoints: str = ""
    # Replica role in a disaggregated fleet (SERVING_ROLES); non-mixed
    # roles need paged_kv=on (pages are the transfer format) and no
    # kv_tiers.
    role: str = "mixed"
    lora: LoraConfig = field(default_factory=LoraConfig)
    # The device mesh (parallel/mesh.py): the batch over data x fsdp,
    # tensor, expert, sequence and stage parallelism over an explicit
    # device list.
    mesh: MeshConfig = field(default_factory=MeshConfig)
    # Ring-buffer KV for sliding-window models (batcher path): the
    # shared cache holds window + prefill_chunk - 1 positions and a
    # request is bounded by the RoPE range, not the cache.
    kv_ring: bool = False
    # Speculative decoding: registry name of a dense draft sharing the
    # target's vocabulary ("" = off), and the tokens it proposes a round.
    # With batching.speculative=on the draft rides the batcher's tick;
    # off, draft-eligible unary calls take serving/spec_batcher.py.
    speculative_draft: str = ""
    speculative_gamma: int = 4
    # Accepted and read nowhere, as in the reference: the weights' dtype
    # is the model config's.
    dtype: str = "bfloat16"
    # Unix-domain-socket listen path: when set, the sidecar binds
    # `unix:{uds_path}` only (no TCP socket). The co-launch
    # (serving/launcher.py) picks a private one unless `colaunch_uds` is
    # off or `port` is pinned.
    uds_path: str = ""
    colaunch_uds: bool = True
    # With hf_checkpoint_path naming an ABSENT directory: serve `model`
    # with random weights and a loud warning instead of failing start.
    hf_checkpoint_optional: bool = False
    # Sequence-parallel fresh prefill over the mesh's `sequence` axis
    # ("ring" | "ulysses" | "" = off), for prompts of at least
    # sp_prefill_min_seq tokens.
    sp_prefill: str = "ring"
    sp_prefill_min_seq: int = 1024
    # Weights of `model` (and of the draft) from a checkpoint in the
    # port's own format (serving/checkpoint.py: what `python -m
    # ggrmcp_tpu_torch train` writes, e.g. <dir>/step_N/params); an
    # Orbax tree of the JAX package is refused here, at construction.
    checkpoint_path: str = ""
    speculative_draft_checkpoint: str = ""

    def __post_init__(self) -> None:
        for name in ("checkpoint_path", "speculative_draft_checkpoint"):
            if getattr(self, name):
                from ggrmcp_tpu_torch.serving.checkpoint import read_meta

                read_meta(getattr(self, name), f"serving.{name}")
        if not isinstance(self.batching, BatchingConfig):
            raise ValueError("serving.batching must be a BatchingConfig")
        for name, cls in (("grammar", GrammarConfig),
                          ("observability", ObservabilityConfig),
                          ("slo", SloConfig),
                          ("scheduler", SchedulerConfig),
                          ("lora", LoraConfig),
                          ("mesh", MeshConfig)):
            if not isinstance(getattr(self, name), cls):
                raise ValueError(f"serving.{name} must be a {cls.__name__}")
        if self.failpoints:
            from ggrmcp_tpu_torch.utils.failpoints import parse_spec

            try:
                parse_spec(self.failpoints)
            except ValueError as exc:
                # A chaos config with a typo fails here, not by
                # injecting nothing.
                raise ValueError(f"serving.failpoints: {exc}")
        sched = self.scheduler
        if sched.enabled:
            unknown = [c for c in sched.classes if c not in self.slo.classes]
            if unknown:
                raise ValueError(
                    f"serving.scheduler.classes {unknown} are not in "
                    f"serving.slo.classes {sorted(self.slo.classes)}"
                )
            if not self.slo.enabled or not self.observability.enabled:
                raise ValueError(
                    "serving.scheduler.enabled requires serving.slo."
                    "enabled and serving.observability.enabled (the "
                    "scheduler orders by live VTC counters and triggers "
                    "preemption off burn rate)"
                )
        # The reference's checks (Config.validate), at construction.
        if self.role not in SERVING_ROLES:
            raise ValueError(
                f"unknown serving.role {self.role!r}; supported: "
                f"{', '.join(SERVING_ROLES)}"
            )
        if self.role != "mixed":
            if self.batching.paged_kv != "on":
                raise ValueError(
                    f"serving.role={self.role!r} requires "
                    "batching.paged_kv=on: KV pages are the transfer "
                    "format (docs/paged_kv.md 'pages over the wire')"
                )
            if self.batching.kv_tiers:
                raise ValueError(
                    f"serving.role={self.role!r} does not compose with "
                    "batching.kv_tiers: page import needs ONE arena per "
                    "replica to land transferred pages in"
                )
        if self.speculative_gamma < 1:
            raise ValueError("speculative_gamma must be >= 1")
        if self.batching.speculative == "on" and self.kv_ring:
            raise ValueError(
                "batching.speculative does not compose with kv_ring: the "
                "draft slot-pool cache is contiguous and the (gamma+1)-"
                "position verify assumes the contiguous length mask"
            )
        if self.kv_ring:
            if self.batching.paged_kv == "on":
                raise ValueError(
                    "batching.paged_kv and kv_ring are mutually "
                    "exclusive: a ring stores positions mod its "
                    "capacity, a page table maps them — one indirection "
                    "scheme per cache"
                )
            if self.batching.kv_tiers:
                raise ValueError(
                    "kv_ring and kv_tiers are mutually exclusive (a "
                    "ring has ONE capacity: window + prefill_chunk - 1)"
                )
            if self.batching.prefix_cache_entries:
                raise ValueError(
                    "kv_ring does not compose with the prefix pool "
                    "(pooled prefixes assume a contiguous layout)"
                )
        if self.sp_prefill not in ("", "ring", "ulysses"):
            raise ValueError(
                f"unknown serving.sp_prefill {self.sp_prefill!r}; "
                f"supported: 'ring', 'ulysses'"
            )
        if len(self.uds_path.encode()) > 100:
            # AF_UNIX sun_path caps at ~108 bytes: fail at parse time,
            # not as an opaque bind error after the model loads.
            raise ValueError(
                f"serving.uds_path too long for AF_UNIX "
                f"({len(self.uds_path.encode())} > 100 bytes)"
            )
        if self.num_layers < 0:
            raise ValueError("serving.num_layers must be >= 0")
        if self.num_layers and (self.checkpoint_path
                                or self.hf_checkpoint_path):
            raise ValueError(
                "serving.num_layers cuts a random-weight model; a "
                "checkpoint brings its own depth"
            )
        if self.quantize not in QUANTIZE_MODES:
            raise ValueError(
                f"unknown serving.quantize {self.quantize!r}; "
                f"supported: 'int8'"
            )
        if self.kv_cache_dtype not in QUANTIZE_MODES:
            raise ValueError(
                f"unknown serving.kv_cache_dtype {self.kv_cache_dtype!r}; "
                f"supported: 'int8'"
            )
        if self.synthetic_weights:
            if self.quantize != "int8":
                raise ValueError(
                    "serving.synthetic_weights initializes the int8 weight "
                    "structure; it requires quantize='int8'"
                )
            if self.checkpoint_path or self.hf_checkpoint_path:
                raise ValueError(
                    "serving.synthetic_weights is random-weight perf "
                    "staging; it cannot combine with a checkpoint"
                )


# ---------------------------------------------------------------------------
# Server / HTTP
# ---------------------------------------------------------------------------


@dataclass
class SecurityConfig:
    enable_security_headers: bool = True
    hsts: bool = True
    content_security_policy: str = "default-src 'none'"


@dataclass
class CORSConfig:
    enabled: bool = True
    allowed_origins: list[str] = field(default_factory=lambda: ["*"])
    allowed_methods: list[str] = field(
        default_factory=lambda: ["GET", "POST", "OPTIONS"]
    )
    allowed_headers: list[str] = field(
        default_factory=lambda: ["Content-Type", "Mcp-Session-Id", "Authorization"]
    )
    exposed_headers: list[str] = field(default_factory=lambda: ["Mcp-Session-Id"])


@dataclass
class RateLimitConfig:
    enabled: bool = True
    requests_per_second: float = 100.0
    burst: int = 200


@dataclass
class ServerConfig:
    host: str = "0.0.0.0"
    port: int = 50053
    read_timeout_s: float = 15.0
    write_timeout_s: float = 15.0
    idle_timeout_s: float = 60.0
    request_timeout_s: float = 30.0
    max_request_bytes: int = 1 << 20  # 1 MB
    shutdown_grace_s: float = 30.0
    # Worker processes sharing the listen port via SO_REUSEPORT. The Go
    # reference used every core through goroutines; asyncio is
    # single-core, so >1 scales the gateway across cores. Sessions are
    # worker-local (kernel hashing keeps a keep-alive connection on one
    # worker; use 1 worker or a sticky LB if cross-connection session
    # continuity matters). Requires a fixed port.
    workers: int = 1
    # HTTP server implementation: "fastlane" (raw asyncio.Protocol hot
    # path, gateway/fastlane.py — the default; ~framework-free
    # per-request cost) or "aiohttp" (the web.Application stack).
    # Identical served surface and gate semantics either way.
    http_impl: str = "fastlane"
    allowed_content_types: list[str] = field(
        default_factory=lambda: ["application/json"]
    )
    security: SecurityConfig = field(default_factory=SecurityConfig)
    cors: CORSConfig = field(default_factory=CORSConfig)
    rate_limit: RateLimitConfig = field(default_factory=RateLimitConfig)


# ---------------------------------------------------------------------------
# gRPC upstream(s)
# ---------------------------------------------------------------------------


@dataclass
class KeepAliveConfig:
    time_s: float = 10.0
    timeout_s: float = 5.0
    permit_without_stream: bool = True


@dataclass
class ReconnectConfig:
    """Background reconnect policy.

    The reference defined Reconnect (pkg/grpc/discovery.go:187-235) but
    never invoked it at runtime; here a background watchdog actually
    drives it (SURVEY.md §5.3 'deliberately fix').
    """

    enabled: bool = True
    max_attempts: int = 5
    interval_s: float = 5.0
    watchdog_interval_s: float = 10.0


@dataclass
class HeaderForwardingConfig:
    enabled: bool = True
    forward_all: bool = False
    case_insensitive: bool = True
    allowed_headers: list[str] = field(
        default_factory=lambda: [
            "authorization",
            "x-trace-id",
            "x-request-id",
            "x-user-id",
            "x-session-id",
            "x-adapter-id",
            "x-tenant-id",
            "x-qos-class",
            "x-api-key",
            "user-agent",
            "accept-language",
        ]
    )
    blocked_headers: list[str] = field(
        default_factory=lambda: [
            "cookie",
            "set-cookie",
            "host",
            "content-length",
            "content-type",
            "connection",
            "upgrade",
            "proxy-authorization",
            "proxy-authenticate",
            "te",
            "trailer",
            "transfer-encoding",
            "mcp-session-id",
        ]
    )


@dataclass
class DescriptorSetConfig:
    enabled: bool = False
    path: str = ""
    prefer_over_reflection: bool = True
    include_source_info: bool = True


@dataclass
class GRPCConfig:
    host: str = "localhost"
    port: int = 50051
    max_message_bytes: int = 4 << 20  # 4 MB
    connect_timeout_s: float = 5.0
    call_timeout_s: float = 30.0
    use_tls: bool = False
    keepalive: KeepAliveConfig = field(default_factory=KeepAliveConfig)
    reconnect: ReconnectConfig = field(default_factory=ReconnectConfig)
    header_forwarding: HeaderForwardingConfig = field(
        default_factory=HeaderForwardingConfig
    )
    descriptor_set: DescriptorSetConfig = field(default_factory=DescriptorSetConfig)

    @property
    def target(self) -> str:
        return f"{self.host}:{self.port}"


# ---------------------------------------------------------------------------
# MCP protocol
# ---------------------------------------------------------------------------


@dataclass
class ValidationConfig:
    max_method_length: int = 1024
    max_tool_name_length: int = 128
    max_nesting_depth: int = 10
    max_request_bytes: int = 1 << 20


@dataclass
class MCPConfig:
    protocol_version: str = "2024-11-05"
    server_name: str = "ggrmcp-tpu"
    # Default comes from the package metadata (ggrmcp_tpu.__version__)
    # so `initialize` reports the real installed version — reference
    # parity with handler.go:160-179 ("ggRMCP/1.0.0"), minus its
    # hardcoding. field(default_factory=...) defers the import.
    server_version: str = field(
        default_factory=lambda: __import__("ggrmcp_tpu_torch").__version__
    )
    validation: ValidationConfig = field(default_factory=ValidationConfig)


# ---------------------------------------------------------------------------
# Sessions
# ---------------------------------------------------------------------------


@dataclass
class SessionRateLimitConfig:
    """Per-session fixed-window limit — and unlike the reference
    (pkg/session/manager.go:178, never called), the handler enforces it."""

    enabled: bool = True
    requests_per_minute: int = 100


@dataclass
class SessionConfig:
    ttl_s: float = 1800.0  # 30 min
    cleanup_interval_s: float = 300.0  # 5 min
    max_sessions: int = 10_000
    rate_limit: SessionRateLimitConfig = field(default_factory=SessionRateLimitConfig)


# ---------------------------------------------------------------------------
# Tools / schema generation
# ---------------------------------------------------------------------------


@dataclass
class SchemaCacheConfig:
    """Schema cache — configured AND implemented (the reference declared
    this but never wired it; pkg/tools/builder.go:18)."""

    enabled: bool = True
    max_entries: int = 4096


@dataclass
class ToolsConfig:
    max_schema_depth: int = 10
    emit_output_schema: bool = True
    include_comments: bool = True
    tensor_extensions: bool = True  # x-tensor dtype/shape hints in schemas
    # Expose server-streaming methods as tools (the reference rejected
    # all streaming, pkg/tools/builder.go:129-134; the gateway here
    # serves them aggregated or over SSE). Client streaming stays out.
    streaming_tools: bool = True
    cache: SchemaCacheConfig = field(default_factory=SchemaCacheConfig)

# Replica-routing policies (gateway.routing.policy) — the single source
# of truth for config.validate() and rpc/router.py.
ROUTING_POLICIES = ("round_robin", "least_loaded", "affinity")


@dataclass
class RoutingConfig:
    """Load-aware replica routing over DP replica pools
    (rpc/router.py, docs/routing.md). Applies whenever several
    discovered backends serve the SAME method full name — the gateway
    then chooses the serving replica per call instead of pinning to
    one upstream (the reference's single-target limitation)."""

    # "round_robin" — per-tool cursors over the healthy replica set
    #   (the historical default; bitwise behavior-compatible with the
    #   pre-router path).
    # "least_loaded" — score each replica from the background
    #   ServingStats snapshot (pending queue depth + EWMA TTFT) and
    #   place on the cheapest one; routing never blocks on a gRPC
    #   fan-out, and a stale/wedged snapshot degrades LOUDLY to
    #   round-robin, never to a stall.
    # "affinity" — rendezvous(HRW)-hash a stable per-call key
    #   (x-session-id header, else tool name + the serialized-request
    #   preamble) over the healthy replica set, so one replica
    #   accumulates a session's paged-KV prefix pages instead of every
    #   replica cold-prefilling them (docs/paged_kv.md). Affinity is a
    #   PREFERENCE: an overloaded home replica spills to the least
    #   loaded one (spill_threshold).
    policy: str = "round_robin"
    # Affinity key fallback: first N bytes of the canonically
    # serialized arguments (sorted-key JSON), hashed with the tool
    # name. Big enough to span a system-prompt preamble, small enough
    # that the key derivation stays off the hot path's flamegraph.
    affinity_preamble_bytes: int = 256
    # Spill when the affinity-chosen replica's load score exceeds this
    # (score units: 1.0 per queued request + EWMA TTFT / 100 ms).
    # 0 disables spilling (strict affinity).
    spill_threshold: float = 8.0
    # DEPRECATED heuristic (off by default), superseded by real
    # prefill/decode disaggregation (serving.role + the disagg knobs
    # below): steer requests whose estimated prefill work exceeds
    # steer_prefill_min_tokens toward replicas whose cumulative
    # tick-phase attribution shows the smallest admit-phase (prefill)
    # share. Only consulted when no affinity key applies. The moment
    # any replica declares a non-"mixed" serving.role, steer_prefill=on
    # is rejected with a typed error naming the migration — the two
    # mechanisms must not fight over placement (docs/routing.md).
    steer_prefill: str = "off"  # off | on
    steer_prefill_min_tokens: int = 1024
    # Prefill/decode disaggregation (serving.role, docs/routing.md).
    # "auto" (default): the two-leg prefill→TransferKV→decode placement
    # engages as soon as the ServingStats snapshot shows a prefill-role
    # replica AND a decode-capable one — a pure-mixed fleet routes
    # exactly as before, bit-for-bit. "off": never split, even with
    # roles declared (prefill replicas are then simply excluded from
    # short-request placement).
    disagg: str = "auto"  # auto | off
    # Requests whose estimated prefill work (prompt bytes; exact for
    # the byte tokenizer, ~4x high for BPE) is below this never take
    # the two-leg path — a short prompt's prefill costs less than the
    # transfer round-trip it would save.
    disagg_min_prompt_tokens: int = 1024
    # ServingStats snapshots older than this are considered wedged:
    # score-based policies fall back to round-robin (with a warning)
    # until the background refresh recovers.
    stale_stats_max_age_s: float = 30.0


@dataclass
class GatewayConfig:
    """Gateway-side behavior knobs (no reference analogue)."""

    # Replica routing policy + affinity/drain knobs (rpc/router.py).
    routing: RoutingConfig = field(default_factory=RoutingConfig)
    # Per-tool structured-output opt-in: MCP tool name → source of the
    # schema to enforce on that tool's generated text. "self" (or "")
    # enforces the tool's OWN output schema; any other value names a
    # discovered tool whose output schema to enforce. The gateway
    # inlines the resolved schema into GenerateRequest.constraint on
    # every call to the tool; only tools whose input message carries a
    # `constraint` field (the TPU Generate surface) are eligible.
    # Callers can also pass `constraint.toolOutputSchemaRef` per call —
    # the gateway resolves it the same way.
    structured_output: dict = field(default_factory=dict)
    # Per-MCP-tool settings: tool name → {"adapter": <name>}. The
    # adapter binding injects `adapter=<name>` into every call of that
    # tool whose input message carries an `adapter` field (the TPU
    # Generate surface), so one pod serves a thousand fine-tunes
    # behind one tool list (docs/multi_lora.md). Per-call/per-session
    # override: the forwarded `x-adapter-id` header beats the binding;
    # an explicit `adapter` argument beats both.
    tools: dict = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Logging / observability
# ---------------------------------------------------------------------------


@dataclass
class LoggingConfig:
    level: str = "info"
    development: bool = False
    json_output: bool = True
    # "json" switches gateway AND sidecar logging to structured
    # one-line JSON records (utils/jsonlog.JsonFormatter): every line
    # is parseable json.dumps output carrying ts/level/logger/msg plus
    # the current trace id from the tracing contextvar, so process
    # logs join /debug/traces, /debug/requests, and /debug/timeline by
    # trace id. "" keeps the legacy format strings above (json_output
    # interpolates into a JSON-shaped template without escaping —
    # greppable, not parseable). GGRMCP_LOG_JSON=1 is the config-free
    # opt-in for both processes.
    format: str = ""  # "" | "json"


@dataclass
class MetricsConfig:
    enabled: bool = True
    prometheus: bool = True  # real text-format metrics, not a JSON stub


def _from_dict(cls, data: Any, where: str, nested: dict):
    if not isinstance(data, dict):
        raise ValueError(f"{where} must be an object, not {data!r}")
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(data) - names)
    if unknown:
        raise ValueError(f"{where}: unknown keys {unknown}")
    kwargs = dict(data)
    for key, sub in nested.items():
        if key in kwargs:
            kwargs[key] = _from_dict(sub, kwargs[key], f"{where}.{key}", {})
    return cls(**kwargs)


@dataclass
class FleetConfig:
    """A reference config's fleet section (the reference's fields and
    defaults, checked by `Config.validate` as the reference checks
    them). The co-launch's supervisor (serving/launcher.py) uses the
    restart knobs: it restarts a dead sidecar after
    min(backoff_max_s, backoff_base_s * 2^attempt) * (1 + jitter * U)
    seconds, at most restart_max_attempts times. With `enabled` the
    gateway's replica fleet (serving/fleet.py) spawns, heals and scales
    workers of this port."""

    enabled: bool = False
    min_replicas: int = 1
    max_replicas: int = 4
    slo_ttft_p99_ms: float = 2000.0
    shed_hold_s: float = 6.0
    scale_up_sustain_s: float = 10.0
    scale_down_sustain_s: float = 60.0
    flap_threshold: int = 3
    flap_window_s: float = 60.0
    max_actions_per_window: int = 4
    action_window_s: float = 60.0
    backoff_base_s: float = 1.0
    backoff_max_s: float = 60.0
    backoff_jitter: float = 0.2
    restart_max_attempts: int = 5
    decide_interval_s: float = 2.0
    drain_grace_s: float = 10.0
    action_log: int = 256


@dataclass
class Config:
    """A whole reference config file: the gateway's sections (the
    reference's classes), `serving` and `training` (the port's, checked
    as they are built) and `fleet`."""

    server: ServerConfig = field(default_factory=ServerConfig)
    grpc: GRPCConfig = field(default_factory=GRPCConfig)
    mcp: MCPConfig = field(default_factory=MCPConfig)
    session: SessionConfig = field(default_factory=SessionConfig)
    tools: ToolsConfig = field(default_factory=ToolsConfig)
    gateway: GatewayConfig = field(default_factory=GatewayConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    metrics: MetricsConfig = field(default_factory=MetricsConfig)

    def validate(self) -> None:
        """The reference's checks of the gateway's sections, the fleet
        and the serving keys that span sections; `serving` and
        `training` check themselves when built."""
        if not (0 < self.server.port < 65536):
            raise ValueError(f"invalid HTTP port: {self.server.port}")
        if self.server.workers < 1:
            raise ValueError("server.workers must be >= 1")
        if self.server.http_impl not in ("fastlane", "aiohttp"):
            raise ValueError(
                f"unknown server.http_impl {self.server.http_impl!r}; "
                "supported: 'fastlane', 'aiohttp'"
            )
        if not (0 < self.grpc.port < 65536):
            raise ValueError(f"invalid gRPC port: {self.grpc.port}")
        if self.server.request_timeout_s <= 0:
            raise ValueError("request timeout must be positive")
        if self.grpc.connect_timeout_s <= 0:
            raise ValueError("gRPC connect timeout must be positive")
        if self.grpc.max_message_bytes <= 0:
            raise ValueError("gRPC max message size must be positive")
        if self.session.max_sessions <= 0:
            raise ValueError("session capacity must be positive")
        if self.tools.max_schema_depth <= 0:
            raise ValueError("schema depth must be positive")
        if self.grpc.descriptor_set.enabled and not self.grpc.descriptor_set.path:
            raise ValueError("descriptor set enabled but no path given")
        so = self.gateway.structured_output
        if not isinstance(so, dict) or not all(
            isinstance(k, str) and isinstance(v, str)
            for k, v in so.items()
        ):
            raise ValueError(
                "gateway.structured_output must map tool names to "
                "'self' (or '') or another tool name"
            )
        tools_cfg = self.gateway.tools
        if not isinstance(tools_cfg, dict):
            raise ValueError(
                "gateway.tools must map tool names to per-tool settings"
            )
        for tool, entry in tools_cfg.items():
            if not isinstance(tool, str) or not isinstance(entry, dict):
                raise ValueError(
                    "gateway.tools must map tool names to settings dicts "
                    "(e.g. {\"adapter\": \"acme\"})"
                )
            unknown = set(entry) - {"adapter"}
            if unknown:
                raise ValueError(
                    f"gateway.tools[{tool!r}]: unknown keys "
                    f"{sorted(unknown)}; supported: 'adapter'"
                )
            adapter = entry.get("adapter", "")
            if not isinstance(adapter, str) or not adapter:
                raise ValueError(
                    f"gateway.tools[{tool!r}].adapter must be a "
                    "non-empty adapter name"
                )
        routing = self.gateway.routing
        if routing.policy not in ROUTING_POLICIES:
            raise ValueError(
                f"unknown gateway.routing.policy {routing.policy!r}; "
                f"supported: {', '.join(ROUTING_POLICIES)}"
            )
        if routing.affinity_preamble_bytes < 1:
            raise ValueError(
                "gateway.routing.affinity_preamble_bytes must be >= 1"
            )
        if routing.spill_threshold < 0:
            raise ValueError(
                "gateway.routing.spill_threshold must be >= 0 "
                "(0 = strict affinity, never spill)"
            )
        if routing.steer_prefill not in ("off", "on"):
            raise ValueError(
                "gateway.routing.steer_prefill must be 'off' or 'on' "
                "(experimental — docs/routing.md)"
            )
        if routing.steer_prefill_min_tokens < 1:
            raise ValueError(
                "gateway.routing.steer_prefill_min_tokens must be >= 1"
            )
        if routing.stale_stats_max_age_s <= 0:
            raise ValueError(
                "gateway.routing.stale_stats_max_age_s must be > 0"
            )
        if routing.disagg not in ("auto", "off"):
            raise ValueError(
                f"unknown gateway.routing.disagg {routing.disagg!r}; "
                "supported: 'auto', 'off'"
            )
        if routing.disagg_min_prompt_tokens < 1:
            raise ValueError(
                "gateway.routing.disagg_min_prompt_tokens must be >= 1"
            )
        fleet = self.fleet
        if fleet.min_replicas < 1:
            raise ValueError("fleet.min_replicas must be >= 1")
        if fleet.max_replicas < fleet.min_replicas:
            raise ValueError(
                "fleet.max_replicas must be >= fleet.min_replicas"
            )
        if fleet.slo_ttft_p99_ms <= 0:
            raise ValueError("fleet.slo_ttft_p99_ms must be > 0")
        if fleet.scale_up_sustain_s <= 0 or fleet.scale_down_sustain_s <= 0:
            raise ValueError(
                "fleet.scale_up_sustain_s/scale_down_sustain_s must be > 0"
            )
        if not (0 <= fleet.shed_hold_s < fleet.scale_up_sustain_s):
            raise ValueError(
                "fleet.shed_hold_s must be >= 0 and < scale_up_sustain_s "
                "(a single shed rise must never fake a sustained episode)"
            )
        if fleet.flap_threshold < 2:
            raise ValueError("fleet.flap_threshold must be >= 2")
        if fleet.flap_window_s <= 0 or fleet.action_window_s <= 0:
            raise ValueError(
                "fleet.flap_window_s/action_window_s must be > 0"
            )
        if fleet.max_actions_per_window < 1:
            raise ValueError("fleet.max_actions_per_window must be >= 1")
        if fleet.backoff_base_s <= 0 or fleet.backoff_max_s < fleet.backoff_base_s:
            raise ValueError(
                "fleet.backoff_base_s must be > 0 and <= fleet.backoff_max_s"
            )
        if not (0 <= fleet.backoff_jitter < 1):
            raise ValueError("fleet.backoff_jitter must be in [0, 1)")
        if fleet.restart_max_attempts < 1:
            raise ValueError("fleet.restart_max_attempts must be >= 1")
        if fleet.decide_interval_s <= 0:
            raise ValueError("fleet.decide_interval_s must be > 0")
        if fleet.drain_grace_s < 0:
            raise ValueError("fleet.drain_grace_s must be >= 0 (0 = kill "
                             "immediately after drain)")
        if fleet.action_log < 1:
            raise ValueError("fleet.action_log must be >= 1")
        if self.serving.role != "mixed" and routing.steer_prefill == "on":
            raise ValueError(
                "gateway.routing.steer_prefill=on is superseded by "
                "replica roles: a non-'mixed' serving.role does the "
                "real prefill/decode split (page-granular KV "
                "shipping). Migrate to serving.role + "
                "gateway.routing.disagg and drop steer_prefill "
                "(docs/routing.md role-split runbook)"
            )
        if self.logging.format not in ("", "json"):
            raise ValueError(
                f"unknown logging.format {self.logging.format!r}; "
                "supported: 'json' (or '' for the legacy formats)"
            )


def default() -> Config:
    return Config()


def development() -> Config:
    """Development overrides (the reference's `development`)."""
    cfg = Config()
    cfg.logging.level = "debug"
    cfg.logging.development = True
    cfg.logging.json_output = False
    cfg.server.rate_limit.enabled = False
    return cfg


# The sections the port builds from the whole section (checked as they
# are built); every other section merges key by key over its defaults,
# by the reference's `_merge`.
_SERVING_NESTED = {
    "batching": BatchingConfig, "grammar": GrammarConfig,
    "observability": ObservabilityConfig, "slo": SloConfig,
    "scheduler": SchedulerConfig, "lora": LoraConfig, "mesh": MeshConfig,
}
_BUILT = {"serving": (ServingConfig, _SERVING_NESTED),
          "training": (TrainingConfig, {"mesh": MeshConfig})}


def _merge(obj: Any, data: dict[str, Any], path: str = "") -> None:
    """The reference's merge: `data` over the dataclass `obj`, key by
    key; an unknown key or a value of another type raises."""
    for key, value in data.items():
        attr = key.replace("-", "_")
        if not hasattr(obj, attr):
            raise ValueError(f"unknown config key: {path}{key}")
        current = getattr(obj, attr)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            _merge(current, value, f"{path}{key}.")
        else:
            if current is not None and not isinstance(value, type(current)):
                # Allow int→float promotion, nothing else silently.
                if isinstance(current, float) and isinstance(value, int):
                    value = float(value)
                elif isinstance(current, bool) != isinstance(value, bool):
                    raise ValueError(
                        f"config key {path}{key}: expected "
                        f"{type(current).__name__}, got {type(value).__name__}"
                    )
            setattr(obj, attr, value)


def config_from_dict(data: dict, base: Optional[Config] = None) -> Config:
    """A reference config tree over `base` (default: the defaults) →
    Config, validated. `serving` and `training` are parsed strictly (a
    key these classes do not carry raises, naming it); an unknown
    top-level section raises."""
    if not isinstance(data, dict):
        raise ValueError("a config file holds one object")
    cfg = base or default()
    names = {f.name for f in dataclasses.fields(Config)}
    unknown = sorted(set(data) - names)
    if unknown:
        raise ValueError(
            f"config: unknown top-level keys {unknown}; the sidecar's "
            f"settings nest under \"serving\""
        )
    for name, section in data.items():
        if name in _BUILT:
            cls, nested = _BUILT[name]
            setattr(cfg, name, _from_dict(cls, section, name, nested))
        elif isinstance(section, dict):
            _merge(getattr(cfg, name), section, f"{name}.")
        else:
            raise ValueError(f"{name} must be an object, not {section!r}")
    cfg.validate()
    return cfg


def serving_config_from_dict(data: dict) -> ServingConfig:
    """{"serving": {..., "batching": {...}, "grammar": {...},
    "observability": {...}, "slo": {...}, "scheduler": {...},
    "lora": {...}, "mesh": {...}}, <gateway sections>} → ServingConfig.
    Any serving key these classes do not carry raises ValueError naming
    it."""
    return config_from_dict(data).serving


def read_file(path: str) -> dict:
    """A config file's tree: JSON, or YAML (.yaml / .yml) where PyYAML
    is installed."""
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    if path.endswith((".yaml", ".yml")):
        try:
            import yaml
        except ImportError:
            raise ValueError(
                f"config file {path} is YAML, and PyYAML is not installed "
                f"(write it as JSON)"
            ) from None
        return yaml.safe_load(text) or {}
    return json.loads(text or "{}")


def load_serving_config(path: str) -> ServingConfig:
    """A config file in the reference's layout → ServingConfig."""
    return config_from_dict(read_file(path)).serving


# The environment layer (the reference's apply_env): GGRMCP_SECTION_KEY
# sets a key of any section. GGRMCP_-prefixed control variables that are
# not config paths are skipped, as the reference skips them: the chaos
# registry's GGRMCP_FAILPOINTS, GGRMCP_LOG_JSON (gateway/app.py), bench
# knobs, the fleet's spawn handshake (serving/fleet.py) and the
# multi-process runtime's GGRMCP_COORDINATOR / _NUM_PROCESSES /
# _PROCESS_ID (parallel/distributed.py).
_ENV_PREFIX = "GGRMCP_"
_ENV_SKIP = frozenset({"GGRMCP_FAILPOINTS", "GGRMCP_LOG_JSON",
                       "GGRMCP_COORDINATOR", "GGRMCP_NUM_PROCESSES",
                       "GGRMCP_PROCESS_ID"})
_ENV_SKIP_PREFIXES = ("GGRMCP_BENCH_", "GGRMCP_FLEET_WORKER_")


def apply_env(cfg: Config, environ: Optional[dict] = None) -> Config:
    """Apply GGRMCP_SECTION_KEY=value overrides to `cfg`, in place (the
    reference's signature): nested paths use single underscores resolved
    greedily against the config classes, and the raw string is coerced
    by the type of the value it replaces. `serving` and `training` are
    rebuilt with the overrides, so their checks run again."""
    for name, section in _env_tree(environ).items():
        if name in _BUILT:
            cls, nested = _BUILT[name]
            tree = dataclasses.asdict(getattr(cfg, name))
            for key, value in section.items():
                if isinstance(value, dict):
                    tree[key].update(value)
                else:
                    tree[key] = value
            setattr(cfg, name, _from_dict(cls, tree, name, nested))
        else:
            _merge(getattr(cfg, name), section, f"{name}.")
    return cfg


def _env_tree(environ: Optional[dict]) -> dict:
    """The GGRMCP_* variables of `environ` (default os.environ) as a
    config tree of coerced values."""
    environ = dict(os.environ) if environ is None else environ
    sections = {f.name: f.default_factory for f in dataclasses.fields(Config)}
    data: dict = {}
    for key, raw in environ.items():
        if not key.startswith(_ENV_PREFIX):
            continue
        if key in _ENV_SKIP or key.startswith(_ENV_SKIP_PREFIXES):
            continue
        parts = key[len(_ENV_PREFIX):].lower().split("_")
        for take in range(len(parts) - 1, 0, -1):
            section = "_".join(parts[:take])
            if section in sections:
                _env_path(sections[section], data.setdefault(section, {}),
                          parts[take:], raw, key)
                break
        else:
            raise ValueError(f"unknown config env var: {key}")
    return data


def _env_path(cls, data: dict, parts: list[str], raw: str, orig: str) -> None:
    defaults = cls()
    names = {f.name for f in dataclasses.fields(cls)}
    for take in range(len(parts), 0, -1):
        attr = "_".join(parts[:take])
        if attr not in names:
            continue
        current = getattr(defaults, attr)
        rest = parts[take:]
        if dataclasses.is_dataclass(current):
            if not rest:
                raise ValueError(f"{orig}: points at a section, not a value")
            sub = data.setdefault(attr, {})
            if not isinstance(sub, dict):
                raise ValueError(f"{orig}: {attr} must be an object")
            _env_path(type(current), sub, rest, raw, orig)
            return
        if rest:
            continue  # try a shorter attribute match
        data[attr] = _coerce(data.get(attr, current), raw, orig)
        return
    raise ValueError(f"unknown config env var: {orig}")


def _coerce(current: Any, raw: str, orig: str) -> Any:
    if isinstance(current, bool):
        if raw.lower() in ("1", "true", "yes", "on"):
            return True
        if raw.lower() in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"{orig}: expected boolean, got {raw!r}")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, list):
        return [item.strip() for item in raw.split(",") if item.strip()]
    return raw


def load(path: Optional[str] = None,
         environ: Optional[dict] = None, dev: bool = False) -> Config:
    """Defaults (`development()` with `dev`) → file → environment
    (`environ`, default os.environ), as the reference loads (command
    line flags go over the result)."""
    cfg = config_from_dict(read_file(path) if path else {},
                           development() if dev else None)
    apply_env(cfg, environ)
    cfg.validate()
    return cfg
