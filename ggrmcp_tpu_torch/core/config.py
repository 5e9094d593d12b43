"""The port's serving and training configuration.

`BatchingConfig`, `ServingConfig`, `TrainingConfig` and their sections
carry the fields this package reads, under the reference's names and
defaults (`ggrmcp_tpu/core/config.py`), with the reference's checks. A
value the port does not serve raises ValueError naming the field, never
silently ignored. `load` reads a whole reference config file (JSON, or
YAML with PyYAML) and the GGRMCP_SERVING_* / GGRMCP_FLEET_* /
GGRMCP_TRAINING_* environment over it: `serving`, `training` and the
fleet section into these classes, the gateway's sections (the fleet
section among them) verbatim.
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
                    "prefix pool: set prefix_cache_entries to 0"
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
            raise ValueError("batching.prefix_cache_entries must be >= 0")
        if self.prefix_cache_entries:
            if self.prefix_cache_min_seq < 1:
                raise ValueError("batching.prefix_cache_min_seq must be >= 1")
            if self.prefix_cache_max_seq < self.prefix_cache_min_seq:
                raise ValueError(
                    "batching.prefix_cache_max_seq must be >= "
                    "prefix_cache_min_seq"
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
                    "format"
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


# Top-level sections of a reference config file that the gateway reads:
# the co-launch hands them to the gateway process verbatim (it validates
# them); the sidecar alone ignores them. "training" is also parsed here,
# strictly, for the train subcommand.
GATEWAY_SECTIONS = ("server", "grpc", "logging", "mcp", "metrics",
                    "session", "tools", "gateway", "training")


@dataclass
class FleetConfig:
    """A reference config's fleet section (the reference's fields and
    defaults). The co-launch's supervisor (serving/launcher.py) uses the
    restart knobs, with the reference's checks: it restarts a dead
    sidecar after min(backoff_max_s, backoff_base_s * 2^attempt) * (1 +
    jitter * U) seconds, at most restart_max_attempts times. The rest
    are the replica fleet's (`enabled`: the gateway child supervises
    workers of this port, serving/fleet.py): they reach the child in its
    config file, whose own FleetConfig checks them."""

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

    def __post_init__(self) -> None:
        if self.backoff_base_s <= 0 or self.backoff_max_s < self.backoff_base_s:
            raise ValueError(
                "fleet.backoff_base_s must be > 0 and <= fleet.backoff_max_s"
            )
        if not (0 <= self.backoff_jitter < 1):
            raise ValueError("fleet.backoff_jitter must be in [0, 1)")
        if self.restart_max_attempts < 1:
            raise ValueError("fleet.restart_max_attempts must be >= 1")


@dataclass
class Config:
    """A whole reference config file as the port reads it: `serving`,
    `training` and the fleet section parsed, the gateway's
    sections (training and the fleet section among them) kept verbatim
    in `sections`."""

    serving: ServingConfig = field(default_factory=ServingConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    sections: dict = field(default_factory=dict)


_SERVING_NESTED = {
    "batching": BatchingConfig, "grammar": GrammarConfig,
    "observability": ObservabilityConfig, "slo": SloConfig,
    "scheduler": SchedulerConfig, "lora": LoraConfig, "mesh": MeshConfig,
}


def config_from_dict(data: dict) -> Config:
    """A reference config tree → Config. `serving` is parsed strictly
    (a key these classes do not carry raises, naming it); an unknown
    top-level section raises."""
    if not isinstance(data, dict):
        raise ValueError("a config file holds one object")
    known = {"serving", "fleet", *GATEWAY_SECTIONS}
    unknown = sorted(set(data) - known)
    if unknown:
        raise ValueError(
            f"config: unknown top-level keys {unknown}; the sidecar's "
            f"settings nest under \"serving\""
        )
    fleet = data.get("fleet", {})
    if not isinstance(fleet, dict):
        raise ValueError(f"fleet must be an object, not {fleet!r}")
    knobs = {f.name for f in dataclasses.fields(FleetConfig)}
    return Config(
        serving=_from_dict(ServingConfig, data.get("serving", {}), "serving",
                           _SERVING_NESTED),
        fleet=FleetConfig(**{k: v for k, v in fleet.items() if k in knobs}),
        training=_from_dict(TrainingConfig, data.get("training", {}),
                            "training", {"mesh": MeshConfig}),
        sections={k: v for k, v in data.items() if k != "serving"},
    )


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


# The environment layer (the reference's apply_env): GGRMCP_SERVING_*,
# GGRMCP_FLEET_* and GGRMCP_TRAINING_* set the port's sections; every
# other GGRMCP_ variable is the gateway's, and GGRMCP_FLEET_WORKER_* is
# the fleet's spawn handshake (serving/fleet.py), never a config path.
_ENV_SECTIONS = {"serving": ServingConfig, "fleet": FleetConfig,
                 "training": TrainingConfig}
_ENV_SKIP_PREFIXES = ("GGRMCP_FLEET_WORKER_",)


def apply_env(data: dict, environ: Optional[dict] = None) -> dict:
    """GGRMCP_{SERVING,FLEET,TRAINING}_KEY=value overrides into
    a config tree, in place: nested paths use single underscores
    resolved greedily against the config classes, and the raw string is
    coerced by the type of the value it replaces (the reference's
    rules)."""
    environ = dict(os.environ) if environ is None else environ
    for key, raw in environ.items():
        if key.startswith(_ENV_SKIP_PREFIXES):
            continue
        for section, cls in _ENV_SECTIONS.items():
            prefix = f"GGRMCP_{section.upper()}_"
            if key.startswith(prefix):
                sub = data.setdefault(section, {})
                if not isinstance(sub, dict):
                    raise ValueError(f"{section} must be an object")
                _env_path(cls, sub, key[len(prefix):].lower().split("_"),
                          raw, key)
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
         environ: Optional[dict] = None) -> Config:
    """Defaults → file → environment (`environ`, default os.environ), as
    the reference loads (command line flags go over the result)."""
    data = read_file(path) if path else {}
    apply_env(data, environ)
    return config_from_dict(data)
