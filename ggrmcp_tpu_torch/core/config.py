"""The port's serving configuration.

`BatchingConfig` and `ServingConfig` carry the fields this package
reads, under the reference's names and defaults
(`ggrmcp_tpu/core/config.py`). Fields of features the port does not
implement yet are carried only as guards: a non-default value raises
ValueError naming the field, never silently ignored. `load_serving_config`
reads the reference's JSON config file layout (everything under
"serving") into these classes.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any

# Weight and KV-cache quantization modes ("" = the model dtype).
QUANTIZE_MODES = ("", "int8")


def _check_unsupported(obj: Any, names: tuple[str, ...], where: str) -> None:
    for f in dataclasses.fields(obj):
        if f.name not in names:
            continue
        default = (
            f.default_factory() if f.default_factory is not dataclasses.MISSING
            else f.default
        )
        if getattr(obj, f.name) != default:
            raise ValueError(
                f"{where}.{f.name}={getattr(obj, f.name)!r} is not supported "
                f"by the PyTorch port yet (only the default {default!r})"
            )


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
    # Guards: features of the reference batcher not ported yet.
    queue_deadline_ms: float = 0.0
    p50_budget_ms: float = 0.0
    kv_tiers: list = field(default_factory=list)
    speculative: str = "off"
    paged_kv_host_bytes: int = 0
    paged_kv_host_path: str = ""
    paged_kv_host_file_bytes: int = 0

    UNSUPPORTED = (
        "queue_deadline_ms", "p50_budget_ms", "kv_tiers", "speculative",
        "paged_kv_host_bytes", "paged_kv_host_path",
        "paged_kv_host_file_bytes",
    )

    def __post_init__(self) -> None:
        _check_unsupported(self, self.UNSUPPORTED, "batching")
        self._validate_kv_reuse()
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


@dataclass
class ServingConfig:
    model: str = "tiny-llama"
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
    # Guards: reference features not ported yet.
    role: str = "mixed"
    uds_path: str = ""
    checkpoint_path: str = ""
    kv_ring: bool = False
    speculative_draft: str = ""
    failpoints: str = ""

    UNSUPPORTED = (
        "role", "uds_path", "checkpoint_path", "kv_ring", "speculative_draft",
        "failpoints",
    )

    def __post_init__(self) -> None:
        _check_unsupported(self, self.UNSUPPORTED, "serving")
        if not isinstance(self.batching, BatchingConfig):
            raise ValueError("serving.batching must be a BatchingConfig")
        if not isinstance(self.grammar, GrammarConfig):
            raise ValueError("serving.grammar must be a GrammarConfig")
        # The reference's checks (Config.validate), at construction.
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


def serving_config_from_dict(data: dict) -> ServingConfig:
    """{"serving": {..., "batching": {...}, "grammar": {...}}} →
    ServingConfig. Any key
    these classes do not carry raises ValueError naming it."""
    if not isinstance(data, dict):
        raise ValueError("a config file holds one JSON object")
    unknown = sorted(set(data) - {"serving"})
    if unknown:
        raise ValueError(
            f"config: unknown top-level keys {unknown}; the sidecar's "
            f"settings nest under \"serving\""
        )
    return _from_dict(ServingConfig, data.get("serving", {}), "serving",
                      {"batching": BatchingConfig, "grammar": GrammarConfig})


def load_serving_config(path: str) -> ServingConfig:
    """A JSON config file in the reference's layout → ServingConfig."""
    with open(path) as fh:
        return serving_config_from_dict(json.load(fh))
