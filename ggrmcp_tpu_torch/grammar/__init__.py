"""Schema-constrained decoding for MCP tool outputs: copies of
`ggrmcp_tpu/grammar` (numpy only; this package imports nothing of the
reference).

- compiler: JSON schema → regex IR → byte DFA → dense [n_states, V]
  token tables (CompiledGrammar) with forced-run (jump-ahead) tables,
  and typed errors for unsupported dialect and over-budget schemas.
- runtime: GrammarCache (LRU of compiled DFAs, sidecar-owned) and
  GrammarArena (the fixed-shape table arena with per-grammar residency
  and refcounts, batcher-owned; it also records the rows each insert
  wrote, so the batcher uploads only those).

The device side is ops/sampling.py (`masked_sample_dynamic`,
`forced_run_lookup`) inside serving/batching.py's admission and ticks;
the wire contract is GenerateRequest.constraint.
"""

from ggrmcp_tpu_torch.grammar.compiler import (
    CompiledGrammar,
    GrammarCapacityError,
    GrammarError,
    SchemaTooComplexError,
    SchemaUnsupportedError,
    compile_schema,
    schema_fingerprint,
)
from ggrmcp_tpu_torch.grammar.runtime import GrammarArena, GrammarCache, GrammarHandle

__all__ = [
    "CompiledGrammar",
    "GrammarArena",
    "GrammarCache",
    "GrammarCapacityError",
    "GrammarError",
    "GrammarHandle",
    "SchemaTooComplexError",
    "SchemaUnsupportedError",
    "compile_schema",
    "schema_fingerprint",
]
