"""JSON schema → token-level DFA compiler for constrained decoding.
A copy of `ggrmcp_tpu/grammar/compiler.py`: its tables are byte-equal
to the reference's (tests/test_torch_grammar.py).

The pipeline (Outlines, Willard & Louf 2023; precompiled per-state token
masks as in XGrammar, Dong et al. 2024):

    JSON schema  →  regex IR  →  byte-level NFA (Thompson)
                 →  byte-level DFA (subset construction)
                 →  tokenizer-aligned dense tables

The serving tokenizer is the hermetic ``ByteTokenizer`` (byte b ↦ b+3,
vocab ≈ 259), so the compiled artifact is a dense ``[n_states, V]``
allow-mask plus a ``[n_states, V]`` transition table, so the
constrained decode step is a gather + where inside the decode tick
(ops/sampling.py::masked_sample_dynamic).

Supported schema dialect — the subset ``schema/builder.py`` emits for
MCP tools: ``object`` (properties + required), ``array`` (items,
min/maxItems), ``string`` (min/maxLength, full JSON escapes, UTF-8
multi-byte), ``integer``/``number``/``boolean``/``null``, ``enum`` /
``const``, ``oneOf``/``anyOf``, ``type`` lists, and ``$ref`` into
``definitions``/``$defs`` (acyclic only — a DFA cannot express
unbounded recursion). The grammar generates CANONICAL compact JSON: no
insignificant whitespace, object properties in declaration order,
non-required properties omitted (with no ``required`` list every
property is emitted). Anything the grammar accepts validates against
the schema; the schema's full value space is deliberately NOT all
reachable — conformance is the contract, coverage is not.

Failure modes are typed: ``SchemaUnsupportedError`` for dialect gaps,
``SchemaTooComplexError`` when the DFA exceeds the configured state
budget (``serving.grammar.max_states``) or a ``$ref`` cycle is found.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Optional

import numpy as np


class GrammarError(ValueError):
    """Base for schema-compilation failures (caller error, not a 500)."""


class SchemaUnsupportedError(GrammarError):
    """The schema uses a construct outside the compilable dialect."""


class SchemaTooComplexError(GrammarError):
    """DFA state budget exceeded, or recursive ($ref cycle) schema."""


class GrammarCapacityError(GrammarError):
    """The device table arena cannot hold another live grammar
    (too many DISTINCT schemas decoding at once) — transient overload,
    mapped to RESOURCE_EXHAUSTED by the sidecar."""


# ---------------------------------------------------------------------------
# regex IR
# ---------------------------------------------------------------------------


class _Node:
    __slots__ = ()


class _Byte(_Node):
    __slots__ = ("bytes",)

    def __init__(self, byte_set):
        self.bytes = frozenset(byte_set)


class _Seq(_Node):
    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = list(parts)


class _Alt(_Node):
    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = list(parts)


class _Rep(_Node):
    __slots__ = ("child", "lo", "hi")

    def __init__(self, child, lo: int, hi: Optional[int]):
        self.child = child
        self.lo = int(lo)
        self.hi = hi  # None = unbounded

    def __post_check__(self):
        pass


def _lit(data: bytes) -> _Seq:
    return _Seq([_Byte((b,)) for b in data])


def _rng(lo: int, hi: int) -> range:
    return range(lo, hi + 1)


_DIGIT = _Byte(_rng(0x30, 0x39))
_DIGIT19 = _Byte(_rng(0x31, 0x39))
_HEX = _Byte(set(_rng(0x30, 0x39)) | set(_rng(0x41, 0x46)) | set(_rng(0x61, 0x66)))

# One JSON string character, as bytes: printable ASCII minus quote and
# backslash, the two-char escapes, \uXXXX, and well-formed-shaped UTF-8
# multi-byte sequences (lead-byte classes C2-DF / E0-EF / F0-F4 with
# 80-BF continuations — a slight overapproximation of strict UTF-8
# around surrogates/overlongs, which decode(errors="replace") absorbs).
_STR_CHAR = _Alt([
    _Byte(set(_rng(0x20, 0x7E)) - {0x22, 0x5C}),
    _Seq([_Byte((0x5C,)), _Byte(frozenset(b'"\\/bfnrt'))]),
    _Seq([_Byte((0x5C,)), _Byte((0x75,)), _HEX, _HEX, _HEX, _HEX]),
    _Seq([_Byte(_rng(0xC2, 0xDF)), _Byte(_rng(0x80, 0xBF))]),
    _Seq([_Byte(_rng(0xE0, 0xEF)), _Byte(_rng(0x80, 0xBF)),
          _Byte(_rng(0x80, 0xBF))]),
    _Seq([_Byte(_rng(0xF0, 0xF4)), _Byte(_rng(0x80, 0xBF)),
          _Byte(_rng(0x80, 0xBF)), _Byte(_rng(0x80, 0xBF))]),
])

# Digit runs are BOUNDED (18 covers the full int64 range): an
# unbounded [0-9]* would let a pathological model ramble in the digit
# state until max_new and return unterminated JSON — past the bound the
# DFA offers only the exit tokens, so every number path terminates.
_MAX_DIGITS = 18
# -?(0|[1-9][0-9]{0,17})
_INT = _Seq([
    _Rep(_Byte((0x2D,)), 0, 1),
    _Alt([_Byte((0x30,)),
          _Seq([_DIGIT19, _Rep(_DIGIT, 0, _MAX_DIGITS - 1)])]),
])
# integer (\.[0-9]{1,18})? ([eE][+-]?[0-9]{1,3})?
_NUMBER = _Seq([
    _INT,
    _Rep(_Seq([_Byte((0x2E,)), _Rep(_DIGIT, 1, _MAX_DIGITS)]), 0, 1),
    _Rep(_Seq([_Byte(frozenset(b"eE")), _Rep(_Byte(frozenset(b"+-")), 0, 1),
               _Rep(_DIGIT, 1, 3)]), 0, 1),
])


# ---------------------------------------------------------------------------
# schema → IR
# ---------------------------------------------------------------------------

_MAX_REF_DEPTH = 64


def _json_bytes(value: Any) -> bytes:
    return json.dumps(
        value, separators=(",", ":"), ensure_ascii=False
    ).encode("utf-8")


def _resolve_ref(ref: str, root: dict) -> Any:
    for prefix, key in (("#/definitions/", "definitions"), ("#/$defs/", "$defs")):
        if ref.startswith(prefix):
            name = ref[len(prefix):]
            target = root.get(key, {}).get(name)
            if target is None:
                raise SchemaUnsupportedError(f"unresolvable $ref {ref!r}")
            return target
    raise SchemaUnsupportedError(f"unsupported $ref form {ref!r}")


def _schema_node(schema: Any, root: dict, depth: int) -> _Node:
    if depth > _MAX_REF_DEPTH:
        raise SchemaTooComplexError(
            "schema nests deeper than the compiler's bound "
            f"({_MAX_REF_DEPTH}) — recursive ($ref cycle) schemas have "
            "no finite DFA"
        )
    if schema is True or schema == {}:
        raise SchemaUnsupportedError(
            "unconstrained subschema (true/{}) has no grammar; spell "
            "out a type"
        )
    if not isinstance(schema, dict):
        raise SchemaUnsupportedError(f"subschema must be an object: {schema!r}")
    if "$ref" in schema:
        return _schema_node(_resolve_ref(schema["$ref"], root), root, depth + 1)
    if "const" in schema:
        return _lit(_json_bytes(schema["const"]))
    if "enum" in schema:
        values = schema["enum"]
        if not values:
            raise SchemaUnsupportedError("empty enum matches nothing")
        return _Alt([_lit(_json_bytes(v)) for v in values])
    for key in ("oneOf", "anyOf"):
        if key in schema:
            subs = schema[key]
            if not subs:
                raise SchemaUnsupportedError(f"empty {key}")
            return _Alt([_schema_node(s, root, depth + 1) for s in subs])
    t = schema.get("type")
    if isinstance(t, list):
        if not t:
            raise SchemaUnsupportedError("empty type list")
        return _Alt([
            _schema_node({**schema, "type": x}, root, depth + 1) for x in t
        ])
    if t == "object" or (t is None and "properties" in schema):
        return _object_node(schema, root, depth)
    if t == "array":
        return _array_node(schema, root, depth)
    if t == "string":
        return _string_node(schema)
    if t == "integer":
        return _INT
    if t == "number":
        return _NUMBER
    if t == "boolean":
        return _Alt([_lit(b"true"), _lit(b"false")])
    if t == "null":
        return _lit(b"null")
    raise SchemaUnsupportedError(f"unsupported schema type {t!r}")


def _object_node(schema: dict, root: dict, depth: int) -> _Node:
    props = schema.get("properties") or {}
    required = schema.get("required") or []
    unknown = [k for k in required if k not in props]
    if unknown:
        raise SchemaUnsupportedError(
            f"required properties missing from properties: {unknown}"
        )
    # Canonical emission: declaration order, required-only (all
    # properties when no required list — an empty grammar object would
    # satisfy nothing useful).
    chosen = [k for k in props if not required or k in required]
    if not chosen:
        return _lit(b"{}")
    parts: list[_Node] = [_lit(b"{")]
    for i, key in enumerate(chosen):
        if i:
            parts.append(_lit(b","))
        parts.append(_lit(_json_bytes(key) + b":"))
        parts.append(_schema_node(props[key], root, depth + 1))
    parts.append(_lit(b"}"))
    return _Seq(parts)


def _array_node(schema: dict, root: dict, depth: int) -> _Node:
    items = schema.get("items")
    if items is None:
        raise SchemaUnsupportedError("array without items has no grammar")
    lo = int(schema.get("minItems", 0))
    hi = schema.get("maxItems")
    hi = int(hi) if hi is not None else None
    if hi is not None and hi < lo:
        raise SchemaUnsupportedError("maxItems < minItems")
    item = _schema_node(items, root, depth + 1)
    if hi == 0:
        return _lit(b"[]")
    more = _Rep(
        _Seq([_lit(b","), item]), max(lo - 1, 0),
        None if hi is None else hi - 1,
    )
    non_empty = _Seq([_lit(b"["), item, more, _lit(b"]")])
    if lo == 0:
        return _Alt([_lit(b"[]"), non_empty])
    return non_empty


def _string_node(schema: dict) -> _Node:
    if "pattern" in schema:
        raise SchemaUnsupportedError("string pattern is not supported")
    lo = int(schema.get("minLength", 0))
    hi = schema.get("maxLength")
    hi = int(hi) if hi is not None else None
    if hi is not None and hi < lo:
        raise SchemaUnsupportedError("maxLength < minLength")
    return _Seq([_lit(b'"'), _Rep(_STR_CHAR, lo, hi), _lit(b'"')])


# ---------------------------------------------------------------------------
# IR → NFA (Thompson construction)
# ---------------------------------------------------------------------------


class _NFA:
    def __init__(self):
        self.eps: list[list[int]] = []
        self.edges: list[list[tuple[frozenset, int]]] = []

    def state(self) -> int:
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1

    def build(self, node: _Node) -> tuple[int, int]:
        """Returns (start, end) state ids for `node`."""
        if isinstance(node, _Byte):
            s, e = self.state(), self.state()
            self.edges[s].append((node.bytes, e))
            return s, e
        if isinstance(node, _Seq):
            s = cur = self.state()
            for part in node.parts:
                ps, pe = self.build(part)
                self.eps[cur].append(ps)
                cur = pe
            return s, cur
        if isinstance(node, _Alt):
            s, e = self.state(), self.state()
            for part in node.parts:
                ps, pe = self.build(part)
                self.eps[s].append(ps)
                self.eps[pe].append(e)
            return s, e
        if isinstance(node, _Rep):
            s = cur = self.state()
            for _ in range(node.lo):
                ps, pe = self.build(node.child)
                self.eps[cur].append(ps)
                cur = pe
            if node.hi is None:
                # star over one more copy: cur -eps-> cs, ce -eps-> cs,
                # and both can exit to e.
                cs, ce = self.build(node.child)
                e = self.state()
                self.eps[cur] += [cs, e]
                self.eps[ce] += [cs, e]
                return s, e
            e = self.state()
            self.eps[cur].append(e)
            for _ in range(node.hi - node.lo):
                ps, pe = self.build(node.child)
                self.eps[cur].append(ps)
                cur = pe
                self.eps[cur].append(e)
            return s, e
        raise AssertionError(f"unknown IR node {node!r}")


# ---------------------------------------------------------------------------
# NFA → DFA (subset construction) → token tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CompiledGrammar:
    """A schema's DFA in tokenizer-aligned dense-table form.

    States are LOCAL (0 = start); the batcher's GrammarArena relocates
    them to a global base when the grammar becomes live (trans + base
    works because disallowed/self transitions are self-loops; jump_states
    entries are always valid local ids for the same reason).

    Forced-run tables (SGLang compressed-FSM jump-forward / XGrammar
    forced-token compilation): a state is FORCED when exactly one token
    is admissible and it is not EOS (accepting states always admit EOS,
    so they are never forced). jump_len[s] is the length of the maximal
    forced chain from s (0 at branching/accepting states), capped at
    the compile-time jump_cap; jump_tokens[s, :L] are the chain's token
    ids and jump_states[s, k] is the state after consuming
    jump_tokens[s, :k+1] — the landing state of an L-token jump is
    jump_states[s, L-1]. Padding entries keep token 0 / the landing
    state so every jump_states cell relocates in-range.
    """

    allow: np.ndarray      # [n_states, vocab] bool — sampleable tokens
    trans: np.ndarray      # [n_states, vocab] int32 — next LOCAL state
    accept: np.ndarray     # [n_states] bool — EOS is legal here
    sink: np.ndarray       # [n_states] bool — accepting, no way forward
    jump_len: np.ndarray     # [n_states] int32 — forced-run length
    jump_tokens: np.ndarray  # [n_states, jump_cap] int32 — run token ids
    jump_states: np.ndarray  # [n_states, jump_cap] int32 — run states
    n_states: int
    schema_hash: str
    vocab_size: int
    eos_id: int
    byte_offset: int

    @property
    def start(self) -> int:
        return 0

    def step(self, state: int, token: int) -> int:
        return int(self.trans[state, token])

    def state_after(self, tokens, state: Optional[int] = None) -> int:
        s = self.start if state is None else state
        for token in tokens:
            s = int(self.trans[s, int(token)])
        return s

    def matches(self, text: "str | bytes") -> bool:
        """Host-side acceptance check (tests / debugging)."""
        data = text.encode("utf-8") if isinstance(text, str) else text
        s = self.start
        for b in data:
            token = b + self.byte_offset
            if not self.allow[s, token]:
                return False
            s = int(self.trans[s, token])
        return bool(self.accept[s])

    def forced_run(self, state: int) -> list:
        """The forced token run from `state` (host-side mirror of the
        device jump: empty at branching/accepting states)."""
        length = int(self.jump_len[state])
        return [int(t) for t in self.jump_tokens[state, :length]]


def schema_fingerprint(schema: "str | dict") -> str:
    """Canonical hash for compile caching: whitespace/key-order
    insensitive. Unparsable schema text is the caller's error (typed),
    here as well as at compile — the cache fingerprints before it
    compiles."""
    if isinstance(schema, str):
        try:
            schema = json.loads(schema)
        except json.JSONDecodeError as exc:
            raise GrammarError(f"constraint schema is not valid JSON: {exc}")
    canon = json.dumps(schema, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode("utf-8")).hexdigest()


# Compile-time forced-run bound: runs are precomputed up to this many
# tokens per state; the arena truncates further to the serving-time
# window (serving.grammar.jump_max), so compiling wider than any
# reasonable serving window costs only host memory at compile time.
JUMP_CAP = 16


def compute_jump_tables(
    allow: np.ndarray, trans: np.ndarray, eos_id: int,
    jump_cap: int = JUMP_CAP,
) -> tuple:
    """Forced-run tables from dense allow/transition tables.

    A state forces a token when its allow row admits EXACTLY one token
    and that token is not EOS — accepting states admit EOS beside any
    byte edges, so a forced state is never accepting and a jump can
    never skip over a legal stop point. Chains of forced states
    collapse into one run, truncated at jump_cap (the per-state walk is
    bounded, so forced cycles — impossible in a terminating JSON
    grammar anyway — cannot hang compilation)."""
    n = allow.shape[0]
    jump_cap = max(0, int(jump_cap))
    counts = allow.sum(axis=1)
    single = np.where(counts == 1)[0]
    # forced_tok[s] = the unique admissible token, or -1.
    forced_tok = np.full((n,), -1, dtype=np.int64)
    if len(single):
        toks = allow[single].argmax(axis=1)
        keep = toks != eos_id
        forced_tok[single[keep]] = toks[keep]
    jump_len = np.zeros((n,), dtype=np.int32)
    jump_tokens = np.zeros((n, jump_cap), dtype=np.int32)
    # Padding states = self, so `jump_states + base` stays in-range
    # after arena relocation even for never-read cells.
    jump_states = np.tile(
        np.arange(n, dtype=np.int32)[:, None], (1, max(1, jump_cap))
    )[:, :jump_cap]
    for sid in range(n):
        s = sid
        length = 0
        while length < jump_cap and forced_tok[s] >= 0:
            tok = int(forced_tok[s])
            s = int(trans[s, tok])
            jump_tokens[sid, length] = tok
            jump_states[sid, length] = s
            length += 1
        jump_len[sid] = length
        # Landing-state padding: cells past the run read as the landing
        # state, which keeps truncated-window lookups well-defined.
        if length:
            jump_states[sid, length:] = s
    return jump_len, jump_tokens, jump_states


def compile_schema(
    schema: "str | dict",
    vocab_size: int,
    eos_id: int = 2,
    max_states: int = 1024,
    byte_offset: int = 3,
    jump_cap: int = JUMP_CAP,
) -> CompiledGrammar:
    """Compile a JSON schema into a CompiledGrammar.

    Raises GrammarError subclasses for unsupported dialect
    (SchemaUnsupportedError) or over-budget DFAs (SchemaTooComplexError).
    """
    if isinstance(schema, str):
        try:
            parsed = json.loads(schema)
        except json.JSONDecodeError as exc:
            raise GrammarError(f"constraint schema is not valid JSON: {exc}")
    else:
        parsed = schema
    if not isinstance(parsed, dict):
        raise SchemaUnsupportedError("schema root must be a JSON object")
    if byte_offset + 256 > vocab_size:
        raise GrammarError(
            f"vocab_size {vocab_size} cannot address the byte token "
            f"range [{byte_offset}, {byte_offset + 255}]"
        )

    node = _schema_node(parsed, parsed, 0)
    nfa = _NFA()
    n_start, n_end = nfa.build(node)

    def closure(states) -> frozenset:
        stack = list(states)
        seen = set(states)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    start_set = closure([n_start])
    ids: dict[frozenset, int] = {start_set: 0}
    order: list[frozenset] = [start_set]
    dfa_edges: list[dict[int, int]] = []
    i = 0
    while i < len(order):
        cur = order[i]
        i += 1
        # byte → union of NFA targets
        targets: dict[int, set] = {}
        for ns in cur:
            for byte_set, t in nfa.edges[ns]:
                for b in byte_set:
                    targets.setdefault(b, set()).add(t)
        edges: dict[int, int] = {}
        # Group identical target sets so closure() runs once per
        # distinct successor, not once per byte.
        grouped: dict[frozenset, list[int]] = {}
        for b, tset in targets.items():
            grouped.setdefault(frozenset(tset), []).append(b)
        for tset, bytes_ in grouped.items():
            dst = closure(tset)
            dst_id = ids.get(dst)
            if dst_id is None:
                dst_id = len(order)
                if dst_id >= max_states:
                    raise SchemaTooComplexError(
                        f"schema DFA exceeds the {max_states}-state "
                        "budget (serving.grammar.max_states); simplify "
                        "the schema or raise the budget"
                    )
                ids[dst] = dst_id
                order.append(dst)
            for b in bytes_:
                edges[b] = dst_id
        dfa_edges.append(edges)

    n = len(order)
    allow = np.zeros((n, vocab_size), dtype=bool)
    trans = np.tile(
        np.arange(n, dtype=np.int32)[:, None], (1, vocab_size)
    )  # disallowed tokens self-loop (never taken: they are masked)
    accept = np.zeros((n,), dtype=bool)
    sink = np.zeros((n,), dtype=bool)
    for sid, state_set in enumerate(order):
        if n_end in state_set:
            accept[sid] = True
            allow[sid, eos_id] = True  # EOS legal at any valid stop point
        for b, dst in dfa_edges[sid].items():
            allow[sid, b + byte_offset] = True
            trans[sid, b + byte_offset] = dst
        if accept[sid] and not dfa_edges[sid]:
            sink[sid] = True
    jump_len, jump_tokens, jump_states = compute_jump_tables(
        allow, trans, eos_id, jump_cap
    )
    return CompiledGrammar(
        allow=allow,
        trans=trans,
        accept=accept,
        sink=sink,
        jump_len=jump_len,
        jump_tokens=jump_tokens,
        jump_states=jump_states,
        n_states=n,
        schema_hash=schema_fingerprint(parsed),
        vocab_size=vocab_size,
        eos_id=eos_id,
        byte_offset=byte_offset,
    )
