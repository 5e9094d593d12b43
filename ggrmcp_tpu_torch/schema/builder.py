"""Protobuf descriptor → JSON Schema engine, and MCP tool building.

Capability parity with the reference schema generator
(pkg/tools/builder.go): recursive message walk with cycle breaking into
``$ref``/``definitions``, oneof → ``oneOf`` of single-property options,
maps → ``patternProperties``, enums as strings with values and
descriptions, well-known types special-cased, presence-based
``required``, comment-derived descriptions, and a depth limit.

Fixed vs the reference: the schema cache is configured AND implemented
(builder.go:18 declared a cache that was never wired; SURVEY.md §3.4),
and tensor-typed messages get ``x-tensor`` dtype/shape annotations so
TPU model endpoints advertise their array contract to MCP clients.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional

from google.protobuf import descriptor as _d

from ggrmcp_tpu_torch.core.config import ToolsConfig
from ggrmcp_tpu_torch.core.types import MethodInfo, generate_tool_name, is_valid_tool_name
from ggrmcp_tpu_torch.mcp.types import Tool

FieldDescriptor = _d.FieldDescriptor

# Scalar kind table (builder.go:307-342 parity). 64-bit integers are
# tagged format:int64 — protojson transcodes them as strings on the wire,
# and the invoker accepts both.
_SCALAR_SCHEMAS: dict[int, dict[str, Any]] = {
    FieldDescriptor.TYPE_DOUBLE: {"type": "number"},
    FieldDescriptor.TYPE_FLOAT: {"type": "number"},
    FieldDescriptor.TYPE_INT64: {"type": "integer", "format": "int64"},
    FieldDescriptor.TYPE_UINT64: {"type": "integer", "format": "uint64"},
    FieldDescriptor.TYPE_INT32: {"type": "integer", "format": "int32"},
    FieldDescriptor.TYPE_FIXED64: {"type": "integer", "format": "uint64"},
    FieldDescriptor.TYPE_FIXED32: {"type": "integer", "format": "int32"},
    FieldDescriptor.TYPE_BOOL: {"type": "boolean"},
    FieldDescriptor.TYPE_STRING: {"type": "string"},
    FieldDescriptor.TYPE_BYTES: {"type": "string", "format": "byte"},
    FieldDescriptor.TYPE_UINT32: {"type": "integer", "format": "int32"},
    FieldDescriptor.TYPE_SFIXED32: {"type": "integer", "format": "int32"},
    FieldDescriptor.TYPE_SFIXED64: {"type": "integer", "format": "int64"},
    FieldDescriptor.TYPE_SINT32: {"type": "integer", "format": "int32"},
    FieldDescriptor.TYPE_SINT64: {"type": "integer", "format": "int64"},
}

# Well-known type handling (builder.go:376-418 parity).
_WRAPPER_TYPES: dict[str, dict[str, Any]] = {
    "google.protobuf.DoubleValue": {"type": "number"},
    "google.protobuf.FloatValue": {"type": "number"},
    "google.protobuf.Int64Value": {"type": "integer", "format": "int64"},
    "google.protobuf.UInt64Value": {"type": "integer", "format": "uint64"},
    "google.protobuf.Int32Value": {"type": "integer", "format": "int32"},
    "google.protobuf.UInt32Value": {"type": "integer", "format": "int32"},
    "google.protobuf.BoolValue": {"type": "boolean"},
    "google.protobuf.StringValue": {"type": "string"},
    "google.protobuf.BytesValue": {"type": "string", "format": "byte"},
}

# TPU extension: messages that carry dense arrays advertise their tensor
# contract. Maps message full name → dtype field conventions understood by
# the serving plane (ggrmcp_tpu/serving).
TENSOR_MESSAGE_TYPES = {
    "ggrmcp.tpu.Tensor",
}

# Comment provider signature: (descriptor) -> leading+trailing comment str.
CommentFn = Callable[[Any], str]


class SchemaBuilder:
    """Builds JSON Schemas from message descriptors, with an LRU cache."""

    def __init__(
        self,
        cfg: Optional[ToolsConfig] = None,
        comment_fn: Optional[CommentFn] = None,
    ):
        self.cfg = cfg or ToolsConfig()
        self.comment_fn = comment_fn
        self._cache: dict[str, dict[str, Any]] = {}
        self._cache_lock = threading.Lock()

    # -- public API ---------------------------------------------------------

    def message_schema(self, desc: _d.Descriptor) -> dict[str, Any]:
        """Schema for a message type, cached by full name."""
        if self.cfg.cache.enabled:
            with self._cache_lock:
                hit = self._cache.get(desc.full_name)
            if hit is not None:
                return hit
        schema = self._build_root(desc)
        if self.cfg.cache.enabled:
            with self._cache_lock:
                if len(self._cache) >= self.cfg.cache.max_entries:
                    self._cache.clear()  # simple full reset; rebuild is cheap
                self._cache[desc.full_name] = schema
        return schema

    def invalidate_cache(self) -> None:
        with self._cache_lock:
            self._cache.clear()

    # -- construction -------------------------------------------------------

    def _build_root(self, desc: _d.Descriptor) -> dict[str, Any]:
        refs: set[str] = set()
        schema = self._message(desc, visited=set(), depth=0, refs=refs)
        if refs:
            definitions: dict[str, Any] = {}
            pending = set(refs)
            defined: set[str] = set()
            pool_lookup = {d.full_name: d for d in _collect_types(desc)}
            while pending:
                fqn = pending.pop()
                defined.add(fqn)
                target = pool_lookup.get(fqn)
                if target is None:
                    continue
                inner_refs: set[str] = set()
                # Build with an empty visited set: the walk re-adds `fqn`
                # on entry, so self-references inside become $refs while
                # the definition body itself is expanded.
                definitions[fqn] = self._message(
                    target, visited=set(), depth=0, refs=inner_refs
                )
                pending |= inner_refs - defined
            schema = dict(schema)
            schema["definitions"] = definitions
        return schema

    def _message(
        self,
        desc: _d.Descriptor,
        visited: set[str],
        depth: int,
        refs: set[str],
    ) -> dict[str, Any]:
        fqn = desc.full_name

        wkt = self._well_known(desc, visited, depth, refs)
        if wkt is not None:
            return wkt

        if fqn in visited:
            # Cycle: emit a $ref and record it for the definitions block
            # (builder.go:162-174 behavior).
            refs.add(fqn)
            return {"$ref": f"#/definitions/{fqn}"}

        if depth >= self.cfg.max_schema_depth:
            return {
                "type": "object",
                "description": f"(schema depth limit {self.cfg.max_schema_depth} reached)",
            }

        visited = visited | {fqn}
        properties: dict[str, Any] = {}
        required: list[str] = []
        one_ofs: list[dict[str, Any]] = []

        real_oneofs = [o for o in desc.oneofs if not _is_synthetic_oneof(o)]
        oneof_field_names = {f.name for o in real_oneofs for f in o.fields}

        for field in desc.fields:
            name = field.json_name or field.name
            if field.name in oneof_field_names:
                continue  # rendered inside oneOf options below
            properties[name] = self._field(field, visited, depth + 1, refs)
            # proto3 implicit-presence fields are listed as required
            # (builder.go:205-211 semantics: no optional keyword, no
            # message/oneof presence).
            if not field.has_presence or field.is_repeated:
                required.append(name)

        for oneof in real_oneofs:
            options = []
            for field in oneof.fields:
                name = field.json_name or field.name
                options.append(
                    {
                        "type": "object",
                        "properties": {
                            name: self._field(field, visited, depth + 1, refs)
                        },
                        "additionalProperties": False,
                    }
                )
            one_ofs.append(
                {
                    "oneOf": options,
                    "description": f"At most one of: "
                    + ", ".join(f.json_name or f.name for f in oneof.fields),
                }
            )

        schema: dict[str, Any] = {"type": "object", "properties": properties}
        if required:
            schema["required"] = sorted(required)
        if one_ofs:
            # A single oneof lifts to top-level oneOf options merged with
            # the base properties; multiple oneofs use allOf of oneOfs.
            if len(one_ofs) == 1:
                schema["oneOf"] = one_ofs[0]["oneOf"]
            else:
                schema["allOf"] = [{"oneOf": o["oneOf"]} for o in one_ofs]
        comment = self._comment(desc)
        if comment:
            schema["description"] = comment
        if self.cfg.tensor_extensions and fqn in TENSOR_MESSAGE_TYPES:
            schema["x-tensor"] = True
        return schema

    def _field(
        self,
        field: FieldDescriptor,
        visited: set[str],
        depth: int,
        refs: set[str],
    ) -> dict[str, Any]:
        if _is_map_field(field):
            value_schema = self._map_value(field, visited, depth, refs)
            schema: dict[str, Any] = {
                "type": "object",
                "patternProperties": {".*": value_schema},
                "additionalProperties": False,
            }
        elif field.is_repeated:
            schema = {"type": "array", "items": self._single_field(field, visited, depth, refs)}
        else:
            schema = self._single_field(field, visited, depth, refs)

        comment = self._comment(field)
        if comment and "description" not in schema:
            schema = dict(schema)
            schema["description"] = comment
        return schema

    def _single_field(
        self,
        field: FieldDescriptor,
        visited: set[str],
        depth: int,
        refs: set[str],
    ) -> dict[str, Any]:
        if field.type == FieldDescriptor.TYPE_MESSAGE:
            return self._message(field.message_type, visited, depth, refs)
        if field.type == FieldDescriptor.TYPE_GROUP:
            return {"type": "object"}
        if field.type == FieldDescriptor.TYPE_ENUM:
            return self._enum(field.enum_type)
        base = _SCALAR_SCHEMAS.get(field.type)
        return dict(base) if base else {"type": "string"}

    def _map_value(
        self,
        field: FieldDescriptor,
        visited: set[str],
        depth: int,
        refs: set[str],
    ) -> dict[str, Any]:
        value_field = field.message_type.fields_by_name["value"]
        return self._single_field(value_field, visited, depth, refs)

    def _enum(self, enum: _d.EnumDescriptor) -> dict[str, Any]:
        """Enums as strings with value list + descriptions
        (builder.go:344-371)."""
        schema: dict[str, Any] = {
            "type": "string",
            "enum": [v.name for v in enum.values],
        }
        descriptions = {}
        for value in enum.values:
            comment = self._comment(value)
            if comment:
                descriptions[value.name] = comment
        if descriptions:
            schema["enumDescriptions"] = descriptions
        comment = self._comment(enum)
        if comment:
            schema["description"] = comment
        return schema

    def _well_known(
        self,
        desc: _d.Descriptor,
        visited: set[str],
        depth: int,
        refs: set[str],
    ) -> Optional[dict[str, Any]]:
        fqn = desc.full_name
        if fqn == "google.protobuf.Timestamp":
            return {"type": "string", "format": "date-time"}
        if fqn == "google.protobuf.Duration":
            return {
                "type": "string",
                "format": "duration",
                "description": "Duration in seconds, e.g. '3.5s'",
            }
        if fqn == "google.protobuf.Any":
            return {
                "type": "object",
                "properties": {"@type": {"type": "string"}},
                "additionalProperties": True,
            }
        if fqn == "google.protobuf.Struct":
            return {"type": "object", "additionalProperties": True}
        if fqn == "google.protobuf.Value":
            return {}  # any JSON value
        if fqn == "google.protobuf.ListValue":
            return {"type": "array"}
        if fqn == "google.protobuf.Empty":
            return {"type": "object", "additionalProperties": False}
        if fqn == "google.protobuf.FieldMask":
            return {"type": "string"}
        wrapper = _WRAPPER_TYPES.get(fqn)
        if wrapper is not None:
            return dict(wrapper)
        return None

    def _comment(self, desc: Any) -> str:
        if not self.cfg.include_comments or self.comment_fn is None:
            return ""
        try:
            return self.comment_fn(desc) or ""
        except Exception:
            return ""


# ---------------------------------------------------------------------------
# Tool building
# ---------------------------------------------------------------------------


class ToolBuilder:
    """MethodInfo → MCP Tool (builder.go:36-151 parity)."""

    def __init__(
        self,
        cfg: Optional[ToolsConfig] = None,
        comment_fn: Optional[CommentFn] = None,
    ):
        self.cfg = cfg or ToolsConfig()
        self.schema_builder = SchemaBuilder(self.cfg, comment_fn)

    def build_tool(self, method: MethodInfo) -> Tool:
        name = generate_tool_name(method.service_name, method.name)
        if not is_valid_tool_name(name):
            raise ValueError(f"invalid tool name generated: {name!r}")
        description = method.description or (
            f"Calls the {method.name} method of the {method.service_name} service"
        )
        if method.input_descriptor is None:
            raise ValueError(f"method {method.full_name} has no input descriptor")
        input_schema = self.schema_builder.message_schema(method.input_descriptor)
        output_schema = None
        if self.cfg.emit_output_schema and method.output_descriptor is not None:
            output_schema = self.schema_builder.message_schema(method.output_descriptor)
        annotations = {}
        if method.is_server_streaming:
            annotations["x-streaming"] = True
        return Tool(
            name=name,
            description=description,
            input_schema=input_schema,
            output_schema=output_schema,
            annotations=annotations,
        )

    def build_tools(self, methods: list[MethodInfo]) -> list[Tool]:
        """Build all tools, log-and-skip failures (builder.go:125-151).
        Client-streaming methods are never exposed; server-streaming
        ones are included when cfg.streaming_tools is set."""
        tools: list[Tool] = []
        for method in methods:
            if method.is_client_streaming:
                continue
            if method.is_server_streaming and not self.cfg.streaming_tools:
                continue
            try:
                tools.append(self.build_tool(method))
            except Exception:
                continue
        return tools


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _is_map_field(field: FieldDescriptor) -> bool:
    return (
        field.type == FieldDescriptor.TYPE_MESSAGE
        and field.message_type.GetOptions().map_entry
    )


def _is_synthetic_oneof(oneof: _d.OneofDescriptor) -> bool:
    """proto3 `optional` fields live in synthetic single-field oneofs
    named `_<field>`; they are presence markers, not unions."""
    return len(oneof.fields) == 1 and oneof.name == "_" + oneof.fields[0].name


def _collect_types(root: _d.Descriptor) -> list[_d.Descriptor]:
    """All message types reachable from `root` (for $ref resolution)."""
    seen: dict[str, _d.Descriptor] = {}
    stack = [root]
    while stack:
        desc = stack.pop()
        if desc.full_name in seen:
            continue
        seen[desc.full_name] = desc
        for field in desc.fields:
            if field.type == FieldDescriptor.TYPE_MESSAGE:
                stack.append(field.message_type)
    return list(seen.values())
