"""gRPC server-reflection client and dynamic JSON↔proto invoker.

Capability parity with the reference reflection layer
(pkg/grpc/reflection.go): list services over the v1alpha bidi stream,
fetch file descriptors by symbol with caching, filter internal services,
build MethodInfo with resolved message descriptors, and invoke methods
generically — JSON in, JSON out — with forwarded metadata.

Fixed vs the reference: ALL file descriptors in a reflection response
are retained (the reference unmarshalled only element [0], dropping
dependencies — reflection.go:241), so cross-file message resolution
works without global registration; each backend gets its own isolated
DescriptorPool.

The protocol is spoken via generic stream_stream calls with hand-written
reflection_pb2 messages — no grpc_reflection package needed.
"""

from __future__ import annotations

import asyncio
import logging
import math
from typing import Any, AsyncIterator, Optional

import grpc
import grpc.aio
from google.protobuf import descriptor_pb2, descriptor_pool, json_format
from google.protobuf import message_factory

from ggrmcp_tpu_torch.core.types import MethodInfo
from ggrmcp_tpu_torch.rpc import descriptors as desc_mod
from ggrmcp_tpu_torch.rpc.pb import reflection_pb2

logger = logging.getLogger("ggrmcp.rpc.reflection")

_REFLECTION_V1ALPHA = (
    "/grpc.reflection.v1alpha.ServerReflection/ServerReflectionInfo"
)
_REFLECTION_V1 = "/grpc.reflection.v1.ServerReflection/ServerReflectionInfo"

# Internal service prefixes never exposed as tools (reflection.go:393-419).
INTERNAL_SERVICE_PREFIXES = (
    "grpc.reflection.",
    "grpc.health.",
    "grpc.channelz.",
    "grpc.testing.",
)


def filter_internal_services(names: list[str]) -> list[str]:
    return [
        n for n in names if not any(n.startswith(p) for p in INTERNAL_SERVICE_PREFIXES)
    ]


class ReflectionError(RuntimeError):
    pass


class ReflectionClient:
    """Speaks ServerReflection over one channel; caches descriptors.

    The response cache is keyed by both requested symbol and returned
    file name (reflection.go:196-254 behavior).
    """

    def __init__(self, channel: grpc.aio.Channel, host: str = ""):
        self._channel = channel
        self._host = host
        self._fd_cache: dict[str, list[descriptor_pb2.FileDescriptorProto]] = {}
        self._lock = asyncio.Lock()
        self._method_path = _REFLECTION_V1ALPHA

    # -- protocol primitives ------------------------------------------------

    async def _roundtrip(
        self, request: reflection_pb2.ServerReflectionRequest
    ) -> reflection_pb2.ServerReflectionResponse:
        """One request/response over a short-lived reflection stream."""
        for path in (self._method_path, _REFLECTION_V1):
            call = self._channel.stream_stream(
                path,
                request_serializer=reflection_pb2.ServerReflectionRequest.SerializeToString,
                response_deserializer=reflection_pb2.ServerReflectionResponse.FromString,
            )()
            try:
                await call.write(request)
                await call.done_writing()
                response = await call.read()
                if response is grpc.aio.EOF or response is None:
                    raise ReflectionError("reflection stream closed without response")
                self._method_path = path  # remember the working version
                return response
            except grpc.aio.AioRpcError as exc:
                if (
                    exc.code() == grpc.StatusCode.UNIMPLEMENTED
                    and path != _REFLECTION_V1
                ):
                    continue  # try the v1 endpoint
                raise ReflectionError(f"reflection RPC failed: {exc.details()}") from exc
            finally:
                call.cancel()
        raise ReflectionError("no reflection endpoint available")

    async def list_services(self) -> list[str]:
        """ListServices (reflection.go:108-146 parity)."""
        request = reflection_pb2.ServerReflectionRequest(
            host=self._host, list_services=""
        )
        response = await self._roundtrip(request)
        if response.HasField("error_response"):
            err = response.error_response
            raise ReflectionError(
                f"list_services error {err.error_code}: {err.error_message}"
            )
        return [s.name for s in response.list_services_response.service]

    async def file_containing_symbol(
        self, symbol: str
    ) -> list[descriptor_pb2.FileDescriptorProto]:
        """All FileDescriptorProtos for `symbol` including transitive
        dependencies the server sends (nothing dropped)."""
        async with self._lock:
            hit = self._fd_cache.get(symbol)
        if hit is not None:
            return hit
        request = reflection_pb2.ServerReflectionRequest(
            host=self._host, file_containing_symbol=symbol
        )
        response = await self._roundtrip(request)
        if response.HasField("error_response"):
            err = response.error_response
            raise ReflectionError(
                f"file_containing_symbol({symbol}) error {err.error_code}: "
                f"{err.error_message}"
            )
        protos = [
            descriptor_pb2.FileDescriptorProto.FromString(blob)
            for blob in response.file_descriptor_response.file_descriptor_proto
        ]
        async with self._lock:
            self._fd_cache[symbol] = protos
            for fdp in protos:
                self._fd_cache.setdefault(f"file:{fdp.name}", [fdp])
        return protos

    async def health_check(self) -> bool:
        """Deep health probe = live list_services RPC (reflection.go:439)."""
        try:
            await self.list_services()
            return True
        except asyncio.CancelledError:
            raise  # cancellation is not "unhealthy"
        except Exception:
            return False

    # -- discovery ----------------------------------------------------------

    async def discover_methods(self) -> tuple[list[MethodInfo], desc_mod.CommentIndex]:
        """Full discovery pass (reflection.go:49-105): list → filter →
        fetch descriptors → build one pool → extract methods+comments."""
        services = filter_internal_services(await self.list_services())
        all_files: dict[str, descriptor_pb2.FileDescriptorProto] = {}
        service_files: list[descriptor_pb2.FileDescriptorProto] = []
        for service in services:
            try:
                protos = await self.file_containing_symbol(service)
            except ReflectionError as exc:
                logger.warning("skipping service %s: %s", service, exc)
                continue
            for fdp in protos:
                if fdp.name not in all_files:
                    all_files[fdp.name] = fdp
            # The file that declares this service drives extraction.
            for fdp in protos:
                if any(
                    (fdp.package + "." + s.name if fdp.package else s.name) == service
                    for s in fdp.service
                ):
                    service_files.append(fdp)
                    break

        pool = desc_mod.build_pool(all_files.values())
        comments = desc_mod.CommentIndex()
        for fdp in all_files.values():
            comments.add_file(fdp)

        # Deduplicate declaring files, then extract only the discovered
        # services (a file may declare several).
        seen_files: dict[str, descriptor_pb2.FileDescriptorProto] = {}
        for fdp in service_files:
            seen_files.setdefault(fdp.name, fdp)
        methods = desc_mod.extract_methods(seen_files.values(), pool, comments)
        wanted = set(services)
        methods = [m for m in methods if m.service_name in wanted]
        return methods, comments


# ---------------------------------------------------------------------------
# Dynamic invocation (JSON ↔ proto ↔ wire)
# ---------------------------------------------------------------------------


_FD = descriptor_pb2.FieldDescriptorProto

# Scalar field types the compiled fast transcoder handles with plain
# Python values. Deliberately excluded: 64-bit ints (protojson maps
# them to strings), bytes (base64), enums (name mapping), and FLOAT on
# both sides (parse: ParseDict range-checks float32 and raises on
# overflow where setattr stores inf; dump: json_format applies float32
# precision rounding). DOUBLE dumps carry a finiteness check — protojson
# serializes nonfinite doubles as the strings "Infinity"/"NaN".
_FAST_PARSE_TYPES = {
    _FD.TYPE_STRING: (str,),
    _FD.TYPE_BOOL: (bool,),
    _FD.TYPE_INT32: (int,),
    _FD.TYPE_SINT32: (int,),
    _FD.TYPE_SFIXED32: (int,),
    _FD.TYPE_UINT32: (int,),
    _FD.TYPE_FIXED32: (int,),
    _FD.TYPE_DOUBLE: (int, float),
}
_FAST_DUMP_TYPES = frozenset({
    _FD.TYPE_STRING, _FD.TYPE_BOOL, _FD.TYPE_INT32, _FD.TYPE_SINT32,
    _FD.TYPE_SFIXED32, _FD.TYPE_UINT32, _FD.TYPE_FIXED32, _FD.TYPE_DOUBLE,
})


_SLOW = None  # sentinel entry: this key exists but needs json_format


def _compile_parse_table(desc):
    """JSON-key → (field name, accepted Python types, repeated?) parse
    table. Fields json_format must handle (nested messages, maps,
    64-bit ints, bytes, enums) become _SLOW entries — the fast path
    bails to ParseDict only when a request actually uses one, so e.g. a
    GenerateRequest without `sampling` stays fast. Messages with oneofs
    refuse outright (None): protojson rejects two members of one oneof
    in a single object, which setattr last-wins would silently accept.
    protojson accepts both the original field name and the camelCase
    json_name — the table carries both spellings."""
    # Multi-member oneofs refuse outright: protojson rejects two
    # members of one oneof in a single object, which setattr last-wins
    # would silently accept. Single-member oneofs (incl. the synthetic
    # ones proto3 `optional` creates) have no such rule.
    if any(len(o.fields) > 1 for o in desc.oneofs):
        return None
    table = {}
    for f in desc.fields:
        types = _FAST_PARSE_TYPES.get(f.type)
        if f.message_type is not None or types is None:
            entry = _SLOW
        else:
            entry = (
                f.name, types, f.is_repeated,
                # Nonfinite doubles (json.loads turns 1e400 into inf)
                # must divert: ParseDict rejects them with a ParseError
                # where setattr would silently store inf.
                f.type == _FD.TYPE_DOUBLE,
            )
        table[f.name] = entry
        table[f.json_name] = entry
    return table


def _compile_dump_table(desc):
    """field name → (json_name, repeated?) for the scalar (or
    repeated-scalar) fields of a message; fields json_format must
    handle are simply absent — _fast_dump falls back when a set field
    is not in the table, so a response only pays MessageToDict when it
    actually populates a complex field. (Oneofs need no special
    handling here: ListFields reports whichever member is set, exactly
    like MessageToDict.)"""
    table = {}
    for f in desc.fields:
        if f.message_type is None and f.type in _FAST_DUMP_TYPES:
            table[f.name] = (
                f.json_name,
                f.is_repeated,
                # protojson serializes nonfinite doubles as the strings
                # "Infinity"/"-Infinity"/"NaN"; a bare Python inf would
                # json.dumps to invalid JSON — divert those responses.
                f.type == _FD.TYPE_DOUBLE,
            )
    return table


def _fast_parse(request, arguments: dict, table) -> bool:
    """Set fields directly (upb C setattr/extend). Returns False — with
    the request possibly part-populated; caller must use a FRESH
    message — when anything needs the slow path: unknown key (so
    ParseDict raises the exact reference-parity error), bool-for-int
    (type() is exact), wrong type, non-list for a repeated field.
    Out-of-range ints raise ValueError like ParseDict."""
    for key, value in arguments.items():
        entry = table.get(key, _SLOW)
        if entry is _SLOW:
            return False
        name, types, repeated, needs_finite = entry
        if repeated:
            if type(value) is not list or any(
                type(v) not in types for v in value
            ):
                return False
            if needs_finite and not all(
                math.isfinite(v) for v in value
            ):
                return False
            getattr(request, name).extend(value)
        else:
            if type(value) not in types:
                return False
            if needs_finite and not math.isfinite(value):
                return False
            setattr(request, name, value)
    return True


def _fast_dump(message, table):
    """json_format.MessageToDict equivalent for scalar messages:
    ListFields yields only explicitly-set fields (and non-empty
    repeateds), matching protojson's omission of default values.
    Returns None — caller uses MessageToDict — when the message set a
    field the table can't represent."""
    out = {}
    for f, v in message.ListFields():
        entry = table.get(f.name)
        if entry is None:
            return None
        json_name, repeated, check_finite = entry
        if repeated:
            v = list(v)
            if check_finite and not all(math.isfinite(x) for x in v):
                return None
        elif check_finite and not math.isfinite(v):
            return None
        out[json_name] = v
    return out


class DynamicInvoker:
    """Generic unary + server-streaming invocation using dynamic messages
    (reflection.go:333-391 parity, plus streaming which the reference
    rejected). Flat all-scalar messages ride a descriptor-compiled
    transcoder (~2x less per-call Python than json_format — the Go
    reference gets compiled protojson for free); anything nested,
    repeated, mapped, 64-bit, bytes, or enum falls back to json_format
    for exact protojson semantics."""

    def __init__(self, channel: grpc.aio.Channel):
        self._channel = channel
        # Hot-path cache: building a multicallable and resolving message
        # classes per call costs more than the transcode itself (SURVEY
        # §3.3 hot loop). Keyed by (full name, descriptor identity) so a
        # rediscovery that rebuilds descriptors repopulates naturally.
        self._unary_cache: dict[tuple, tuple] = {}
        self._stream_cache: dict[tuple, tuple] = {}

    def invalidate_cache(self) -> None:
        """Drop cached message classes/multicallables. Called on
        rediscovery: a rebuilt descriptor pool would otherwise leave
        stale entries pinning the whole previous pool in memory."""
        self._unary_cache.clear()
        self._stream_cache.clear()

    def _message_classes(self, method: MethodInfo):
        if method.input_descriptor is None or method.output_descriptor is None:
            raise ValueError(f"method {method.full_name} missing descriptors")
        req_cls = message_factory.GetMessageClass(method.input_descriptor)
        resp_cls = message_factory.GetMessageClass(method.output_descriptor)
        return req_cls, resp_cls

    def _unary_entry(self, method: MethodInfo):
        key = (method.full_name, id(method.input_descriptor))
        entry = self._unary_cache.get(key)
        if entry is None:
            req_cls, resp_cls = self._message_classes(method)
            callable_ = self._channel.unary_unary(
                method.grpc_path,
                request_serializer=req_cls.SerializeToString,
                response_deserializer=resp_cls.FromString,
            )
            entry = (
                req_cls,
                callable_,
                _compile_parse_table(method.input_descriptor),
                _compile_dump_table(method.output_descriptor),
            )
            self._unary_cache[key] = entry
        return entry

    def _stream_entry(self, method: MethodInfo):
        key = (method.full_name, id(method.input_descriptor))
        entry = self._stream_cache.get(key)
        if entry is None:
            req_cls, resp_cls = self._message_classes(method)
            callable_ = self._channel.unary_stream(
                method.grpc_path,
                request_serializer=req_cls.SerializeToString,
                response_deserializer=resp_cls.FromString,
            )
            entry = (req_cls, callable_)
            self._stream_cache[key] = entry
        return entry

    async def invoke(
        self,
        method: MethodInfo,
        arguments: dict[str, Any],
        headers: Optional[list[tuple[str, str]]] = None,
        timeout_s: Optional[float] = None,
    ) -> dict[str, Any]:
        """Unary call: JSON dict in → JSON dict out."""
        req_cls, call, parse_table, dump_table = self._unary_entry(method)
        request = req_cls()
        if parse_table is None or not _fast_parse(request, arguments, parse_table):
            # protojson-equivalent parse; unknown fields are an error,
            # like the reference's protojson.Unmarshal
            # (reflection.go:351-359). Fresh message: a failed fast
            # parse may have part-populated the first one.
            request = req_cls()
            json_format.ParseDict(arguments, request)
        response = await call(
            request, metadata=headers or None, timeout=timeout_s
        )
        if dump_table is not None:
            out = _fast_dump(response, dump_table)
            if out is not None:
                return out
        return json_format.MessageToDict(
            response, preserving_proto_field_name=False
        )

    async def invoke_stream(
        self,
        method: MethodInfo,
        arguments: dict[str, Any],
        headers: Optional[list[tuple[str, str]]] = None,
        timeout_s: Optional[float] = None,
    ) -> AsyncIterator[dict[str, Any]]:
        """Server-streaming call: yields one JSON dict per message — the
        capability the reference lacked (discovery.go:353-356 rejected
        all streaming), feeding the MCP streaming path."""
        req_cls, stream_callable = self._stream_entry(method)
        request = req_cls()
        json_format.ParseDict(arguments, request)
        call = stream_callable(request, metadata=headers or None, timeout=timeout_s)
        async for response in call:
            yield json_format.MessageToDict(
                response, preserving_proto_field_name=False
            )
