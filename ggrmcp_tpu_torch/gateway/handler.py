"""The MCP protocol handler: JSON-RPC dispatch over HTTP.

Capability parity with the reference handler (pkg/server/handler.go):
GET / returns the initialize result; POST / decodes + validates JSON-RPC
and dispatches initialize / tools/list / tools/call / prompts/list /
resources/list; sessions ride the Mcp-Session-Id header and are echoed
back; backend failures surface as IsError tool results with sanitized
messages (handler.go:252-259); JSON-RPC errors are written with HTTP 200
(handler.go:311); /health 503s when no tools are registered.

Deliberately fixed vs the reference (SURVEY.md 'deliberately fix'):
error codes travel structurally with MCPError instead of substring
matching on error text (handler.go:118-125); session rate limits and
blocks are actually enforced; notifications (id-less requests) are
accepted per JSON-RPC instead of rejected; streaming tools are served
(aggregated for plain tools/call, incremental over SSE).
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
import time
from typing import Any, Optional

import grpc
from aiohttp import web
from google.protobuf import json_format

from ggrmcp_tpu_torch.core.config import Config
from ggrmcp_tpu_torch.core.headers import HeaderFilter
from ggrmcp_tpu_torch.core.sessions import SessionContext, SessionManager
from ggrmcp_tpu_torch.gateway.metrics import GatewayMetrics, tick_field_help
from ggrmcp_tpu_torch.serving.timeline import build_timeline
from ggrmcp_tpu_torch.mcp import types as mcp
from ggrmcp_tpu_torch.mcp.validation import Validator, sanitize_error
from ggrmcp_tpu_torch.rpc.discovery import (
    ServiceDiscoverer,
    StreamingNotSupportedError,
    ToolNotFoundError,
)
from ggrmcp_tpu_torch.schema.builder import ToolBuilder
from ggrmcp_tpu_torch.utils import tracing

logger = logging.getLogger("ggrmcp.gateway.handler")

SESSION_HEADER = "Mcp-Session-Id"
TRACE_RESPONSE_HEADER = "X-Trace-Id"

# What the gateway's Retry-After advertises when a call is shed with
# RESOURCE_EXHAUSTED and the backend's status details carry no explicit
# backoff. Backends with the SLO scheduler config encode a per-QoS-class
# "retry in Ns" hint in the details (serving/scheduler.py
# retry_after_for — background backs off geometrically longer than
# interactive), parsed by _RETRY_IN below; this flat fallback covers old
# backends and non-generate overloads.
OVERLOAD_RETRY_AFTER_S = 1
# Matches the sidecar's overload-detail suffix, e.g.
# "server overloaded (tokens): ...; retry in 4s".
_RETRY_IN = re.compile(r"retry in ([0-9]+(?:\.[0-9]+)?)s\b")


def _retry_after_from_details(details: str) -> float:
    """Per-class Retry-After from a RESOURCE_EXHAUSTED status detail
    string, falling back to the flat contract when absent."""
    m = _RETRY_IN.search(details or "")
    return float(m.group(1)) if m else OVERLOAD_RETRY_AFTER_S
# /health reports "degraded" while any backend shed within this window:
# a scrape between shed bursts must not flap back to "healthy" while
# the overload is plainly ongoing.
SHED_DEGRADED_WINDOW_S = 30.0


class SSETransport:
    """How `MCPHandler._stream_tool_call` writes an event stream,
    independent of the HTTP server implementation. `start` opens the
    stream (headers out), `event` writes one SSE event, `close` ends
    the stream. Implementations: `_AiohttpSSE` here, `_RawSSE` in
    gateway/fastlane.py."""

    async def start(self, session_id: str, trace_id: str) -> None:
        raise NotImplementedError

    async def event(self, event: str, data: Any) -> None:
        raise NotImplementedError

    async def close(self) -> None:
        raise NotImplementedError


class _AiohttpSSE(SSETransport):
    def __init__(self, request: web.Request):
        self._request = request
        self.response: Optional[web.StreamResponse] = None

    async def start(self, session_id: str, trace_id: str) -> None:
        self.response = web.StreamResponse(
            status=200,
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
                SESSION_HEADER: session_id,
                TRACE_RESPONSE_HEADER: trace_id,
            },
        )
        await self.response.prepare(self._request)

    async def event(self, event: str, data: Any) -> None:
        payload = json.dumps(data, ensure_ascii=False)
        await self.response.write(
            f"event: {event}\ndata: {payload}\n\n".encode()
        )

    async def close(self) -> None:
        await self.response.write_eof()


class MCPHandler:
    def __init__(
        self,
        cfg: Config,
        discoverer: ServiceDiscoverer,
        sessions: Optional[SessionManager] = None,
        metrics: Optional[GatewayMetrics] = None,
    ):
        self.cfg = cfg
        self.discoverer = discoverer
        self.sessions = sessions or SessionManager(cfg.session)
        self.metrics = metrics or GatewayMetrics()
        self.validator = Validator(cfg.mcp.validation)
        self.header_filter = HeaderFilter(cfg.grpc.header_forwarding)
        self.tool_builder = ToolBuilder(cfg.tools, discoverer.comment_fn)
        # Shed tracking for /health's "degraded" state: the last total
        # shed count seen across backends and when it last increased.
        self._shed_seen = 0.0
        self._shed_last_rise = float("-inf")
        # Fleet supervisor (serving/fleet.py), attached by the Gateway
        # when fleet.enabled (or by a bench/chaos harness). None =
        # static fleet; /admin/fleet then 404s and /stats omits the
        # fleet section.
        self.fleet = None

    # ------------------------------------------------------------------
    # HTTP entry points
    # ------------------------------------------------------------------

    async def handle_get(self, request: web.Request) -> web.Response:
        """GET / → capability discovery (handler.go:61-78)."""
        session = self._session_for(request)
        result = mcp.initialize_result(
            self.cfg.mcp.protocol_version,
            self.cfg.mcp.server_name,
            self.cfg.mcp.server_version,
        )
        response = web.json_response(mcp.make_response(None, result))
        response.headers[SESSION_HEADER] = session.id
        return response

    async def handle_post(self, request: web.Request) -> web.StreamResponse:
        """POST / → JSON-RPC dispatch (handler.go:81-157): the aiohttp
        wrapper over the transport-agnostic `dispatch` core (shared with
        the raw-protocol fast lane, gateway/fastlane.py)."""
        try:
            body = await request.read()
            data = json.loads(body)
        except (json.JSONDecodeError, UnicodeDecodeError) as exc:
            return web.json_response(
                mcp.make_error_response(
                    None, mcp.PARSE_ERROR, f"parse error: {exc}"
                )
            )

        # JSON-RPC notifications (no id) are accepted and acknowledged
        # with 202/no-content; MCP clients send notifications/initialized.
        if isinstance(data, dict) and "id" not in data:
            method = data.get("method", "")
            logger.debug("notification: %s", method)
            return web.Response(status=202)

        sse = (
            _AiohttpSSE(request) if self._wants_sse(request) else None
        )
        resp_dict, session, trace_id = await self.dispatch(
            data,
            lambda: self._session_for(request),
            trace_id_in=request.headers.get(tracing.TRACE_HEADER),
            sse=sse,
        )
        if resp_dict is None and sse is not None and sse.response is not None:
            return sse.response  # streamed; final event already written
        retry_after = mcp.overload_retry_after_s(resp_dict)
        if retry_after is not None:
            # Backend shed the call (bounded admission): HTTP 429 with
            # a Retry-After so well-behaved clients back off.
            response = web.json_response(
                resp_dict, status=429,
                headers={"Retry-After": str(max(1, int(retry_after)))},
            )
        else:
            response = web.json_response(resp_dict)
        if session is not None:
            response.headers[SESSION_HEADER] = session.id
        if trace_id is not None:
            response.headers[TRACE_RESPONSE_HEADER] = trace_id
        return response

    async def dispatch(
        self,
        data: Any,
        get_session: Any,
        trace_id_in: Optional[str] = None,
        sse: Optional["SSETransport"] = None,
    ) -> tuple[Optional[dict[str, Any]], Optional[SessionContext], Optional[str]]:
        """Transport-agnostic JSON-RPC dispatch.

        `data` is the decoded request (the caller handles parse errors
        and notifications — they need the raw body). `get_session` is
        called lazily so an invalid request never mints a session.
        Returns `(response_dict, session, trace_id)`; `response_dict`
        is None when the response was streamed through `sse`.
        """
        request_id = data.get("id") if isinstance(data, dict) else None
        try:
            self.validator.validate_request(data)
        except mcp.MCPError as exc:
            self.metrics.observe_rpc(
                data.get("method", "?") if isinstance(data, dict) else "?",
                "invalid",
            )
            return (
                mcp.make_error_response(
                    request_id, exc.code, exc.message, exc.data
                ),
                None,
                None,
            )

        session = get_session()
        method = data["method"]
        params = data.get("params")

        # Enforced session policy (the reference defined but never called
        # these — manager.go:178).
        if session.blocked:
            return (
                mcp.make_error_response(
                    request_id, mcp.INVALID_REQUEST, "session is blocked"
                ),
                session,
                None,
            )
        if not self.sessions.check_rate_limit(session):
            self.metrics.rate_limit_hit("session")
            return (
                mcp.make_error_response(
                    request_id, mcp.INVALID_REQUEST,
                    "session rate limit exceeded",
                ),
                session,
                None,
            )

        # One span per request; the incoming x-trace-id header (if any)
        # continues the caller's trace, and the id is echoed back.
        trace_id = trace_id_in or tracing.new_id()
        try:
            with tracing.tracer.span(
                f"gateway.{method}", trace_id=trace_id, session=session.id[:8]
            ):
                if method == "initialize":
                    result = self._handle_initialize()
                elif method == "ping":
                    result = {}
                elif method == "tools/list":
                    result = self._handle_tools_list()
                elif method == "tools/call":
                    if sse is not None:
                        await self._stream_tool_call(
                            request_id, session, params, sse, trace_id
                        )
                        return None, session, trace_id
                    result = await self._handle_tools_call(session, params)
                elif method == "prompts/list":
                    result = {"prompts": []}
                elif method == "resources/list":
                    result = {"resources": []}
                else:
                    raise mcp.MCPError(
                        mcp.METHOD_NOT_FOUND, f"method not found: {method}"
                    )
            self.metrics.observe_rpc(method, "ok")
            return mcp.make_response(request_id, result), session, trace_id
        except mcp.MCPError as exc:
            self.metrics.observe_rpc(method, "error")
            return (
                mcp.make_error_response(
                    request_id, exc.code, exc.message, exc.data
                ),
                session,
                trace_id,
            )
        except asyncio.CancelledError:
            raise  # a cancelled request must not become a JSON error
        except Exception as exc:  # unexpected → internal error, sanitized
            logger.exception("internal error handling %s", method)
            self.metrics.observe_rpc(method, "internal_error")
            return (
                mcp.make_error_response(
                    request_id, mcp.INTERNAL_ERROR, sanitize_error(str(exc))
                ),
                session,
                trace_id,
            )

    # ------------------------------------------------------------------
    # Method handlers
    # ------------------------------------------------------------------

    def _handle_initialize(self) -> dict[str, Any]:
        return mcp.initialize_result(
            self.cfg.mcp.protocol_version,
            self.cfg.mcp.server_name,
            self.cfg.mcp.server_version,
        )

    def _handle_tools_list(self) -> dict[str, Any]:
        methods = self.discoverer.get_methods()
        tools = self.tool_builder.build_tools(methods)
        return {"tools": [t.to_dict() for t in tools]}

    def _apply_structured_output(
        self, tool_name: str, arguments: Any
    ) -> Any:
        """Schema-constrained tool output (gateway.structured_output +
        ggrmcp_tpu/grammar): resolve which output schema — if any — the
        backend must enforce on this call's generated text, and inline
        it into the arguments as `constraint.jsonSchema`.

        Two triggers: the caller passed
        `constraint.toolOutputSchemaRef = <tool>` (per-call), or the
        operator opted the tool in via gateway.structured_output
        (tool name → "self"/"" for its own output schema, or another
        tool's name). The sidecar has no tool registry, so the ref is
        resolved HERE, where the schema builder lives. Only tools whose
        input message carries a `constraint` field (the TPU Generate
        surface) are eligible — anything else passes through untouched
        rather than failing proto transcoding."""
        if not isinstance(arguments, dict):
            return arguments
        constraint = arguments.get("constraint")
        ref = None
        if isinstance(constraint, dict):
            ref = constraint.get("toolOutputSchemaRef") or constraint.get(
                "tool_output_schema_ref"
            )
            if not ref:
                return arguments  # inline schema (or empty): pass through
        elif constraint is None:
            gateway_cfg = getattr(self.cfg, "gateway", None)
            configured = (
                gateway_cfg.structured_output.get(tool_name)
                if gateway_cfg is not None else None
            )
            if configured is None:
                return arguments
            ref = configured or "self"
        else:
            return arguments
        try:
            method = self.discoverer.get_method_by_tool(tool_name)
        except ToolNotFoundError:
            return arguments  # invoke will surface the real error
        desc = method.input_descriptor
        if desc is None or "constraint" not in desc.fields_by_name:
            if isinstance(constraint, dict):
                raise mcp.MCPError(
                    mcp.INVALID_PARAMS,
                    f"tool {tool_name} does not accept an output "
                    "constraint",
                )
            return arguments  # config opt-in on a non-generate tool: skip
        target = tool_name if ref == "self" else ref
        try:
            source = self.discoverer.get_method_by_tool(target)
        except ToolNotFoundError:
            raise mcp.MCPError(
                mcp.INVALID_PARAMS,
                f"structured_output: unknown schema source tool {target!r}",
            )
        schema = self.tool_builder.build_tool(source).output_schema
        if not schema:
            raise mcp.MCPError(
                mcp.INVALID_PARAMS,
                f"structured_output: tool {target!r} has no output schema",
            )
        new_constraint = {
            k: v for k, v in (constraint or {}).items()
            if k not in ("toolOutputSchemaRef", "tool_output_schema_ref")
        }
        new_constraint["jsonSchema"] = json.dumps(schema)
        return {**arguments, "constraint": new_constraint}

    def _apply_adapter_binding(
        self, tool_name: str, arguments: Any, session: SessionContext
    ) -> Any:
        """Multi-tenant adapter binding (gateway.tools.<name>.adapter +
        serving/adapter_arena.py, docs/multi_lora.md): resolve which
        LoRA adapter — if any — this call decodes under, and inject it
        as the `adapter` argument so one pod serves a thousand
        fine-tunes behind one tool list.

        Precedence, most explicit first: an `adapter` the caller
        already passed in the arguments is untouched; the session's
        forwarded `x-adapter-id` header overrides the operator's
        per-tool binding; the binding is the default. Only tools whose
        input message carries an `adapter` field (the TPU Generate
        surface) are eligible — anything else passes through untouched
        rather than failing proto transcoding. The injected value also
        feeds the router's adapter-affinity key (rpc/router.py), so an
        adapter's weights and pages stay co-resident on one replica."""
        if not isinstance(arguments, dict) or arguments.get("adapter"):
            return arguments
        override = ""
        for key, value in session.headers.items():
            if key.lower() == "x-adapter-id" and value:
                override = value[0] if isinstance(value, list) else value
                break
        gateway_cfg = getattr(self.cfg, "gateway", None)
        bound = (
            gateway_cfg.tools.get(tool_name, {}).get("adapter", "")
            if gateway_cfg is not None and isinstance(
                getattr(gateway_cfg, "tools", None), dict
            ) else ""
        )
        name = override or bound
        if not name:
            return arguments
        try:
            method = self.discoverer.get_method_by_tool(tool_name)
        except ToolNotFoundError:
            return arguments  # invoke will surface the real error
        desc = method.input_descriptor
        if desc is None or "adapter" not in desc.fields_by_name:
            return arguments  # binding on a non-generate tool: skip
        return {**arguments, "adapter": name}

    def _apply_tenant_binding(
        self, tool_name: str, arguments: Any, session: SessionContext
    ) -> Any:
        """SLO-plane identity (serving/slo.py, docs/observability.md):
        inject the session's forwarded `x-tenant-id` / `x-qos-class`
        headers as the `tenantId` / `qosClass` request fields so the
        backend attributes tokens and classifies latency without
        re-parsing metadata. Explicit arguments the caller passed win;
        only tools whose input message carries the fields (the TPU
        Generate surface) are eligible — anything else passes through
        untouched. The sidecar applies the same precedence a second
        time from raw metadata, so non-gateway gRPC callers get
        identical attribution."""
        if not isinstance(arguments, dict):
            return arguments
        wanted = {"x-tenant-id": "tenantId", "x-qos-class": "qosClass"}
        inject: dict[str, str] = {}
        for key, value in session.headers.items():
            arg = wanted.get(key.lower())
            if arg and value and not arguments.get(arg):
                inject[arg] = (
                    value[0] if isinstance(value, list) else value
                )
        if not inject:
            return arguments
        try:
            method = self.discoverer.get_method_by_tool(tool_name)
        except ToolNotFoundError:
            return arguments  # invoke will surface the real error
        desc = method.input_descriptor
        if desc is None or "tenant_id" not in desc.fields_by_name \
                or "qos_class" not in desc.fields_by_name:
            return arguments  # binding on a non-generate tool: skip
        return {**arguments, **inject}

    async def _handle_tools_call(
        self,
        session: SessionContext,
        params: Any,
    ) -> dict[str, Any]:
        tool_name, arguments = self.validator.validate_tool_call_params(params)
        arguments = self._apply_structured_output(tool_name, arguments)
        arguments = self._apply_adapter_binding(tool_name, arguments, session)
        arguments = self._apply_tenant_binding(tool_name, arguments, session)
        headers = self._metadata_with_trace(session)
        start = time.perf_counter()
        try:
            method = self.discoverer.get_method_by_tool(tool_name)
            timeout = self.cfg.server.request_timeout_s
            if method.is_server_streaming:
                # Aggregate the stream for plain tools/call clients.
                chunks = []
                async for chunk in self.discoverer.invoke_stream_by_tool(
                    tool_name, arguments, headers, timeout
                ):
                    chunks.append(chunk)
                content = [
                    mcp.text_content(json.dumps(c, ensure_ascii=False))
                    for c in chunks
                ]
                result = mcp.tool_call_result(content)
            else:
                payload = await self.discoverer.invoke_by_tool(
                    tool_name, arguments, headers, timeout
                )
                result = mcp.tool_call_result(
                    [mcp.text_content(json.dumps(payload, ensure_ascii=False))]
                )
        except ToolNotFoundError:
            raise mcp.MCPError(
                mcp.METHOD_NOT_FOUND, f"tool not found: {tool_name}"
            )
        except StreamingNotSupportedError as exc:
            raise mcp.MCPError(mcp.INVALID_PARAMS, str(exc))
        except (json.JSONDecodeError, ValueError, json_format.ParseError) as exc:
            # Argument→proto transcoding failure = caller error.
            raise mcp.MCPError(
                mcp.INVALID_PARAMS, sanitize_error(f"invalid arguments: {exc}")
            )
        except (grpc.RpcError, grpc.aio.UsageError) as exc:
            if (
                isinstance(exc, grpc.aio.AioRpcError)
                and exc.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
            ):
                # The backend SHED this call (bounded admission full) —
                # overload, not failure. Surface it as a typed JSON-RPC
                # error the HTTP transports turn into 429 + Retry-After
                # so clients back off instead of hammering an IsError
                # result loop.
                self.metrics.observe_tool_call(
                    tool_name, "overloaded", time.perf_counter() - start
                )
                session.increment_calls()
                raise mcp.MCPError(
                    mcp.OVERLOADED,
                    sanitize_error(f"backend overloaded: {exc.details()}"),
                    data={"retryAfterS": _retry_after_from_details(
                        exc.details()
                    )},
                )
            # Backend failure → IsError result, NOT a protocol error
            # (handler.go:252-259 behavior, carried over). UsageError
            # covers invoking over a channel the reconnect watchdog
            # closed between routing and the call.
            self.metrics.observe_tool_call(
                tool_name, "backend_error", time.perf_counter() - start
            )
            if isinstance(exc, grpc.aio.AioRpcError):
                message = f"gRPC call failed ({exc.code().name}): {exc.details()}"
            else:
                message = f"gRPC call failed: {exc}"
            session.increment_calls()
            return mcp.tool_call_error(sanitize_error(message))
        except (ConnectionError, asyncio.TimeoutError) as exc:
            self.metrics.observe_tool_call(
                tool_name, "unavailable", time.perf_counter() - start
            )
            session.increment_calls()
            return mcp.tool_call_error(sanitize_error(str(exc)))

        session.increment_calls()
        self.metrics.observe_tool_call(
            tool_name, "ok", time.perf_counter() - start
        )
        return result

    # ------------------------------------------------------------------
    # Streaming over SSE (no reference analogue — new capability)
    # ------------------------------------------------------------------

    def _wants_sse(self, request: web.Request) -> bool:
        accept = request.headers.get("Accept", "")
        return "text/event-stream" in accept

    async def _stream_tool_call(
        self,
        request_id: Any,
        session: SessionContext,
        params: Any,
        sse: "SSETransport",
        trace_id: str,
    ) -> None:
        """Stream tool output incrementally as SSE events; the final
        event carries the complete JSON-RPC response. Transport-agnostic:
        `sse` opens the stream and writes events (aiohttp StreamResponse
        or the fast lane's raw socket writer)."""
        tool_name, arguments = self.validator.validate_tool_call_params(params)
        arguments = self._apply_structured_output(tool_name, arguments)
        arguments = self._apply_adapter_binding(tool_name, arguments, session)
        arguments = self._apply_tenant_binding(tool_name, arguments, session)
        headers = self._metadata_with_trace(session)
        await sse.start(session.id, trace_id)
        start = time.perf_counter()
        chunks: list[dict[str, Any]] = []
        outcome = "ok"
        try:
            async for chunk in self.discoverer.invoke_stream_by_tool(
                tool_name, arguments, headers, self.cfg.server.request_timeout_s
            ):
                chunks.append(chunk)
                await sse.event(
                    "chunk",
                    {"content": mcp.text_content(json.dumps(chunk, ensure_ascii=False))},
                )
            content = [
                mcp.text_content(json.dumps(c, ensure_ascii=False)) for c in chunks
            ]
            final = mcp.make_response(request_id, mcp.tool_call_result(content))
        except ToolNotFoundError:
            outcome = "not_found"
            final = mcp.make_error_response(
                request_id, mcp.METHOD_NOT_FOUND, f"tool not found: {tool_name}"
            )
        except (ConnectionResetError, ConnectionAbortedError):
            # The SSE *client* went away mid-stream (a write inside the
            # try raised) — not a backend failure; nothing left to write.
            session.increment_calls()
            self.metrics.observe_tool_call(
                tool_name, "client_disconnect", time.perf_counter() - start
            )
            return
        except ConnectionError as exc:
            # Same outcome label as the unary path, so per-outcome
            # dashboards agree across transports.
            outcome = "unavailable"
            final = mcp.make_response(
                request_id,
                mcp.tool_call_error(sanitize_error(f"backend unavailable: {exc}")),
            )
        except (grpc.RpcError, grpc.aio.UsageError) as exc:
            outcome = "backend_error"
            if isinstance(exc, grpc.aio.AioRpcError):
                message = f"gRPC call failed ({exc.code().name}): {exc.details()}"
            else:
                message = f"gRPC call failed: {exc}"
            final = mcp.make_response(
                request_id, mcp.tool_call_error(sanitize_error(message))
            )
        except asyncio.CancelledError:
            raise  # client went away mid-stream; don't fabricate a chunk
        except Exception as exc:
            outcome = "internal_error"
            final = mcp.make_error_response(
                request_id, mcp.INTERNAL_ERROR, sanitize_error(str(exc))
            )
        session.increment_calls()
        self.metrics.observe_tool_call(
            tool_name, outcome, time.perf_counter() - start
        )
        try:
            await sse.event("result", final)
            await sse.close()
        except (ConnectionResetError, ConnectionAbortedError):
            pass  # client vanished before the final event

    # ------------------------------------------------------------------
    # Health / metrics / stats endpoints
    # ------------------------------------------------------------------

    def _sustained_shed(self, serving_stats: list[dict[str, Any]]) -> bool:
        """True while any backend shed (RESOURCE_EXHAUSTED / 429)
        within SHED_DEGRADED_WINDOW_S. Tracks the cross-backend total
        of the shed_requests counter; protojson renders int64 as
        strings, hence float()."""
        total = 0.0
        for entry in serving_stats:
            if "error" not in entry:
                try:
                    total += float(entry.get("shedRequests", 0))
                except (TypeError, ValueError):
                    pass
        now = time.monotonic()
        if total > self._shed_seen:
            self._shed_seen = total
            self._shed_last_rise = now
        return now - self._shed_last_rise < SHED_DEGRADED_WINDOW_S

    async def health_body(self) -> tuple[dict[str, Any], int]:
        """GET /health core (handler.go:331-364): deep backend check +
        tool count; 503 when unhealthy. A healthy stack that is
        actively SHEDDING (bounded admission refusing work) reports
        "degraded" at HTTP 200 — still serving, but load balancers and
        dashboards see the overload before clients collapse into
        retry storms. Framework-free — shared by the aiohttp handler
        and the fast lane."""
        try:
            healthy = await asyncio.wait_for(
                self.discoverer.health_check(), timeout=5.0
            )
        except asyncio.TimeoutError:
            healthy = False
        stats = self.discoverer.get_service_stats()
        shedding = self._sustained_shed(
            await self.discoverer.get_serving_stats_snapshot()
        )
        if not (healthy and stats["methodCount"] > 0):
            status = "unhealthy"
        elif shedding:
            status = "degraded"
        else:
            status = "healthy"
        body = {
            "status": status,
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "serviceCount": stats["serviceCount"],
            "methodCount": stats["methodCount"],
            "sessions": self.sessions.count(),
            "shedding": shedding,
        }
        return body, 503 if status == "unhealthy" else 200

    async def handle_health(self, request: web.Request) -> web.Response:
        body, status = await self.health_body()
        return web.json_response(body, status=status)

    async def metrics_body(self) -> tuple[bytes, str]:
        """GET /metrics core: Prometheus text exposition (replacing the
        reference's JSON stub)."""
        stats = self.discoverer.get_service_stats()
        healthy_backends = sum(1 for b in stats["backends"] if b["healthy"])
        self.metrics.set_gauges(self.sessions.count(), healthy_backends)
        # Snapshot, not live fan-out: a wedged sidecar must not add its
        # gRPC timeout to every Prometheus scrape.
        self.metrics.set_serving_stats(
            await self.discoverer.get_serving_stats_snapshot()
        )
        self.metrics.set_routing_stats(self.discoverer.get_routing_stats())
        if self.fleet is not None:
            self.metrics.set_fleet_stats(self.fleet.snapshot())
        payload, content_type = self.metrics.render()
        return payload, content_type.split(";")[0]

    async def handle_metrics(self, request: web.Request) -> web.Response:
        payload, content_type = await self.metrics_body()
        return web.Response(body=payload, content_type=content_type)

    async def stats_body(self) -> dict[str, Any]:
        """GET /stats core: the reference's JSON stats dump, kept for
        parity (handler.go:367-376)."""
        stats = self.discoverer.get_service_stats()
        stats["sessions"] = self.sessions.stats()
        stats["routing"] = self.discoverer.get_routing_stats()
        if self.fleet is not None:
            stats["fleet"] = self.fleet.snapshot()
        serving = await self.discoverer.get_backend_serving_stats()
        if serving:
            stats["serving"] = serving
        return stats

    async def handle_stats(self, request: web.Request) -> web.Response:
        return web.json_response(await self.stats_body())

    # ------------------------------------------------------------------
    # Admin: graceful drain (docs/routing.md runbook)
    # ------------------------------------------------------------------

    def admin_drain_body(
        self, backend: str, drain: bool
    ) -> tuple[dict[str, Any], int]:
        """POST /admin/drain | /admin/undrain core (?backend=<target>):
        flip a backend's drain state. Draining stops NEW placements
        only — in-flight calls finish, health stays monitored,
        rediscovery keeps the tools resolvable via the remaining
        replicas; un-drain restores the candidate set. Framework-free,
        shared by both HTTP impls."""
        if not backend:
            return {
                "error": "missing ?backend=<target> query parameter",
                "backends": [
                    b["target"]
                    for b in self.discoverer.get_service_stats()["backends"]
                ],
            }, 400
        try:
            state = self.discoverer.set_draining(backend, drain)
        except KeyError:
            return {
                "error": f"unknown backend: {backend}",
                "backends": [
                    b["target"]
                    for b in self.discoverer.get_service_stats()["backends"]
                ],
            }, 404
        return {
            "backend": backend,
            "draining": drain,
            "backends": state,
        }, 200

    async def handle_admin_drain(self, request: web.Request) -> web.Response:
        body, status = self.admin_drain_body(
            request.query.get("backend", ""), drain=True
        )
        return web.json_response(body, status=status)

    async def handle_admin_undrain(
        self, request: web.Request
    ) -> web.Response:
        body, status = self.admin_drain_body(
            request.query.get("backend", ""), drain=False
        )
        return web.json_response(body, status=status)

    def admin_fleet_body(self, action: str) -> tuple[dict[str, Any], int]:
        """POST /admin/fleet?action=pause|resume|status core: gate the
        fleet supervisor's whole decide loop (docs/fleet.md runbook —
        pause before manual surgery, resume after; status is the same
        snapshot /stats carries). 404 when no supervisor is attached
        (fleet.enabled=false), 400 on an unknown action. Framework-
        free, shared by both HTTP impls."""
        if self.fleet is None:
            return {
                "error": "no fleet supervisor attached "
                         "(fleet.enabled=false)",
            }, 404
        if action == "pause":
            self.fleet.pause()
        elif action == "resume":
            self.fleet.resume()
        elif action not in ("", "status"):
            return {
                "error": f"unknown action: {action}",
                "actions": ["pause", "resume", "status"],
            }, 400
        return {"fleet": self.fleet.snapshot()}, 200

    async def handle_admin_fleet(self, request: web.Request) -> web.Response:
        body, status = self.admin_fleet_body(
            request.query.get("action", "status")
        )
        return web.json_response(body, status=status)

    def traces_body(self, n_raw: str) -> dict[str, Any]:
        """GET /debug/traces core: recent per-call spans, newest first
        (SURVEY.md §5.1 — the reference had durations in logs only)."""
        try:
            n = int(n_raw)
        except ValueError:
            n = 100
        return {"spans": tracing.tracer.recent(max(1, min(n, 512)))}

    async def handle_traces(self, request: web.Request) -> web.Response:
        return web.json_response(
            self.traces_body(request.query.get("n", "100"))
        )

    async def debug_flight_body(
        self, kind: str, trace_id: str, n_raw: str, source: str = "",
        tenant: str = "",
    ) -> dict[str, Any]:
        """GET /debug/ticks | /debug/requests core: the backends'
        flight-recorder rings (DebugService.GetFlightRecord fan-out),
        filterable by the trace id a tool call echoed in X-Trace-Id —
        the span → request record → tick records walk — and by the
        originating batcher's `source` label ("" flat pool,
        "tier-<max_seq>", "spec"). `kind` is "ticks" or "requests";
        framework-free, shared by the aiohttp handler and the fast
        lane. The ticks body carries a `fields` help table
        (metrics.tick_field_help — the proto-drift-enforced descriptor
        set) so the record keys are self-describing. `tenant` filters
        request records to one tenant's lifecycle (server-side, like
        trace_id — the SLO plane's drill-down from an aggregate
        /debug/slo row to the individual requests behind it)."""
        try:
            n = int(n_raw)
        except ValueError:
            n = 128
        n = max(1, min(n, 2048))
        entries = await self.discoverer.get_backend_flight_records(
            trace_id=trace_id,
            max_ticks=n if kind == "ticks" else 1,
            max_requests=n if kind == "requests" else 1,
            tenant=tenant if kind == "requests" else "",
        )
        backends = []
        for entry in entries:
            if "error" in entry:
                backends.append(
                    {"target": entry["target"], "error": entry["error"]}
                )
            else:
                # protojson omits empty repeated fields AND zero/empty
                # scalars — a flat-pool record carries no "source" key
                # at all, hence the .get default in the filter.
                records = entry.get(kind, [])
                if source:
                    records = [
                        r for r in records
                        if r.get("source", "") == source
                    ]
                backends.append({
                    "target": entry["target"],
                    "enabled": entry.get("enabled", False),
                    kind: records,
                })
        body: dict[str, Any] = {"backends": backends}
        if trace_id:
            body["traceId"] = trace_id
        if source:
            body["source"] = source
        if tenant and kind == "requests":
            body["tenant"] = tenant
        if kind == "ticks":
            body["fields"] = tick_field_help()
        else:
            # /debug/requests answers "why did THIS call go THERE":
            # the router's policy + per-backend placement counters ride
            # alongside the lifecycle records (docs/routing.md), and —
            # with a fleet supervisor attached — the typed action log
            # answers "why did the POOL change" (docs/fleet.md).
            body["routing"] = self.discoverer.get_routing_stats()
            if self.fleet is not None:
                body["fleet"] = self.fleet.snapshot()
        return body

    async def handle_debug_ticks(self, request: web.Request) -> web.Response:
        return web.json_response(await self.debug_flight_body(
            "ticks",
            request.query.get("trace_id", ""),
            request.query.get("n", "128"),
            request.query.get("source", ""),
        ))

    async def handle_debug_requests(
        self, request: web.Request
    ) -> web.Response:
        return web.json_response(await self.debug_flight_body(
            "requests",
            request.query.get("trace_id", ""),
            request.query.get("n", "128"),
            request.query.get("source", ""),
            request.query.get("tenant", ""),
        ))

    async def debug_slo_body(self) -> dict[str, Any]:
        """GET /debug/slo core: the SLO accounting plane's full
        surface, per backend (serving/slo.py) — the per-class goodput
        partition, latency histograms and burn rates that /metrics
        exports, PLUS the per-tenant attribution table that /metrics
        deliberately does NOT (tenant is an unbounded label; here it is
        a bounded JSON list with an explicit ~overflow row). Fans out
        the same ServingStats RPC as /stats and filters it to the SLO
        fragments; framework-free, shared by both HTTP impls."""
        entries = await self.discoverer.get_backend_serving_stats()
        backends = []
        for entry in entries:
            if "error" in entry:
                backends.append(
                    {"target": entry["target"], "error": entry["error"]}
                )
                continue
            backends.append({
                "target": entry["target"],
                # protojson omits empty repeateds and zero scalars:
                # restore them so the body shape is stable whether or
                # not traffic (or the SLO plane itself) has happened.
                "classes": entry.get("sloClasses", []),
                "tenants": entry.get("tenants", []),
                "metTotal": int(float(entry.get("sloMetTotal", 0))),
                "violatedTotal": int(
                    float(entry.get("sloViolatedTotal", 0))
                ),
                "unevaluatedTotal": int(
                    float(entry.get("sloUnevaluatedTotal", 0))
                ),
                "tenantsTracked": int(
                    float(entry.get("sloTenantsTracked", 0))
                ),
                "tenantEvictions": int(
                    float(entry.get("sloTenantEvictions", 0))
                ),
            })
        return {"backends": backends}

    async def handle_debug_slo(self, request: web.Request) -> web.Response:
        return web.json_response(await self.debug_slo_body())

    async def timeline_body(self, n_raw: str) -> dict[str, Any]:
        """GET /debug/timeline core: the unified Chrome trace-event
        document (serving/timeline.py) — gateway spans plus every
        backend's tick and request rings, phase attribution nested
        inside each tick slice, lifecycle events as instants. Save the
        JSON to a file and open it in Perfetto (ui.perfetto.dev) or
        chrome://tracing. Framework-free, shared by both HTTP impls."""
        try:
            n = int(n_raw)
        except ValueError:
            n = 512
        n = max(1, min(n, 2048))
        entries = await self.discoverer.get_backend_flight_records(
            max_ticks=n, max_requests=n
        )
        return build_timeline(
            tracing.tracer.recent(min(n, 512)), entries
        )

    async def handle_debug_timeline(
        self, request: web.Request
    ) -> web.Response:
        return web.json_response(
            await self.timeline_body(request.query.get("n", "512"))
        )

    async def debug_memory_body(self, reconcile_raw: str) -> dict[str, Any]:
        """GET /debug/memory core: the device-memory ledger fan-out
        (DebugService.GetMemory) — per-backend component bytes, the
        closure reconciliation against JAX live-buffer totals
        (?reconcile=0 skips the live-array census), and the compile
        watcher's counters + recent-compile ring. The byte complement
        of /debug/ticks' time attribution; framework-free, shared by
        both HTTP impls (docs/observability.md)."""
        reconcile = reconcile_raw not in ("0", "false", "off")
        entries = await self.discoverer.get_backend_memory(
            reconcile=reconcile
        )
        return {"reconcile": reconcile, "backends": entries}

    async def handle_debug_memory(
        self, request: web.Request
    ) -> web.Response:
        return web.json_response(await self.debug_memory_body(
            request.query.get("reconcile", "1")
        ))

    async def debug_profile_body(
        self, duration_raw: str, label: str
    ) -> dict[str, Any]:
        """POST /debug/profile core: fan the sidecar DebugService
        profiler capture out to every backend and return the
        per-backend server-side artifact paths — the "minimal capture
        FIRST" TPU-window preflight as one gateway command
        (docs/observability.md). ?duration_ms= bounds the window
        (sidecar clamps to [10, 60000]); ?label= names the dump
        (sanitized server-side, never a path)."""
        try:
            duration_ms = int(duration_raw)
        except ValueError:
            duration_ms = 1000
        entries = await self.discoverer.profile_backends(
            duration_ms=duration_ms, label=label
        )
        return {"durationMs": duration_ms, "backends": entries}

    async def handle_debug_profile(
        self, request: web.Request
    ) -> web.Response:
        body = await self.debug_profile_body(
            request.query.get("duration_ms", "1000"),
            request.query.get("label", ""),
        )
        return web.json_response(body)

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _metadata_with_trace(self, session: SessionContext) -> list[tuple[str, str]]:
        """Forwarded session headers + the current trace id as
        x-trace-id metadata (the gateway's own id wins over any stale
        client-supplied header so one id stitches the whole call)."""
        headers = self.header_filter.to_grpc_metadata(session.headers)
        trace_id = tracing.tracer.current_trace_id()
        if trace_id:
            headers = [
                (k, v) for k, v in headers if k != tracing.TRACE_HEADER
            ] + [(tracing.TRACE_HEADER, trace_id)]
        return headers

    def _session_for(self, request: web.Request) -> SessionContext:
        """Resolve/mint the session from Mcp-Session-Id. Headers are
        snapshotted once at session creation (manager.go:69-84 parity);
        ALL values of multi-valued headers are captured (multi-value
        fix). Resolving an existing session skips the capture entirely —
        it is pure per-request overhead on the hot path."""
        sid = request.headers.get(SESSION_HEADER, "")
        if sid:
            sess = self.sessions.get_live(sid)
            if sess is not None:
                return sess
        raw_headers: dict[str, Any] = {}
        for key in set(request.headers.keys()):
            values = request.headers.getall(key)
            raw_headers[key] = values[0] if len(values) == 1 else list(values)
        return self.sessions.get_or_create(sid, raw_headers)

