"""Raw asyncio.Protocol HTTP/1.1 server for the gateway hot path.

Why this exists: the gateway's throughput ceiling on one core is
Python-per-request cost. Profiling the aiohttp stack under load puts
~60% of gateway CPU in framework machinery (web_protocol request
lifecycle, StreamResponse header objects, middleware dispatch) rather
than in our dispatch, validation, or the gRPC invoke. The Go reference
serves its hot path from net/http with near-zero per-request framework
cost (pkg/server/handler.go); this module is the Python equivalent: a
single protocol class that parses HTTP/1.1 with byte ops, runs the SAME
`MCPHandler.dispatch` core and gate semantics as the fused middleware
(gateway/middleware.py::fused_middleware), and writes responses as one
precomputed-header `bytes` + body per call.

Served surface is identical to the aiohttp app (gateway/app.py routes):
GET/POST/OPTIONS /, /health, /metrics, /stats, /debug/traces,
/debug/ticks, /debug/requests, /debug/timeline, /debug/memory,
POST /debug/profile, SSE streaming on tools/call.
`server.http_impl` selects the implementation;
both are driven by the same test suite (tests/test_fastlane.py runs the
gateway protocol tests against this server).

Deliberate scope bounds (each answered with a correct HTTP status, not
a hang): request bodies must carry Content-Length (chunked uploads →
411; no MCP client streams its JSON-RPC request), and Expect:
100-continue is acknowledged.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Any, Optional
from urllib.parse import parse_qs, urlsplit

from ggrmcp_tpu_torch.core.config import Config
from ggrmcp_tpu_torch.gateway.handler import MCPHandler, SSETransport
from ggrmcp_tpu_torch.gateway.middleware import _KNOWN_PATHS, TokenBucket
from ggrmcp_tpu_torch.mcp import types as mcp
from ggrmcp_tpu_torch.utils import tracing
from ggrmcp_tpu_torch.utils.aio_compat import timeout as aio_timeout

logger = logging.getLogger("ggrmcp.gateway.http")

_REASONS = {
    200: "OK", 202: "Accepted", 204: "No Content", 400: "Bad Request",
    404: "Not Found", 405: "Method Not Allowed", 408: "Request Timeout",
    411: "Length Required", 413: "Payload Too Large",
    415: "Unsupported Media Type", 429: "Too Many Requests",
    431: "Request Header Fields Too Large", 500: "Internal Server Error",
    503: "Service Unavailable", 504: "Gateway Timeout",
}

_MAX_HEADER_BYTES = 32 * 1024


class _RawSSE(SSETransport):
    """SSE over the raw transport: headers + `event:`/`data:` frames
    written directly. Close-delimited (`Connection: close`) — SSE
    streams are one-per-connection, so chunked framing buys nothing."""

    def __init__(self, conn: "FastLaneProtocol", const_headers: bytes):
        self._conn = conn
        self._const = const_headers
        self.started = False

    async def start(self, session_id: str, trace_id: str) -> None:
        head = (
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
            b"Connection: close\r\n"
            + self._const
            + b"Mcp-Session-Id: " + session_id.encode() + b"\r\n"
            b"X-Trace-Id: " + trace_id.encode() + b"\r\n\r\n"
        )
        self._conn.write_raw(head)
        self.started = True
        # Once stream headers are out, no error/timeout path may write
        # an HTTP status onto this connection (FastLaneServer.handle).
        self._conn.sse_started = True

    async def event(self, event: str, data: Any) -> None:
        payload = json.dumps(data, ensure_ascii=False)
        self._conn.write_raw(
            f"event: {event}\ndata: {payload}\n\n".encode()
        )
        await self._conn.drain()

    async def close(self) -> None:
        self._conn.close_after_write()


class FastLaneProtocol(asyncio.Protocol):
    """One instance per connection; keep-alive with sequential
    request handling (requests on one connection are processed in
    order, matching aiohttp's behavior)."""

    __slots__ = (
        "server", "transport", "buf", "task", "queue", "closing",
        "last_activity", "pending", "busy", "sse_started",
        "_paused", "_reading_paused", "_drain_waiter",
    )

    # Pipelined requests queued beyond this pause the transport's reads
    # until the serve loop catches up — a client blasting requests
    # without reading responses must not grow the queue unboundedly.
    MAX_QUEUED = 8

    def __init__(self, server: "FastLaneServer"):
        self.server = server
        self.transport: Optional[asyncio.Transport] = None
        self.buf = b""
        self.task: Optional[asyncio.Task] = None
        self.queue: asyncio.Queue = asyncio.Queue()
        self.closing = False
        self.last_activity = time.monotonic()
        # Parsed head of a request whose body hasn't fully arrived:
        # (method, target, version, headers, pairs, body_len). The head
        # is parsed (and any 100-continue sent) exactly once.
        self.pending: Optional[tuple] = None
        self.busy = False  # a request is being handled right now
        self.sse_started = False  # current request opened an SSE stream
        self._paused = False
        self._reading_paused = False
        self._drain_waiter: Optional[asyncio.Future] = None

    # -- transport events ------------------------------------------------

    def connection_made(self, transport: asyncio.BaseTransport) -> None:
        self.transport = transport  # type: ignore[assignment]
        self.server.connections.add(self)

    def connection_lost(self, exc: Optional[Exception]) -> None:
        self.closing = True
        self.server.connections.discard(self)
        if self.task is not None:
            self.task.cancel()
        if self._drain_waiter is not None and not self._drain_waiter.done():
            self._drain_waiter.set_result(None)

    def pause_writing(self) -> None:
        self._paused = True

    def resume_writing(self) -> None:
        self._paused = False
        if self._drain_waiter is not None and not self._drain_waiter.done():
            self._drain_waiter.set_result(None)

    def data_received(self, data: bytes) -> None:
        self.last_activity = time.monotonic()
        self.buf += data
        self._pump()

    def eof_received(self) -> bool:
        return False  # close when the peer half-closes

    # -- request framing -------------------------------------------------

    def _pump(self) -> None:
        """Frame complete requests out of the buffer; queue them for
        the serving task (started lazily on the first request). Each
        head is parsed exactly once — an incomplete body parks the
        parsed head in `pending` until the rest arrives."""
        while True:
            if self.pending is None:
                end = self.buf.find(b"\r\n\r\n")
                if end < 0:
                    if len(self.buf) > _MAX_HEADER_BYTES:
                        self._simple_response(431, close=True)
                    return
                head = self.buf[:end]
                self.buf = self.buf[end + 4:]
                try:
                    method, target, version, headers, pairs = _parse_head(head)
                except ValueError:
                    self._simple_response(400, close=True)
                    return
                path = target.partition("?")[0]
                mpath = path if path in _KNOWN_PATHS else "other"
                te = headers.get("transfer-encoding")
                if te and "chunked" in te:
                    self._simple_response(411, close=True, method=method, path=mpath)
                    return
                length_raw = headers.get("content-length")
                try:
                    length = int(length_raw) if length_raw is not None else 0
                except ValueError:
                    self._simple_response(400, close=True, method=method, path=mpath)
                    return
                # Oversize requests are rejected up front without
                # buffering the body (fused 413 gate, pre-read here).
                if length > self.server.max_request_bytes:
                    self._simple_response(413, close=True, method=method, path=mpath)
                    return
                if headers.get("expect", "").lower() == "100-continue":
                    self.write_raw(b"HTTP/1.1 100 Continue\r\n\r\n")
                self.pending = (method, target, version, headers, pairs, length)
            length = self.pending[5]
            if len(self.buf) < length:
                return  # body incomplete; wait for more data
            body = self.buf[:length]
            self.buf = self.buf[length:]
            self.queue.put_nowait(self.pending[:5] + (body,))
            self.pending = None
            if (
                self.queue.qsize() >= self.MAX_QUEUED
                and not self._reading_paused
                and self.transport is not None
            ):
                self.transport.pause_reading()
                self._reading_paused = True
            if self.task is None:
                self.task = asyncio.ensure_future(self._serve_loop())

    async def _serve_loop(self) -> None:
        try:
            while not self.closing:
                req = await self.queue.get()
                self.busy = True
                try:
                    await self.server.handle(self, *req)
                finally:
                    self.busy = False
                    self.last_activity = time.monotonic()
                if (
                    self._reading_paused
                    and self.queue.qsize() < self.MAX_QUEUED // 2
                    and self.transport is not None
                    and not self.transport.is_closing()
                ):
                    self.transport.resume_reading()
                    self._reading_paused = False
        except asyncio.CancelledError:
            pass
        except Exception:
            logger.exception("fastlane connection loop failed")
            self._simple_response(500, close=True)

    # -- writing ---------------------------------------------------------

    def write_raw(self, data: bytes) -> None:
        if self.transport is not None and not self.transport.is_closing():
            self.transport.write(data)
        else:
            raise ConnectionResetError("client disconnected")

    async def drain(self) -> None:
        if self.closing:
            raise ConnectionResetError("client disconnected")
        if self._paused:
            self._drain_waiter = asyncio.get_running_loop().create_future()
            await self._drain_waiter
            self._drain_waiter = None

    def close_after_write(self) -> None:
        self.closing = True
        if self.transport is not None and not self.transport.is_closing():
            self.transport.close()

    def _simple_response(
        self,
        status: int,
        close: bool = False,
        method: str = "?",
        path: str = "other",
    ) -> None:
        """Protocol-level reject (400/411/413/431/500). Carries the
        constant security headers and is counted/logged like any other
        response — a flood of malformed requests must be visible on
        dashboards. (CORS echo is skipped: the head may be unparsable.)"""
        try:
            self.write_raw(
                b"HTTP/1.1 %d %s\r\n" % (status, _REASONS[status].encode())
                + self.server._const
                + b"Content-Length: 0\r\n%s\r\n"
                % (b"Connection: close\r\n" if close else b"")
            )
        except ConnectionResetError:
            return
        finally:
            if logger.isEnabledFor(logging.INFO):
                logger.info("%s %s -> %d (reject)", method, path, status)
            self.server.metrics.observe_http(method, path, status, 0.0)
        if close:
            self.close_after_write()


def _parse_head(
    head: bytes,
) -> tuple[str, str, str, dict[str, str], list[tuple[str, str]]]:
    """Parse request line + headers. Returns (method, target, version,
    headers-lowercased-last-wins, all-pairs-in-order). `pairs` keeps
    every value for multi-valued headers AND the sender's original key
    casing — session minting snapshots them all (core/sessions.py
    multi-value fix), and the snapshot must fingerprint identically to
    the aiohttp backend's, which preserves case."""
    lines = head.split(b"\r\n")
    try:
        method_b, target_b, version_b = lines[0].split(b" ", 2)
    except ValueError:
        raise ValueError("bad request line")
    headers: dict[str, str] = {}
    pairs: list[tuple[str, str]] = []
    for line in lines[1:]:
        if not line:
            continue
        key_b, sep, val_b = line.partition(b":")
        if not sep:
            raise ValueError("bad header line")
        key_orig = key_b.decode("latin-1").strip()
        key = key_orig.lower()
        val = val_b.decode("latin-1").strip()
        if key in headers:
            # repeated headers combine per RFC 9110 for our dict view;
            # pairs keeps the originals
            headers[key] = headers[key] + ", " + val
        else:
            headers[key] = val
        pairs.append((key_orig, val))
    return (
        method_b.decode("latin-1"),
        target_b.decode("latin-1"),
        version_b.decode("latin-1"),
        headers,
        pairs,
    )


class FastLaneServer:
    """The gateway's HTTP server as precomputed-bytes responses over
    FastLaneProtocol connections. Mirrors fused_middleware's gate order
    exactly: OPTIONS preflight → global rate limit → content-type →
    size → timeout → recovery, with security/CORS headers, the
    request log line, and observe_http on every response."""

    def __init__(self, cfg: Config, handler: MCPHandler):
        self.cfg = cfg
        self.handler = handler
        self.metrics = handler.metrics
        self.sessions = handler.sessions
        server = cfg.server
        self.max_request_bytes = server.max_request_bytes
        self.request_timeout_s = server.request_timeout_s
        self.idle_timeout_s = server.idle_timeout_s
        self.bucket = TokenBucket(
            server.rate_limit.requests_per_second, server.rate_limit.burst
        )
        self.rate_limit_enabled = server.rate_limit.enabled
        self.allowed_ctypes = tuple(server.allowed_content_types)
        self.connections: set[FastLaneProtocol] = set()
        self._server: Optional[asyncio.AbstractServer] = None
        self._sweeper: Optional[asyncio.Task] = None
        self.port = server.port

        # Constant response-header block: security + CORS headers that
        # do not depend on the request. Origin-echo only matters when a
        # browser sends Origin AND the allowlist is restrictive; that
        # rare case is handled per-request in _finish_headers.
        const = []
        sec = server.security
        if sec.enable_security_headers:
            const.append(b"X-Content-Type-Options: nosniff")
            const.append(b"X-Frame-Options: DENY")
            if sec.hsts:
                const.append(
                    b"Strict-Transport-Security: max-age=31536000; includeSubDomains"
                )
            const.append(
                b"Content-Security-Policy: "
                + sec.content_security_policy.encode()
            )
        self.cors = server.cors
        self._cors_const = b""
        if self.cors.enabled:
            self._cors_wildcard = "*" in self.cors.allowed_origins
            cors_tail = (
                b"Access-Control-Allow-Methods: "
                + ", ".join(self.cors.allowed_methods).encode() + b"\r\n"
                b"Access-Control-Allow-Headers: "
                + ", ".join(self.cors.allowed_headers).encode() + b"\r\n"
                b"Access-Control-Expose-Headers: "
                + ", ".join(self.cors.exposed_headers).encode() + b"\r\n"
            )
            self._cors_tail = cors_tail
            # no-Origin requests (curl, SDK clients, the bench): the
            # whole CORS block is constant with a wildcard origin
            self._cors_const = (
                b"Access-Control-Allow-Origin: *\r\n" + cors_tail
            )
        self._const = b"".join(h + b"\r\n" for h in const)
        # Most calls (curl, SDKs, the bench) carry no Origin: the whole
        # header block is one precomputed bytes object.
        self._const_no_origin = self._const + self._cors_const
        self._json_200 = (
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: application/json; charset=utf-8\r\n"
        )

    # -- lifecycle -------------------------------------------------------

    async def start(
        self, host: str, port: int, reuse_port: bool = False
    ) -> None:
        loop = asyncio.get_running_loop()
        self._server = await loop.create_server(
            lambda: FastLaneProtocol(self), host, port,
            reuse_address=True, reuse_port=reuse_port or None,
        )
        sock = self._server.sockets[0]
        self.port = sock.getsockname()[1]
        self._sweeper = asyncio.ensure_future(self._sweep_idle())

    async def stop(self) -> None:
        """Graceful drain: stop accepting, let in-flight requests
        finish, then close. Gateway.stop bounds the whole thing with
        shutdown_grace_s — on that timeout the CancelledError lands in
        the drain sleep and the finally still closes everything."""
        if self._sweeper is not None:
            self._sweeper.cancel()
            self._sweeper = None
        if self._server is not None:
            self._server.close()
        try:
            while any(  # noqa: ASYNC110 — shutdown drain; no event exists for "every connection idle"
                c.busy or not c.queue.empty() for c in self.connections
            ):
                await asyncio.sleep(0.05)
        finally:
            # 3.12's Server.wait_closed waits for live connections too —
            # close them before awaiting it or a keep-alive client
            # wedges shutdown.
            for conn in list(self.connections):
                conn.close_after_write()
            if self._server is not None:
                await self._server.wait_closed()
                self._server = None

    async def _sweep_idle(self) -> None:
        """Close keep-alive connections idle past idle_timeout_s —
        a periodic sweep costs nothing per request, unlike a per-
        connection timer reset on every read."""
        while True:
            await asyncio.sleep(max(5.0, self.idle_timeout_s / 4))
            cutoff = time.monotonic() - self.idle_timeout_s
            for conn in list(self.connections):
                # busy = a handler is mid-request (e.g. a long tool
                # call under a request_timeout_s > idle_timeout_s) —
                # idleness only applies between requests.
                if (
                    conn.last_activity < cutoff
                    and not conn.busy
                    and conn.queue.empty()
                ):
                    conn.close_after_write()

    # -- per-request -----------------------------------------------------

    async def handle(
        self,
        conn: FastLaneProtocol,
        method: str,
        target: str,
        version: str,
        headers: dict[str, str],
        pairs: list[tuple[str, str]],
        body: bytes,
    ) -> None:
        start = time.perf_counter()
        path = target.partition("?")[0]
        status = 500
        conn.sse_started = False
        try:
            # fused_middleware gate order: preflight, rate, ctype, size
            # (size was enforced pre-read in _pump), then the handler
            # under the request timeout, recovery around everything.
            if self.cors.enabled and method == "OPTIONS":
                status = 204
                self._write_response(conn, headers, 204, None, b"")
            elif self.rate_limit_enabled and not self.bucket.allow():
                self.metrics.rate_limit_hit("global")
                status = 429
                self._write_json(
                    conn, headers, 429,
                    mcp.make_error_response(
                        None, mcp.INVALID_REQUEST, "rate limit exceeded"
                    ),
                    retry_after_s=1.0,
                )
            elif method == "POST" and body and not any(
                headers.get("content-type", "").startswith(a)
                for a in self.allowed_ctypes
            ):
                # `body and`: the gate polices request BODIES (aiohttp
                # parity — its chain checks request.can_read_body), so
                # a body-less POST like /admin/drain?backend=... needs
                # no Content-Type.
                status = 415
                self._write_json(
                    conn, headers, 415,
                    mcp.make_error_response(
                        None, mcp.INVALID_REQUEST,
                        "unsupported content type: "
                        f"{headers.get('content-type') or '(none)'}",
                    ),
                )
            else:
                try:
                    async with aio_timeout(self.request_timeout_s):
                        status = await self._route(
                            conn, method, target, path, headers, pairs, body
                        )
                except (TimeoutError, asyncio.TimeoutError):
                    status = 504
                    if conn.sse_started:
                        # Stream headers already went out — an HTTP 504
                        # written now would be garbage mid-stream; end
                        # the close-delimited stream instead.
                        conn.close_after_write()
                    else:
                        self._write_json(
                            conn, headers, 504,
                            mcp.make_error_response(
                                None, mcp.INTERNAL_ERROR, "request timed out"
                            ),
                        )
        except (ConnectionResetError, ConnectionAbortedError):
            return  # client went away; nothing to write or log
        except asyncio.CancelledError:
            raise
        except Exception:
            logger.exception("panic in handler for %s", path)
            status = 500
            try:
                if conn.sse_started:
                    conn.close_after_write()
                else:
                    self._write_json(
                        conn, headers, 500,
                        mcp.make_error_response(
                            None, mcp.INTERNAL_ERROR, "internal server error"
                        ),
                    )
            except (ConnectionResetError, ConnectionAbortedError):
                return
        elapsed = time.perf_counter() - start
        if logger.isEnabledFor(logging.INFO):
            logger.info(
                "%s %s -> %d (%.1f ms)", method, path, status, elapsed * 1000
            )
        self.metrics.observe_http(
            method, path if path in _KNOWN_PATHS else "other", status, elapsed
        )
        if (
            headers.get("connection", "").lower() == "close"
            or version == "HTTP/1.0"
            and headers.get("connection", "").lower() != "keep-alive"
        ):
            conn.close_after_write()

    async def _route(
        self,
        conn: FastLaneProtocol,
        method: str,
        target: str,
        path: str,
        headers: dict[str, str],
        pairs: list[tuple[str, str]],
        body: bytes,
    ) -> int:
        h = self.handler
        if path == "/":
            if method == "POST":
                return await self._post(conn, headers, pairs, body)
            if method in ("GET", "OPTIONS"):
                session = self._session(headers, pairs)
                result = mcp.initialize_result(
                    self.cfg.mcp.protocol_version,
                    self.cfg.mcp.server_name,
                    self.cfg.mcp.server_version,
                )
                self._write_json(
                    conn, headers, 200, mcp.make_response(None, result),
                    session_id=session.id,
                )
                return 200
            self._write_response(conn, headers, 405, None, b"")
            return 405
        if path in ("/admin/drain", "/admin/undrain"):
            if method != "POST":
                self._write_response(conn, headers, 405, None, b"")
                return 405
            query = parse_qs(urlsplit(target).query)
            body_dict, status = h.admin_drain_body(
                query.get("backend", [""])[0],
                drain=(path == "/admin/drain"),
            )
            self._write_json(conn, headers, status, body_dict)
            return status
        if path == "/admin/fleet":
            if method != "POST":
                self._write_response(conn, headers, 405, None, b"")
                return 405
            query = parse_qs(urlsplit(target).query)
            body_dict, status = h.admin_fleet_body(
                query.get("action", ["status"])[0]
            )
            self._write_json(conn, headers, status, body_dict)
            return status
        if path == "/debug/profile":
            # POST: a capture is an action (it spends a device window),
            # not a read — same verb on both http impls.
            if method != "POST":
                self._write_response(conn, headers, 405, None, b"")
                return 405
            query = parse_qs(urlsplit(target).query)
            body_dict = await h.debug_profile_body(
                query.get("duration_ms", ["1000"])[0],
                query.get("label", [""])[0],
            )
            self._write_json(conn, headers, 200, body_dict)
            return 200
        if method != "GET":
            self._write_response(conn, headers, 405, None, b"")
            return 405
        if path == "/health":
            body_dict, status = await h.health_body()
            self._write_json(conn, headers, status, body_dict)
            return status
        if path == "/metrics":
            payload, content_type = await h.metrics_body()
            self._write_response(
                conn, headers, 200, content_type.encode(), payload
            )
            return 200
        if path == "/stats":
            self._write_json(conn, headers, 200, await h.stats_body())
            return 200
        if path == "/debug/traces":
            query = parse_qs(urlsplit(target).query)
            n = query.get("n", ["100"])[0]
            self._write_json(conn, headers, 200, h.traces_body(n))
            return 200
        if path in ("/debug/ticks", "/debug/requests"):
            query = parse_qs(urlsplit(target).query)
            body = await h.debug_flight_body(
                path.rsplit("/", 1)[1],
                query.get("trace_id", [""])[0],
                query.get("n", ["128"])[0],
                query.get("source", [""])[0],
                query.get("tenant", [""])[0],
            )
            self._write_json(conn, headers, 200, body)
            return 200
        if path == "/debug/slo":
            self._write_json(conn, headers, 200, await h.debug_slo_body())
            return 200
        if path == "/debug/timeline":
            query = parse_qs(urlsplit(target).query)
            body = await h.timeline_body(query.get("n", ["512"])[0])
            self._write_json(conn, headers, 200, body)
            return 200
        if path == "/debug/memory":
            query = parse_qs(urlsplit(target).query)
            body = await h.debug_memory_body(
                query.get("reconcile", ["1"])[0]
            )
            self._write_json(conn, headers, 200, body)
            return 200
        self._write_response(conn, headers, 404, None, b"")
        return 404

    async def _post(
        self,
        conn: FastLaneProtocol,
        headers: dict[str, str],
        pairs: list[tuple[str, str]],
        body: bytes,
    ) -> int:
        """POST /: the hot path. Mirrors MCPHandler.handle_post's
        framing (parse errors and notifications handled here, at the
        transport) around the shared dispatch core."""
        try:
            data = json.loads(body)
        except (json.JSONDecodeError, UnicodeDecodeError) as exc:
            self._write_json(
                conn, headers, 200,
                mcp.make_error_response(
                    None, mcp.PARSE_ERROR, f"parse error: {exc}"
                ),
            )
            return 200
        if isinstance(data, dict) and "id" not in data:
            logger.debug("notification: %s", data.get("method", ""))
            self._write_response(conn, headers, 202, None, b"")
            return 202

        sse = (
            _RawSSE(conn, self._const)
            if "text/event-stream" in headers.get("accept", "")
            else None
        )
        resp_dict, session, trace_id = await self.handler.dispatch(
            data,
            lambda: self._session(headers, pairs),
            trace_id_in=headers.get(tracing.TRACE_HEADER),
            sse=sse,
        )
        if resp_dict is None and sse is not None and sse.started:
            return 200  # streamed; connection closes after the result
        retry_after = mcp.overload_retry_after_s(resp_dict)
        status = 200 if retry_after is None else 429
        self._write_json(
            conn, headers, status, resp_dict,
            session_id=session.id if session is not None else None,
            trace_id=trace_id,
            retry_after_s=retry_after,
        )
        return status

    # -- helpers ---------------------------------------------------------

    def _session(
        self, headers: dict[str, str], pairs: list[tuple[str, str]]
    ):
        """MCPHandler._session_for, headers-dict edition: live-session
        resolution touches one dict lookup; the multi-value header
        snapshot is built only when minting (cold path)."""
        sid = headers.get("mcp-session-id", "")
        if sid:
            sess = self.sessions.get_live(sid)
            if sess is not None:
                return sess
        # Merge case-insensitively but keep the first-seen original
        # casing, matching the aiohttp backend's CIMultiDict snapshot
        # (gateway/handler.py::_session_for) so both http_impl backends
        # store identical session headers.
        raw: dict[str, Any] = {}
        canon: dict[str, str] = {}
        for key, val in pairs:
            first = canon.setdefault(key.lower(), key)
            if first in raw:
                prev = raw[first]
                if isinstance(prev, list):
                    prev.append(val)
                else:
                    raw[first] = [prev, val]
            else:
                raw[first] = val
        return self.sessions.get_or_create(sid, raw)

    def _finish_headers(self, req_headers: dict[str, str]) -> bytes:
        """Security + CORS block; constant unless a restrictive CORS
        allowlist must echo the caller's Origin."""
        if not self.cors.enabled:
            return self._const
        origin = req_headers.get("origin")
        if origin is None:
            return self._const_no_origin
        # fused parity: wildcard allowlists (and exact matches) echo the
        # caller's Origin; otherwise fall back to the first allowed one
        if self._cors_wildcard or origin in self.cors.allowed_origins:
            chosen = origin
        else:
            allowed = self.cors.allowed_origins
            chosen = allowed[0] if allowed else "*"
        return (
            self._const
            + b"Access-Control-Allow-Origin: " + chosen.encode() + b"\r\n"
            + self._cors_tail
        )

    def _write_json(
        self,
        conn: FastLaneProtocol,
        req_headers: dict[str, str],
        status: int,
        payload: Any,
        session_id: Optional[str] = None,
        trace_id: Optional[str] = None,
        retry_after_s: Optional[float] = None,
    ) -> None:
        body = json.dumps(payload, ensure_ascii=False).encode()
        extra = b""
        if session_id is not None:
            extra += b"Mcp-Session-Id: " + session_id.encode() + b"\r\n"
        if trace_id is not None:
            extra += b"X-Trace-Id: " + trace_id.encode() + b"\r\n"
        if retry_after_s is not None:
            extra += b"Retry-After: %d\r\n" % max(1, int(retry_after_s))
        if status == 200:
            head = self._json_200
        else:
            head = (
                b"HTTP/1.1 %d %s\r\n"
                b"Content-Type: application/json; charset=utf-8\r\n"
                % (status, _REASONS[status].encode())
            )
        conn.write_raw(
            head
            + self._finish_headers(req_headers)
            + extra
            + b"Content-Length: %d\r\n\r\n" % len(body)
            + body
        )

    def _write_response(
        self,
        conn: FastLaneProtocol,
        req_headers: dict[str, str],
        status: int,
        content_type: Optional[bytes],
        body: bytes,
    ) -> None:
        head = b"HTTP/1.1 %d %s\r\n" % (status, _REASONS[status].encode())
        if content_type:
            head += b"Content-Type: " + content_type + b"\r\n"
        conn.write_raw(
            head
            + self._finish_headers(req_headers)
            + b"Content-Length: %d\r\n\r\n" % len(body)
            + body
        )


__all__ = ["FastLaneServer", "FastLaneProtocol"]
