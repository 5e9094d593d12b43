"""HTTP middleware chain for the gateway.

Capability parity with the reference chain (pkg/server/middleware.go):
recovery → logging → security headers → CORS → global rate limit →
content-type allowlist → request size cap → timeout → metrics. Built as
aiohttp middleware factories; `default_middlewares(cfg)` assembles the
chain from config (the reference hard-coded its values,
middleware.go:280-293 — here the config tree is plumbed through).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Awaitable, Callable

from aiohttp import web

from ggrmcp_tpu_torch.core.config import ServerConfig
from ggrmcp_tpu_torch.gateway.metrics import GatewayMetrics
from ggrmcp_tpu_torch.utils.aio_compat import timeout as aio_timeout
from ggrmcp_tpu_torch.mcp import types as mcp

logger = logging.getLogger("ggrmcp.gateway.http")

Handler = Callable[[web.Request], Awaitable[web.StreamResponse]]

# The gateway's route table (gateway/app.py); used to bound the
# cardinality of the HTTP metrics path label.
_KNOWN_PATHS = frozenset(
    {"/", "/health", "/metrics", "/stats", "/debug/traces",
     "/debug/ticks", "/debug/requests", "/debug/timeline",
     "/debug/memory", "/debug/profile", "/debug/slo",
     "/admin/drain", "/admin/undrain", "/admin/fleet"}
)


class TokenBucket:
    """Global token-bucket rate limiter (x/time/rate analogue)."""

    def __init__(self, rate: float, burst: int):
        self.rate = rate
        self.burst = float(burst)
        self.tokens = float(burst)
        self.updated = time.monotonic()

    def allow(self) -> bool:
        now = time.monotonic()
        self.tokens = min(self.burst, self.tokens + (now - self.updated) * self.rate)
        self.updated = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


def recovery_middleware() -> Callable:
    @web.middleware
    async def mw(request: web.Request, handler: Handler) -> web.StreamResponse:
        try:
            return await handler(request)
        except web.HTTPException:
            raise
        except asyncio.CancelledError:
            raise
        except Exception:
            logger.exception("panic in handler for %s", request.path)
            return web.json_response(
                mcp.make_error_response(None, mcp.INTERNAL_ERROR, "internal server error"),
                status=500,
            )

    return mw


def logging_middleware() -> Callable:
    @web.middleware
    async def mw(request: web.Request, handler: Handler) -> web.StreamResponse:
        start = time.perf_counter()
        response = await handler(request)
        logger.info(
            "%s %s -> %d (%.1f ms)",
            request.method,
            request.path,
            getattr(response, "status", 0),
            (time.perf_counter() - start) * 1000,
        )
        return response

    return mw


def security_headers_middleware(cfg: ServerConfig) -> Callable:
    @web.middleware
    async def mw(request: web.Request, handler: Handler) -> web.StreamResponse:
        response = await handler(request)
        if cfg.security.enable_security_headers:
            response.headers["X-Content-Type-Options"] = "nosniff"
            response.headers["X-Frame-Options"] = "DENY"
            if cfg.security.hsts:
                response.headers["Strict-Transport-Security"] = (
                    "max-age=31536000; includeSubDomains"
                )
            response.headers["Content-Security-Policy"] = (
                cfg.security.content_security_policy
            )
        return response

    return mw


def cors_middleware(cfg: ServerConfig) -> Callable:
    @web.middleware
    async def mw(request: web.Request, handler: Handler) -> web.StreamResponse:
        if not cfg.cors.enabled:
            return await handler(request)
        if request.method == "OPTIONS":
            response: web.StreamResponse = web.Response(status=204)
        else:
            response = await handler(request)
        origin = request.headers.get("Origin", "*")
        allowed = cfg.cors.allowed_origins
        response.headers["Access-Control-Allow-Origin"] = (
            origin if "*" in allowed or origin in allowed else allowed[0] if allowed else "*"
        )
        response.headers["Access-Control-Allow-Methods"] = ", ".join(
            cfg.cors.allowed_methods
        )
        response.headers["Access-Control-Allow-Headers"] = ", ".join(
            cfg.cors.allowed_headers
        )
        response.headers["Access-Control-Expose-Headers"] = ", ".join(
            cfg.cors.exposed_headers
        )
        return response

    return mw


def rate_limit_middleware(cfg: ServerConfig, metrics: GatewayMetrics) -> Callable:
    bucket = TokenBucket(cfg.rate_limit.requests_per_second, cfg.rate_limit.burst)

    @web.middleware
    async def mw(request: web.Request, handler: Handler) -> web.StreamResponse:
        if cfg.rate_limit.enabled and not bucket.allow():
            metrics.rate_limit_hit("global")
            return web.json_response(
                mcp.make_error_response(None, mcp.INVALID_REQUEST, "rate limit exceeded"),
                status=429,
                # Token bucket refills continuously; 1s is the honest
                # "try again soon" for a burst-sized dip.
                headers={"Retry-After": "1"},
            )
        return await handler(request)

    return mw


def content_type_middleware(cfg: ServerConfig) -> Callable:
    allowed = tuple(cfg.allowed_content_types)

    @web.middleware
    async def mw(request: web.Request, handler: Handler) -> web.StreamResponse:
        if request.method == "POST" and request.can_read_body:
            ctype = request.headers.get("Content-Type", "")
            if not any(ctype.startswith(a) for a in allowed):
                return web.json_response(
                    mcp.make_error_response(
                        None, mcp.INVALID_REQUEST,
                        f"unsupported content type: {ctype or '(none)'}",
                    ),
                    status=415,
                )
        return await handler(request)

    return mw


def request_size_middleware(cfg: ServerConfig) -> Callable:
    @web.middleware
    async def mw(request: web.Request, handler: Handler) -> web.StreamResponse:
        length = request.content_length
        if length is not None and length > cfg.max_request_bytes:
            return web.json_response(
                mcp.make_error_response(None, mcp.INVALID_REQUEST, "request too large"),
                status=413,
            )
        return await handler(request)

    return mw


def timeout_middleware(cfg: ServerConfig) -> Callable:
    @web.middleware
    async def mw(request: web.Request, handler: Handler) -> web.StreamResponse:
        try:
            return await asyncio.wait_for(
                handler(request), timeout=cfg.request_timeout_s
            )
        except asyncio.TimeoutError:
            return web.json_response(
                mcp.make_error_response(None, mcp.INTERNAL_ERROR, "request timed out"),
                status=504,
            )

    return mw


def metrics_middleware(metrics: GatewayMetrics) -> Callable:
    @web.middleware
    async def mw(request: web.Request, handler: Handler) -> web.StreamResponse:
        start = time.perf_counter()
        response = await handler(request)
        path = request.path if request.path in _KNOWN_PATHS else "other"
        metrics.observe_http(
            request.method,
            path,
            getattr(response, "status", 0),
            time.perf_counter() - start,
        )
        return response

    return mw


def fused_middleware(cfg: ServerConfig, metrics: GatewayMetrics) -> Callable:
    """The whole default chain fused into ONE middleware coroutine.

    Nine stacked aiohttp middlewares cost nine coroutine frames +
    scheduling per request; at gateway throughput targets (≥1k calls/s)
    that overhead is measurable (SURVEY §3.3). Response semantics are
    identical to the individual factories below, in the same order:
    recovery → logging → security headers → CORS → global rate limit →
    content-type → size cap → timeout → metrics. One DELIBERATE
    difference: metrics cover every response, including short-circuited
    ones (429/415/413/preflight/recovery-500) that the unfused chain's
    innermost metrics middleware never saw — error-rate dashboards see
    the full truth here. The individual factories remain exported for
    tests and custom chains."""
    bucket = TokenBucket(cfg.rate_limit.requests_per_second, cfg.rate_limit.burst)
    allowed_ctypes = tuple(cfg.allowed_content_types)
    sec = cfg.security
    cors = cfg.cors
    cors_methods = ", ".join(cors.allowed_methods)
    cors_headers = ", ".join(cors.allowed_headers)
    cors_expose = ", ".join(cors.exposed_headers)

    @web.middleware
    async def mw(request: web.Request, handler: Handler) -> web.StreamResponse:
        start = time.perf_counter()
        try:
            # -- pre-handler gates (CORS preflight / rate / content-type
            # / size). OPTIONS must short-circuit BEFORE the rate
            # limiter, as in the unfused chain (cors at position 4,
            # rate limit at 5): preflights never consume tokens.
            if cors.enabled and request.method == "OPTIONS":
                response: web.StreamResponse = web.Response(status=204)
            elif cfg.rate_limit.enabled and not bucket.allow():
                metrics.rate_limit_hit("global")
                response = web.json_response(
                    mcp.make_error_response(
                        None, mcp.INVALID_REQUEST, "rate limit exceeded"
                    ),
                    status=429,
                    headers={"Retry-After": "1"},
                )
            else:
                if request.method == "POST" and request.can_read_body:
                    ctype = request.headers.get("Content-Type", "")
                    if not any(ctype.startswith(a) for a in allowed_ctypes):
                        response = web.json_response(
                            mcp.make_error_response(
                                None, mcp.INVALID_REQUEST,
                                f"unsupported content type: {ctype or '(none)'}",
                            ),
                            status=415,
                        )
                        return _finish(request, response, start)
                length = request.content_length
                if length is not None and length > cfg.max_request_bytes:
                    response = web.json_response(
                        mcp.make_error_response(
                            None, mcp.INVALID_REQUEST, "request too large"
                        ),
                        status=413,
                    )
                    return _finish(request, response, start)
                try:
                    async with aio_timeout(cfg.request_timeout_s):
                        response = await handler(request)
                except (TimeoutError, asyncio.TimeoutError):
                    response = web.json_response(
                        mcp.make_error_response(
                            None, mcp.INTERNAL_ERROR, "request timed out"
                        ),
                        status=504,
                    )
        except web.HTTPException:
            raise
        except asyncio.CancelledError:
            raise
        except Exception:
            logger.exception("panic in handler for %s", request.path)
            response = web.json_response(
                mcp.make_error_response(
                    None, mcp.INTERNAL_ERROR, "internal server error"
                ),
                status=500,
            )
        return _finish(request, response, start)

    def _finish(
        request: web.Request, response: web.StreamResponse, start: float
    ) -> web.StreamResponse:
        headers = response.headers
        if sec.enable_security_headers:
            headers["X-Content-Type-Options"] = "nosniff"
            headers["X-Frame-Options"] = "DENY"
            if sec.hsts:
                headers["Strict-Transport-Security"] = (
                    "max-age=31536000; includeSubDomains"
                )
            headers["Content-Security-Policy"] = sec.content_security_policy
        if cors.enabled:
            origin = request.headers.get("Origin", "*")
            allowed = cors.allowed_origins
            headers["Access-Control-Allow-Origin"] = (
                origin if "*" in allowed or origin in allowed
                else allowed[0] if allowed else "*"
            )
            headers["Access-Control-Allow-Methods"] = cors_methods
            headers["Access-Control-Allow-Headers"] = cors_headers
            headers["Access-Control-Expose-Headers"] = cors_expose
        elapsed = time.perf_counter() - start
        status = getattr(response, "status", 0)
        if logger.isEnabledFor(logging.INFO):
            logger.info(
                "%s %s -> %d (%.1f ms)",
                request.method, request.path, status, elapsed * 1000,
            )
        # Client-controlled paths must not become metric label values
        # (unbounded cardinality); anything off the route table is
        # folded into one bucket.
        path = request.path if request.path in _KNOWN_PATHS else "other"
        metrics.observe_http(request.method, path, status, elapsed)
        return response

    return mw


def default_middlewares(cfg: ServerConfig, metrics: GatewayMetrics) -> list:
    """The assembled chain (middleware.go:280-293 parity; per-session
    rate limiting lives in the handler where the session is known —
    fixing the unbounded limiter map). Fused into a single middleware
    for hot-path efficiency; see `fused_middleware`."""
    return [fused_middleware(cfg, metrics)]
