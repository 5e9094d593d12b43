"""Per-call tracing: spans across gateway → sidecar → device.

The reference's only observability is duration logging in middleware
(pkg/server/middleware.go:17-43) and `x-trace-id` being an allowed
forwarded header (pkg/config/config.go:250); SURVEY.md §5.1 calls for
real per-call spans in the new framework. This module provides them
without external dependencies:

- every MCP request opens a span; `tools/call` propagates the trace id
  to the backend as `x-trace-id` gRPC metadata; the sidecar continues
  the same trace around its engine work — one id stitches the hops.
- spans nest via a contextvar (async-safe), finish into a bounded ring
  buffer, and are served by the gateway's `/debug/traces` endpoint and
  mirrored to debug logs.
- the device layer is covered two ways: span attributes carry the
  engine's compute timings, and the sidecar's DebugService.Profile RPC
  captures a real JAX profiler trace (TensorBoard/XProf-loadable) on
  demand — the deep-dive path when a span shows a slow hop.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import logging
import os
import re
import threading
import time
from collections import deque
from typing import Any, Iterator, Optional

logger = logging.getLogger("ggrmcp.tracing")

# Header (HTTP) / metadata key (gRPC) carrying the trace id. Lowercase:
# gRPC metadata keys must be lowercase, and HTTP lookup is
# case-insensitive.
TRACE_HEADER = "x-trace-id"


def new_id(nbytes: int = 8) -> str:
    return os.urandom(nbytes).hex()


@dataclasses.dataclass
class Span:
    trace_id: str
    span_id: str
    parent_id: str
    name: str
    start_unix: float  # wall-clock epoch seconds
    duration_ms: float = 0.0
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def to_dict(self) -> dict[str, Any]:
        return {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "name": self.name,
            "startUnix": round(self.start_unix, 6),
            "durationMs": round(self.duration_ms, 3),
            "attrs": self.attrs,
        }


class Tracer:
    """Contextvar-scoped span stack + bounded ring of finished spans."""

    def __init__(self, capacity: int = 512):
        self._finished: deque[Span] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._current: contextvars.ContextVar[Optional[Span]] = (
            contextvars.ContextVar("ggrmcp_current_span", default=None)
        )

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        trace_id: Optional[str] = None,
        **attrs: Any,
    ) -> Iterator[Span]:
        """Open a span. Child spans inherit the trace id from the
        enclosing span unless one is passed explicitly."""
        parent = self._current.get()
        tid = trace_id or (parent.trace_id if parent else new_id())
        span = Span(
            trace_id=tid,
            span_id=new_id(),
            parent_id=parent.span_id if parent and parent.trace_id == tid else "",
            name=name,
            start_unix=time.time(),
            attrs=dict(attrs),
        )
        token = self._current.set(span)
        t0 = time.perf_counter()
        try:
            yield span
        except Exception as exc:
            span.attrs.setdefault("error", type(exc).__name__)
            raise
        finally:
            span.duration_ms = (time.perf_counter() - t0) * 1000
            self._current.reset(token)
            with self._lock:
                self._finished.append(span)
            logger.debug(
                "span %s trace=%s %.2fms %s",
                span.name, span.trace_id, span.duration_ms, span.attrs,
            )

    def current(self) -> Optional[Span]:
        return self._current.get()

    def current_trace_id(self) -> str:
        span = self._current.get()
        return span.trace_id if span else ""

    def recent(self, n: int = 100) -> list[dict[str, Any]]:
        """Most recent finished spans, newest first."""
        with self._lock:
            spans = list(self._finished)
        return [s.to_dict() for s in reversed(spans[-n:])]

    def clear(self) -> None:
        with self._lock:
            self._finished.clear()


# Process-wide default tracer: the gateway and the sidecar each run in
# their own process, so module scope is the natural singleton.
tracer = Tracer()


def trace_id_from_metadata(metadata) -> str:
    """Pull the trace id out of gRPC invocation metadata (a sequence of
    (key, value) pairs), '' if absent."""
    for key, value in metadata or ():
        if key.lower() == TRACE_HEADER:
            return value
    return ""


def kernel_events(trace: dict) -> list[dict]:
    """The device kernel events of a Chrome trace written by
    `torch.profiler`."""
    return [
        e for e in trace.get("traceEvents", [])
        if e.get("ph") == "X" and e.get("cat") == "kernel"
    ]


def profile_capture(duration_ms: float, out: str, cuda: bool) -> str:
    """Profile the process for `duration_ms` (blocking) and write a
    Chrome trace into directory `out`; returns the trace's path. CPU
    activity is recorded on the calling thread; `cuda` adds the device's
    activity (every kernel the process launches, whichever thread
    launched it). A capture that asked for CUDA and holds no kernel
    event raises RuntimeError: it never passes for a device trace."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"trace-{time.time_ns()}.json")
    with torch.profiler.profile(activities=activities) as prof:
        time.sleep(max(duration_ms, 0.0) / 1000.0)
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    if cuda and not _holds_kernel(path):
        raise RuntimeError(f"the CUDA profile {path} holds no kernel event")
    return path


_KERNEL_CAT = re.compile(rb'"cat"\s*:\s*"kernel"')


def _holds_kernel(path: str) -> bool:
    """Whether the Chrome trace at `path` holds a kernel event, read in
    4 MiB chunks: the serving loop's thread runs between them, where a
    whole-file `json.load` of a busy card's trace held the GIL for
    seconds (a health probe waits as long)."""
    tail = b""
    with open(path, "rb") as fh:
        while chunk := fh.read(1 << 22):
            if _KERNEL_CAT.search(tail + chunk):
                return True
            tail = chunk[-64:]
    return False
