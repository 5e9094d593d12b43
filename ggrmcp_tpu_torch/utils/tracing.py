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
  captures a `torch.profiler` Chrome trace (Perfetto-loadable) on
  demand — the deep-dive path when a span shows a slow hop.
- work timed where no `with` block fits (a serving-loop turn, a device
  region resolved after the tick's sync) is kept after the fact
  (`Tracer.record`), its start in wall seconds on the tick records'
  axis; spans of no call carry an empty trace id. The ring keeps the
  latest end among the spans it drops, so a reader of an interval can
  tell it is whole.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import logging
import os
import re
import sys
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
        # The latest wall end among the spans the full ring pushed out:
        # every span that ends after it is still in the ring.
        self.dropped_until = 0.0

    @property
    def capacity(self) -> int:
        return self._finished.maxlen

    def reserve(self, capacity: int) -> None:
        """Grow the ring to hold `capacity` spans (it never shrinks)."""
        with self._lock:
            if capacity > self._finished.maxlen:
                self._finished = deque(self._finished, maxlen=capacity)

    def _keep(self, span: Span) -> None:
        with self._lock:
            ring = self._finished
            if len(ring) == ring.maxlen:
                old = ring[0]
                self.dropped_until = max(
                    self.dropped_until,
                    old.start_unix + old.duration_ms / 1000.0)
            ring.append(span)

    def record(
        self,
        name: str,
        start_unix: float,
        duration_ms: float,
        trace_id: str = "",
        parent_id: str = "",
        **attrs: Any,
    ) -> Span:
        """Keep a span timed elsewhere: its start in wall seconds and
        its duration. An empty trace id marks work of no call."""
        span = Span(trace_id=trace_id, span_id=new_id(), parent_id=parent_id,
                    name=name, start_unix=start_unix,
                    duration_ms=duration_ms, attrs=attrs)
        self._keep(span)
        return span

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
        profiled = profiler_range(name)
        t0 = time.perf_counter()
        try:
            yield span
        except Exception as exc:
            span.attrs.setdefault("error", type(exc).__name__)
            raise
        finally:
            span.duration_ms = (time.perf_counter() - t0) * 1000
            if profiled is not None:
                profiled.__exit__(None, None, None)
            self._current.reset(token)
            self._keep(span)
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

    def snapshot(self) -> tuple[list[Span], float]:
        """The ring's spans, oldest kept first, and `dropped_until`."""
        with self._lock:
            return list(self._finished), self.dropped_until

    def clear(self) -> None:
        with self._lock:
            self._finished.clear()
            self.dropped_until = 0.0


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


def profiler_range(name: str):
    """While a torch profiler records, an entered `record_function(name)`
    range (the caller exits it when the work ends), so that a capture on
    this thread shows the span; None otherwise. torch is looked up, never
    imported: the gateway runs without it."""
    profiler = sys.modules.get("torch.autograd.profiler")
    if profiler is None or not profiler._is_profiler_enabled:
        return None
    rf = profiler.record_function(name)
    rf.__enter__()
    return rf


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
