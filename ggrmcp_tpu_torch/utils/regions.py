"""Device-timed regions of a forward, on only while a torch profiler is.

A region is a named stretch of a model's forward whose device time a
layer metric reads: `attn.decode` (ops/attention.py, `attention_ref` at
decode-shaped queries) and `moe.ffn` (models/moe.py, `moe_ffn`).

- Off (no profiler active: `torch.autograd.profiler._is_profiler_enabled`,
  the flag `torch.profiler.profile` sets while it records), the call
  sites check that one flag and call straight through: no CUDA event,
  no `record_function`, no span.
- On, a region is entered as `record_function(name)`, so a Profile
  capture shows it; and inside a `Window` that the serving loop opened
  on this thread (a decode tick, an admission round) it is bracketed
  by a pair of CUDA events on the current stream (on a CPU tensor, by
  the host's clock: the CPU runs it synchronously).
- `Window.close`, called after a synchronisation the caller already
  makes (the tick's token pull, the admission's first-token pulls),
  resolves the events into one span per region name: `device_ms`, the
  regions' stream time summed (each from its first launch's start to
  its last kernel's end), `layers`, the number of regions, and the
  caller's attributes. Its start is the first region's host entry on
  the wall axis of the tick records (utils/tracing.py).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Iterable, Optional

import torch
from torch.autograd import profiler as _profiler

from ggrmcp_tpu_torch.utils import tracing

# The window this thread's forward is in: the model code it times takes
# no extra argument.
_local = threading.local()


class Window:
    """The regions of one forward on one thread, named in `names`."""

    def __init__(self, names: Iterable[str]) -> None:
        self.names = frozenset(names)
        # Wall and perf_counter read together: the host stamps' axis.
        self.wall, self.mono = time.time(), time.perf_counter()
        self.marks: dict[str, list] = {}

    def add(self, name: str, p0: float, p1: float, start, end) -> None:
        self.marks.setdefault(name, []).append((p0, p1, start, end))

    def close(self, attrs: Optional[dict] = None) -> None:
        """One span per region name (its `attrs[name]` added), once the
        caller's own synchronisation has passed every region's end. A
        window the profiler's stop cut short (its later regions not
        timed), or a name whose last event has not completed, makes no
        span."""
        if getattr(_local, "window", None) is self:
            _local.window = None
        if not _profiler._is_profiler_enabled:
            return
        for name, marks in self.marks.items():
            last = marks[-1][3]
            if last is not None and not last.query():
                continue
            device_ms = sum(
                (p1 - p0) * 1e3 if start is None else start.elapsed_time(end)
                for p0, p1, start, end in marks)
            p_first, p_last = marks[0][0], marks[-1][1]
            tracing.tracer.record(
                name, self.wall + (p_first - self.mono),
                (p_last - p_first) * 1e3, device_ms=round(device_ms, 4),
                layers=len(marks), **(attrs or {}).get(name, {}))


def open_window(names: Iterable[str]) -> Optional[Window]:
    """A window for this thread's regions in `names` while a profiler
    is recording; None (nothing to close) otherwise."""
    if not _profiler._is_profiler_enabled:
        return None
    window = _local.window = Window(names)
    return window


def timed(name: str, fn: Callable) -> Callable:
    """`fn` run as region `name`, on the device of its first argument.
    Call sites build it only once torch's profiler flag said yes."""

    def run(*args: Any, **kwargs: Any):
        rf = tracing.profiler_range(name)
        window = getattr(_local, "window", None)
        if window is not None and name not in window.names:
            window = None
        start = end = None
        if window is not None and args[0].device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        p0 = time.perf_counter()
        try:
            out = fn(*args, **kwargs)
        finally:
            if rf is not None:
                rf.__exit__(None, None, None)
        if window is not None:
            if start is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
            window.add(name, p0, time.perf_counter(), start, end)
        return out

    return run
