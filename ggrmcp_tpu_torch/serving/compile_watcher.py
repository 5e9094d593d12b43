"""Compile watcher: every build or load of one of the port's CUDA kernels
in the serving process becomes a counter, a log line and a timeline
instant. Port of `ggrmcp_tpu/serving/compile_watcher.py`.

The reference taps XLA's compiles: the persistent compilation cache's
hit / miss events and the dispatch log's "Finished XLA compilation of
<fn> in <s> sec" line, which names the compiled function and fires on a
cache hit too. The port compiles its kernels with `nvcc` into a
persistent cache of its own (`ops/_build.py`: `build/kernels/`, a
library's name carrying the hash of its sources, headers and flags),
and reports each library it loads to its listeners:

* a library built by `nvcc` is a cache MISS and a compile of the
  library's seconds (the build and the load);
* a library found under its hash is a cache HIT and a compile of its
  load time.

Eager PyTorch compiles nothing else at serve time. `mark_warm()` draws
the line between expected cold compiles (the engine's warmup builds its
kernels) and steady-state ones: every compile after the mark increments
`compile_post_warmup`, is logged at WARNING and is flagged in the ring.

Process-global, as `_build`'s cache of loaded libraries is (a library is
loaded once a process). The sidecar exports the counters through
ServingStats (`gateway_backend_compile_*`) and the ring through
DebugService.GetMemory / GetFlightRecord. `install()` is idempotent and
gated by serving.observability at the engine.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import deque
from typing import Optional

logger = logging.getLogger("ggrmcp.torch.serving.compile")

# The cache outcomes, in the reference's event form.
CACHE_HIT_EVENT = "/ggrmcp/kernel_cache/cache_hits"
CACHE_MISS_EVENT = "/ggrmcp/kernel_cache/cache_misses"


@dataclasses.dataclass
class CompileEvent:
    """One kernel library built or loaded (serving_pb2.CompileRecord
    mirror)."""

    fn_name: str
    t_wall: float
    duration_ms: float
    post_warmup: bool = False

    def to_dict(self) -> dict:
        return {
            "fnName": self.fn_name,
            "tWall": round(self.t_wall, 6),
            "durationMs": round(self.duration_ms, 3),
            "postWarmup": self.post_warmup,
        }


class CompileWatcher:
    """Counters + bounded ring of kernel compile events for this
    process."""

    RING = 256

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._installed = False
        self.compile_count = 0
        self.compile_ms = 0.0
        self.cache_hits = 0
        self.cache_misses = 0
        self._count_at_warm: Optional[int] = None
        self._ring: deque = deque(maxlen=self.RING)

    # -- lifecycle -----------------------------------------------------------

    def install(self) -> None:
        """Listen to `ops/_build.py`'s library loads (idempotent). Called
        at engine init when serving.observability.enabled; never
        uninstalled."""
        with self._lock:
            if self._installed:
                return
            self._installed = True
        from ggrmcp_tpu_torch.ops import _build

        _build.listeners.append(self._on_load)
        logger.info("compile watcher installed")

    def mark_warm(self) -> None:
        """Declare warmup over: compiles from here on are steady-state
        compiles — counted, WARNING-logged, flagged in the ring. A later
        mark (a second sidecar warming up in-process) re-draws the
        line."""
        with self._lock:
            self._count_at_warm = self.compile_count

    def mark_cold(self) -> None:
        """A new warmup era opened (engine construction): compiles are
        expected again until the next mark_warm()."""
        with self._lock:
            self._count_at_warm = None

    # -- hooks ---------------------------------------------------------------

    def _on_load(self, name: str, secs: float, hit: bool) -> None:
        """`_build`'s report of library `name` loaded in `secs` seconds,
        found under its hash (`hit`) or built by nvcc."""
        self._on_event(CACHE_HIT_EVENT if hit else CACHE_MISS_EVENT)
        self._on_compile(name, secs)

    def _on_event(self, event: str, **kwargs) -> None:
        if event == CACHE_HIT_EVENT:
            with self._lock:
                self.cache_hits += 1
        elif event == CACHE_MISS_EVENT:
            with self._lock:
                self.cache_misses += 1

    def _on_compile(self, fn_name: str, secs: float) -> None:
        with self._lock:
            self.compile_count += 1
            self.compile_ms += secs * 1000.0
            post = self._count_at_warm is not None
            self._ring.append(CompileEvent(
                fn_name=fn_name,
                t_wall=time.time(),
                duration_ms=secs * 1000.0,
                post_warmup=post,
            ))
        if post:
            # A kernel built or loaded after warmup: a path the warmup
            # did not cover paid for it in a request's latency.
            logger.warning(
                "steady-state compile: %s took %.1f ms after warmup "
                "(watch gateway_backend_compile_post_warmup)",
                fn_name, secs * 1000.0,
            )

    # -- queries -------------------------------------------------------------

    def post_warmup_count(self) -> int:
        with self._lock:
            if self._count_at_warm is None:
                return 0
            return self.compile_count - self._count_at_warm

    def stats(self) -> dict:
        """ServingStats field values (proto names, fields 101-105)."""
        with self._lock:
            post = (
                self.compile_count - self._count_at_warm
                if self._count_at_warm is not None else 0
            )
            return {
                "compile_count": self.compile_count,
                "compile_ms": round(self.compile_ms, 3),
                "compile_cache_hits": self.cache_hits,
                "compile_cache_misses": self.cache_misses,
                "compile_post_warmup": post,
            }

    def snapshot(self, limit: int = RING) -> list:
        """Newest-last compile events (the /debug/memory and timeline
        instant source)."""
        with self._lock:
            events = list(self._ring)
        return events[-max(1, limit):]


# The process singleton (`_build`'s loaded libraries are process-global;
# so is this).
watcher = CompileWatcher()
