"""Request trace ids and on-demand profiler captures.

The port's counterpart of the parts of `ggrmcp_tpu/utils/tracing.py`
the sidecar uses: the gateway's trace id read from gRPC metadata, and
the capture behind DebugService.Profile, on `torch.profiler` instead of
`jax.profiler`.
"""

from __future__ import annotations

import json
import os
import time

import torch

# The gateway forwards its trace id under this gRPC metadata key.
TRACE_HEADER = "x-trace-id"


def trace_id_from_metadata(metadata) -> str:
    """The trace id of a call's (key, value) metadata pairs, '' if
    absent."""
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
    if cuda:
        with open(path) as fh:
            if not kernel_events(json.load(fh)):
                raise RuntimeError(
                    f"the CUDA profile {path} holds no kernel event"
                )
    return path
