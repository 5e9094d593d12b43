"""The device trace of a `--trace 1` run: `torch.profiler` over a short
slice of steady traffic after the window, read into kernel times, the
device's busy share, the admissions wholly inside the slice and the
idle gaps.

Admissions (the batcher's `_prefill_into_slots`, the one entry of every
admission route) are wrapped from here, a span of the benchmark's own:
each records its prompts' lengths and the attention kernel's launches
it made (`flash_attention.launches`), under a lock that the profiler's
start and stop also take, so that an admission lies wholly inside the
slice or wholly outside it. Its prompts' attention work is then set
against the kernel time of exactly its launches.

The profiler holds the interpreter lock for some microseconds a kernel
when it stops, so the slice is short and lies after the window whose
flight records the other metrics read.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import os
import re
import tempfile
import threading
import time

import torch

B1_KERNEL = re.compile(r"flash_fwd")
MARK = "perfbench.mark"
# Chrome-trace categories of work on the device.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Admissions:
    """The wrapper of one batcher's admissions."""

    def __init__(self, batcher, flash_attention) -> None:
        self.lock = threading.Lock()
        self.inside = False
        self.records: list[dict] = []
        self._flash = flash_attention
        self._orig = batcher._prefill_into_slots
        batcher._prefill_into_slots = self._admit

    def _admit(self, slots_idx, batch):
        with self.lock:
            lens = [len(r.prompt) for r in batch]
            before = self._flash.launches
            try:
                return self._orig(slots_idx, batch)
            finally:
                self.records.append(dict(
                    lens=lens, launches=self._flash.launches - before,
                    inside=self.inside))


class Slice:
    """Start and stop the profiler, then `read()` the slice: blocking
    calls, made through `call` on one thread of their own, since the
    profiler's session belongs to the thread that started it."""

    def __init__(self, admissions: Admissions) -> None:
        self._thread = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self.adm = admissions
        self.prof = None
        self.t0 = self.t1 = 0.0
        self.mark_wall = 0.0

    async def call(self, fn):
        return await asyncio.get_running_loop().run_in_executor(
            self._thread, fn)

    def close(self) -> None:
        self._thread.shutdown()

    def start(self) -> None:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        with self.adm.lock:
            prof.start()
            self.adm.inside = True
            self.t0 = time.time()
            with torch.profiler.record_function(MARK):
                self.mark_wall = time.time()
        self.prof = prof

    def stop(self) -> None:
        with self.adm.lock:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.t1 = time.time()
            self.adm.inside = False
            self.prof.stop()

    def read(self) -> dict:
        """Device operations [(name, start wall s, seconds)], busy seconds, the
        slice's length and the admissions inside it."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.prof = None
        mark = [e for e in events if e.get("name") == MARK
                and e.get("ph") == "X"]
        offset = (self.mark_wall - mark[0]["ts"] * 1e-6) if mark else None
        kernels = sorted(
            (e["name"], e["ts"] * 1e-6, e.get("dur", 0) * 1e-6)
            for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
        busy, end = 0.0, None
        for _, ts, dur in sorted(kernels, key=lambda k: k[1]):
            lo = ts if end is None else max(ts, end)
            if ts + dur > lo:
                busy += ts + dur - lo
            end = ts + dur if end is None else max(end, ts + dur)
        return dict(
            window_s=self.t1 - self.t0, busy_s=busy,
            kernels=[(n, ts + offset if offset is not None else None, d)
                     for n, ts, d in sorted(kernels, key=lambda k: k[1])],
            admissions=[a for a in self.adm.records if a["inside"]],
            t0=self.t0, t1=self.t1)


def device_ops(trace: dict, top: int = 10) -> list:
    """The kernels that took most device time: [[name, seconds], ...]."""
    tot: dict = {}
    for name, _, dur in trace["kernels"]:
        tot[name] = tot.get(name, 0.0) + dur
    return [[n[:200], s] for n, s in
            sorted(tot.items(), key=lambda x: -x[1])[:top]]


def _phase_at(t: float, ticks: list[dict]) -> str:
    """What the batcher was doing at wall time t, by its tick records:
    a tick's admit phase runs up to its dispatch mark `t_wall`, then
    sync, dispatch, wait and host follow in order."""
    for tick in ticks:
        start = tick["t_wall"] - tick["phase_admit_ms"] * 1e-3
        if start <= t < tick["t_wall"]:
            return "tick admit"
        mark = tick["t_wall"]
        for phase in ("sync", "dispatch", "wait", "host"):
            nxt = mark + tick[f"phase_{phase}_ms"] * 1e-3
            if mark <= t < nxt:
                return f"tick {phase}"
            mark = nxt
    return "between ticks"


def idle_gaps(trace: dict, ticks: list[dict], top: int = 10) -> list:
    """The longest gaps with no kernel running, each named by what the
    batcher was doing at its middle: [[name, seconds], ...]."""
    kernels = [k for k in trace["kernels"] if k[1] is not None]
    if not kernels:
        return []
    gaps, end = [], kernels[0][1] + kernels[0][2]
    for _, ts, dur in kernels[1:]:
        if ts > end:
            gaps.append((ts - end, end))
        end = max(end, ts + dur)
    near = [t for t in ticks if trace["t0"] - 5 <= t["t_wall"] <= trace["t1"]]
    out = []
    for length, at in sorted(gaps, reverse=True)[:top]:
        out.append([_phase_at(at + length / 2, near), length])
    return out
