"""How long a `torch.profiler` capture holds the GIL when it stops, on a
card, while another thread launches kernels as a serving loop does.

    python scripts/profile_stop_cost.py [--seconds 3] [--out FILE]

A thread launches small matmuls without a pause (tens of thousands of
kernels a second, the rate of a busy llama3-8b decode loop); the main
thread runs a capture of `--seconds` under each configuration below and
exports its Chrome trace, while a watchdog thread that wakes every 10 ms
records its longest wake-up delay: the longest time no other Python
thread could run (a gRPC health probe of the same process waits as
long). Each configuration prints one JSON line: the kernels in the
trace, the seconds the profiler's stop and the export took, and the
watchdog's longest delay during each. Needs a CUDA card; prints the
card's name and power limit first.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import torch


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


class _Watchdog:
    """The longest delay past a 10 ms sleep since the last `reset`."""

    def __init__(self):
        self.worst = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        last = time.perf_counter()
        while not self._stop.is_set():
            time.sleep(0.01)
            now = time.perf_counter()
            self.worst = max(self.worst, now - last - 0.01)
            last = now

    def reset(self) -> None:
        time.sleep(0.05)
        self.worst = 0.0

    def close(self) -> None:
        self._stop.set()
        self._thread.join()


def _storm(stop: threading.Event) -> None:
    x = torch.randn(256, 256, device="cuda")
    while not stop.is_set():
        for _ in range(64):
            x = torch.tanh(x @ x)
        torch.cuda.synchronize()


def _kernels(path: str) -> int:
    with open(path, "rb") as fh:
        return len(re.findall(rb'"cat"\s*:\s*"kernel"', fh.read()))


CONFIGS = {
    "cpu+cuda": dict(cpu=True),
    "cuda": dict(cpu=False),
    "cpu+cuda, trace_only": dict(cpu=True, trace_only=True),
    "cpu+cuda, no external correlation": dict(
        cpu=True, disable_external_correlation=True),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_stop_cost: no CUDA device", file=sys.stderr)
        return 2
    print(_card(), flush=True)
    stop = threading.Event()
    storm = threading.Thread(target=_storm, args=(stop,), daemon=True)
    storm.start()
    dog = _Watchdog()
    rows = []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for name, opts in CONFIGS.items():
                extra = {k: v for k, v in opts.items() if k != "cpu"}
                try:
                    config = torch._C._profiler._ExperimentalConfig(**extra)
                except TypeError as exc:
                    rows.append(dict(config=name, unsupported=str(exc)))
                    print(json.dumps(rows[-1]), flush=True)
                    continue
                acts = [torch.profiler.ProfilerActivity.CUDA]
                if opts["cpu"]:
                    acts.append(torch.profiler.ProfilerActivity.CPU)
                prof = torch.profiler.profile(activities=acts,
                                              experimental_config=config)
                prof.__enter__()
                time.sleep(args.seconds)
                dog.reset()
                t = time.perf_counter()
                prof.__exit__(None, None, None)
                stop_s, stop_gap = time.perf_counter() - t, dog.worst
                path = os.path.join(tmp, f"{len(rows)}.json")
                dog.reset()
                t = time.perf_counter()
                prof.export_chrome_trace(path)
                export_s, export_gap = time.perf_counter() - t, dog.worst
                rows.append(dict(
                    config=name, seconds=args.seconds,
                    kernels=_kernels(path), stop_s=stop_s,
                    stop_gil_gap_s=stop_gap, export_s=export_s,
                    export_gil_gap_s=export_gap,
                    trace_mb=os.path.getsize(path) / 1e6))
                print(json.dumps(rows[-1]), flush=True)
    finally:
        stop.set()
        storm.join()
        dog.close()
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(card=_card(), rows=rows), fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
