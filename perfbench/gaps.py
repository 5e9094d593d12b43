"""One traced run of a cell, and what its spans say of the profiled
slice: the result line (as `run.py` prints it) on stdout, then a JSON
record of the slice's device idle gaps of 1 ms or more named by the
innermost program span or tick phase (`spans.idle_gaps`), the slice's
tick medians, the span counts, and the medians of the gateway-sidecar
hop's parts over the window's calls.

    python3 perfbench/gaps.py --workload W --seed N [--seconds 51]
        [--no-regions]

`--no-regions` turns the device regions (`attn.decode`, `moe.ffn`) off
in process, so that two runs of one seed measure what region timing
costs the slice and moves in its other metrics.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench import records, run as run_mod, spans, yardstick  # noqa: E402


def slice_summary(run: dict) -> dict:
    """The slice's ticks (their median less the admit phase, and the
    median dispatch phase) and the spans of each name that start in it."""
    trace = run["trace"]
    ticks = [t for t in run["ticks"] if trace["t0"] <= t["t_wall"] < trace["t1"]]
    counts: dict = {}
    for s in spans.since(trace["t0"]) or []:
        if s["start"] < trace["t1"]:
            counts[s["name"]] = counts.get(s["name"], 0) + 1
    return dict(
        slice_ticks=len(ticks),
        slice_tick_ms_p50=yardstick.median(
            t["duration_ms"] - t["phase_admit_ms"] for t in ticks),
        slice_dispatch_ms_p50=yardstick.median(
            t["phase_dispatch_ms"] for t in ticks),
        slice_span_counts=counts)


def hop_split(run: dict) -> dict:
    """Medians over the window's calls: `gateway.http` less
    `gateway.invoke` (the gateway itself), `gateway.invoke` less
    `sidecar.generate` (the gRPC client, the socket and the gRPC server,
    both ways), and `sidecar.generate` less the record's `e2e_ms` (the
    sidecar's handler outside the batcher)."""
    names = ("gateway.http", "gateway.invoke", "sidecar.generate")
    calls = spans.window_calls(run, *names)
    if not calls:
        return {}
    by = records.requests_by_trace(run)
    full = {t: c for t, c in calls.items() if len(c) == 3 and t in by}
    return dict(
        gateway_self_ms_p50=yardstick.median(
            c["gateway.http"]["ms"] - c["gateway.invoke"]["ms"]
            for c in full.values()),
        hop_grpc_ms_p50=yardstick.median(
            c["gateway.invoke"]["ms"] - c["sidecar.generate"]["ms"]
            for c in full.values()),
        hop_handler_ms_p50=yardstick.median(
            c["sidecar.generate"]["ms"] - by[t]["e2e_ms"]
            for t, c in full.items()))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51)
    p.add_argument("--no-regions", action="store_true")
    args = p.parse_args(argv)
    args.trace = 1
    if args.no_regions:
        from ggrmcp_tpu_torch.utils import regions
        regions.timed = lambda name, fn: fn
        regions.open_window = lambda names: None
    t0 = time.time()
    result, run = run_mod.run_cell(args)
    print(json.dumps(result), flush=True)
    out = dict(cell=args.workload, seed=args.seed,
               no_regions=args.no_regions, wall_s=time.time() - t0,
               card=run_mod.power_limit(), correct=result["correct"],
               metrics={k: v["value"] for k, v in result["metrics"].items()},
               busy_s=run["trace"]["busy_s"],
               window_s=run["trace"]["window_s"],
               idle_gaps=spans.idle_gaps(run))
    out.update(slice_summary(run))
    out.update(hop_split(run))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
