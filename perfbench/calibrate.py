"""Readings that a cell's limits and rate are set from, on the card, in
one process: not part of the benchmark's runs.

    python3 perfbench/calibrate.py --workload W --seeds 1,2,3,4 \
            --control 1,2 --witness 3
        the program's readings (judge.numbers) on each seed and, on the
        `--control` seeds, the float8 reference's (the control) judged
        in the program's place, on the `--witness` seeds the bfloat16
        reference's, each from a run of `--seconds` at the cell's own
        load;
    python3 perfbench/calibrate.py --workload W --seeds 1 --rates 3,4,5
        an open-loop cell at each offered rate: calls answered against
        calls due, and whether latency grows across the window.

One JSON line a run on standard output.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import records, run as run_mod, yardstick  # noqa: E402


def backlog(run: dict) -> dict:
    """Offered against answered, and the latency of the window's last
    third against its first."""
    due = sorted(records.due_in_window(run), key=lambda c: c["due"])
    third = max(1, len(due) // 3)
    first = [records.call_ms(run, c) for c in due[:third]]
    last = [records.call_ms(run, c) for c in due[-third:]]
    return dict(
        due=len(due), answered_in_window=len(records.done_in_window(run)),
        p50_first_third_ms=yardstick.median(first),
        p50_last_third_ms=yardstick.median(last),
        p50_ms=yardstick.nearest_rank([records.call_ms(run, c)
                                       for c in due], 0.5),
        p95_ms=yardstick.nearest_rank([records.call_ms(run, c)
                                       for c in due], 0.95))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="")
    p.add_argument("--witness", default="")
    p.add_argument("--rates", default="")
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--out", default="",
                   help="a directory for each run's per-token readings")
    a = p.parse_args()
    seeds = [int(s) for s in a.seeds.split(",")]
    low = {int(s): "fp8" for s in a.control.split(",") if s}
    low.update({int(s): "bf16" for s in a.witness.split(",") if s})
    rates = [float(r) for r in a.rates.split(",") if r] or [None]
    for rate in rates:
        for seed in seeds:
            args = argparse.Namespace(workload=a.workload, seed=seed,
                                      seconds=a.seconds, trace=0,
                                      low=low.get(seed))
            res, run = run_mod.run_cell(args, traffic_override=(
                {"rate_per_s": rate} if rate is not None else None))
            line = dict(workload=a.workload, seed=seed, rate=rate,
                        low=low.get(seed), correct=res["correct"],
                        failed=res["failed"], checks=res["checks"],
                        readings=res["readings"],
                        metrics={k: v["value"]
                                 for k, v in res["metrics"].items()},
                        memory_peak_bytes=res["device"]["memory_peak_bytes"])
            if rate is not None:
                line["backlog"] = backlog(run)
            if a.out:
                out = Path(a.out)
                out.mkdir(parents=True, exist_ok=True)
                (out / f"{a.workload}.{seed}.{rate}.json").write_text(
                    json.dumps(dict(line, per_token=run["per_token"])))
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
