"""What region timing (ggrmcp_tpu_torch/utils/regions.py) costs the host,
on a CUDA card: ticks of 32 decode-shaped `attention()` calls (small
enough that their launches bound them), run on a worker thread started
before the profiler, as the batcher's executor is, under a
`torch.profiler` recording CPU and CUDA activities, as the benchmark's
slice does. Variants alternate within each of `--rounds` captures:

- off: the regions disabled;
- rf: their `record_function` ranges only (no window, no events);
- ev: their CUDA event pairs only (no `record_function`);
- full: both, as the program runs them;
- noprof: no profiler recording (the regions' one flag check).

Prints one JSON line: ms a tick of each variant and round, their
medians, the host's cost a region of rf, ev and full against off, and
the host's CPU model and core count, beside which the costs are read.

    python3 perfbench/region_cost.py [--rounds 6] [--ticks 40]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import platform
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

LAYERS = 32
MODES = ("off", "rf", "ev", "full")


def cpu_model() -> str:
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown"


def main(argv=None) -> int:
    import torch

    from ggrmcp_tpu_torch.ops import attention
    from ggrmcp_tpu_torch.utils import regions, tracing

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rounds", type=int, default=6)
    p.add_argument("--ticks", type=int, default=40)
    args = p.parse_args(argv)
    dev = torch.device("cuda")
    q = torch.randn(32, 1, 32, 128, device=dev, dtype=torch.bfloat16)
    k = torch.randn(32, 64, 8, 128, device=dev, dtype=torch.bfloat16)
    timed, open_window = regions.timed, regions.open_window
    profiler_range = tracing.profiler_range

    def setup(mode: str) -> None:
        regions.timed = timed if mode in ("rf", "ev", "full") else (
            lambda name, fn: fn)
        regions.open_window = open_window if mode in ("ev", "full") else (
            lambda names: None)
        tracing.profiler_range = (
            (lambda name: None) if mode == "ev" else profiler_range)

    def ticks() -> float:
        t0 = time.perf_counter()
        for _ in range(args.ticks):
            window = regions.open_window(("attn.decode",))
            for _ in range(LAYERS):
                attention.attention(q, k, k, causal=False)
            torch.cuda.synchronize()
            if window is not None:
                window.close({"attn.decode": dict(lengths=[64] * 32)})
        return (time.perf_counter() - t0) / args.ticks * 1e3

    pool = concurrent.futures.ThreadPoolExecutor(1)
    pool.submit(ticks).result()  # warm-up, outside any capture
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out: dict = {m: [] for m in MODES + ("noprof",)}
    for rnd in range(args.rounds):
        with torch.profiler.profile(activities=acts):
            for mode in (MODES if rnd % 2 == 0 else MODES[::-1]):
                setup(mode)
                out[mode].append(pool.submit(ticks).result())
        setup("off")
        out["noprof"].append(pool.submit(ticks).result())
    setup("full")
    med = {m: statistics.median(v) for m, v in out.items()}
    print(json.dumps(dict(
        cpu=cpu_model(), cores=os.cpu_count(),
        card=torch.cuda.get_device_name(dev), ms_per_tick=out, median=med,
        us_per_region={m: (med[m] - med["off"]) / LAYERS * 1e3
                       for m in MODES[1:]})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
