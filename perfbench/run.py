"""The port's benchmark: one run of one cell.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell (`BENCHMARK.json` `workloads`) names a configuration
(`configs/<config>.json`: the published sizes, and the program's
settings under "program") and a traffic mix (`workloads/<traffic>.json`,
read by traffic.py). One process makes the weights on the card from the
seed, co-launches the port's gateway and sidecar (the path of
`python -m ggrmcp_tpu_torch gateway --tpu`), and drives MCP `tools/call`
of the Generate tool from a load-generator process (loadgen.py):
warm-up calls, a lead-in of the cell's own traffic, then the measured
window of `--seconds`. After the window it reads the flight recorder
(GetFlightRecord), the peak memory, and with `--trace 1` a short profiled
slice (devtrace.py); then it stops the program and judges the answers
against the plain reference (judge.py, reference/). The last line of
standard output is the result; the numbers compared, each beside its
limit, end standard error and the result.

Metrics are files too: `metrics/<name>.py`, each a `read(run)` that
returns a number or None (nothing to read: the metric is left out).
`--trace 0` reports the cell's end-to-end metrics, `--trace 1` its
per-layer ones.
"""

import time

T0_WALL = time.time()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import copy  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import urllib.request  # noqa: E402
from pathlib import Path  # noqa: E402

# Neither JAX nor the JAX package may load in a run's processes.
BLOCKED = ("jax", "jaxlib", "flax", "ggrmcp_tpu")
for _name in BLOCKED:
    sys.modules[_name] = None  # type: ignore[assignment]
# A library that would load JAX by itself is told not to.
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "perfbench"
sys.path.insert(0, str(ROOT))
# Every build and kernel cache at a fixed path inside the checkout.
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")

GENERATE_TOOL = "ggrmcp_tpu_generateservice_generate"
DRAIN_S = 60.0


class Refused(Exception):
    """A run that cannot be made: exit non-zero, print no result."""


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def load_bench(path: Path) -> dict:
    try:
        with open(path) as fh:
            return json.load(fh)
    except FileNotFoundError:
        raise Refused(f"no {path}") from None


def find_cell(bench: dict, name: str) -> tuple[dict, dict]:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"unknown workload {name!r}; cells: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return cell, configs[cell["config"]]


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (an entry without `workloads`, such
    as `setup_s`, is every cell's) or, with `trace`, its per-layer ones
    (every entry lists its cells)."""
    if not trace:
        return [m for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell])]
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


def reader(root: Path, name: str):
    """`metrics/<name>.py`'s `read`; a metric split by the cells it is
    read in (`<stem>.<cells>`) may share `metrics/<stem>.py` instead."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    if not path.exists():
        path = path.with_name(f"{name.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def register(cfg: dict):
    """The port's model config for `cfg`: its preset (`port.preset`),
    checked against the file's published sizes, at the file's depth and
    with `port.overrides`, registered under the file's name."""
    from ggrmcp_tpu_torch.models import llama, moe

    from perfbench import model as model_mod

    m = model_mod.shape(cfg)
    registry = moe.CONFIGS if m["family"] == "moe" else llama.CONFIGS
    preset = registry[cfg["port"]["preset"]]
    want = dict(hidden_dim=m["hidden"], num_heads=m["heads"],
                num_kv_heads=m["kv_heads"], head_dim=m["head_dim"],
                ffn_dim=m["ffn"], vocab_size=m["vocab"],
                rope_theta=m["rope_theta"], sliding_window=m["window"],
                norm_eps=m["norm_eps"])
    if m["family"] == "moe":
        want.update(num_experts=m["experts"],
                    experts_per_token=m["experts_per_token"])
    wrong = {k: (getattr(preset, k), v) for k, v in want.items()
             if getattr(preset, k) != v}
    if wrong:
        raise Refused(f"{cfg['name']}: preset {preset.name} differs from "
                      f"the file: {wrong}")
    port_cfg = dataclasses.replace(
        preset, name=cfg["name"], num_layers=m["layers"], dtype=m["dtype"],
        **cfg["port"].get("overrides", {}))
    registry[cfg["name"]] = port_cfg
    return m, port_cfg


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http(port: int, method: str, params=None, timeout: float = 30.0):
    body = {"jsonrpc": "2.0", "method": method, "id": 1}
    if params is not None:
        body["params"] = params
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


async def discovered(port: int, timeout_s: float = 120.0) -> None:
    """Until the gateway lists the Generate tool."""
    deadline = time.time() + timeout_s
    while True:
        try:
            res = await asyncio.to_thread(http, port, "tools/list")
            names = {t["name"] for t in res.get("result", {}).get("tools", [])}
            if GENERATE_TOOL in names:
                return
        except OSError:
            pass
        if time.time() > deadline:
            raise RuntimeError("the gateway never listed the Generate tool")
        await asyncio.sleep(0.2)


async def flight_record(target: str) -> tuple[list, list]:
    import grpc.aio

    from ggrmcp_tpu_torch.rpc.pb import serving_pb2

    from perfbench import records

    opts = [("grpc.max_receive_message_length", 1 << 30)]
    async with grpc.aio.insecure_channel(target, options=opts) as ch:
        call = ch.unary_unary(
            "/ggrmcp.tpu.DebugService/GetFlightRecord",
            request_serializer=serving_pb2.FlightRecordRequest.SerializeToString,
            response_deserializer=serving_pb2.FlightRecordResponse.FromString)
        resp = await call(serving_pb2.FlightRecordRequest(
            max_ticks=1 << 30, max_requests=1 << 30), timeout=120)
    return ([records.tick_dict(t) for t in resp.ticks],
            [records.request_dict(r) for r in resp.requests])


def warmup_calls(spec: dict) -> list:
    return [[w["prompt_tokens"], w["max_new"]]
            for w in spec["warmup"] for _ in range(w["count"])]


async def drive(args, cfg: dict, spec: dict, m: dict, device,
                sidecar_hook=None) -> dict:
    """Start the program, run the traffic, read the records, stop the
    program. Returns the run record (records.py)."""
    import torch

    from ggrmcp_tpu_torch.core.config import config_from_dict
    from ggrmcp_tpu_torch.ops import attention as attention_mod
    from ggrmcp_tpu_torch.serving import launcher
    from ggrmcp_tpu_torch.serving.sidecar import Sidecar

    from perfbench import devtrace, model as model_mod

    prog = config_from_dict(copy.deepcopy(cfg["program"]))
    prog.serving = dataclasses.replace(prog.serving, model=cfg["name"])
    prog.server.port = port = free_port()
    launcher.resolve_colaunch_transport(prog)
    # Held here for the supervisor's restarts, dropped once the program
    # stops, so that the reference's draw finds the card free.
    held = dict(weights=model_mod.make_weights(m, args.seed, device))

    def factory():
        sidecar = Sidecar(prog.serving, params=held["weights"],
                          seed=args.seed, device=device)
        if sidecar_hook is not None:
            sidecar_hook(sidecar)
        return sidecar

    co = launcher.Colaunch(prog, sidecar_factory=factory, device=device,
                           seed=args.seed)
    proc = None
    try:
        await co.start()
        await discovered(port)
        slicer = None
        if args.trace:
            slicer = devtrace.Slice(devtrace.Admissions(
                co.sidecar.batcher, attention_mod.flash_attention))
        slice_s = float(spec["trace_slice_s"]) if args.trace else 0.0
        job = dict(url=f"http://127.0.0.1:{port}", tool=GENERATE_TOOL,
                   seed=args.seed, vocab=m["vocab"], traffic=spec,
                   seconds=args.seconds,
                   extra_s=slice_s + 1.0 if args.trace else 0.0,
                   drain_s=DRAIN_S, warmup=warmup_calls(spec))
        proc = await asyncio.create_subprocess_exec(
            sys.executable, str(HERE / "loadgen.py"),
            stdin=asyncio.subprocess.PIPE, stdout=asyncio.subprocess.PIPE,
            limit=1 << 28)
        proc.stdin.write(json.dumps(job).encode() + b"\n")
        await proc.stdin.drain()
        proc.stdin.close()
        line = await proc.stdout.readline()
        if not line:
            raise RuntimeError("the load generator ended before its window")
        marks = json.loads(line)
        if torch.cuda.is_available() and device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        trace = None
        if slicer is not None:
            await asyncio.sleep(max(0.0, marks["w1"] - time.time()))
            await slicer.call(slicer.start)
            await asyncio.sleep(slice_s)
            await slicer.call(slicer.stop)
        done = json.loads(await proc.stdout.readline())
        await proc.wait()
        proc = None
        if slicer is not None:
            trace = await slicer.call(slicer.read)
            slicer.close()
        ticks, requests = await flight_record(co.target)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
    finally:
        if proc is not None and proc.returncode is None:
            proc.kill()
            await proc.wait()
        await co.stop()
        held.clear()
    return dict(calls=done["calls"], w0=done["w0"], w1=done["w1"],
                seconds=float(args.seconds), setup_s=done["w0"] - T0_WALL,
                given_up=done["t_end"] + DRAIN_S, loop=spec["loop"],
                ticks=ticks, requests=requests, m=m, seed=args.seed,
                trace=trace, memory_peak_bytes=int(peak),
                pool=dict(slots=prog.serving.batching.max_batch_size,
                          positions=prog.serving.batching.kv_cache_max_seq))


# A limit's key in a cell's limits file, the check's name, and the
# reading (judge.numbers) it holds at or below the limit.
LIMITS = (("max_logit_gap", "logit_gap", "max_gap"),
          ("max_mean_gap", "mean_logit_gap", "mean_gap"),
          ("max_clear_gap", "clear_routing_gap", "clear_max_gap"))


def judge_run(run: dict, cfg_limits: dict, spec: dict, device,
              low: str | None = None) -> tuple[bool, dict, dict, list]:
    """(correct, the numbers compared {name: {value, limit}}, readings,
    the per-token gaps). With `low` ("fp8", the control; "bf16", a
    witness) the reference at that precision is judged in the
    program's place."""
    from perfbench import judge, model as model_mod, records

    due = records.due_in_window(run)
    unanswered = [c for c in due if c["done"] is None or not c["ok"]]
    malformed = [c for c in due if c["ok"] and judge.well_formed(c)]
    for c in (unanswered + malformed)[:5]:
        log(f"call {c['index']}: {c.get('err') or judge.well_formed(c)}")
    answered = [c for c in due if c["ok"] and not judge.well_formed(c)]
    j = spec["judge"]
    sample = judge.pick(answered, run["seed"], j["min_tokens"], j["max_calls"])
    per_token: list = []
    if sample:
        weights = model_mod.make_weights(run["m"], run["seed"], device)
        per_token = judge.gaps(run["m"], weights, sample, run["seed"], low)
        del weights
    clear = float(cfg_limits.get("clear_margin", "inf"))
    readings = dict(judge.numbers(per_token, 0, clear), calls=len(sample))
    judged = readings
    if low is not None:
        judged = readings[low] = judge.numbers(per_token, 2, clear)
    # Each number is held at or below its limit; the cell's limits file
    # names the numbers it is judged on (limits/README.md).
    checks = {
        "unanswered_calls": dict(value=len(unanswered), limit=0),
        "malformed_answers": dict(value=len(malformed), limit=0),
    }
    for key, name, reading in LIMITS:
        if key in cfg_limits:
            checks[name] = dict(value=judged[reading], limit=cfg_limits[key])
    correct = bool(due) and judged["tokens"] > 0 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    return correct, checks, readings, per_token


def card_check(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise Refused("no CUDA device: the benchmark measures the card")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell asks for {chips} cards, "
                      f"{torch.cuda.device_count()} present")
    return torch.device("cuda:0")


def jax_loaded() -> list[str]:
    return sorted(n for n, mod in sys.modules.items()
                  if mod is not None and n.split(".")[0] in BLOCKED)


def run_cell(args, root: Path = ROOT, device=None, sidecar_hook=None,
             traffic_override=None) -> tuple[dict, dict]:
    """One run; returns the result object (the last line's) and the run
    record (records.py). `root` holds
    BENCHMARK.json and the data under perfbench/. `device` None asks for
    the card; tests pass the CPU, and `sidecar_hook` sees the sidecar
    before it starts. `traffic_override` replaces keys of the traffic
    file (calibrate.py's rate sweep)."""
    import torch

    from perfbench import devtrace, model as model_mod, records, traffic

    bench = load_bench(root / "BENCHMARK.json")
    cell, centry = find_cell(bench, args.workload)
    if device is None:
        device = card_check(int(cell["chips"]))
    cfg = model_mod.load(root / centry["file"])
    spec = traffic.load(root / "perfbench" / "workloads"
                        / f"{cell['traffic']}.json")
    spec.update(traffic_override or {})
    with open(root / "perfbench" / "limits" / f"{cell['name']}.json") as fh:
        limits = json.load(fh)
    m, _ = register(cfg)
    chosen = metrics_for(bench, cell["name"], bool(args.trace))
    run = asyncio.run(drive(args, cfg, spec, m, device, sidecar_hook))
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    values = {}
    for metric in chosen:
        value = reader(root, metric["name"])(run)
        if value is not None:
            values[metric["name"]] = dict(value=float(value),
                                          unit=metric["unit"])
    correct, checks, readings, per_token = judge_run(
        run, limits, spec, device, getattr(args, "low", None))
    due = len(records.due_in_window(run))
    result = dict(
        correct=bool(correct), attempted=due,
        failed=checks["unanswered_calls"]["value"], metrics=values,
        device=dict(
            platform="gpu" if device.type == "cuda" else device.type,
            kind=(torch.cuda.get_device_name(device)
                  if device.type == "cuda" else "cpu"),
            count=1, memory_peak_bytes=run["memory_peak_bytes"]))
    if run["trace"] is not None:
        result["device"].update(busy_s=run["trace"]["busy_s"],
                                window_s=run["trace"]["window_s"])
        result["breakdown"] = dict(
            device_ops=devtrace.device_ops(run["trace"]),
            idle_gaps=devtrace.idle_gaps(run["trace"], run["ticks"]))
    run["per_token"] = per_token
    result["readings"] = readings
    result["checks"] = checks
    return result, run


def power_limit() -> str:
    """The card's name and power limit, for the log beside the numbers."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        result, _ = run_cell(args)
    except Refused as exc:
        log(f"refused: {exc}")
        return 2
    found = jax_loaded()
    if found:
        log(f"JAX or the JAX package was loaded: {found}")
        return 4
    log(f"card: {power_limit()}")
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
