"""A throwaway benchmark at the port's tiny presets, for the CPU tests:
a root that holds its own BENCHMARK.json and, under perfbench/, a copy
of the benchmark's data and metric files plus new files for the tiny
configurations, traffic and limits. Nothing of the repository's files is
edited: a cell is added by files and entries alone."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

PROGRAM = {
    "serving": {
        "batching": {"max_batch_size": 4, "kv_cache_max_seq": 256,
                     "prefill_chunk": 32},
        "observability": {"tick_ring": 16384, "request_ring": 8192},
    },
    "server": {"request_timeout_s": 300, "rate_limit": {"enabled": False}},
    "grpc": {"call_timeout_s": 300},
}

CONFIGS = {
    "tiny-mistral": dict(
        family="llama", hidden_size=256, intermediate_size=704,
        num_attention_heads=8, num_hidden_layers=4, num_key_value_heads=4,
        rms_norm_eps=1e-5, rope_theta=10000.0, sliding_window=16,
        torch_dtype="float32", vocab_size=512,
        port={"preset": "tiny-mistral"}),
    "tiny-moe-sw": dict(
        family="moe", hidden_size=256, intermediate_size=512,
        num_attention_heads=8, num_hidden_layers=2, num_key_value_heads=4,
        num_local_experts=4, num_experts_per_tok=2, rms_norm_eps=1e-5,
        rope_theta=10000.0, sliding_window=16, torch_dtype="float32",
        vocab_size=512,
        port={"preset": "tiny-moe-sw", "overrides": {"capacity_factor": 2.0}}),
}

TRAFFIC = {
    "tiny-open": dict(
        loop="open", rate_per_s=6.0,
        prompt_tokens=dict(dist="loguniform", min=8, max=80),
        output_tokens=dict(dist="uniform", min=4, max=12),
        lead_s=1.0, trace_slice_s=0.5,
        warmup=[dict(count=4, prompt_tokens=80, max_new=2)],
        judge=dict(min_tokens=40, max_calls=6)),
    "tiny-closed": dict(
        loop="closed", clients=6,
        prompt_tokens=dict(dist="uniform", min=40, max=100),
        output_tokens=dict(dist="uniform", min=2, max=6),
        lead_s=1.0, trace_slice_s=0.5,
        warmup=[dict(count=4, prompt_tokens=100, max_new=2)],
        judge=dict(min_tokens=20, max_calls=6)),
}

# float32 on both sides: rounding alone. The MoE cell is judged as
# mixtral's is: the mean gap and the widest over clearly routed tokens.
LIMIT = {"max_logit_gap": 1e-3}
MOE_LIMIT = {"max_mean_gap": 1e-3, "clear_margin": 0.05,
             "max_clear_gap": 1e-3}


def limits(cell: str) -> dict:
    return MOE_LIMIT if cell.startswith("tiny-moe") else LIMIT


def cells() -> list[dict]:
    return [
        dict(name="tiny-mistral.tiny-open", config="tiny-mistral",
             traffic="tiny-open", chips=1, why="open loop, dense"),
        dict(name="tiny-moe-sw.tiny-closed", config="tiny-moe-sw",
             traffic="tiny-closed", chips=1, why="closed loop, experts"),
    ]


def make_root(tmp: Path) -> Path:
    """The throwaway benchmark's root under `tmp`."""
    root = tmp / "bench"
    data = root / "perfbench"
    for sub in ("configs", "workloads", "limits", "metrics"):
        shutil.copytree(HERE / sub, data / sub)
    for name, cfg in CONFIGS.items():
        (data / "configs" / f"{name}.json").write_text(
            json.dumps(dict(name=name, program=PROGRAM, **cfg)))
    for name, spec in TRAFFIC.items():
        (data / "workloads" / f"{name}.json").write_text(json.dumps(spec))
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["configs"] = [
        dict(name=n, source="test", file=f"perfbench/configs/{n}.json",
             reduced=[], why="test") for n in CONFIGS]
    bench["workloads"] = cells()
    names = [c["name"] for c in cells()]
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in metric:
            open_metric = any("agent-open" in w for w in metric["workloads"])
            metric["workloads"] = [names[0] if open_metric else names[1]]
    for cell in names:
        (data / "limits" / f"{cell}.json").write_text(
            json.dumps(limits(cell)))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
