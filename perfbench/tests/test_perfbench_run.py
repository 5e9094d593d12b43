"""Whole runs of a throwaway benchmark at the port's tiny presets on the
CPU (tiny.py), past the harness's look for a card: the result's shape, a
metric and a cell added by files alone, the float8 control judged in the
program's place and not correct, and `correct` false when the timed path
alters its tokens, in every row or in one."""

import argparse
import json

import pytest
import torch

from perfbench import run as run_mod
from perfbench.tests import tiny

SEED = 2**31 + 101


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("perfbench"))
    # A per-layer metric added by one file and one entry, no edit.
    (root / "perfbench" / "metrics" / "calls_answered.test.py").write_text(
        "from perfbench import records\n\n\n"
        "def read(run):\n"
        "    return len(records.done_in_window(run))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append(dict(
        name="calls_answered.test", unit="calls", better="higher",
        source="host_clock", layer="gateway", moves="setup_s",
        workloads=[c["name"] for c in tiny.cells()]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(root, cell, trace=0, low=None, hook=None):
    args = argparse.Namespace(workload=cell, seed=SEED, seconds=3.0,
                              trace=trace, low=low)
    return run_mod.run_cell(args, root=root, device=torch.device("cpu"),
                            sidecar_hook=hook)


@pytest.mark.parametrize("cell,trace", [
    ("tiny-mistral.tiny-open", 0), ("tiny-moe-sw.tiny-closed", 1)])
def test_a_run_is_correct(root, cell, trace):
    result, record = run(root, cell, trace)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] > 5
    assert list(result)[-1] == "checks"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wanted = {m["name"] for m in run_mod.metrics_for(bench, cell, trace)}
    assert set(result["metrics"]) <= wanted
    if trace:
        # No device on the CPU: the device trace's metrics stay out.
        assert "calls_answered.test" in result["metrics"]
        assert "flash_attn_roofline.docs" not in result["metrics"]
        assert result["metrics"]["mfu.docs"]["value"] > 0
    else:
        assert set(result["metrics"]) == wanted
        m = {k: v["value"] for k, v in result["metrics"].items()}
        assert 0 < m["call_ms_p50"] <= m["call_ms_p95"]
        assert m["setup_s"] > 0 and m["output_tokens_per_s"] > 0
    assert result["readings"]["tokens"] > 0
    limits = tiny.limits(cell)
    for key, name, _ in run_mod.LIMITS:
        if key in limits:
            assert result["checks"][name]["value"] <= limits[key]


@pytest.mark.parametrize("cell", [c["name"] for c in tiny.cells()])
def test_the_control_fails_the_limit(root, cell):
    """The float8 reference in the program's place is not correct, by
    the same checks that judge the program."""
    result, _ = run(root, cell, low="fp8")
    assert not result["correct"]
    assert result["readings"]["fp8"]["max_gap"] > (
        3 * result["readings"]["max_gap"])
    failed = [name for name, c in result["checks"].items()
              if c["value"] > c["limit"]]
    assert failed and set(failed) <= {"logit_gap", "mean_logit_gap",
                                      "clear_routing_gap"}


def _alter(rows):
    """A hook that moves by one the tokens the batcher samples for
    `rows` (a slice of the batch)."""

    def hook(sidecar):
        batcher = sidecar.batcher
        sample = batcher._sample

        def altered(*a):
            tokens, states = sample(*a)
            tokens = tokens.clone()
            tokens[rows] = (tokens[rows] + 1) % 512
            return tokens, states

        batcher._sample = altered

    return hook


def test_an_altered_token_is_not_correct(root):
    """Every sampled token moved by one where the batcher produces it."""
    result, _ = run(root, "tiny-mistral.tiny-open", hook=_alter(slice(None)))
    assert not result["correct"]
    assert result["checks"]["logit_gap"]["value"] > (
        tiny.LIMIT["max_logit_gap"])


def test_one_altered_row_fails_the_clear_routing_gap(root):
    """A MoE cell: the tokens of one row of the batch moved by one fail
    the widest gap over clearly routed tokens, whatever the mean says."""
    result, _ = run(root, "tiny-moe-sw.tiny-closed", hook=_alter(0))
    assert not result["correct"]
    check = result["checks"]["clear_routing_gap"]
    assert result["readings"]["clear_tokens"] > 0
    assert check["value"] > check["limit"]


@pytest.mark.gpu
def test_a_cell_on_the_card():
    """The first cell, short, on the card (run there with `-m gpu`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card")
    args = argparse.Namespace(workload="mistral-7b.agent-open", seed=SEED,
                              seconds=5.0, trace=0)
    result, _ = run_mod.run_cell(args)
    assert result["correct"], result["checks"]
