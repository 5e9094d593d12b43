"""BENCHMARK.json against the contract's shape, every file it names found
by name, and the imports of the benchmark's modules: none of JAX or the
JAX package anywhere, nothing of the program in the reference, and the
standard library alone in the load generator and the traffic generator."""

import ast
import json
import re
import sys
from pathlib import Path

import pytest

from perfbench import run as run_mod

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def top_imports(path: Path) -> set[str]:
    """The top-level name (before the first dot) of every import."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


MODULES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax(path):
    assert not top_imports(path) & {"jax", "jaxlib", "flax", "ggrmcp_tpu"}


def test_the_whole_name_is_compared():
    mod = ast.parse("import ggrmcp_tpu_torch.models\nfrom ggrmcp_tpu.x import y")
    names = {n.names[0].name.split(".")[0] if isinstance(n, ast.Import)
             else n.module.split(".")[0] for n in mod.body}
    assert names == {"ggrmcp_tpu_torch", "ggrmcp_tpu"}
    assert "ggrmcp_tpu_torch" not in {"jax", "jaxlib", "flax", "ggrmcp_tpu"}


@pytest.mark.parametrize("name", ["loadgen.py", "traffic.py"])
def test_generators_take_the_standard_library_alone(name):
    assert top_imports(HERE / name) <= set(sys.stdlib_module_names) | {
        "perfbench"}
    # Within the benchmark, only the traffic generator.
    src = (HERE / name).read_text()
    assert set(re.findall(r"from perfbench import (\w+)", src)) <= {"traffic"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    assert "ggrmcp_tpu_torch" not in top_imports(path)
    src = path.read_text()
    assert set(re.findall(r"from perfbench import (\w+)", src)) <= {"model"}


def test_benchmark_shape():
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    assert set(BENCH) == keys
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in {
            "host_clock", "device_trace"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    cells = {w["name"]: w for w in BENCH["workloads"]}
    pairs = {(w["config"], w["traffic"]) for w in cells.values()}
    assert len(pairs) == len(cells)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["workloads"] and set(m["workloads"]) <= set(cells)
        for w in m["workloads"]:
            reported = run_mod.metrics_for(BENCH, w, False)
            assert m["moves"] in {x["name"] for x in reported}, (m, w)
    for w in cells.values():
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        e2e_of = {x["name"] for x in run_mod.metrics_for(BENCH, w["name"],
                                                         False)}
        assert "setup_s" in e2e_of and len(e2e_of) >= 2
        assert run_mod.metrics_for(BENCH, w["name"], True)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_file_is_found_by_name(cell):
    w, centry = run_mod.find_cell(BENCH, cell)
    cfg = json.loads((ROOT / centry["file"]).read_text())
    assert cfg["name"] == centry["name"] and cfg["source"] == centry["source"]
    assert sorted(cfg["reduced"]) == sorted(centry["reduced"])
    assert (HERE / "workloads" / f"{w['traffic']}.json").exists()
    limits = json.loads((HERE / "limits" / f"{cell}.json").read_text())
    held = {key for key, _, _ in run_mod.LIMITS} & set(limits)
    assert held and all(limits[k] > 0 for k in held)
    assert ("max_clear_gap" in limits) == ("clear_margin" in limits)
    for trace in (False, True):
        for metric in run_mod.metrics_for(BENCH, cell, trace):
            assert callable(run_mod.reader(ROOT, metric["name"]))


def test_configs_keep_every_width():
    widths = ("hidden_size", "intermediate_size", "num_attention_heads",
              "num_key_value_heads", "num_experts_per_tok", "vocab_size")
    for entry in BENCH["configs"]:
        assert not set(entry["reduced"]) & set(widths)
        cfg = json.loads((ROOT / entry["file"]).read_text())
        assert cfg["hidden_size"] == 4096 and cfg["intermediate_size"] == 14336
        assert cfg["num_attention_heads"] == 32
        assert cfg["num_key_value_heads"] == 8 and cfg["vocab_size"] == 32000
