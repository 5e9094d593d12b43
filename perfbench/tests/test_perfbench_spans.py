"""The readers of the program's spans (perfbench/spans.py and the metrics
decode_attn_roofline, moe_ffn_roofline, loop_turn_ms, gateway_self_ms.p50
and rpc_hop_ms.p50) on a synthetic run over a synthetic span ring:
hand-computed values, None where the ring dropped spans of the stretch
read, the slice's idle gaps named by the innermost span, and the other
readers unmoved by the spans. Then one tiny run on
the CPU: its new metrics reported, and the batcher's `batcher.admit`
spans against the benchmark's own wrapper of the admissions."""

import argparse
import json

import pytest
import torch

from ggrmcp_tpu_torch.ops import attention as attention_mod
from ggrmcp_tpu_torch.utils import tracing
from perfbench import run as run_mod
from perfbench import spans, traffic, yardstick
from perfbench.tests import tiny

ROOT = run_mod.ROOT
SEED = 2**31 + 7
NEW = ("decode_attn_roofline", "moe_ffn_roofline", "loop_turn_ms.calls",
       "loop_turn_ms.docs", "gateway_self_ms.p50", "rpc_hop_ms.p50")
M = dict(family="moe", hidden=4, ffn=8, layers=2, heads=4, kv_heads=2,
         head_dim=2, window=None, experts=4, experts_per_token=2, vocab=16)


def _read(name: str, run: dict):
    return run_mod.reader(ROOT, name)(run)


def _tid(i: int) -> str:
    return traffic.trace_id(SEED, i)


def synthetic_run() -> dict:
    """Three calls due in the window [10, 20), one after it; a tick; a
    profiled slice [25, 27) with one admission and one B1 kernel."""
    calls = [dict(index=i, due=10.0 + i, sent=10.0 + i, done=10.5 + i,
                  ok=True, tokens=[5, 6], prompt_len=4, err=None)
             for i in range(3)]
    calls.append(dict(index=3, due=30.0, sent=30.0, done=30.5, ok=True,
                      tokens=[5], prompt_len=4, err=None))
    requests = [dict(trace_id=_tid(i), t_submit=10.01 + i, queue_ms=1.0,
                     ttft_ms=2.0, e2e_ms=400.0 + 2 * i, prompt_tokens=4,
                     first_tick=1) for i in range(4)]
    ticks = [dict(seq=1, t_wall=11.0, duration_ms=50.0, phase_admit_ms=5.0,
                  phase_sync_ms=1.0, phase_dispatch_ms=30.0,
                  phase_wait_ms=10.0, phase_host_ms=4.0,
                  trace_ids=[_tid(0), _tid(1)])]
    trace = dict(t0=25.0, t1=27.0, window_s=2.0, busy_s=1.5,
                 kernels=[("flash_fwd_x", 25.1, 0.001)],
                 admissions=[dict(lens=[4], launches=1, inside=True)])
    return dict(calls=calls, w0=10.0, w1=20.0, seconds=10.0, setup_s=5.0,
                given_up=90.0, loop="open", ticks=ticks, requests=requests,
                m=M, seed=SEED, trace=trace, memory_peak_bytes=0,
                pool=dict(slots=4, positions=64))


def fill(ring) -> None:
    """The spans the program would keep for synthetic_run."""
    for i in range(3):
        http = ring.record("gateway.http", 10.001 + i, 450.0, _tid(i),
                           method="tools/call")
        ring.record("gateway.invoke", 10.002 + i, 420.0 + i, _tid(i),
                    http.span_id, tool="t", target="x")
    turns = [(11.0, 5.0, [("batcher.yield", 0.1), ("batcher.admit", 3.0)]),
             (12.0, 4.0, [("batcher.yield", 0.2)]),
             (13.0, 100.0, [("batcher.wait_work", 90.0)]),
             (21.0, 7.0, [])]
    for start, ms, kids in turns:
        turn = ring.record("batcher.turn", start, ms, after_tick=1)
        for name, kid_ms in kids:
            ring.record(name, start + 0.0001, kid_ms, parent_id=turn.span_id)
    ring.record("attn.decode", 25.5, 3.0, device_ms=2.0, layers=2,
                lengths=[10, 20])
    ring.record("attn.decode", 28.0, 3.0, device_ms=9.0, layers=2,
                lengths=[10])
    ring.record("moe.ffn", 25.6, 2.0, device_ms=1.0, layers=2, tokens=3,
                pairs=12)


@pytest.fixture
def ring(monkeypatch):
    ring = tracing.Tracer(capacity=1000)
    monkeypatch.setattr(tracing, "tracer", ring)
    return ring


def test_readers_on_a_synthetic_ring(ring):
    fill(ring)
    run = synthetic_run()
    # K and V of rows of 10 and 20 positions: 2 B x 2 x n x 2 heads x 2
    # dims x 2 layers, over 3.35 TB/s, over 2 ms.
    kv = 2 * 2 * (10 + 20) * 2 * 2 * 2
    assert kv == yardstick.kv_bytes(M, 10) + yardstick.kv_bytes(M, 20)
    assert _read("decode_attn_roofline", run) == pytest.approx(
        100 * kv / 3.35e12 / 2e-3)
    # Two layers' experts read once (2 B x 3 x 4 x 8 x 4 experts each)
    # outweigh 12 pairs' 6 x 4 x 8 FLOPs; over 1 ms.
    assert 2 * 2 * 3 * 4 * 8 * 4 / 3.35e12 > 12 * 6 * 4 * 8 / 989e12
    assert _read("moe_ffn_roofline", run) == pytest.approx(
        100 * (2 * 2 * 3 * 4 * 8 * 4 / 3.35e12) / 1e-3)
    # Turns in the window with no wait: 5 - 3 (its admission) and 4.
    assert _read("loop_turn_ms.calls", run) == pytest.approx(3.0)
    assert _read("loop_turn_ms.docs", run) == pytest.approx(3.0)
    # 450 - (420 + i) for i = 0..2; (420 + i) - (400 + 2i).
    assert _read("gateway_self_ms.p50", run) == pytest.approx(29.0)
    assert _read("rpc_hop_ms.p50", run) == pytest.approx(19.0)


def test_a_dropped_stretch_reads_nothing(ring, monkeypatch):
    run = synthetic_run()
    # Spans dropped up to 10.5: the window's readers read nothing, the
    # slice's (from 25) still do.
    small = tracing.Tracer(capacity=4)
    monkeypatch.setattr(tracing, "tracer", small)
    small.record("early", 10.0, 500.0)
    for _ in range(4):
        small.record("attn.decode", 25.5, 3.0, device_ms=2.0, layers=2,
                     lengths=[10])
    assert small.dropped_until == 10.5
    for name in ("loop_turn_ms.calls", "gateway_self_ms.p50",
                 "rpc_hop_ms.p50"):
        assert _read(name, run) is None, name
    assert _read("decode_attn_roofline", run) is not None
    # Dropped past the slice's start: nothing there either.
    small.record("late", 26.0, 1.0)
    assert _read("decode_attn_roofline", run) is None


def test_idle_gaps_are_named_by_the_innermost_span(ring, monkeypatch):
    """A tick's phases from 100.000 s (sync 1, dispatch 2, wait 3, host
    4 ms), then a turn [100.010, 100.030) with a yield of 2 ms and an
    admission [100.015, 100.025); gaps of 2 ms (100.0025-100.0045),
    35 ms (100.005-100.040) and 0.4 ms (left out, under 1 ms)."""
    run = synthetic_run()
    run["ticks"] = [dict(t_wall=100.0, phase_sync_ms=1.0,
                         phase_dispatch_ms=2.0, phase_wait_ms=3.0,
                         phase_host_ms=4.0)]
    run["trace"] = dict(t0=100.0, t1=100.1, kernels=[
        ("a", 100.0, 0.0025), ("b", 100.0045, 0.0005),
        ("c", 100.04, 0.0001), ("d", 100.0405, 0.0001), ("host", None, 0.5)])
    turn = ring.record("batcher.turn", 100.010, 20.0, after_tick=1)
    ring.record("batcher.yield", 100.010, 2.0, parent_id=turn.span_id)
    ring.record("batcher.admit", 100.015, 10.0, parent_id=turn.span_id)
    gaps = spans.idle_gaps(run)
    assert gaps["idle_s"] == pytest.approx(0.037)
    want = {"tick dispatch": 0.5, "tick wait": 2.5, "tick host": 4.0,
            "batcher.yield": 2.0, "executor hop": 8.0,
            "batcher.admit": 10.0, "unnamed": 10.0}
    assert set(gaps["by_name"]) == set(want)
    for name, ms in want.items():
        assert gaps["by_name"][name] * 1e3 == pytest.approx(ms, abs=0.2)
    assert gaps["named_share"] == pytest.approx(27 / 37, abs=0.01)
    assert [name for name, _ in gaps["longest"]] == [
        "batcher.admit", "tick wait"]
    assert [ms for _, ms in gaps["longest"]] == pytest.approx([35.0, 2.0])
    # Spans of the slice dropped, or no slice: nothing.
    small = tracing.Tracer(capacity=1)
    monkeypatch.setattr(tracing, "tracer", small)
    small.record("x", 99.0, 1e4)
    small.record("y", 99.0, 1.0)
    assert spans.idle_gaps(run) is None
    assert spans.idle_gaps(dict(run, trace=None)) is None


def test_no_spans_read_nothing(ring):
    run = synthetic_run()
    for name in NEW:
        assert _read(name, run) is None, name
    run["trace"] = None
    fill(ring)
    assert _read("decode_attn_roofline", run) is None
    assert _read("moe_ffn_roofline", run) is None


def test_the_other_readers_ignore_the_spans(ring):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]
             if m["name"] not in NEW]
    assert len(bench["per_layer"]) - len(NEW) == 13
    run = synthetic_run()
    bare = {n: _read(n, run) for n in names}
    fill(ring)
    assert {n: _read(n, run) for n in names} == bare
    assert bare["gateway_ms.p50"] is not None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("perfbench_spans"))


def test_a_tiny_run_reports_the_span_metrics(root, monkeypatch):
    """The open cell, traced on the CPU: the new metrics of its cell
    are reported, and every admission the benchmark's wrapper
    (devtrace.Admissions) saw is a `batcher.admit` span with the same
    lengths and launches (counted at the CPU's plain version)."""
    flash = attention_mod.flash_attention
    plain = attention_mod.flash_attention_ref

    def counted(*args, **kwargs):
        flash.launches += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(attention_mod, "flash_attention_ref", counted)
    seen = {}
    cell = "tiny-mistral.tiny-open"
    args = argparse.Namespace(workload=cell, seed=SEED, seconds=3.0,
                              trace=1)
    result, _ = run_mod.run_cell(
        args, root=root, device=torch.device("cpu"),
        sidecar_hook=lambda s: seen.setdefault("sidecar", s))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wanted = {m["name"] for m in run_mod.metrics_for(bench, cell, True)}
    mine = wanted & set(NEW)
    assert mine == {"decode_attn_roofline", "loop_turn_ms.calls",
                    "gateway_self_ms.p50", "rpc_hop_ms.p50"}
    assert mine <= set(result["metrics"])
    assert result["correct"]
    adm = seen["sidecar"].batcher._prefill_into_slots.__self__.records
    spans = [s for s in tracing.tracer.snapshot()[0]
             if s.name == "batcher.admit"]
    assert adm and len(spans) >= len(adm)
    assert [(s.attrs["lens"], s.attrs["launches"])
            for s in spans[-len(adm):]] == [
        (a["lens"], a["launches"]) for a in adm]
    assert sum(a["launches"] for a in adm) > 0
