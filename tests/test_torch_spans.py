"""The port's spans on one wall axis (utils/tracing.py, utils/regions.py),
on the CPU behind the port's gateway (tests/torch_observed.py): a call's
`gateway.http` around its `gateway.invoke` around the sidecar's
`sidecar.generate`; the serving loop's turns between consecutive tick
records; each admission round's `batcher.admit`; the device regions,
which do nothing without a profiler and time their forward under one;
the ring's drop count; and the timeline's tracks for spans of no call."""

import asyncio

import pytest
import torch
from torch.autograd import profiler as _profiler

from ggrmcp_tpu_torch.core.config import ObservabilityConfig
from ggrmcp_tpu_torch.ops import attention as attention_mod
from ggrmcp_tpu_torch.serving.timeline import build_timeline
from ggrmcp_tpu_torch.utils import regions, tracing
from tests import torch_threads  # noqa: F401
from tests.torch_observed import _generate_call, observed_env

GENERATE = "ggrmcp_tpu_generateservice_generate"
# Wall stamps and perf_counter durations of one process: their clocks
# agree to within microseconds over a call.
SLACK_S = 1e-4


def _end(span) -> float:
    return span.start_unix + span.duration_ms / 1000.0


def _spans(name=None) -> list:
    kept, _ = tracing.tracer.snapshot()
    return [s for s in kept if name is None or s.name == name]


@pytest.mark.parametrize("impl", ["fastlane", "aiohttp"])
async def test_a_calls_spans_nest_on_the_wall_axis(impl):
    """gateway.http ⊇ gateway.invoke ⊇ sidecar.generate, one trace id,
    the invoke no shorter than the batcher's e2e_ms; /debug/traces
    serves as many spans as the ring holds."""
    tracing.tracer.clear()
    ids = [f"nest-{impl}-{i}" for i in range(3)]
    async with observed_env(impl) as (side, _gw, client):
        await asyncio.gather(*(_generate_call(client, t, 4) for t in ids))
        e2e = {t: side.batcher.request_record(t).e2e_ms for t in ids}
        for i in range(600):
            tracing.tracer.record("filler", float(i), 0.0)
        body = await (await client.get(
            "/debug/traces", params={"n": "100000"})).json()
    assert tracing.tracer.capacity > 512
    assert len(body["spans"]) == len(_spans()) > 600
    for t in ids:
        named = {s.name: s for s in _spans() if s.trace_id == t}
        http, invoke = named["gateway.http"], named["gateway.invoke"]
        generate = named["sidecar.generate"]
        assert http.attrs["method"] == "tools/call"
        assert invoke.attrs == {"tool": GENERATE, "target": side.target}
        assert invoke.parent_id == http.span_id
        for outer, inner in ((http, invoke), (invoke, generate)):
            assert inner.start_unix >= outer.start_unix - SLACK_S
            assert _end(inner) <= _end(outer) + SLACK_S
        assert invoke.duration_ms >= e2e[t]


async def test_turns_fill_the_gaps_between_tick_records():
    """A tick's end plus its following batcher.turn is the next record's
    t_wall; the turn's children lie inside it."""
    tracing.tracer.clear()
    async with observed_env("fastlane") as (side, _gw, client):
        await asyncio.gather(*(
            _generate_call(client, f"turn-{i}", 4 + 2 * i) for i in range(4)))
        ticks = side.batcher.recorder.tick_snapshot()
    turns = {s.attrs["after_tick"]: s for s in _spans("batcher.turn")}
    for prev, nxt in zip(ticks, ticks[1:]):
        turn = turns[prev.seq]
        end = prev.t_wall + (prev.duration_ms - prev.phase_admit_ms) / 1e3
        assert abs(turn.start_unix - end) < SLACK_S
        assert abs(_end(turn) - nxt.t_wall) < SLACK_S
        kids = [s for s in _spans() if s.parent_id == turn.span_id]
        assert {k.name for k in kids} <= {
            "batcher.yield", "batcher.host_ops", "batcher.admit",
            "batcher.wait_work"}
        for kid in kids:
            assert kid.start_unix >= turn.start_unix - SLACK_S
            assert _end(kid) <= _end(turn) + SLACK_S
    assert len(ticks) >= 6
    # The first turn runs from the loop's start.
    assert turns[0].start_unix < ticks[0].t_wall


async def test_tick_launch_and_collect_counters_are_the_phases():
    """tick_dispatch_ms and tick_collect_ms sum the records' sync +
    dispatch and wait phases."""
    async with observed_env("fastlane") as (side, _gw, client):
        await _generate_call(client, "phases", 6)
        ticks = side.batcher.recorder.tick_snapshot()
        timing = side.batcher.timing
    assert timing["tick_dispatch_ms"] == pytest.approx(
        sum(t.phase_sync_ms + t.phase_dispatch_ms for t in ticks))
    assert timing["tick_collect_ms"] == pytest.approx(
        sum(t.phase_wait_ms for t in ticks))
    assert timing["tick_dispatch_ms"] > 0


async def test_tick_launch_and_collect_counters_count_without_the_recorder():
    """With the flight recorder off (no tick records, no turns) the
    counters still time every tick's launch and collect."""
    tracing.tracer.clear()
    async with observed_env(
            "fastlane",
            observability=ObservabilityConfig(enabled=False)) as (
                side, _gw, client):
        await _generate_call(client, "no-recorder", 6)
        timing = side.batcher.timing
        assert side.batcher.recorder.tick_snapshot() == []
    assert timing["ticks"] > 0
    assert timing["tick_dispatch_ms"] > 0 and timing["tick_collect_ms"] > 0
    assert not _spans("batcher.turn") and not _spans("batcher.admit")


async def test_admission_spans_carry_the_rounds_lengths_and_launches(
        monkeypatch):
    """Each round's batcher.admit holds its prompts' lengths and the
    attention kernel's launches it made (counted here at the CPU's plain
    version), as a wrapper of the round sees them."""
    flash = attention_mod.flash_attention
    plain = attention_mod.flash_attention_ref

    def counted(*args, **kwargs):
        flash.launches += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(attention_mod, "flash_attention_ref", counted)
    tracing.tracer.clear()
    rounds = []
    async with observed_env("fastlane") as (side, _gw, client):
        batcher = side.batcher
        inner = batcher._prefill_into_slots

        def watched(slots_idx, batch):
            lens, before = [len(r.prompt) for r in batch], flash.launches
            try:
                return inner(slots_idx, batch)
            finally:
                rounds.append((lens, flash.launches - before))

        batcher._prefill_into_slots = watched
        await _generate_call(client, "admit-0", 3)
        await asyncio.gather(*(
            _generate_call(client, f"admit-{i}", 3) for i in range(1, 4)))
    spans = _spans("batcher.admit")
    assert [(s.attrs["lens"], s.attrs["launches"]) for s in spans] == rounds
    assert len(spans) >= 2 and all(n > 0 for _, n in rounds)
    for s in spans:
        a = s.attrs
        assert a["rows"] == len(a["lens"]) == a["fused"] + a["chunked"] + (
            a["prefix"] + a["paged"] + a["queued"] + a["shed"])
        assert a["tokens"] == sum(a["lens"])


async def test_regions_do_nothing_without_a_profiler(monkeypatch):
    """No profiler: the decode tick, the admissions and the MoE FFN make
    no CUDA event, enter no record_function and keep no region span."""
    assert not _profiler._is_profiler_enabled

    def refuse(*args, **kwargs):
        raise AssertionError("region work with no profiler active")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(_profiler, "record_function", refuse)
    monkeypatch.setattr(regions, "Window", refuse)
    tracing.tracer.clear()
    async with observed_env("fastlane", model="tiny-moe") as (_s, _g, client):
        await asyncio.gather(*(
            _generate_call(client, f"off-{i}", 4) for i in range(3)))
    names = {s.name for s in _spans()}
    assert "batcher.turn" in names
    assert not names & {"attn.decode", "moe.ffn"}


async def test_regions_time_their_forward_under_a_cpu_profiler():
    """Under a CPU profiler: one attn.decode and one moe.ffn span a
    tick, the lengths and token counts from the batcher's host state."""
    tracing.tracer.clear()
    async with observed_env("fastlane", model="tiny-moe") as (side, _g, client):
        await _generate_call(client, "warm", 2)
        cfg = side.generation.cfg
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            await asyncio.gather(*(
                _generate_call(client, f"on-{i}", 3 + i) for i in range(3)))
    attn, moe = _spans("attn.decode"), _spans("moe.ffn")
    assert attn and moe
    for s in attn:
        assert s.attrs["layers"] == cfg.num_layers
        assert s.attrs["device_ms"] > 0 and s.trace_id == ""
        assert s.attrs["lengths"] and all(n > 0 for n in s.attrs["lengths"])
    for s in moe:
        assert s.attrs["layers"] % cfg.num_layers == 0
        assert s.attrs["device_ms"] > 0 and s.attrs["tokens"] > 0
        assert s.attrs["pairs"] == (
            s.attrs["tokens"] * cfg.experts_per_token * cfg.num_layers)
    # A tick's tokens are its live rows: as many as its decode lengths.
    ticks = {round(s.start_unix, 6): s for s in attn}
    assert any(len(s.attrs["lengths"]) == m.attrs["tokens"]
               for m in moe for s in ticks.values())


def test_regions_are_record_function_ranges_in_a_profile():
    """On the profiling thread, each region is a range of the profile
    (with no window open, and so no span), and so is a live span."""
    from ggrmcp_tpu_torch.models import moe

    cfg = moe.CONFIGS["tiny-moe"]
    params = moe.init_params(cfg, torch.device("cpu"))
    lp = {name: w[0] for name, w in params["layers"].items()}
    x = torch.randn(1, 3, cfg.hidden_dim).to(cfg.torch_dtype)
    q = torch.randn(2, 1, 4, 8)
    k = torch.randn(2, 6, 2, 8)
    tracing.tracer.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        attention_mod.attention(q, k, k, causal=False)
        moe.moe_ffn(x, lp, cfg)
        with tracing.tracer.span("gateway.http", trace_id="ranged"):
            torch.ones(2).sum()
    assert {"attn.decode", "moe.ffn", "gateway.http"} <= {
        e.name for e in prof.events()}
    assert [s.name for s in _spans()] == ["gateway.http"]


def test_decode_attention_is_a_region_at_decode_shapes_only():
    """Inside a window, attention at Sq <= GQA_GROUPED_MAX_SQ is one
    attn.decode region a call; longer queries are not."""
    tracing.tracer.clear()
    q = torch.randn(2, 1, 4, 8)
    k = v = torch.randn(2, 6, 2, 8)
    long_q = torch.randn(2, 12, 4, 8)
    long_kv = torch.randn(2, 12, 2, 8)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        window = regions.open_window(("attn.decode",))
        attention_mod.attention(q, k, v, causal=False)
        attention_mod.attention(q, k, v, causal=False)
        attention_mod.attention(long_q, long_kv, long_kv)
        window.close({"attn.decode": dict(lengths=[6, 6])})
    [span] = _spans("attn.decode")
    assert span.attrs["layers"] == 2 and span.attrs["lengths"] == [6, 6]
    assert regions.open_window(("attn.decode",)) is None
    # A window the profiler's stop cut short keeps nothing.
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    window = regions.open_window(("attn.decode",))
    attention_mod.attention(q, k, v, causal=False)
    prof.stop()
    window.close({"attn.decode": dict(lengths=[6, 6])})
    assert len(_spans("attn.decode")) == 1


def test_a_small_ring_reports_its_drops():
    ring = tracing.Tracer(capacity=4)
    for i in range(10):
        ring.record("x", 100.0 + i, 500.0)
    kept, until = ring.snapshot()
    assert [s.start_unix for s in kept] == [106.0, 107.0, 108.0, 109.0]
    assert until == 105.5
    ring.reserve(8)
    ring.reserve(2)
    assert ring.capacity == 8 and len(ring.snapshot()[0]) == 4
    with ring.span("live"):
        pass
    kept, until = ring.snapshot()
    assert len(kept) == 5 and until == 105.5
    ring.clear()
    assert ring.snapshot() == ([], 0.0)


def test_timeline_puts_spans_of_no_call_on_the_backends_tracks():
    spans = [
        dict(traceId="call-1", name="gateway.http", startUnix=1.0,
             durationMs=5.0),
        dict(traceId="", name="batcher.turn", startUnix=1.001,
             durationMs=1.0),
        dict(traceId="", name="batcher.yield", startUnix=1.0012,
             durationMs=0.1),
        dict(traceId="", name="attn.decode", startUnix=1.003,
             durationMs=0.5),
    ]
    backends = [dict(target="dead", error="down"),
                dict(target="side", ticks=[], requests=[])]
    doc = build_timeline(spans, backends)
    slices = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert slices["gateway.http"]["pid"] == 1
    turn, yld = slices["batcher.turn"], slices["batcher.yield"]
    attn = slices["attn.decode"]
    assert turn["pid"] == yld["pid"] == attn["pid"] == 3
    assert turn["tid"] == yld["tid"] != attn["tid"]
    names = {(e["pid"], e["tid"]): e["args"]["name"]
             for e in doc["traceEvents"] if e["name"] == "thread_name"}
    assert names[(3, turn["tid"])] == "batcher spans"
    assert names[(3, attn["tid"])] == "attn spans"
    assert not any(n.startswith("trace -") for n in names.values())
