"""The compile watcher in the port (`serving/compile_watcher.py`) against
the JAX package's (`ggrmcp_tpu/serving/compile_watcher.py`): the same
events through `_on_compile` / `_on_event` give equal `stats()` and
`snapshot()`; and the port's source of events, a kernel library built
or loaded by `ops/_build.py` (monkeypatched: this machine has no nvcc),
reaches GetServingStats, GetMemory and GetFlightRecord through a
sidecar, 0 before any build, the post-warmup count after
`mark_warm`."""

import asyncio
import logging
from pathlib import Path

import pytest

from ggrmcp_tpu.serving import compile_watcher as jcw
from ggrmcp_tpu_torch.core.config import BatchingConfig, ServingConfig
from ggrmcp_tpu_torch.ops import _build
from ggrmcp_tpu_torch.rpc.pb import serving_pb2
from ggrmcp_tpu_torch.serving import compile_watcher as tcw
from ggrmcp_tpu_torch.serving import engine as engine_mod
from ggrmcp_tpu_torch.serving import sidecar as sidecar_mod
from ggrmcp_tpu_torch.serving.sidecar import Sidecar
from tests import torch_threads  # noqa: F401

# (call, args) sequences; "hit" / "miss" are each package's cache events.
SEQUENCES = {
    "cold": [("event", "hit"), ("compile", ("flash_attention", 0.0125)),
             ("event", "miss"), ("compile", ("other", 2.5))],
    "warm": [("compile", ("a", 0.5)), ("warm", None), ("event", "miss"),
             ("compile", ("b", 1.25)), ("event", "hit"), ("cold", None),
             ("compile", ("c", 0.001)), ("warm", None),
             ("compile", ("d", 0.25))],
}


def _feed(w, events, hit, miss):
    for call, arg in events:
        if call == "event":
            w._on_event(hit if arg == "hit" else miss)
        elif call == "compile":
            w._on_compile(*arg)
        elif call == "warm":
            w.mark_warm()
        else:
            w.mark_cold()


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_watcher_matches_reference(name, monkeypatch):
    monkeypatch.setattr(jcw.time, "time", lambda: 1234.5)
    monkeypatch.setattr(tcw.time, "time", lambda: 1234.5)
    ref, port = jcw.CompileWatcher(), tcw.CompileWatcher()
    _feed(ref, SEQUENCES[name], jcw._CACHE_HIT_EVENT, jcw._CACHE_MISS_EVENT)
    _feed(port, SEQUENCES[name], tcw.CACHE_HIT_EVENT, tcw.CACHE_MISS_EVENT)
    assert port.stats() == ref.stats()
    assert port.post_warmup_count() == ref.post_warmup_count()
    assert ([e.to_dict() for e in port.snapshot()]
            == [e.to_dict() for e in ref.snapshot()])
    assert ([e.to_dict() for e in port.snapshot(2)]
            == [e.to_dict() for e in ref.snapshot(2)])


def test_kernel_builds_reach_the_sidecar(monkeypatch, tmp_path, caplog):
    watcher = tcw.CompileWatcher()
    monkeypatch.setattr(tcw, "watcher", watcher)
    monkeypatch.setattr(engine_mod, "watcher", watcher)
    monkeypatch.setattr(sidecar_mod, "watcher", watcher)
    monkeypatch.setattr(_build, "listeners", [])
    built = set()

    def library_path(name):
        return tmp_path / f"lib{name}.so"

    def build(name):
        path = library_path(name)
        if not path.exists():
            built.add(name)
            path.write_bytes(b"")
        return path

    monkeypatch.setattr(_build, "library_path", library_path)
    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: Path(path).name)
    names = ("watch_a", "watch_b", "watch_c")
    for name in names:
        monkeypatch.delitem(_build._loaded, name, raising=False)

    side = Sidecar(ServingConfig(
        model="tiny-llama",
        batching=BatchingConfig(max_batch_size=2, kv_cache_max_seq=64)),
        device="cpu")

    async def read():
        stats = await side.get_serving_stats(None, None)
        mem = await side.get_memory(serving_pb2.MemoryRequest(), None)
        rec = await side.get_flight_record(
            serving_pb2.FlightRecordRequest(), None)
        return stats, mem, rec

    fields = ("compile_count", "compile_cache_hits", "compile_cache_misses",
              "compile_post_warmup")
    stats, mem, rec = asyncio.run(read())
    assert [getattr(stats, f) for f in fields] == [0, 0, 0, 0]
    assert mem.compile_count == 0 and not mem.compiles and not rec.compiles

    _build.load("watch_a")  # built: a miss
    library_path("watch_b").write_bytes(b"")
    _build.load("watch_b")  # found under its hash: a hit
    _build.load("watch_a")  # loaded already: no event
    assert built == {"watch_a"}
    watcher.mark_warm()
    with caplog.at_level(logging.WARNING, logger=tcw.logger.name):
        _build.load("watch_c")
    assert "steady-state compile: watch_c" in caplog.text

    stats, mem, rec = asyncio.run(read())
    assert [getattr(stats, f) for f in fields] == [3, 1, 2, 1]
    assert stats.compile_ms == pytest.approx(watcher.stats()["compile_ms"])
    assert [getattr(mem, f) for f in fields] == [3, 1, 2, 1]
    for ring in (mem.compiles, rec.compiles):
        assert [c.fn_name for c in ring] == list(names)
        assert [c.post_warmup for c in ring] == [False, False, True]
