"""The scheduler and the admission limits in the port's batcher against
the JAX package's: the same tiny-llama weights, float32, greedy.

- Preemption: two batch-class requests hold both slots, an interactive
  one arrives; one victim is demoted, parked and resumed. On the
  contiguous pool and the paged arena every request's tokens equal the
  uninterrupted run's and the JAX batcher's, and the sched_* counters
  agree. `sched_preempt_fail` degrades typed: the victim decodes on.
- The prefill budget defers as the JAX batcher does.
- queue_deadline_ms times out the same requests, "timeout".
- p50_budget_ms caps one admission round's rows while slots decode.
"""

import asyncio
import time

import pytest

from ggrmcp_tpu.core.config import BatchingConfig as JBatching
from ggrmcp_tpu.core.config import SchedulerConfig as JScheduler
from ggrmcp_tpu.ops.sampling import SamplingConfig as JSampling
from ggrmcp_tpu.serving.batching import ContinuousBatcher as JBatcher
from ggrmcp_tpu.utils import failpoints as jfail
from ggrmcp_tpu_torch.core.config import BatchingConfig, SchedulerConfig
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher
from ggrmcp_tpu_torch.utils import failpoints
from tests.test_torch_observability import engines, serving_view  # noqa: F401
from tests import torch_threads  # noqa: F401

SCHED = dict(enabled=True, preempt_wait_fraction=1e-6)
ROUTES = {
    "contiguous": dict(max_batch_size=2, kv_cache_max_seq=128),
    "paged": dict(max_batch_size=2, kv_cache_max_seq=128, paged_kv="on",
                  paged_kv_page_size=8),
}
SCHED_KEYS = ("sched_preemptions", "sched_resumes", "sched_parked",
              "sched_preempt_failures", "sched_budget_deferrals")


@pytest.fixture(autouse=True)
def clean_failpoints():
    failpoints.registry.disarm()
    jfail.registry.disarm()
    yield
    failpoints.registry.disarm()
    jfail.registry.disarm()


def prompt_of(n: int, salt: int = 0) -> list:
    return [(i * 13 + salt * 71 + 5) % 500 + 1 for i in range(n)]


VICTIMS = [(prompt_of(12, 1), 12, "bg-a"), (prompt_of(20, 2), 10, "bg-b")]
INTERACTIVE = (prompt_of(6, 3), 4, "ia")


def _make(jeng, teng, reference: bool, batching: dict, **sched):
    if reference:
        return JBatcher(serving_view(jeng, scheduler=JScheduler(**sched)),
                        JBatching(**batching))
    return ContinuousBatcher(
        serving_view(teng, scheduler=SchedulerConfig(**sched)),
        BatchingConfig(**batching))


async def collect(batcher, prompt, max_new, reference, *, qos="",
                  tenant="", seed=0, first=None):
    greedy = JSampling() if reference else SamplingConfig()
    out, reason = [], None
    async for ids, reason in batcher.submit(prompt, max_new, greedy,
                                            seed=seed, tenant=tenant,
                                            qos_class=qos):
        out.extend(ids)
        if first is not None and not first.done():
            first.set_result(None)
    return out, reason


async def preempt_scenario(batcher, reference: bool, arrive: bool = True):
    """Both victims decode (each has a token), then the interactive
    request arrives behind the full pool. Returns [victim a, victim b,
    interactive] outputs; `arrive` False runs the victims alone."""
    loop = asyncio.get_running_loop()
    batcher.start()
    try:
        firsts = [loop.create_future() for _ in VICTIMS]
        victims = [asyncio.ensure_future(collect(
            batcher, p, n, reference, qos="batch", tenant=t, seed=i,
            first=f)) for i, ((p, n, t), f) in enumerate(zip(VICTIMS,
                                                            firsts))]
        await asyncio.wait_for(asyncio.gather(*firsts), timeout=120)
        late = []
        if arrive:
            p, n, t = INTERACTIVE
            late = [await collect(batcher, p, n, reference,
                                  qos="interactive", tenant=t, seed=9)]
        return [await v for v in victims] + late
    finally:
        await batcher.stop()


async def _solo(batcher, reference):
    p, n, t = INTERACTIVE
    batcher.start()
    try:
        return await collect(batcher, p, n, reference, qos="interactive",
                             tenant=t, seed=9)
    finally:
        await batcher.stop()


@pytest.mark.parametrize("route", sorted(ROUTES))
async def test_preempt_resume_matches_uninterrupted_and_reference(
        engines, route):  # noqa: F811
    jeng, teng = engines
    cfg = ROUTES[route]
    base = await preempt_scenario(_make(jeng, teng, False, cfg), False,
                                  arrive=False)
    base.append(await _solo(_make(jeng, teng, False, cfg), False))
    jb = _make(jeng, teng, True, cfg, **SCHED)
    ref = await preempt_scenario(jb, True)
    tb = _make(jeng, teng, False, cfg, **SCHED)
    out = await preempt_scenario(tb, False)
    assert out == base == ref
    assert all(r == "length" for _, r in out)
    stats, ref_stats = tb.stats(), jb.counter_stats()
    assert {k: stats[k] for k in SCHED_KEYS} == {
        k: ref_stats[k] for k in SCHED_KEYS}
    assert stats["sched_preemptions"] == stats["sched_resumes"] == 1
    assert stats["sched_parked"] == 0
    assert stats["replayed_requests"] == 0  # a preemption burns no retry
    if route == "paged":
        assert stats["kv_pages_total"] > 0


async def test_preempt_fail_degrades_typed(engines):  # noqa: F811
    """Every preemption attempt fails typed: the victims decode to their
    uninterrupted tokens and the interactive request waits its turn."""
    jeng, teng = engines
    cfg = ROUTES["paged"]
    base = await preempt_scenario(_make(jeng, teng, False, cfg), False,
                                  arrive=False)
    base.append(await _solo(_make(jeng, teng, False, cfg), False))
    failpoints.registry.arm("sched_preempt_fail", every=1)
    jfail.registry.arm("sched_preempt_fail", every=1)
    jb = _make(jeng, teng, True, cfg, **SCHED)
    ref = await preempt_scenario(jb, True)
    tb = _make(jeng, teng, False, cfg, **SCHED)
    out = await preempt_scenario(tb, False)
    assert out == base == ref
    for stats in (tb.stats(), jb.counter_stats()):
        assert stats["sched_preempt_failures"] >= 1
        assert stats["sched_preemptions"] == stats["sched_resumes"] == 0
        assert stats["sched_parked"] == 0


async def test_prefill_budget_defers_as_reference(engines):  # noqa: F811
    """A 16-token budget while a runner decodes: three 12-token
    followers admit one per round, deferring twice, with the tokens they
    get alone."""
    jeng, teng = engines
    cfg = dict(max_batch_size=4, kv_cache_max_seq=128)
    prompts = [prompt_of(12, 20 + i) for i in range(3)]

    async def scenario(batcher, reference):
        loop = asyncio.get_running_loop()
        first = loop.create_future()
        batcher.start()
        try:
            runner = asyncio.ensure_future(collect(
                batcher, prompt_of(8, 19), 12, reference, qos="batch",
                tenant="runner", first=first))
            await asyncio.wait_for(first, timeout=120)
            followers = await asyncio.gather(*(
                collect(batcher, p, 4, reference, qos="batch",
                        tenant=f"t{i}", seed=i)
                for i, p in enumerate(prompts)))
            return [await runner] + followers
        finally:
            await batcher.stop()

    budget = dict(enabled=True, prefill_budget_tokens=16)
    jb = _make(jeng, teng, True, cfg, **budget)
    ref = await scenario(jb, True)
    tb = _make(jeng, teng, False, cfg, **budget)
    out = await scenario(tb, False)
    free = await scenario(_make(jeng, teng, False, cfg), False)
    assert out == ref == free
    deferrals = tb.stats()["sched_budget_deferrals"]
    assert deferrals == jb.counter_stats()["sched_budget_deferrals"] >= 1


async def test_queue_deadline_times_out_as_reference(engines):  # noqa: F811
    """Two long decodes hold both slots; two requests queued behind them
    expire in the queue (the sweep, while the pool is still busy)."""
    jeng, teng = engines
    cfg = dict(max_batch_size=2, kv_cache_max_seq=256,
               queue_deadline_ms=60.0)

    async def scenario(batcher, reference):
        batcher.start()
        try:
            busy = [asyncio.ensure_future(collect(
                batcher, [5, i + 3], 160, reference, seed=i))
                for i in range(2)]
            await asyncio.sleep(0.05)
            t0 = time.perf_counter()
            late = await asyncio.gather(
                collect(batcher, [7, 7], 4, reference, seed=9),
                collect(batcher, [8, 8], 4, reference, seed=10))
            waited = time.perf_counter() - t0
            assert not all(t.done() for t in busy), "the pool drained first"
            return late, await asyncio.gather(*busy), waited
        finally:
            await batcher.stop()

    jb = JBatcher(jeng, JBatching(**cfg))
    ref_late, ref_busy, _ = await scenario(jb, True)
    tb = ContinuousBatcher(teng, BatchingConfig(**cfg))
    late, busy, waited = await scenario(tb, False)
    assert late == ref_late == [([], "timeout"), ([], "timeout")]
    assert busy == ref_busy
    assert tb.stats()["timed_out"] == jb.timed_out == 2
    assert waited >= 0.06
    _, recs = tb.flight_snapshot()
    assert sorted(r.finish_reason for r in recs) == [
        "length", "length", "timeout", "timeout"]


async def test_p50_budget_caps_admission_rounds(engines):  # noqa: F811
    """While a slot decodes, p50_budget_ms = 1 allows a quarter of a
    millisecond of admission: one row per round, as in the reference
    (without the budget the three followers land in one round)."""
    jeng, teng = engines
    prompts = [prompt_of(6, 30 + i) for i in range(3)]

    async def scenario(batcher, reference):
        rounds = []
        real = batcher._prefill_into_slots

        def spy(slots_idx, batch):
            rounds.append(len(batch))
            return real(slots_idx, batch)

        batcher._prefill_into_slots = spy
        loop = asyncio.get_running_loop()
        first = loop.create_future()
        batcher.start()
        try:
            runner = asyncio.ensure_future(collect(
                batcher, prompt_of(8, 29), 24, reference, first=first))
            await asyncio.wait_for(first, timeout=120)
            followers = await asyncio.gather(*(
                collect(batcher, p, 3, reference, seed=i)
                for i, p in enumerate(prompts)))
            return [await runner] + followers, rounds
        finally:
            await batcher.stop()

    capped = dict(max_batch_size=4, kv_cache_max_seq=128, p50_budget_ms=1.0)
    ref, ref_rounds = await scenario(JBatcher(jeng, JBatching(**capped)),
                                     True)
    out, rounds = await scenario(
        ContinuousBatcher(teng, BatchingConfig(**capped)), False)
    free, free_rounds = await scenario(ContinuousBatcher(
        teng, BatchingConfig(max_batch_size=4, kv_cache_max_seq=128)), False)
    assert out == ref == free
    assert rounds == ref_rounds == [1, 1, 1, 1]
    assert free_rounds == [1, 3]
