"""Paged KV (batching.paged_kv) of the port against the JAX package's.

- The allocator: the port's `serving/pages.py` is a copy of the
  reference's; the same admit / register / free / reset sequence
  through both must give identical tables, refcounts, admissions,
  exceptions and counters.
- The model: a forward through a `PagedKVCache` equals the contiguous
  cache's (bitwise on `attention_ref`), for float32 and int8 KV.
- The batcher: the same tiny-llama weights, float32, greedy, and the
  request sets of `tests/test_paged_kv.py` — cold fused and chunked
  rows, same-round shared preambles (eager register), cross-round
  sharing, copy-on-write at the divergent page, interleaved admission,
  int8 KV, an exhausted arena's typed shed, a tick failure's replay —
  must give the JAX batcher's tokens and its `prefix_cache_*`,
  `paged_*` and `kv_pages_*` counters.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from ggrmcp_tpu.core.config import BatchingConfig as JBatching
from ggrmcp_tpu.core.config import MeshConfig
from ggrmcp_tpu.core.config import ServingConfig as JServing
from ggrmcp_tpu.models import llama as jl
from ggrmcp_tpu.ops.sampling import SamplingConfig as JSampling
from ggrmcp_tpu.parallel import mesh as mesh_mod
from ggrmcp_tpu.serving import pages as jpages
from ggrmcp_tpu.serving.batching import ContinuousBatcher as JBatcher
from ggrmcp_tpu.serving.engine import GenerationEngine as JEngine
from ggrmcp_tpu_torch.core.config import BatchingConfig, ServingConfig
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.models.convert import params_from_numpy
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.rpc.pb import serving_pb2
from ggrmcp_tpu_torch.serving import pages as tpages
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher
from ggrmcp_tpu_torch.serving.engine import GenerationEngine
from tests import torch_threads  # noqa: F401

CPU = torch.device("cpu")
PAGED_KEYS = (
    "prefix_cache_hits", "prefix_cache_misses", "kv_pages_total",
    "kv_pages_in_use", "kv_pages_shared", "paged_prefix_hits",
    "paged_cow_copies", "paged_pages_reused", "paged_pages_admitted",
    "shed_requests",
)


def _single_mesh():
    return mesh_mod.build_mesh(MeshConfig(tensor=1), jax.devices()[:1])


@pytest.fixture(scope="module")
def weights():
    jparams = jl.init_params(jax.random.PRNGKey(0), jl.CONFIGS["tiny-llama"])
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)


def _engines(weights, kv_dtype=""):
    jparams, tparams = weights
    jeng = JEngine(
        jl.CONFIGS["tiny-llama"],
        JServing(mesh=MeshConfig(tensor=1), kv_cache_dtype=kv_dtype),
        mesh=_single_mesh(), params=jparams,
    )
    teng = GenerationEngine(
        tl.CONFIGS["tiny-llama"], ServingConfig(kv_cache_dtype=kv_dtype),
        params=tparams, device="cpu",
    )
    return jeng, teng


@pytest.fixture(scope="module")
def engines(weights):
    return _engines(weights)


def paged_cfg(**kw) -> dict:
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("kv_cache_max_seq", 256)
    kw.setdefault("paged_kv", "on")
    kw.setdefault("paged_kv_page_size", 8)
    # A wave lands in one admission round even on a loaded machine (the
    # first request's wait for company is the only use of the delay).
    kw.setdefault("max_queue_delay_ms", 1000.0)
    return kw


def prompt_of(n: int, salt: int = 0) -> list[int]:
    return [(i * 13 + salt * 71 + 5) % 500 + 1 for i in range(n)]


# -- the allocator ------------------------------------------------------------


def _admission(adm):
    return (adm.merge_start, adm.scan_start, adm.gather_row.tolist(),
            adm.pages_shared, adm.pages_restored)


def _state(alloc):
    return (alloc.tables.tolist(), alloc._ref.tolist(), sorted(alloc._free),
            alloc.stats(), alloc.in_use(), alloc.shared())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_sequence_matches_reference(seed):
    """A seeded random sequence of admit / register / free (with and
    without discard_index) / reset over prompts built from a few shared
    heads, on a small arena so that eviction and exhaustion happen."""
    rng = np.random.default_rng(seed)
    heads = [rng.integers(1, 50, 12).tolist() for _ in range(3)]
    ref = jpages.PageAllocator(24, 4, slots=4, table_width=16)
    got = tpages.PageAllocator(24, 4, slots=4, table_width=16)
    kinds = {"admit": 0, "shed": 0}
    for _ in range(300):
        op = rng.choice(["admit", "admit", "register", "free", "discard",
                         "reset"], p=[0.35, 0.2, 0.2, 0.15, 0.08, 0.02])
        slot = int(rng.integers(0, 4))
        if op == "admit":
            head = heads[int(rng.integers(0, 3))][: int(rng.integers(3, 13))]
            prompt = head + rng.integers(1, 50, int(rng.integers(1, 20))).tolist()
            need = len(prompt) + int(rng.integers(1, 12))
            results = []
            for alloc in (ref, got):
                try:
                    results.append(_admission(alloc.admit(slot, prompt, need)))
                except (jpages.PageExhaustedError,
                        tpages.PageExhaustedError) as exc:
                    results.append(type(exc).__name__)
                except ValueError as exc:
                    results.append(str(exc))
            assert results[0] == results[1]
            kinds["shed" if isinstance(results[0], str) else "admit"] += 1
            last = prompt
        elif op == "register" and kinds["admit"]:
            ref.register(slot, last)
            got.register(slot, last)
        elif op in ("free", "discard"):
            ref.free_slot(slot, discard_index=op == "discard")
            got.free_slot(slot, discard_index=op == "discard")
        elif op == "reset":
            ref.reset()
            got.reset()
        assert _state(got) == _state(ref)
        got.check_invariants()
    assert kinds["admit"] > 50 and kinds["shed"] > 0
    assert got.hits > 0 and got.cow_copies > 0


def test_allocator_is_the_ports_own_copy():
    assert tpages.PageAllocator is not jpages.PageAllocator
    assert tpages.PageAllocator.__module__ == "ggrmcp_tpu_torch.serving.pages"
    assert tpages.adapter_root("") == jpages.adapter_root("") == 0
    assert tpages.adapter_root("tenant-a") == jpages.adapter_root("tenant-a")


# -- the model ----------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_paged_forward_matches_contiguous(weights, kv_dtype):
    """A prefill and two decode steps through a paged cache whose block
    tables scatter each row over non-adjacent pages equal the contiguous
    cache's, bit for bit on attention_ref; a sentinel entry reads page
    n_pages - 1, and a write past the table's width lands in the scratch
    page."""
    _, params = weights
    cfg = tl.CONFIGS["tiny-llama"]
    b, s_max, page = 3, 64, 8
    width = s_max // page
    toks = torch.from_numpy(np.random.default_rng(1).integers(3, 500, (b, 20)))
    steps = [toks[:, :1] + 1, toks[:, :1] + 2]
    flat = tl.KVCache.create(cfg, b, s_max, CPU, kv_dtype)
    paged = tl.PagedKVCache.create(cfg, b, s_max, 30, page, CPU, kv_dtype)
    perm = np.random.default_rng(2).permutation(30)[: b * width]
    paged.table = torch.from_numpy(perm.reshape(b, width).astype(np.int32))
    outs = []
    for cache in (flat, paged):
        logits = [tl.forward(params, cfg, toks, cache, use_flash=False)[0]]
        for step in steps:
            logits.append(tl.forward(params, cfg, step, cache,
                                     use_flash=False)[0])
        outs.append(logits)
    for a, c in zip(*outs):
        assert torch.equal(a, c)
    assert paged.n_pages == 30 and paged.length.tolist() == [22] * b
    # The view clips sentinel entries to page n_pages - 1 (finite).
    paged.table[1] = 30
    view = tl.paged_view(tl._at(0, paged.k), paged.table)
    last = tl._at(0, paged.k)
    last = last.q if kv_dtype else last
    got = view.q if kv_dtype else view
    assert torch.equal(got[1, :page], last[29])
    # A write past the table's width goes to the scratch page.
    paged.length[:] = s_max
    tl.forward(params, cfg, steps[0], paged, use_flash=False)
    scratch = (paged.k.q if kv_dtype else paged.k)[:, 30]
    assert scratch.abs().sum() > 0


def test_paged_view_layers_fills_a_mini(weights):
    """The per-layer views land in the head of a mini cache's leaf (its
    scratch position untouched); a sentinel entry reads page N - 1."""
    cfg = tl.CONFIGS["tiny-llama"]
    cache = tl.PagedKVCache.create(cfg, 2, 32, 9, 8, CPU)
    cache.k.normal_()
    table = torch.tensor([[3, 1, 9, 0], [2, 2, 5, 7]], dtype=torch.int32)
    mini = tl.KVCache.create(cfg, 2, 32, CPU)
    assert tl.paged_view_layers(cache.k, table, out=mini.k) is mini.k
    for layer in range(cfg.num_layers):
        assert torch.equal(mini.k[layer, :, :32],
                           tl.paged_view(cache.k[layer], table))
    assert torch.equal(mini.k[:, 0, 16:24], cache.k[:, 8])  # sentinel 9 → 8
    assert not mini.k[:, :, 32].any()


# -- the batcher --------------------------------------------------------------


async def _collect(batcher, prompt, max_new, seed, sampling):
    out: list[int] = []
    reason = None
    async for ids, r in batcher.submit(prompt, max_new, sampling, seed=seed):
        out.extend(ids)
        reason = r
    return out, reason


async def _run_waves(batcher, waves, sampling):
    outs, stats = [], []
    batcher.start()
    try:
        for wave in waves:
            outs.append(await asyncio.gather(*(
                _collect(batcher, p, m, i, sampling)
                for i, (p, m) in enumerate(wave)
            )))
            # The reference's summable counters; the port's stats().
            stats.append(getattr(batcher, "counter_stats", batcher.stats)())
    finally:
        await batcher.stop()
    return outs, stats


async def _both(engines, cfg: dict, waves):
    """The same waves through the JAX batcher and the port's: identical
    tokens, and identical paged counters after every wave."""
    jeng, teng = engines
    jb = JBatcher(jeng, JBatching(**cfg))
    ref, ref_stats = await _run_waves(jb, waves, JSampling(temperature=0.0))
    tb = ContinuousBatcher(teng, BatchingConfig(**cfg))
    out, stats = await _run_waves(tb, waves, SamplingConfig(temperature=0.0))
    assert out == ref
    for got, want in zip(stats, ref_stats):
        assert {k: got[k] for k in PAGED_KEYS} == {
            k: want[k] for k in PAGED_KEYS}
    tb.pages.check_invariants()
    assert (tb.pages.tables == tb.pages.sentinel).all()  # all finished
    return tb, out


async def test_all_admission_routes(engines):
    """One wave: a short cold row (fused), a same-round shared preamble
    (eager register → one paged group), a long cold row (chunked)."""
    head = prompt_of(24)
    prompts = ([prompt_of(12, salt=50)]
               + [head + prompt_of(6, salt=s) for s in range(2)]
               + [prompt_of(80, salt=9)])
    tb, _ = await _both(engines, paged_cfg(prefill_chunk=32),
                        [[(p, 5) for p in prompts]])
    assert tb.pages.hits >= 1


async def test_repeat_prompt_shares_pages(engines):
    p = prompt_of(40)
    tb, _ = await _both(engines, paged_cfg(), [[(p, 6)], [(p, 6)]])
    assert tb.prefix_hits == 1 and tb.pages.pages_reused >= 4


async def test_copy_on_write_at_divergent_page(engines):
    """The second prompt shares three full pages and four more tokens of
    the first's fourth page: that page is copied, not recomputed."""
    a = prompt_of(40)
    b = a[:28] + prompt_of(12, salt=4)
    tb, _ = await _both(engines, paged_cfg(), [[(a, 5)], [(b, 5)]])
    assert tb.pages.cow_copies == 1


async def test_wave_after_warm_request(engines):
    """A warm request indexes the preamble; a wave then admits as one
    paged group sharing its pages."""
    head = prompt_of(32, salt=2)
    tb, _ = await _both(engines, paged_cfg(), [
        [(head + [401], 2)],
        [(head + [410 + i], 12) for i in range(4)],
    ])
    assert tb.pages.hits >= 4 and tb.pages.pages_reused >= 16


async def test_shared_gauge_while_decoding(engines):
    """kv_pages_shared counts the preamble's pages while the wave is
    live (read between ticks), and falls to 0 once it finishes."""
    _, teng = engines
    head = prompt_of(32)
    tb = ContinuousBatcher(teng, BatchingConfig(**paged_cfg()))
    peak = 0
    tb.start()
    try:
        await _collect(tb, head + [401], 2, 0, SamplingConfig())
        wave = asyncio.gather(*(
            _collect(tb, head + [410 + i], 24, i, SamplingConfig())
            for i in range(4)
        ))
        while not wave.done():
            peak = max(peak, tb.stats()["kv_pages_shared"])
            await asyncio.sleep(0.002)
        await wave
    finally:
        await tb.stop()
    assert peak >= 4
    assert tb.stats()["kv_pages_shared"] == 0


async def test_paged_interleave(engines):
    """Long prompts arriving mid-decode interleave, then merge into
    pages (interleave-bound rows are not registered eagerly)."""
    jeng, teng = engines
    cfg = paged_cfg(prefill_chunk=32, prefill_interleave="on",
                    prefill_interleave_rows=2)
    outs = []
    for batcher, sampling in (
        (JBatcher(jeng, JBatching(**cfg)), JSampling(temperature=0.0)),
        (ContinuousBatcher(teng, BatchingConfig(**cfg)),
         SamplingConfig(temperature=0.0)),
    ):
        batcher.start()
        try:
            started = asyncio.Event()

            async def short():
                out = []
                async for ids, _ in batcher.submit([5, 6, 7], 24, sampling):
                    started.set()
                    out.extend(ids)
                return out

            task = asyncio.create_task(short())
            await started.wait()
            longs = await asyncio.gather(*(
                _collect(batcher, prompt_of(100, salt=7 + i), 5, i, sampling)
                for i in range(2)
            ))
            outs.append(([await task] + longs, batcher))
        finally:
            await batcher.stop()
    (ref, jb), (out, tb) = outs
    assert out == ref
    assert tb.interleaved_admissions == jb.interleaved_admissions == 2
    st, rs = tb.stats(), jb.counter_stats()
    assert {k: st[k] for k in PAGED_KEYS} == {k: rs[k] for k in PAGED_KEYS}


async def test_int8_kv_pages(weights):
    head = prompt_of(24)
    tb, _ = await _both(_engines(weights, "int8"), paged_cfg(), [
        [(head + prompt_of(6, salt=0), 5)],
        [(head + prompt_of(6, salt=s), 5) for s in range(1, 4)],
    ])
    assert tb.cache.k.q.dtype == torch.int8 and tb.prefix_hits == 3


async def test_tiny_arena_sheds_typed(engines):
    """An arena too small for a request sheds it "overloaded" and
    leaves the resident request decoding to its end."""
    jeng, teng = engines
    cfg = paged_cfg(paged_kv_pages=10)
    results = []
    for batcher, sampling in (
        (JBatcher(jeng, JBatching(**cfg)), JSampling(temperature=0.0)),
        (ContinuousBatcher(teng, BatchingConfig(**cfg)),
         SamplingConfig(temperature=0.0)),
    ):
        batcher.start()
        try:
            live = asyncio.ensure_future(
                _collect(batcher, prompt_of(10), 40, 0, sampling))
            await asyncio.sleep(0.05)
            big = await _collect(batcher, prompt_of(200, salt=5), 8, 1,
                                 sampling)
            after = await _collect(batcher, prompt_of(10, salt=2), 4, 2,
                                   sampling)
            results.append((await live, big, after, batcher.shed))
        finally:
            await batcher.stop()
    assert results[1] == results[0]
    (live_out, live_reason), big, _, shed = results[1]
    assert big == ([], "overloaded") and shed == 1
    assert live_reason == "length" and len(live_out) == 40


async def test_tick_failure_replays_on_fresh_arena(engines):
    """A failed tick resets the allocator and rebuilds the arena; every
    request replays and ends with the tokens of an undisturbed run."""
    _, teng = engines
    head = prompt_of(24)
    prompts = [head + prompt_of(6, salt=s) for s in range(3)] + [
        prompt_of(60, salt=8)]
    sampling = SamplingConfig(temperature=0.0)
    cfg = paged_cfg(prefill_chunk=32, tick_retry_limit=3)
    clean, _ = await _run_waves(
        ContinuousBatcher(teng, BatchingConfig(**cfg)),
        [[(p, 5) for p in prompts]], sampling)
    tb = ContinuousBatcher(teng, BatchingConfig(**cfg))
    real = tb._tick_impl
    calls = []

    def flaky(*args, **kwargs):
        calls.append(1)
        if len(calls) in (2, 4):
            raise RuntimeError("injected tick failure")
        return real(*args, **kwargs)

    tb._tick_impl = flaky
    out, _ = await _run_waves(tb, [[(p, 5) for p in prompts]], sampling)
    assert out == clean and tb.replayed >= 1
    tb.pages.check_invariants()


def test_batcher_mirrors_validation(engines):
    _, teng = engines
    with pytest.raises(ValueError, match="divide"):
        ContinuousBatcher(teng, BatchingConfig(
            **paged_cfg(kv_cache_max_seq=2048, paged_kv_page_size=96)))
    cfg = BatchingConfig(**paged_cfg())
    cfg.prefix_cache_entries = 2
    with pytest.raises(ValueError, match="prefix"):
        ContinuousBatcher(teng, cfg)


def test_stats_and_cache_bytes(engines):
    _, teng = engines
    tb = ContinuousBatcher(teng, BatchingConfig(**paged_cfg()))
    msg = serving_pb2.ServingStatsResponse(**tb.stats())
    assert msg.kv_pages_total == tb.pages.n_pages == 4 * 256 // 8
    assert tb.cache.k.shape[1] == tb.pages.n_pages + 1  # the scratch page
    assert tb.cache_bytes() == (tb.cache.k.nbytes + tb.cache.v.nbytes
                                + tb.cache.table.nbytes)
    off = ContinuousBatcher(teng, BatchingConfig(max_batch_size=4,
                                                 kv_cache_max_seq=256))
    assert all(off.stats()[k] == 0 for k in PAGED_KEYS)
