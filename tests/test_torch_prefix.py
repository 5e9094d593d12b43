"""The slot-granular prefix pool (batching.prefix_cache_entries) of the
port against the JAX package's: the same tiny-llama weights (the
reference's init crossed through `params_from_numpy`), float32, greedy,
and the request sequences of `tests/test_prefix_cache.py`. Every route
a pooled prefix can take — trickle store, prefix-hit group (R = 1 and
R = B), the serial bridge path, burst learning, LRU eviction, key
subsumption — must give the JAX batcher's token ids, hit/miss counters
and pool keys exactly, with and without the int8 KV cache; `_pfx_plan`
must equal the reference's over a grid.
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
from ggrmcp_tpu.serving.batching import ContinuousBatcher as JBatcher
from ggrmcp_tpu.serving.engine import GenerationEngine as JEngine
from ggrmcp_tpu_torch.core.config import BatchingConfig, ServingConfig
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.models.convert import params_from_numpy
from ggrmcp_tpu_torch.ops import attention as tatt
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher
from ggrmcp_tpu_torch.serving.engine import GenerationEngine
from tests import torch_threads  # noqa: F401

CPU = torch.device("cpu")


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


@pytest.fixture(scope="module")
def engines8(weights):
    return _engines(weights, "int8")


def pool_cfg(**kw) -> dict:
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("kv_cache_max_seq", 256)
    kw.setdefault("prefix_cache_entries", 2)
    kw.setdefault("prefix_cache_min_seq", 8)
    kw.setdefault("prefix_cache_max_seq", 64)
    # A wave lands in one admission round even on a loaded machine (the
    # first request's wait for company is the only use of the delay).
    kw.setdefault("max_queue_delay_ms", 1000.0)
    return kw


def prompt_of(n: int, salt: int = 0) -> list[int]:
    return [(i * 13 + salt * 71 + 5) % 500 + 1 for i in range(n)]


async def _collect(batcher, prompt, max_new, seed, sampling):
    out: list[int] = []
    reason = None
    async for ids, r in batcher.submit(prompt, max_new, sampling, seed=seed):
        out.extend(ids)
        reason = r
    return out, reason


async def _run_waves(batcher, waves, sampling):
    """Each wave's (prompt, max_new) requests concurrently, the waves one
    after another; returns the outputs and the pool's keys after each."""
    outs, keys = [], []
    batcher.start()
    try:
        for wave in waves:
            outs.append(await asyncio.gather(*(
                _collect(batcher, p, m, i, sampling)
                for i, (p, m) in enumerate(wave)
            )))
            keys.append(sorted(
                tuple(int(t) for t in k)
                for k in getattr(batcher, "_pfx_keys", []) if k is not None
            ))
    finally:
        await batcher.stop()
    return outs, keys


async def _both(engines, cfg: dict, waves):
    """The same waves through the JAX batcher and the port's; asserts
    identical tokens, counters and pool keys; returns the port's batcher."""
    jeng, teng = engines
    jb = JBatcher(jeng, JBatching(**cfg))
    ref, ref_keys = await _run_waves(jb, waves, JSampling(temperature=0.0))
    tb = ContinuousBatcher(teng, BatchingConfig(**cfg))
    out, keys = await _run_waves(tb, waves, SamplingConfig(temperature=0.0))
    assert out == ref
    assert keys == ref_keys
    assert (tb.prefix_hits, tb.prefix_misses) == (
        jb.prefix_hits, jb.prefix_misses)
    for name in ("prefix_cache_hits", "prefix_cache_misses"):
        assert tb.stats()[name] == jb.counter_stats()[name]
    for wave in out:
        assert all(r in ("length", "stop") and o for o, r in wave)
    return tb


async def test_repeat_prompt_hits(engines):
    """Trickle admission pools the prefix; the repeat is a one-row
    prefix-hit group call."""
    p = prompt_of(40)
    tb = await _both(engines, pool_cfg(), [[(p, 6)], [(p, 6)]])
    assert (tb.prefix_hits, tb.prefix_misses) == (1, 1)


async def test_shared_prefix_partial_reuse(engines):
    head = prompt_of(24)
    tb = await _both(engines, pool_cfg(), [
        [(head + prompt_of(10, salt=1), 6)],
        [(head + prompt_of(14, salt=2), 6)],
    ])
    assert tb.prefix_hits == 1


async def test_bridge_path_long_prompt(engines):
    """A pooled 32-token prefix of an 80-token prompt with prefill_chunk
    16: the suffix needs a bridge step plus chunks — the serial path."""
    p = prompt_of(80)
    cfg = pool_cfg(prefill_chunk=16, prefix_cache_max_seq=32)
    tb = await _both(engines, cfg, [[(p, 5)], [(p, 5)]])
    assert tb.prefix_hits == 1
    assert len(tb._pfx_plan(80, 32)[1]) > 1


async def test_lru_eviction_single_entry(engines):
    a, b = prompt_of(20), prompt_of(20, salt=9)
    tb = await _both(engines, pool_cfg(prefix_cache_entries=1),
                     [[(a, 3)], [(b, 3)], [(a, 3)]])
    assert (tb.prefix_hits, tb.prefix_misses) == (0, 3)


async def test_longer_prefix_subsumes_shorter(engines):
    short = prompt_of(16)
    longer = short + prompt_of(20, salt=3)
    tb = await _both(engines, pool_cfg(),
                     [[(short, 3)], [(longer, 4)], [(longer, 4)]])
    assert tb.prefix_hits == 2
    stored = [k for k in tb._pfx_keys if k is not None]
    assert len(stored) == 1 and len(stored[0]) == len(longer) - 1


async def test_concurrent_shared_prefix_burst(engines):
    """A fused burst learns its shared preamble (_pfx_learn_from_burst)."""
    head = prompt_of(24)
    await _both(engines, pool_cfg(), [
        [(head + prompt_of(6, salt=s), 4) for s in range(4)],
    ])


async def test_cold_burst_then_wave_hits(engines):
    """16 cold requests with one new preamble learn it; the next 16 are
    ONE prefix-hit group call at R = B."""
    head = prompt_of(24, salt=9)
    tb = await _both(engines, pool_cfg(max_batch_size=16), [
        [(head + prompt_of(4, salt=100 + s), 4) for s in range(16)],
        [(head + prompt_of(4, salt=200 + s), 4) for s in range(16)],
    ])
    assert tb.prefix_hits >= 15


async def test_pair_arrival_learns_prefix(engines):
    head = prompt_of(24, salt=77)
    tb = await _both(engines, pool_cfg(), [
        [(head + prompt_of(4, salt=300), 4),
         (head + prompt_of(4, salt=301), 4)],
        [(head + prompt_of(4, salt=302), 4),
         (head + prompt_of(4, salt=303), 4)],
    ])
    assert tb.prefix_hits == 2


async def test_distinct_burst_stores_nothing(engines):
    tb = await _both(engines, pool_cfg(max_batch_size=8), [
        [(prompt_of(20, salt=50 + i), 4) for i in range(6)],
    ])
    assert all(k is None for k in tb._pfx_keys)


async def test_long_wave_hits_in_one_group(engines):
    """Chunked (long) cold prompts store nothing as a group; a trickle
    stores, then a long same-preamble wave hits as one group."""
    head = prompt_of(48, salt=5)
    cfg = pool_cfg(prefill_chunk=16, prefix_cache_max_seq=48)
    tb = await _both(engines, cfg, [
        [(head + prompt_of(8, salt=s), 4) for s in range(2)],
        [(head + prompt_of(8, salt=40), 4)],
        [(head + prompt_of(8, salt=50 + s), 4) for s in range(4)],
    ])
    assert tb.prefix_hits == 4


async def test_pool_off_by_default(engines):
    tb = await _both(engines, dict(max_batch_size=4, kv_cache_max_seq=256,
                                   max_queue_delay_ms=1000.0),
                     [[(prompt_of(20), 3)], [(prompt_of(20), 3)]])
    assert tb._pfx_pool is None
    assert (tb.prefix_hits, tb.prefix_misses) == (0, 0)
    assert tb.cache_bytes() == tb.cache.k.nbytes + tb.cache.v.nbytes


async def test_int8_kv_pool(engines8):
    """The pool, its stores and its hits move int8 values and scales."""
    head = prompt_of(24, salt=3)
    tb = await _both(engines8, pool_cfg(), [
        [(head + prompt_of(6, salt=1), 5)],
        [(head + prompt_of(6, salt=2 + s), 5) for s in range(3)],
    ])
    assert tb.prefix_hits == 3
    assert tb._pfx_pool.k.q.dtype == torch.int8


def test_cache_bytes_count_the_pool(engines):
    _, teng = engines
    tb = ContinuousBatcher(teng, BatchingConfig(**pool_cfg()))
    pool = tb._pfx_pool
    assert tb.cache_bytes() == (tb.cache.k.nbytes + tb.cache.v.nbytes
                                + pool.k.nbytes + pool.v.nbytes)
    assert tb.stats()["prefix_cache_hits"] == 0


@pytest.mark.parametrize("chunk", [16, 64])
def test_pfx_plan_matches_reference(engines, chunk):
    jeng, teng = engines
    cfg = pool_cfg(prefill_chunk=chunk)
    jb = JBatcher(jeng, JBatching(**cfg))
    tb = ContinuousBatcher(teng, BatchingConfig(**cfg))
    for n in range(2, 256, 5):
        for plen in range(1, n, 3):
            assert tb._pfx_plan(n, plen) == jb._pfx_plan(n, plen), (n, plen)


def test_no_kernel_launch_on_cpu():
    assert tatt.flash_attention.launches == 0
