"""Stall-free prefill interleave (batching.prefill_interleave) of the port
against the JAX package's: the same tiny-llama weights, float32, greedy,
the scenarios of `tests/test_interleave.py` at a small size. A long
prompt arriving while slots decode must ride the ticks chunk by chunk
and give the JAX batcher's tokens and `interleaved_*` counters — also
with more long prompts than interleave rows, with the int8 KV cache and
through a tick failure — and an idle pool keeps the one-call grid.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from ggrmcp_tpu.core import config as jcfgmod
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
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.rpc.pb import serving_pb2
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher
from ggrmcp_tpu_torch.serving.engine import GenerationEngine
from tests import torch_threads  # noqa: F401

CPU = torch.device("cpu")
# No eos token (2) anywhere: parity compares full-length streams.
SHORT = [5, 6, 7]
LONG = [3 + (i * 7 % 500) for i in range(100)]
LONG2 = [4 + (i * 11 % 490) for i in range(70)]
LONG3 = [6 + (i * 5 % 480) for i in range(90)]


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


def ilv_cfg(mode: str, **kw) -> dict:
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("kv_cache_max_seq", 256)
    kw.setdefault("prefill_chunk", 32)
    kw.setdefault("prefill_interleave_rows", 2)
    kw.setdefault("decode_steps_per_tick", 1)
    kw.setdefault("pipeline_ticks", "off")
    # A wave lands in one admission round even on a loaded machine (the
    # first request's wait for company is the only use of the delay).
    kw.setdefault("max_queue_delay_ms", 1000.0)
    return dict(prefill_interleave=mode, **kw)


async def _drain(batcher, prompt, max_new, sampling, seed=0, started=None):
    out, reason = [], None
    async for ids, reason in batcher.submit(prompt, max_new, sampling,
                                            seed=seed):
        if started is not None:
            started.set()
        out.extend(ids)
    return out, reason


async def _mid_decode(batcher, longs, sampling, short_new=24):
    """One short request decoding; once it has its first token the long
    prompts arrive together."""
    batcher.start()
    try:
        started = asyncio.Event()
        short = asyncio.create_task(
            _drain(batcher, SHORT, short_new, sampling, started=started))
        await started.wait()
        long_out = await asyncio.gather(*(
            _drain(batcher, p, 8, sampling, seed=1 + i)
            for i, p in enumerate(longs)
        ))
        return [await short] + long_out
    finally:
        await batcher.stop()


async def _both(engines, cfg: dict, longs, **kw):
    jeng, teng = engines
    jb = JBatcher(jeng, JBatching(**cfg))
    ref = await _mid_decode(jb, longs, JSampling(temperature=0.0), **kw)
    tb = ContinuousBatcher(teng, BatchingConfig(**cfg))
    out = await _mid_decode(tb, longs, SamplingConfig(temperature=0.0), **kw)
    assert out == ref
    for name in ("interleaved_admissions", "interleaved_chunks"):
        assert tb.stats()[name] == jb.counter_stats()[name], name
    assert all(r in ("length", "stop") for _, r in out)
    return tb


async def test_interleaved_matches_reference_and_off(engines):
    on = await _both(engines, ilv_cfg("on"), [LONG])
    assert on.interleaved_admissions == 1
    assert on.interleaved_chunks == 4  # ceil(100 / 32)
    off = await _both(engines, ilv_cfg("off"), [LONG])
    assert off.interleaved_admissions == 0


async def test_more_long_prompts_than_rows(engines):
    """Three long prompts, two interleave rows: one waits in the queue
    holding its reserved slot, then takes the first freed row."""
    tb = await _both(engines, ilv_cfg("on"), [LONG, LONG2, LONG3],
                     short_new=40)
    assert tb.interleaved_admissions == 3
    assert tb.interleaved_chunks == 4 + 3 + 3
    assert not any(s.reserved for s in tb.slots)
    assert tb._ilv_mini is not None
    assert tb.cache_bytes() == (
        tb.cache.k.nbytes + tb.cache.v.nbytes
        + tb._ilv_mini.k.nbytes + tb._ilv_mini.v.nbytes)


async def test_interleave_int8_kv(weights):
    tb = await _both(_engines(weights, "int8"), ilv_cfg("on"), [LONG])
    assert tb.interleaved_admissions == 1
    assert tb._ilv_mini.k.q.dtype == torch.int8


async def test_idle_pool_uses_serialized_path(engines):
    _, teng = engines
    tb = ContinuousBatcher(teng, BatchingConfig(**ilv_cfg("on")))
    tb.start()
    try:
        out, reason = await _drain(tb, LONG, 4, SamplingConfig())
    finally:
        await tb.stop()
    assert reason in ("stop", "length") and out
    assert tb.interleaved_admissions == 0 and tb.chunked_admissions == 1


async def test_tick_failure_mid_interleave_replays(engines):
    """A tick that fails while a long prompt is mid-chunk: the decoding
    slot and the admitting row both replay, and every request ends with
    the tokens of an undisturbed run."""
    _, teng = engines
    sampling = SamplingConfig(temperature=0.0)
    clean = await _mid_decode(
        ContinuousBatcher(teng, BatchingConfig(**ilv_cfg("on"))), [LONG],
        sampling)
    tb = ContinuousBatcher(teng, BatchingConfig(**ilv_cfg(
        "on", tick_retry_limit=2)))
    real = tb._tick_chunk_impl
    calls = []

    def flaky(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected tick failure")
        return real(*args, **kwargs)

    tb._tick_chunk_impl = flaky
    out = await _mid_decode(tb, [LONG], sampling)
    assert out == clean
    assert tb.replayed >= 2 and len(calls) >= 2


# (batching fields, raises): the reference's Config.validate cases for
# the interleave, the prefix pool and paged KV (tests/test_interleave.py,
# tests/test_paged_kv.py, core/config.py).
VALIDATION = [
    (dict(prefill_interleave="on"), False),
    (dict(prefill_interleave="maybe"), True),
    (dict(prefill_interleave="on", prefill_interleave_rows=0), True),
    (dict(prefix_cache_entries=4), False),
    (dict(prefix_cache_entries=-1), True),
    (dict(prefix_cache_entries=2, prefix_cache_min_seq=0), True),
    (dict(prefix_cache_entries=2, prefix_cache_max_seq=8,
          prefix_cache_min_seq=16), True),
    (dict(prefix_cache_entries=0, prefix_cache_min_seq=0), False),
    (dict(paged_kv="on"), False),
    (dict(paged_kv="maybe"), True),
    (dict(paged_kv="on", prefix_cache_entries=4), True),
    (dict(paged_kv="on", paged_kv_page_size=24, kv_cache_max_seq=256), True),
    (dict(paged_kv="off", paged_kv_page_size=24, kv_cache_max_seq=256),
     False),
    (dict(paged_kv="on", paged_kv_page_size=0), True),
    (dict(paged_kv="on", paged_kv_pages=-1), True),
    (dict(paged_kv="on", paged_kv_pages=64), False),
]


@pytest.mark.parametrize("fields,raises", VALIDATION,
                         ids=[str(i) for i in range(len(VALIDATION))])
def test_config_validation_matches_reference(fields, raises):
    ref = jcfgmod.default()
    for key, value in fields.items():
        setattr(ref.serving.batching, key, value)
    if raises:
        with pytest.raises(ValueError):
            ref.validate()
        with pytest.raises(ValueError):
            BatchingConfig(**fields)
    else:
        ref.validate()
        cfg = BatchingConfig(**fields)
        assert all(getattr(cfg, k) == v for k, v in fields.items())


def test_stats_keys_ride_the_proto(engines):
    _, teng = engines
    tb = ContinuousBatcher(teng, BatchingConfig(**ilv_cfg("on")))
    msg = serving_pb2.ServingStatsResponse(**tb.stats())
    assert msg.interleaved_chunks == 0 and msg.interleaved_admissions == 0
