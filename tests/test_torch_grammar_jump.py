"""Jump-ahead constrained decoding in the PyTorch port, on the CPU.

The request sets of tests/test_grammar_jump.py's TestJumpBitIdentity
(its forced-run schemas, several rows at once, an unconstrained rider)
through fused, chunked, paged and interleaved admission: greedy tokens
of the port with jump on equal the port with jump off and the JAX
batcher's (jump on, tiny-llama float32, the same weights), and the
port's jump ticks run. Also: an unconstrained row near the cache's end
rides jump ticks with the tokens it gets without them; corrupted device
jump tables are refused by the collect-side check and degrade typed
(`grammar_jump_fallbacks`) with identical tokens; a tick failure midway
through a run replays to identical tokens. The jump window's attention
shape (Sq = 1 + jump_max, kv_len past Sk for a row at the cache's end)
agrees across the kernel's plain version, `attention_ref` and the
reference's XLA attention.
"""

import asyncio
import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggrmcp_tpu.core.config import BatchingConfig as JBatching
from ggrmcp_tpu.core.config import MeshConfig
from ggrmcp_tpu.core.config import ServingConfig as JServing
from ggrmcp_tpu.grammar import compile_schema as j_compile
from ggrmcp_tpu.models import llama as jl
from ggrmcp_tpu.ops.attention import attention_xla
from ggrmcp_tpu.ops.sampling import SamplingConfig as JSampling
from ggrmcp_tpu.parallel import mesh as mesh_mod
from ggrmcp_tpu.serving.batching import ContinuousBatcher as JBatcher
from ggrmcp_tpu.serving.engine import GenerationEngine as JEngine
from ggrmcp_tpu_torch.core.config import BatchingConfig
from ggrmcp_tpu_torch.grammar import compile_schema
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.models.convert import params_from_numpy
from ggrmcp_tpu_torch.ops import attention as tatt
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher
from ggrmcp_tpu_torch.serving.engine import GenerationEngine
from ggrmcp_tpu_torch.serving.tokenizer import ByteTokenizer
from tests.test_grammar_jump import SCHEMAS
from tests import torch_threads  # noqa: F401

CPU = torch.device("cpu")
TOK = ByteTokenizer()
VOCAB = tl.CONFIGS["tiny-llama"].vocab_size
# A bounded free string after a forced literal: the row stays live for
# dozens of ticks, alternating forced runs and sampled bytes.
LABELED = {
    "type": "object",
    "properties": {
        "kind": {"const": "structured"},
        "label": {"type": "string", "maxLength": 24},
    },
    "required": ["kind", "label"],
}


@pytest.fixture(scope="module")
def engines():
    cfg = jl.CONFIGS["tiny-llama"]
    jparams = jl.init_params(jax.random.PRNGKey(0), cfg)
    jeng = JEngine(
        cfg, JServing(mesh=MeshConfig(tensor=1)),
        mesh=mesh_mod.build_mesh(MeshConfig(tensor=1), jax.devices()[:1]),
        params=jparams,
    )
    teng = GenerationEngine(
        tl.CONFIGS["tiny-llama"], device="cpu",
        params=params_from_numpy(jax.tree.map(np.asarray, jparams), CPU))
    return jeng, teng


@contextlib.contextmanager
def _jump(engine, on: bool):
    """Batchers read serving.grammar.jump_max at construction: flip it
    for the construction window only."""
    saved = engine.serving.grammar.jump_max
    engine.serving.grammar.jump_max = saved if on else 0
    try:
        yield
    finally:
        engine.serving.grammar.jump_max = saved


def _port(teng, jump=True, **cfg):
    with _jump(teng, jump):
        return ContinuousBatcher(teng, BatchingConfig(**cfg))


def _ref(jeng, **cfg):
    return JBatcher(jeng, JBatching(**cfg))


async def _drain(batcher, prompt, max_new, sampling, **kw):
    out, reason = [], None
    async for ids, reason in batcher.submit(prompt, max_new, sampling, **kw):
        out.extend(ids)
    return out, reason


async def _run(batcher, requests, reference=False):
    """(prompt, schema or None, max_new) rows, greedy, submitted at once."""
    compile_fn = j_compile if reference else compile_schema
    sampling = JSampling() if reference else SamplingConfig()
    batcher.start()
    try:
        return await asyncio.gather(*(
            _drain(batcher, prompt, max_new, sampling, seed=i,
                   grammar=None if schema is None else compile_fn(
                       schema, vocab_size=VOCAB))
            for i, (prompt, schema, max_new) in enumerate(requests)))
    finally:
        await batcher.stop()


def _jump_stats(batcher) -> dict:
    s = batcher.stats()
    return {k: s[k] for k in ("grammar_jump_tokens", "grammar_jump_runs",
                              "grammar_jump_fallbacks")}


SET = [
    ([3, 1, 4, 1], SCHEMAS["const_obj"], 256),
    ([2, 7, 1], SCHEMAS["enum_obj"], 256),
    ([5, 5, 5, 5], SCHEMAS["nested"], 256),
    ([6, 6], None, 12),
]
ROUTES = {
    "fused": (dict(max_batch_size=4, kv_cache_max_seq=512), SET),
    "chunked": (dict(max_batch_size=4, kv_cache_max_seq=512,
                     prefill_chunk=32),
                SET[:2] + [(list(range(3, 93)), SCHEMAS["nested"], 256)]
                + SET[3:]),
    "paged": (dict(max_batch_size=4, kv_cache_max_seq=512, paged_kv="on",
                   paged_kv_page_size=16), SET),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
async def test_jump_on_equals_off_and_reference(engines, route):
    jeng, teng = engines
    cfg, requests = ROUTES[route]
    cfg = dict(cfg, max_queue_delay_ms=1000.0)
    ref = await _run(_ref(jeng, **cfg), requests, reference=True)
    on = _port(teng, jump=True, **cfg)
    out_on = await _run(on, requests)
    off = _port(teng, jump=False, **cfg)
    out_off = await _run(off, requests)
    assert out_on == out_off == ref
    stats_on, stats_off = _jump_stats(on), _jump_stats(off)
    assert stats_on["grammar_jump_runs"] > 0
    assert stats_on["grammar_jump_tokens"] >= stats_on["grammar_jump_runs"]
    assert stats_on["grammar_jump_fallbacks"] == 0
    assert stats_off == dict.fromkeys(stats_off, 0)
    # Fewer ticks with jump on: forced runs ride one forward each.
    assert on.stats()["ticks"] < off.stats()["ticks"]
    for (ids, reason), (_, schema, _) in zip(out_on, requests):
        if schema is not None:
            assert reason in ("grammar_complete", "stop")
            json.loads(TOK.decode(ids))


async def test_interleaved_jump_on_equals_off_and_reference(engines):
    """A constrained long prompt admitted through the interleave while a
    constrained row decodes: the fused jump + chunk tick carries the
    chunks."""
    jeng, teng = engines
    prompt = list(range(5, 95))
    cfg = dict(max_batch_size=4, kv_cache_max_seq=512, prefill_chunk=32,
               prefill_interleave="on", prefill_interleave_rows=2)

    async def interleaved(batcher, reference=False):
        compile_fn = j_compile if reference else compile_schema
        sampling = JSampling() if reference else SamplingConfig()
        batcher.start()
        try:
            bg = asyncio.create_task(_drain(
                batcher, [8, 8, 8], 120, sampling, seed=1,
                grammar=compile_fn(LABELED, vocab_size=VOCAB)))
            while batcher.stats()["active_slots"] == 0:
                await asyncio.sleep(0.005)
            out = await _drain(batcher, prompt, 256, sampling, grammar=(
                compile_fn(SCHEMAS["enum_obj"], vocab_size=VOCAB)))
            return out, await bg
        finally:
            await batcher.stop()

    ref = await interleaved(_ref(jeng, **cfg), reference=True)
    on = _port(teng, jump=True, **cfg)
    real, fused = on._tick_jump_chunk_impl, []

    def spy(*args, **kwargs):
        fused.append(1)
        return real(*args, **kwargs)

    on._tick_jump_chunk_impl = spy
    out_on = await interleaved(on)
    out_off = await interleaved(_port(teng, jump=False, **cfg))
    assert out_on == out_off == ref
    assert on.interleaved_admissions >= 1 and fused
    assert _jump_stats(on)["grammar_jump_runs"] > 0


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
async def test_unconstrained_row_near_cache_end_rides_jump_ticks(engines,
                                                                  paged):
    """An unconstrained row decoding to the cache's end while a
    constrained row keeps the pool on jump ticks: its last tick starts at
    length max_seq - 3 and writes 1 + jump_max window positions, six past
    the end (into the scratch slot, or the scratch page when paged); its
    tokens equal the same row's with jump off."""
    _, teng = engines
    max_seq = 128
    cfg = dict(max_batch_size=2, kv_cache_max_seq=max_seq,
               max_queue_delay_ms=1000.0)
    if paged:
        cfg.update(paged_kv="on", paged_kv_page_size=8)
    near_end = [(i * 7) % 250 + 3 for i in range(113)]  # 113 + 14 + 1 = 128
    requests = [([3, 1, 4, 1], LABELED, 80), (near_end, None, 14)]
    on = _port(teng, jump=True, **cfg)
    real, starts = on._tick_jump_impl, []

    def spy(*args, **kwargs):
        starts.append(int(on.cache.length[1]))
        return real(*args, **kwargs)

    on._tick_jump_impl = spy
    out_on = await _run(on, requests)
    out_off = await _run(_port(teng, jump=False, **cfg), requests)
    assert out_on == out_off
    assert len(out_on[1][0]) == 14 and out_on[1][1] == "length"
    assert max_seq - 3 in starts
    assert _jump_stats(on)["grammar_jump_runs"] > 0


async def test_corrupted_jump_tables_degrade_typed(engines):
    """Device jump tables that disagree with the host arena: every forced
    run is refused at collect, each constrained request degrades once to
    one-token decoding and replays, and the tokens equal jump off."""
    _, teng = engines
    cfg = dict(max_batch_size=4, kv_cache_max_seq=512, tick_retry_limit=8)
    requests = SET[:2]
    clean = await _run(_port(teng, jump=False, **cfg), requests)
    batcher = _port(teng, jump=True, **cfg)
    sync = batcher._grammar_tables

    def corrupted_sync():
        sync()
        if batcher._g_full:
            a = batcher.arena
            bad = np.where(a.jump_len[:, None] > 0,
                           (a.jump_tokens + 1) % VOCAB, a.jump_tokens)
            batcher._g_jtok.copy_(torch.from_numpy(bad))

    batcher._grammar_tables = corrupted_sync
    out = await _run(batcher, requests)
    assert out == clean
    stats = batcher.stats()
    assert stats["grammar_jump_fallbacks"] == len(requests)
    assert stats["grammar_jump_runs"] == 0
    assert stats["replayed_requests"] == len(requests)


async def test_tick_failure_mid_run_replays_identically(engines):
    """A jump tick that raises once mid-stream: the victims replay from
    prompt + emitted tokens, their grammar state re-derived through the
    emitted prefix, and finish with the undisturbed run's tokens."""
    _, teng = engines
    cfg = dict(max_batch_size=4, kv_cache_max_seq=256, tick_retry_limit=4)
    requests = [([3, 1, 4, 1], SCHEMAS["nested"], 256),
                ([2, 7, 1], LABELED, 256), ([5, 5, 5, 5], None, 20)]
    clean = await _run(_port(teng, **cfg), requests)
    batcher = _port(teng, **cfg)
    real = batcher._tick_jump_impl
    calls = []

    def flaky(*args, **kwargs):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("injected jump tick failure")
        return real(*args, **kwargs)

    batcher._tick_jump_impl = flaky
    out = await _run(batcher, requests)
    assert out == clean
    stats = batcher.stats()
    assert stats["replayed_requests"] == len(requests)
    assert stats["grammar_jump_runs"] > 0
    # Each arena reference was returned exactly once.
    assert all(e["refs"] == 0 for e in batcher.arena._entries.values())


def test_jump_window_attention_clips_past_the_cache():
    """[B, 9] queries at per-row offsets over a 64-position cache, one row
    at its end so kv_len = offset + 9 passes Sk: the kernel's plain
    version (what the dispatcher sends Sq 9 to), `attention_ref` and the
    reference's XLA attention agree within 1e-5 (float32)."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((3, 9, 8, 32), dtype=np.float32)
    k = rng.standard_normal((3, 64, 2, 32), dtype=np.float32)
    v = rng.standard_normal((3, 64, 2, 32), dtype=np.float32)
    q_off = np.array([0, 30, 61], np.int32)
    kv_len = q_off + 9
    ref = np.asarray(attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_offset=jnp.asarray(q_off), kv_len=jnp.asarray(kv_len)))
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    kw = dict(causal=True, q_offset=torch.from_numpy(q_off),
              kv_len=torch.from_numpy(kv_len))
    for out in (tatt.flash_attention_ref(*args, **kw),
                tatt.attention_ref(*args, **kw), tatt.attention(*args, **kw)):
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
