"""Ring-buffer KV (`serving.kv_ring`) of the port: `forward(ring=True)`
writes position p at slot p % C and masks each slot by the absolute
position it holds, so a sliding-window model's cache is bounded by
window + prefill_chunk - 1 instead of the context. The counterpart of
`tests/test_kv_ring.py` on tiny-mistral (window 16):

- ring logits equal a contiguous cache's at every step, below and past
  capacity, across many wrap-arounds, with int8 KV, and equal the JAX
  package's ring forward on the same weights;
- a step that would clobber an in-window key is refused;
- the engine and the config refuse what the reference refuses;
- the ring batcher's greedy tokens equal the contiguous windowed
  engine's, solo, concurrent and on the fused route, and the JAX ring
  batcher's; a group of long prompts of different chunk counts too
  (the port admits such rows in groups of equal chunk count).
"""

import asyncio

import jax
import jax.numpy as jnp
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
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher
from ggrmcp_tpu_torch.serving.engine import GenerationEngine
from tests import torch_threads  # noqa: F401

CPU = torch.device("cpu")
CFG = tl.CONFIGS["tiny-mistral"]  # sliding_window = 16
W = CFG.sliding_window
GREEDY = SamplingConfig(temperature=0.0)


@pytest.fixture(scope="module")
def jparams():
    return jl.init_params(jax.random.PRNGKey(0), jl.CONFIGS["tiny-mistral"])


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)


def schedule(total, chunk, b=2, seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(1, 500, (b, total)).astype(np.int64)
    return [tokens[:, off: off + chunk] for off in range(0, total, chunk)]


def run_schedule(params, capacity, ring, steps, kv_dtype=""):
    """Last-position logits of every step of `steps` through one cache."""
    cache = tl.KVCache.create(CFG, steps[0].shape[0], capacity, CPU, kv_dtype)
    outs = []
    for chunk in steps:
        logits, cache = tl.forward(params, CFG, torch.from_numpy(chunk),
                                   cache, ring=ring)
        outs.append(logits[:, -1].numpy())
    return outs


@pytest.mark.parametrize("total,chunk,capacity,flat", [
    (24, 8, 32, 32),  # below capacity
    (48, 8, 24, 64),  # past capacity: C = W + 8
    (40, 1, W, 64),  # decode wraps at the least legal capacity
], ids=["below", "beyond", "decode_wraps"])
def test_ring_matches_contiguous(params, total, chunk, capacity, flat):
    steps = schedule(total, chunk, seed=total)
    ring = run_schedule(params, capacity, True, steps)
    cont = run_schedule(params, flat, False, steps)
    for i, (r, f) in enumerate(zip(ring, cont)):
        np.testing.assert_allclose(r, f, atol=1e-5, err_msg=f"step {i}")


def test_ring_many_wraps_after_prefill(params):
    """A chunk of 8, then 40 decode steps at C = W + 7."""
    steps = schedule(8, 8) + schedule(40, 1, seed=3)
    ring = run_schedule(params, W + 7, True, steps)
    cont = run_schedule(params, 64, False, steps)
    for i, (r, f) in enumerate(zip(ring, cont)):
        np.testing.assert_allclose(r, f, atol=1e-5, err_msg=f"step {i}")


def test_ring_composes_with_int8_kv(params):
    """The reference's bound for this case (two cache widths, two
    reduction trees, int8 round trips): 5e-3, and top-1 exact."""
    steps = schedule(48, 8, seed=5)
    ring = run_schedule(params, 24, True, steps, kv_dtype="int8")
    cont = run_schedule(params, 64, False, steps, kv_dtype="int8")
    for i, (r, f) in enumerate(zip(ring, cont)):
        np.testing.assert_allclose(r, f, atol=5e-3, rtol=5e-3,
                                   err_msg=f"step {i}")
        assert (r.argmax(-1) == f.argmax(-1)).all(), f"step {i}"


def test_ring_matches_jax_ring(params, jparams):
    steps = schedule(48, 8, seed=9)
    jcfg = jl.CONFIGS["tiny-mistral"]
    cache = jl.KVCache.create(jcfg, 2, 24)
    want = []
    for chunk in steps:
        logits, cache = jl.forward(jparams, jcfg, jnp.asarray(chunk), cache,
                                   ring=True)
        want.append(np.asarray(logits[:, -1]))
    got = run_schedule(params, 24, True, steps)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=1e-4, err_msg=f"step {i}")


def test_clobber_capacity_rejected(params):
    """C < W + s - 1: the step's writes would destroy in-window keys
    before its queries attend."""
    cache = tl.KVCache.create(CFG, 1, W + 2, CPU)
    with pytest.raises(AssertionError, match="clobber"):
        tl.forward(params, CFG, torch.ones((1, 8), dtype=torch.long), cache,
                   ring=True)


def test_config_and_engine_rejections():
    for batching, match in (
        (BatchingConfig(kv_tiers=[[64, 2], [256, 2]]), "kv_tiers"),
        (BatchingConfig(prefix_cache_entries=2), "prefix"),
        (BatchingConfig(paged_kv="on"), "paged_kv"),
    ):
        with pytest.raises(ValueError, match=match):
            ServingConfig(model="tiny-mistral", kv_ring=True,
                          batching=batching)
    with pytest.raises(ValueError, match="sliding-window"):
        GenerationEngine(tl.CONFIGS["tiny-llama"],
                         ServingConfig(kv_ring=True), device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        GenerationEngine(CFG, ServingConfig(
            kv_ring=True, batching=BatchingConfig(prefill_chunk=1024)),
            device="cpu")
    eng = GenerationEngine(CFG, ServingConfig(
        kv_ring=True, batching=BatchingConfig(prefill_chunk=8)), device="cpu")
    assert eng.ring_capacity == W + 8 - 1
    with pytest.raises(ValueError, match="ring capacity was sized"):
        ContinuousBatcher(eng, BatchingConfig(prefill_chunk=16))


def _engine(params, **kw):
    return GenerationEngine(CFG, ServingConfig(
        kv_ring=True, batching=BatchingConfig(max_batch_size=4,
                                              prefill_chunk=8), **kw),
        params=params, device="cpu")


async def _serve(batcher, prompts, max_new, sampling=GREEDY):
    batcher.start()

    async def one(p, seed):
        acc: list[int] = []
        async for ids, _ in batcher.submit(p, max_new, sampling, seed=seed):
            acc.extend(ids)
        return acc

    try:
        return await asyncio.gather(*(one(p, i) for i, p in enumerate(prompts)))
    finally:
        await batcher.stop()


def _prompt(n, salt=0):
    return [(i * 11 + 3 + salt) % 500 + 1 for i in range(n)]


async def test_ring_batcher_matches_contiguous_generate(params):
    """Prompt + generation well past the ring's 23 positions: solo, a
    concurrent pair, and a short prompt on the fused route, each equal
    to the contiguous windowed engine's greedy generate."""
    eng = _engine(params)
    ref = GenerationEngine(CFG, ServingConfig(), params=params, device="cpu")
    prompt, short = _prompt(30), [7, 3, 9, 4, 2]
    want = ref.generate([prompt], max_new_tokens=20)[0][0]
    want_short = ref.generate([short], max_new_tokens=30)[0][0]
    b = ContinuousBatcher(eng, BatchingConfig(
        max_batch_size=4, prefill_chunk=8, max_queue_delay_ms=500.0))
    assert b.max_seq == 23 and b._fit_limit == CFG.max_seq_len
    assert b._pfx_pool is None and b._jump_max == 0
    assert await _serve(b, [prompt], 20) == [want]
    assert await _serve(b, [prompt, prompt], 20) == [want, want]
    assert await _serve(b, [short], 30) == [want_short]
    assert b.fused_admissions == 1 and b.chunked_admissions == 3


async def test_ring_mixed_length_group(params):
    """Long prompts of 30, 45 and 60 tokens (4, 6 and 8 chunks) arriving
    together, and a short one: each row's tokens equal its contiguous
    generate. One [R, T, C] grid for all of them would run the shorter
    rows through padding chunks whose writes wrap onto their in-window
    keys; equal-chunk-count groups never do."""
    eng = _engine(params)
    ref = GenerationEngine(CFG, ServingConfig(), params=params, device="cpu")
    prompts = [_prompt(n, salt) for salt, n in enumerate((30, 45, 5, 60))]
    want = [ref.generate([p], max_new_tokens=20)[0][0] for p in prompts]
    b = ContinuousBatcher(eng, BatchingConfig(
        max_batch_size=4, prefill_chunk=8, max_queue_delay_ms=500.0))
    assert await _serve(b, prompts, 20) == want
    assert b.chunked_admissions == 3 and b.timing["admit_rounds"] == 1


async def test_ring_batcher_matches_jax(params, jparams):
    """Greedy and sampled tokens equal the JAX ring batcher's (same
    weights, same prompts; concurrent rows of one chunk count)."""
    jeng = JEngine(
        jl.CONFIGS["tiny-mistral"],
        JServing(model="tiny-mistral", kv_ring=True, mesh=MeshConfig(tensor=1),
                 batching=JBatching(max_batch_size=4, prefill_chunk=8)),
        mesh=mesh_mod.build_mesh(MeshConfig(tensor=1), jax.devices()[:1]),
        params=jparams,
    )
    prompts = [_prompt(30), _prompt(31, 1), [7, 3, 9, 4, 2]]
    cfg = dict(max_batch_size=4, prefill_chunk=8, max_queue_delay_ms=500.0)
    for sampling, jsampling in ((GREEDY, JSampling()),
                                (SamplingConfig(temperature=0.8, top_k=20),
                                 JSampling(temperature=0.8, top_k=20))):
        want = await _serve(JBatcher(jeng, JBatching(**cfg)), prompts, 24,
                            jsampling)
        got = await _serve(ContinuousBatcher(_engine(params),
                                             BatchingConfig(**cfg)),
                           prompts, 24, sampling)
        assert got == want


async def test_ring_int8_batcher(params):
    """The int8 ring batcher against the int8 contiguous engine: top-1
    agreement over a wrapped generation."""
    eng = _engine(params, kv_cache_dtype="int8")
    ref = GenerationEngine(CFG, ServingConfig(kv_cache_dtype="int8"),
                           params=params, device="cpu")
    prompt = _prompt(30)
    want = ref.generate([prompt], max_new_tokens=12)[0][0]
    b = ContinuousBatcher(eng, BatchingConfig(max_batch_size=2,
                                              prefill_chunk=8))
    assert await _serve(b, [prompt], 12) == [want]


def test_ring_cache_bytes(params):
    """The ring holds C positions a slot whatever the context."""
    ring = ContinuousBatcher(_engine(params), BatchingConfig(
        max_batch_size=4, prefill_chunk=8))
    flat = ContinuousBatcher(
        GenerationEngine(CFG, ServingConfig(), params=params, device="cpu"),
        BatchingConfig(max_batch_size=4, prefill_chunk=8,
                       kv_cache_max_seq=CFG.max_seq_len))
    per_pos = 2 * CFG.num_layers * CFG.num_kv_heads * CFG.head_dim * 4 * 4
    assert ring.cache_bytes() == per_pos * (23 + 1)
    assert flat.cache_bytes() == per_pos * (CFG.max_seq_len + 1)
