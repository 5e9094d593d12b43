"""The port on the card: the hand-written CUDA FlashAttention kernel
against its plain PyTorch version, the wrapper's input checks, and the
tiny-llama engine and continuous batcher on CUDA against the same code
on the CPU (which takes the plain versions).

Every test needs an NVIDIA GPU with `nvcc` (the kernel has no CPU
mode) and skips without one. This file imports no JAX, so it runs on a
machine that has only PyTorch: `python -m pytest -m gpu
tests/test_torch_gpu.py`.

Tolerance, elementwise |kernel - plain| <= atol + rtol * |plain|:
float32 1e-4 / 1e-4 (both sides compute in float32; only the summation
order differs). bfloat16 1e-2 / 1.6e-2: both sides round the output to
bf16, so they may differ by a step of the output's magnitude (rtol 1.6e-2
is two steps, torch.testing's bf16 rtol), and the kernel rounds P to bf16
for its P V product, which near-zero outputs see as atol 1e-2.
"""

import asyncio

import numpy as np
import pytest
import torch

from ggrmcp_tpu_torch.core.config import BatchingConfig
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.ops import attention as tatt
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher
from ggrmcp_tpu_torch.serving.engine import GenerationEngine

pytestmark = pytest.mark.gpu

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1.6e-2)}


def _assert_close(out, ref):
    atol, rtol = TOL[ref.dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _qkv(seed, b, sq, sk, h, kvh, d, device, dtype):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return tuple(
        torch.randn(shape, generator=g).to(device, dtype)
        for shape in ((b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d))
    )


def _i32(values, device):
    return None if values is None else torch.tensor(
        values, dtype=torch.int32, device=device
    )


# (name, (b, sq, sk, h, kvh, d), causal, q_offset, kv_len, window)
CASES = [
    ("causal", (2, 256, 256, 4, 4, 64), True, None, None, None),
    ("non_causal", (1, 128, 128, 2, 2, 32), False, None, None, None),
    ("gqa", (2, 128, 128, 8, 2, 128), True, None, None, None),
    ("cached_prefill", (2, 128, 256, 8, 2, 128), True, [0, 64], [128, 192],
     None),
    ("window_cached", (2, 64, 256, 4, 4, 32), True, [128, 70], [192, 134],
     80),
    ("window_long", (1, 512, 512, 4, 2, 128), True, None, None, 100),
    ("ragged", (2, 300, 333, 8, 2, 128), True, [5, 20], [305, 320], None),
    ("dead_row", (2, 64, 128, 4, 2, 32), True, None, [0, 100], None),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "name,shape,causal,q_off,kv_len,window", CASES, ids=[c[0] for c in CASES]
)
def test_kernel_matches_plain(cuda, dtype, name, shape, causal, q_off,
                              kv_len, window):
    q, k, v = _qkv(61, *shape, cuda, dtype)
    kw = dict(causal=causal, window=window, q_offset=_i32(q_off, cuda),
              kv_len=_i32(kv_len, cuda))
    before = tatt.flash_attention.launches
    out = tatt.flash_attention(q, k, v, **kw)
    ref = tatt.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tatt.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    _assert_close(out, ref)
    if name == "dead_row":
        assert not out[0].any()


def test_kernel_reads_strided_cache_views(cuda):
    """The per-layer slice of a [B, S_max + 1, KVH, D] cache (the model's
    chunked-admission operand) is a strided view, read as it is."""
    dtype = torch.bfloat16
    q, _, _ = _qkv(3, 2, 64, 1, 8, 2, 128, cuda, dtype)
    cache_k, cache_v = (
        torch.randn((2, 257, 2, 128), device=cuda).to(dtype) for _ in range(2)
    )
    k, v = cache_k[:, :256], cache_v[:, :256]
    assert not k.is_contiguous()
    kw = dict(q_offset=_i32([128, 192], cuda), kv_len=_i32([192, 256], cuda))
    out = tatt.flash_attention(q, k, v, **kw)
    ref = tatt.flash_attention_ref(q, k.contiguous(), v.contiguous(), **kw)
    torch.cuda.synchronize()
    _assert_close(out, ref)


def test_kernel_copies_views_it_cannot_read(cuda):
    """A bf16 view whose rows are not 16-byte aligned (head_dim sliced
    out of a wider tensor) is made contiguous by the wrapper first."""
    dtype = torch.bfloat16
    wide = torch.randn((2, 128, 4, 72), device=cuda).to(dtype)
    q = wide[..., 4:68]
    assert q.data_ptr() % 16 != 0
    k, v = (torch.randn((2, 128, 2, 64), device=cuda).to(dtype)
            for _ in range(2))
    out = tatt.flash_attention(q, k, v)
    ref = tatt.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    _assert_close(out, ref)


@pytest.mark.parametrize(
    "problem",
    ["float16", "heads", "offset_dtype", "head_dim"],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda, problem):
    dtype = torch.float16 if problem == "float16" else torch.bfloat16
    h, kvh = (6, 4) if problem == "heads" else (8, 2)
    d = 48 if problem == "head_dim" else 64
    q, k, v = _qkv(5, 1, 64, 64, h, kvh, d, cuda, dtype)
    kw = {}
    if problem == "offset_dtype":
        kw["q_offset"] = torch.zeros(1, dtype=torch.int64, device=cuda)
    before = tatt.flash_attention.launches
    with pytest.raises(ValueError):
        tatt.flash_attention(q, k, v, **kw)
    assert tatt.flash_attention.launches == before


def _to(params, device):
    return {
        key: ({n: t.to(device) for n, t in val.items()}
              if isinstance(val, dict) else val.to(device))
        for key, val in params.items()
    }


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(3, 500, n).tolist() for n in (5, 12, 30, 9, 41, 16)]


def test_engine_on_card_matches_cpu(cuda):
    """tiny-llama (float32): the CUDA engine, whose prefill runs the
    kernel, picks the same greedy tokens as the CPU engine on the same
    weights, and its prefill logits agree."""
    cfg = tl.CONFIGS["tiny-llama"]
    cpu_params = tl.init_params(cfg, torch.device("cpu"), seed=11)
    gpu_params = _to(cpu_params, cuda)
    toks = torch.tensor(_prompts()[4][:40])[None]
    ref, _ = tl.forward(cpu_params, cfg, toks)
    before = tatt.flash_attention.launches
    out, _ = tl.forward(gpu_params, cfg, toks.to(cuda))
    assert tatt.flash_attention.launches == before + cfg.num_layers
    assert (out.cpu() - ref).abs().max().item() <= 1e-3

    prompts = _prompts()[:3]
    cpu_eng = GenerationEngine(cfg, params=cpu_params, device="cpu")
    gpu_eng = GenerationEngine(cfg, params=gpu_params, device=cuda)
    assert gpu_eng.generate(prompts, 10) == cpu_eng.generate(prompts, 10)


async def _serve(batcher, prompts):
    async def one(prompt):
        out = []
        async for ids, _ in batcher.submit(prompt, 7, SamplingConfig()):
            out.extend(ids)
        return out

    batcher.start()
    try:
        return await asyncio.gather(*(one(p) for p in prompts))
    finally:
        await batcher.stop()


async def test_batcher_on_card_matches_cpu(cuda):
    """Both admission routes on the card give the CPU batcher's greedy
    tokens, and the chunked route launches the kernel."""
    cfg = tl.CONFIGS["tiny-llama"]
    params = tl.init_params(cfg, torch.device("cpu"), seed=11)
    small = dict(max_batch_size=4, kv_cache_max_seq=256, prefill_chunk=16)
    ref = await _serve(ContinuousBatcher(
        GenerationEngine(cfg, params=params, device="cpu"),
        BatchingConfig(**small)), _prompts())
    gpu_params = _to(params, cuda)
    before = tatt.flash_attention.launches
    batcher = ContinuousBatcher(
        GenerationEngine(cfg, params=gpu_params, device=cuda),
        BatchingConfig(**small))
    out = await _serve(batcher, _prompts())
    assert out == ref
    assert batcher.chunked_admissions > 0 and batcher.fused_admissions > 0
    assert tatt.flash_attention.launches > before
