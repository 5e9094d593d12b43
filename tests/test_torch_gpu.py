"""The port on the card: the hand-written CUDA FlashAttention kernel
against its plain PyTorch version (at the decoder's shapes and at the
BERT encoder's), the wrapper's input checks, the tiny-llama engine and
continuous batcher and the bert-tiny embedding engine on CUDA against
the same code on the CPU (which takes the plain versions), int8
quantization, int8-weight forwards and the int8 KV cache on the card
against the CPU, and the safetensors reader and HF loader reading
straight to the card.

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

int8: `quantize` on the card equals the CPU's bit for bit (IEEE float32
division on both). int8-weight logits, card against CPU: 1e-3, as for
dense weights (the weights are the same bits; the kernel and the CPU's
plain version sum in another order). int8-KV logits: 1e-2, because each
side quantizes its own K/V and a value at a rounding tie of the int8
grid may land one step apart (tests/test_torch_quant.py states the same
bound against the JAX package).
"""

import asyncio
import json

import numpy as np
import pytest
import torch

import chip_smoke
from ggrmcp_tpu_torch.core.config import BatchingConfig
from ggrmcp_tpu_torch.models import bert as tb
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.ops import attention as tatt
from ggrmcp_tpu_torch.ops import quant as tq
from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
from ggrmcp_tpu_torch.serving import safetensors_io
from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher
from ggrmcp_tpu_torch.serving.engine import EmbeddingEngine, GenerationEngine
from ggrmcp_tpu_torch.serving.weights import load_hf_checkpoint

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


def _check_against_plain(cuda, dtype, shape, causal, q_off, kv_len, window,
                         seed=61):
    q, k, v = _qkv(seed, *shape, cuda, dtype)
    kw = dict(causal=causal, window=window, q_offset=_i32(q_off, cuda),
              kv_len=_i32(kv_len, cuda))
    before = tatt.flash_attention.launches
    out = tatt.flash_attention(q, k, v, **kw)
    ref = tatt.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tatt.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    _assert_close(out, ref)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "name,shape,causal,q_off,kv_len,window", CASES, ids=[c[0] for c in CASES]
)
def test_kernel_matches_plain(cuda, dtype, name, shape, causal, q_off,
                              kv_len, window):
    out = _check_against_plain(cuda, dtype, shape, causal, q_off, kv_len,
                               window)
    if name == "dead_row":
        assert not out[0].any()


# The bf16 kernel's tile geometry: 128 query rows x 128 keys per tile,
# persistent blocks (one per SM, 132 on an H100), D = 32 (64-byte
# swizzle), 64 and 128 (128-byte swizzle).
# (name, (b, sq, sk, h, kvh, d), causal, q_offset, kv_len, window)
TILE_CASES = [
    ("d64", (2, 256, 256, 8, 2, 64), True, None, None, None),
    ("d128", (2, 256, 256, 8, 2, 128), True, None, None, None),
    ("d32", (2, 300, 333, 8, 2, 32), True, [5, 20], [305, 320], None),
    ("sq129", (1, 129, 129, 4, 2, 128), True, None, None, None),
    ("sq255_sk300", (2, 255, 300, 4, 1, 64), True, [45, 0], [300, 255],
     None),
    ("sq300_non_causal", (2, 300, 129, 4, 4, 128), False, None, [129, 77],
     None),
    ("kv_len_mid_tile", (2, 64, 512, 8, 2, 128), True, [200, 330],
     [264, 394], None),
    ("window_below_tile", (1, 384, 384, 4, 2, 128), True, None, None, 50),
    ("window_cached_mid_tile", (2, 200, 700, 4, 2, 64), True, [300, 410],
     [500, 610], 77),
    ("more_tiles_than_sms", (4, 1024, 1024, 16, 4, 128), True, None, None,
     None),
    ("more_tiles_than_sms_non_causal", (3, 640, 700, 12, 4, 64), False,
     None, None, None),
    ("more_tiles_than_sms_d32", (2, 1000, 1000, 16, 8, 32), True, None,
     None, None),
]


@pytest.mark.parametrize(
    "name,shape,causal,q_off,kv_len,window", TILE_CASES,
    ids=[c[0] for c in TILE_CASES],
)
def test_bf16_kernel_tile_geometry(cuda, name, shape, causal, q_off, kv_len,
                                   window):
    _check_against_plain(cuda, torch.bfloat16, shape, causal, q_off, kv_len,
                         window)


def test_bf16_kernel_repeats_bitwise(cuda):
    """Back-to-back launches at the fused-admission shape (llama3-8b
    geometry, 4096 tiles over the persistent blocks) give the same bits
    every time: the barrier rings carry no state from one tile or launch
    into the next."""
    q, k, v = _qkv(17, 32, 512, 512, 32, 8, 128, cuda, torch.bfloat16)
    first = tatt.flash_attention(q, k, v)
    before = tatt.flash_attention.launches
    for _ in range(10):
        outs = [tatt.flash_attention(q, k, v) for _ in range(20)]
        torch.cuda.synchronize()
        assert all(torch.equal(out, first) for out in outs)
    assert tatt.flash_attention.launches == before + 200
    _assert_close(first, tatt.flash_attention_ref(q, k, v))


def test_bf16_kernel_dead_rows(cuda):
    """Rows with no valid key inside tiles that have live rows: with
    kv_len 100 and a window of 50, rows at positions >= 149 see no key;
    batch row 1 (kv_len 0) is dead throughout."""
    out = _check_against_plain(cuda, torch.bfloat16, (2, 300, 300, 4, 2, 128),
                               True, None, [100, 0], 50)
    assert not out[0, 149:].any() and out[0, :149].abs().sum() > 0
    assert not out[1].any()


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


@pytest.mark.parametrize("d,s_max", [(128, 4096), (64, 1024)])
def test_kernel_reads_strided_cache_views_at_tile_edges(cuda, d, s_max):
    """The model's chunked-admission operands at serving geometry: K/V
    are [:, :S_max] of a [B, S_max + 1, KVH, D] cache, kv_len and
    q_offset fall inside 128-key tiles, and TMA must neither read the
    scratch position nor need a copy."""
    dtype = torch.bfloat16
    q, _, _ = _qkv(9, 2, 300, 1, 8, 2, d, cuda, dtype)
    cache_k, cache_v = (
        torch.randn((2, s_max + 1, 2, d), device=cuda).to(dtype)
        for _ in range(2)
    )
    cache_k[:, s_max] = cache_v[:, s_max] = float("nan")  # scratch slot
    k, v = cache_k[:, :s_max], cache_v[:, :s_max]
    assert not k.is_contiguous() and tatt._kernel_layout_ok(k)
    kw = dict(q_offset=_i32([s_max - 300, 1000], cuda),
              kv_len=_i32([s_max, 1300], cuda))
    before = tatt.flash_attention.launches
    out = tatt.flash_attention(q, k, v, **kw)
    ref = tatt.flash_attention_ref(q, k.contiguous(), v.contiguous(), **kw)
    torch.cuda.synchronize()
    assert tatt.flash_attention.launches == before + 1
    assert torch.isfinite(out.float()).all()
    _assert_close(out, ref)


@pytest.mark.parametrize("view", ["sliced_head_dim", "offset_base"])
def test_kernel_copies_views_it_cannot_read(cuda, view):
    """A bf16 view the kernel's tensor maps cannot address is copied by
    the wrapper first: head_dim sliced out of a wider tensor (rows not
    16-byte aligned), or a contiguous view whose base sits 8 bytes into
    an allocation (which .contiguous() would keep)."""
    dtype = torch.bfloat16
    if view == "sliced_head_dim":
        wide = torch.randn((2, 128, 4, 72), device=cuda).to(dtype)
        q = wide[..., 4:68]
    else:
        flat = torch.randn(2 * 128 * 4 * 64 + 4, device=cuda).to(dtype)
        q = flat[4:].view(2, 128, 4, 64)
        assert q.is_contiguous()
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


# The BERT encoder's calls: non-causal, D = 64, H = KVH (12 for
# bert-base, a head count that is no power of two, and 3), per-row
# kv_len with a dead row (kv_len 0), q/k/v split views of one fused
# [B, S, 3 H D] projection. (name, b, s, h, kv_len)
BERT_CASES = [
    ("base_128", 4, 128, 12, [128, 17, 0, 100]),
    ("base_300", 3, 300, 12, [300, 129, 0]),
    ("h3_512", 2, 512, 3, [0, 511]),
    ("base_32x64", 32, 64, 12, list(range(2, 66, 2))),
]


@pytest.mark.parametrize("name,b,s,h,kv_len", BERT_CASES,
                         ids=[c[0] for c in BERT_CASES])
def test_bert_shapes_kernel_matches_plain(cuda, name, b, s, h, kv_len):
    g = torch.Generator(device="cpu").manual_seed(23)
    qkv = torch.randn((b, s, 3 * h * 64), generator=g).to(cuda, torch.bfloat16)
    q, k, v = (t.reshape(b, s, h, 64) for t in qkv.chunk(3, dim=-1))
    assert not q.is_contiguous()
    assert all(tatt._kernel_layout_ok(t) for t in (q, k, v))  # no copy
    kw = dict(causal=False, kv_len=_i32(kv_len, cuda))
    before = tatt.flash_attention.launches
    out = tatt.attention(q, k, v, **kw)
    ref = tatt.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tatt.flash_attention.launches == before + 1
    _assert_close(out, ref)
    for row, n in enumerate(kv_len):
        if n == 0:
            assert not out[row].any()


def test_embedding_engine_on_card_matches_cpu(cuda):
    """bert-tiny (float32): the CUDA engine, whose encoder runs the
    kernel once a layer, gives the CPU engine's vectors."""
    cfg = tb.CONFIGS["bert-tiny"]
    params = tb.init_params(cfg, torch.device("cpu"), seed=5)
    rng = np.random.default_rng(5)
    lists = [rng.integers(1, 30522, n).tolist() for n in (5, 60, 1, 33)]
    cpu = EmbeddingEngine(cfg, params=params, device="cpu")
    gpu = EmbeddingEngine(cfg, params=_to(params, cuda), device=cuda)
    for pooling in ("mean", "cls", "max"):
        before = tatt.flash_attention.launches
        out = gpu.embed(lists, pooling)
        assert tatt.flash_attention.launches == before + cfg.num_layers
        np.testing.assert_allclose(out, cpu.embed(lists, pooling), atol=1e-4,
                                   rtol=0)


def test_safetensors_read_straight_to_card(cuda, tmp_path):
    """A bf16 file read onto the card bit for bit, and a small HF
    checkpoint (two files under an index) loaded onto the card equal to
    the same load on the CPU."""
    g = torch.Generator().manual_seed(2)
    tensors = {"w": torch.randn((64, 48), generator=g).to(torch.bfloat16),
               "b": torch.randn((48,), generator=g).to(torch.bfloat16)}
    path = str(tmp_path / "w.safetensors")
    chip_smoke.write_safetensors(path, tensors)
    with safetensors_io.SafetensorsFile(path) as f:
        for name, t in tensors.items():
            got = f.read(name, cuda)
            assert got.is_cuda and torch.equal(got.cpu(), t), name

    hf = dict(chip_smoke.HF_CONFIG, vocab_size=512, hidden_size=256,
              intermediate_size=704, num_attention_heads=8,
              num_key_value_heads=4)
    ckpt = tmp_path / "ck"
    ckpt.mkdir()
    chip_smoke.write_hf_checkpoint(str(ckpt), hf, torch, cuda, seed=4)
    with open(ckpt / "model.safetensors.index.json") as fh:
        assert len(set(json.load(fh)["weight_map"].values())) == 2
    cfg, on_card = load_hf_checkpoint(str(ckpt), cuda)
    _, on_cpu = load_hf_checkpoint(str(ckpt), "cpu")
    assert cfg.rope_scaling == (8.0, 1.0, 4.0, 8192.0)
    for key, val in on_cpu.items():
        pairs = val.items() if isinstance(val, dict) else [(key, val)]
        mine = on_card[key]
        for name, t in pairs:
            got = mine[name] if isinstance(val, dict) else mine
            assert got.is_cuda and torch.equal(got.cpu(), t), name


def _to(params, device):
    def move(t):
        return tq.kv_map(lambda x: x.to(device), t)

    return {
        key: ({n: move(t) for n, t in val.items()}
              if isinstance(val, dict) else move(val))
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


# -- int8 ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("axis", [-2, -1])
def test_quantize_on_card_equals_cpu(cuda, dtype, axis):
    g = torch.Generator().manual_seed(31)
    w = (torch.randn((3, 512, 384), generator=g) * 0.05).to(dtype)
    w[0, :, 7] = 0.0
    w[1, 9, :] = 0.0
    cpu = tq.quantize(w, axis=axis)
    card = tq.quantize(w.to(cuda), axis=axis)
    assert card.q.is_cuda and card.q.dtype == torch.int8
    assert torch.equal(card.q.cpu(), cpu.q)
    assert card.scale.dtype == dtype and torch.equal(card.scale.cpu(), cpu.scale)


def test_int8_forward_on_card_matches_cpu(cuda):
    """tiny-llama (float32) on int8 weights: the card's cache-free
    forward (prefill attention on the kernel) and greedy tokens equal
    the CPU's; an int8-KV prefill and decode step stay off the kernel
    and within the int8-KV bound."""
    cfg = tl.CONFIGS["tiny-llama"]
    cpu_params = tq.quantize_model(tl.init_params(cfg, torch.device("cpu"),
                                                  seed=13))
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

    step = torch.tensor([[17]])
    logits = {}
    before = tatt.flash_attention.launches
    for dev, params in (("cpu", cpu_params), (cuda, gpu_params)):
        cache = tl.KVCache.create(cfg, 1, 64, torch.device(dev), "int8")
        prefill, cache = tl.forward(params, cfg, toks.to(dev), cache)
        decode, _ = tl.forward(params, cfg, step.to(dev), cache)
        logits[str(dev)] = (prefill.cpu(), decode.cpu())
    assert tatt.flash_attention.launches == before
    for a, b in zip(logits["cpu"], logits[str(cuda)]):
        assert (a - b).abs().max().item() <= 1e-2


def test_int8_kv_writes_past_end_land_in_scratch_on_card(cuda):
    """Values and scales written past S_max land in the scratch position
    of both leaves on the card; the cache proper keeps its bytes."""
    cfg = tl.CONFIGS["tiny-llama"]
    params = _to(tq.quantize_model(tl.init_params(cfg, torch.device("cpu"),
                                                  seed=3)), cuda)
    cache = tl.KVCache.create(cfg, 1, 8, cuda, "int8")
    tl.forward(params, cfg, torch.arange(3, 9, device=cuda)[None], cache)
    before = (cache.k.q[:, :, :6].clone(), cache.v.scale[:, :, :6].clone())
    logits, cache = tl.forward(params, cfg,
                               torch.arange(20, 24, device=cuda)[None], cache)
    torch.cuda.synchronize()
    assert torch.isfinite(logits).all()
    assert torch.equal(cache.k.q[:, :, :6], before[0])
    assert torch.equal(cache.v.scale[:, :, :6], before[1])
    assert (cache.k.scale[:, :, 6:] != 0).all()  # 6, 7 and the scratch
    assert int(cache.length[0]) == 10
