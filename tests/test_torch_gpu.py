"""The port on the card: the hand-written CUDA FlashAttention kernel
against its plain PyTorch version (at the decoder's shapes and at the
BERT encoder's), the wrapper's input checks, the tiny-llama engine and
continuous batcher and the bert-tiny embedding engine on CUDA against
the same code on the CPU (which takes the plain versions), int8
quantization, int8-weight forwards and the int8 KV cache on the card
against the CPU, the safetensors reader and HF loader reading
straight to the card, and the KV-reuse paths (paged forward, the prefix
pool, paged KV and the interleave through the batcher) against the CPU,
and constrained decoding (the masked tick and the jump-ahead tick, whose
[B, 1 + jump_max] window launches the kernel) against the CPU, with the
threefry draws bit-identical on both, and speculative decoding (the
[B, gamma + 1] verify window through the kernel, the spec tick against
the CPU) and the ring cache (whose steps never launch the kernel), and
the sparse-MoE family (its FFN on the card against the CPU and, in
bf16, against its float32 one-hot form; the batcher's routes against
the CPU), and tensor parallelism (the kernel at a tensor shard's head
count; two shards on one card against one shard; eight, whose cache
holds every KV head, still launching the kernel a shard), and training
(the kernel's forward under autograd with the plain version's gradient:
its output carries a graph, its dq / dk / dv equal autograd's through
the plain version; three AdamW steps of tiny-llama on the card against
the CPU: losses at rtol 1e-4, each leaf within 1e-4 of its largest
entry save at most one entry in 10^4).

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
import dataclasses
import json

import numpy as np
import pytest
import torch

import chip_smoke
from ggrmcp_tpu_torch.core.config import BatchingConfig, GrammarConfig, ServingConfig
from ggrmcp_tpu_torch.grammar import compile_schema
from ggrmcp_tpu_torch.models import bert as tb
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.models import moe as tm
from ggrmcp_tpu_torch.ops import attention as tatt
from ggrmcp_tpu_torch.ops import quant as tq
from ggrmcp_tpu_torch.ops import sampling as ts
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
    # KV reuse: a prefix hit's 32-wide suffix step at per-row offsets,
    # and an interleave chunk whose rows sit at different offsets (row 0
    # is an idle row's launch: offset 0, kv_len = the chunk).
    ("pfx_suffix_sq32", (4, 32, 512, 8, 2, 128), True, [256, 300, 448, 7],
     [288, 332, 480, 39], None),
    ("ilv_row_offsets", (4, 64, 512, 8, 2, 128), True, [0, 64, 192, 448],
     [64, 128, 256, 512], None),
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


# -- KV reuse -----------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_paged_forward_on_card_matches_contiguous(cuda, kv_dtype):
    """A prefill and a decode step through a paged cache with scattered
    pages equal the contiguous cache's on the card (attention_ref on
    both), and the CPU's paged forward to 1e-3."""
    cfg = tl.CONFIGS["tiny-llama"]
    cpu_params = tl.init_params(cfg, torch.device("cpu"), seed=5)
    params = _to(cpu_params, cuda)
    b, s_max, page = 3, 64, 8
    perm = torch.from_numpy(np.random.default_rng(2).permutation(30)[
        : b * s_max // page].reshape(b, -1).astype(np.int32))
    toks = torch.from_numpy(np.random.default_rng(1).integers(3, 500, (b, 20)))
    outs = []
    for device in (cuda, cuda, torch.device("cpu")):
        paged = len(outs) != 0
        if paged:
            cache = tl.PagedKVCache.create(cfg, b, s_max, 30, page, device,
                                           kv_dtype)
            cache.table = perm.to(device)
        else:
            cache = tl.KVCache.create(cfg, b, s_max, device, kv_dtype)
        p = params if device.type == "cuda" else cpu_params
        first, _ = tl.forward(p, cfg, toks.to(device), cache, use_flash=False)
        step, _ = tl.forward(p, cfg, toks[:, :1].to(device) + 1, cache,
                             use_flash=False)
        outs.append((first.cpu(), step.cpu()))
    for flat, paged, cpu in zip(*outs):
        assert torch.equal(flat, paged)
        assert (paged - cpu).abs().max().item() <= (1e-2 if kv_dtype else 1e-3)


async def _reuse_waves(batcher, waves, late=()):
    """The waves one after another; the `late` prompts join the last
    wave once one of its requests has its first token."""
    started = asyncio.Event()

    async def one(prompt, seed):
        out = []
        async for ids, _ in batcher.submit(prompt, 6, SamplingConfig(),
                                           seed=seed):
            started.set()
            out.extend(ids)
        return out

    async def after_first(prompt, seed):
        await started.wait()
        return await one(prompt, seed)

    batcher.start()
    try:
        outs = [await asyncio.gather(*(one(p, i) for i, p in enumerate(w)))
                for w in waves[:-1]]
        started.clear()
        last = [one(p, i) for i, p in enumerate(waves[-1])]
        last += [after_first(p, 50 + i) for i, p in enumerate(late)]
        return outs + [await asyncio.gather(*last)]
    finally:
        await batcher.stop()


@pytest.mark.parametrize("switch", [
    dict(prefix_cache_entries=2, prefix_cache_min_seq=8,
         prefix_cache_max_seq=64),
    dict(paged_kv="on", paged_kv_page_size=8),
    dict(prefill_interleave="on", prefill_interleave_rows=2),
], ids=["prefix_pool", "paged", "interleave"])
async def test_kv_reuse_batcher_on_card_matches_cpu(cuda, switch):
    """Each KV-reuse route on the card gives the CPU batcher's greedy
    tokens and counters: a warm request, then a same-preamble wave, and
    a long prompt arriving while the wave decodes (interleaved when
    that is on)."""
    cfg = tl.CONFIGS["tiny-llama"]
    params = tl.init_params(cfg, torch.device("cpu"), seed=11)
    head = [(i * 13 + 5) % 500 + 1 for i in range(40)]
    waves = [[head + [401]], [head + [410 + i] for i in range(3)]]
    small = dict(max_batch_size=4, kv_cache_max_seq=256, prefill_chunk=32,
                 max_queue_delay_ms=1000.0, **switch)
    runs = []
    for device, p in (("cpu", params), (cuda, _to(params, cuda))):
        batcher = ContinuousBatcher(GenerationEngine(cfg, params=p,
                                                     device=device),
                                    BatchingConfig(**small))
        before = tatt.flash_attention.launches
        outs = await _reuse_waves(batcher, waves,
                                  late=[list(range(3, 103))])
        runs.append((outs, batcher.stats(),
                     tatt.flash_attention.launches - before))
    (ref, ref_stats, _), (out, stats, launched) = runs
    assert out == ref
    keys = ("prefix_cache_hits", "prefix_cache_misses", "paged_prefix_hits",
            "kv_pages_in_use", "interleaved_admissions", "interleaved_chunks")
    assert {k: stats[k] for k in keys} == {k: ref_stats[k] for k in keys}
    assert launched > 0
    if "prefill_interleave" in switch:
        assert stats["interleaved_admissions"] == 1
    else:
        assert stats["prefix_cache_hits"] >= 3


async def test_wave_hit_logits_match_cold_on_card(cuda):
    """tiny-llama (float32) on the card: a prefix-pool hit's final logits
    (pool entry + one suffix step) equal a cold chunked prefill's to
    1e-3 — chip_smoke.py phase 9's check at llama3-8b width."""
    cfg = tl.CONFIGS["tiny-llama"]
    params = _to(tl.init_params(cfg, torch.device("cpu"), seed=13), cuda)
    batcher = ContinuousBatcher(
        GenerationEngine(cfg, params=params, device=cuda),
        BatchingConfig(max_batch_size=4, kv_cache_max_seq=256,
                       prefill_chunk=32, prefix_cache_entries=2,
                       prefix_cache_min_seq=8, prefix_cache_max_seq=64))
    head = [(i * 7 + 3) % 500 + 1 for i in range(64)]
    await _reuse_waves(batcher, [[head + [9, 8]]])
    hit, cold = chip_smoke.pfx_hit_vs_cold(torch, batcher, head + [11, 12, 13])
    assert (hit - cold).abs().max().item() <= 1e-3


# -- grammar ------------------------------------------------------------------


GRAMMARS = [
    {"type": "object", "properties": {"kind": {"const": "structured"},
                                      "ok": {"type": "boolean"}},
     "required": ["kind", "ok"]},
    {"type": "object", "properties": {"mode": {"enum": ["alpha", "beta"]},
                                      "n": {"type": "integer"}},
     "required": ["mode", "n"]},
    {"type": "array", "items": {"type": "string", "maxLength": 3},
     "maxItems": 2},
]


async def _constrained(batcher, vocab):
    """Three constrained greedy rows and an unconstrained one at once."""
    async def one(i, schema):
        out = []
        grammar = None if schema is None else compile_schema(schema, vocab)
        async for ids, _ in batcher.submit([3 + i, 1, 4], 120,
                                           SamplingConfig(), grammar=grammar):
            out.extend(ids)
        return out

    batcher.start()
    try:
        return await asyncio.gather(*(
            one(i, s) for i, s in enumerate(GRAMMARS + [None])))
    finally:
        await batcher.stop()


@pytest.mark.parametrize("jump_max", [8, 0], ids=["jump", "masked"])
async def test_constrained_ticks_on_card_match_cpu(cuda, jump_max):
    """tiny-llama (float32): the masked tick (jump off) and the jump tick
    on the card give the CPU batcher's constrained greedy tokens; the
    jump tick's [4, 9] window launches the kernel once a layer."""
    cfg = tl.CONFIGS["tiny-llama"]
    params = tl.init_params(cfg, torch.device("cpu"), seed=11)
    serving = ServingConfig(grammar=GrammarConfig(jump_max=jump_max))
    small = dict(max_batch_size=4, kv_cache_max_seq=256,
                 max_queue_delay_ms=1000.0)
    runs = []
    for device, p in (("cpu", params), (cuda, _to(params, cuda))):
        batcher = ContinuousBatcher(
            GenerationEngine(cfg, serving, params=p, device=device),
            BatchingConfig(**small))
        jumped = []
        if device != "cpu" and jump_max:
            real = batcher._tick_jump_impl

            def counted(*args, _real=real, **kwargs):
                before = tatt.flash_attention.launches
                out = _real(*args, **kwargs)
                jumped.append(tatt.flash_attention.launches - before)
                return out

            batcher._tick_jump_impl = counted
        runs.append((await _constrained(batcher, cfg.vocab_size),
                     batcher.grammar_jump_runs, jumped))
    (ref, ref_runs, _), (out, runs_gpu, jumped) = runs
    assert out == ref
    assert runs_gpu == ref_runs
    if jump_max:
        assert runs_gpu > 0 and jumped
        assert all(n == cfg.num_layers for n in jumped)


async def test_jump_on_equals_off_on_card(cuda):
    cfg = tl.CONFIGS["tiny-llama"]
    params = _to(tl.init_params(cfg, torch.device("cpu"), seed=12), cuda)
    outs = []
    for jump_max in (8, 0):
        batcher = ContinuousBatcher(
            GenerationEngine(cfg, ServingConfig(grammar=GrammarConfig(
                jump_max=jump_max)), params=params, device=cuda),
            BatchingConfig(max_batch_size=4, kv_cache_max_seq=256))
        outs.append(await _constrained(batcher, cfg.vocab_size))
    assert outs[0] == outs[1]


def test_threefry_bits_identical_on_card_and_cpu(cuda):
    seeds = torch.tensor([0, 1, 2**31 - 1, 2**32 - 1, 123456789, 77])
    for step in (0, 1, 9, 10**6):
        cpu = ts.uniform(ts.fold_in(ts.prng_key(seeds), step))
        gpu = ts.uniform(ts.fold_in(ts.prng_key(seeds.to(cuda)), step))
        assert torch.equal(gpu.cpu().view(torch.int32),
                           cpu.view(torch.int32))
    key = ts.fold_in(ts.prng_key(torch.tensor(5)), 3)
    rows = torch.arange(32)
    assert torch.equal(
        ts.uniform(ts.fold_in(key.to(cuda), rows.to(cuda))).cpu(),
        ts.uniform(ts.fold_in(key, rows)))


# -- the control plane ----------------------------------------------------------


def test_ledger_reconciles_to_the_allocator(cuda):
    """attributed + unattributed == torch.cuda.memory_allocated(): the
    ledger's closure holds on the card by construction, with the weights
    and the KV arena the engine's and the cache's bytes."""
    cfg = tl.CONFIGS["tiny-llama"]
    params = _to(tl.init_params(cfg, torch.device("cpu"), seed=11), cuda)
    engine = GenerationEngine(cfg, params=params, device=cuda)
    batcher = ContinuousBatcher(engine, BatchingConfig(
        max_batch_size=4, kv_cache_max_seq=256))
    rec = engine.ledger.reconcile()
    assert rec["live_bytes"] == torch.cuda.memory_allocated(cuda)
    assert rec["attributed_bytes"] + rec["unattributed_bytes"] == (
        rec["live_bytes"])
    assert rec["components"]["weights"] == engine.weight_bytes()
    assert rec["components"]["kv_arena"] == batcher.cache.nbytes()
    assert rec["unattributed_bytes"] >= 0


def test_profile_capture_holds_the_kernel(cuda, tmp_path):
    """A torch.profiler capture while prefills run on another thread
    holds CUDA kernel events, the attention kernel's among them."""
    import threading

    from ggrmcp_tpu_torch.utils import tracing

    cfg = tl.CONFIGS["tiny-llama"]
    params = _to(tl.init_params(cfg, torch.device("cpu"), seed=11), cuda)
    toks = torch.tensor(_prompts()[4][:40], device=cuda)[None]
    tl.forward(params, cfg, toks)  # build and load the kernel first
    stop = threading.Event()

    def prefills():
        with torch.no_grad():
            while not stop.is_set():
                tl.forward(params, cfg, toks)
                torch.cuda.synchronize(cuda)

    worker = threading.Thread(target=prefills)
    worker.start()
    try:
        path = tracing.profile_capture(300, str(tmp_path), cuda=True)
    finally:
        stop.set()
        worker.join(60)
    assert not worker.is_alive()
    with open(path) as fh:
        names = {e["name"] for e in tracing.kernel_events(json.load(fh))}
    assert any("flash_fwd" in n for n in names), sorted(names)[:20]


async def _preempt_cycle(batcher, victims, interactive):
    """Victims decode (each has a token), then the interactive request
    arrives behind the full pool; outputs in that order."""
    loop = asyncio.get_running_loop()
    batcher.start()
    try:
        firsts = [loop.create_future() for _ in victims]

        async def one(prompt, max_new, qos, first=None):
            out = []
            async for ids, _ in batcher.submit(prompt, max_new,
                                               SamplingConfig(),
                                               qos_class=qos):
                out.extend(ids)
                if first is not None and not first.done():
                    first.set_result(None)
            return out

        tasks = [asyncio.ensure_future(one(p, n, "batch", f))
                 for (p, n), f in zip(victims, firsts)]
        await asyncio.wait_for(asyncio.gather(*firsts), timeout=120)
        late = [await one(*interactive, "interactive")] if interactive else []
        return [await t for t in tasks] + late
    finally:
        await batcher.stop()


async def test_preempt_and_tick_fail_on_card_match_cpu(cuda):
    """tiny-llama float32 on the card: a preempt cycle (one victim
    demoted, parked and resumed by re-prefill) and a run under
    tick_fail:every=3 give the tokens of the uninterrupted run on the
    CPU, bit for bit."""
    from ggrmcp_tpu_torch.core.config import SchedulerConfig
    from ggrmcp_tpu_torch.utils import failpoints

    cfg = tl.CONFIGS["tiny-llama"]
    params = tl.init_params(cfg, torch.device("cpu"), seed=11)
    victims = [(_prompts()[2], 12), (_prompts()[4], 10)]
    interactive = (_prompts()[0], 4)
    small = dict(max_batch_size=2, kv_cache_max_seq=256, prefill_chunk=16)
    cpu_eng = GenerationEngine(cfg, params=params, device="cpu")
    base = await _preempt_cycle(
        ContinuousBatcher(cpu_eng, BatchingConfig(**small)), victims, None)
    base += await _preempt_cycle(
        ContinuousBatcher(cpu_eng, BatchingConfig(**small)),
        [interactive], None)
    gpu_params = _to(params, cuda)
    sched = ServingConfig(scheduler=SchedulerConfig(
        enabled=True, preempt_wait_fraction=1e-6))
    batcher = ContinuousBatcher(
        GenerationEngine(cfg, sched, params=gpu_params, device=cuda),
        BatchingConfig(**small))
    assert await _preempt_cycle(batcher, victims, interactive) == base
    stats = batcher.stats()
    assert stats["sched_preemptions"] == stats["sched_resumes"] == 1

    prompts = _prompts()
    ref = await _serve(ContinuousBatcher(cpu_eng, BatchingConfig(
        max_batch_size=4, kv_cache_max_seq=256, prefill_chunk=16)), prompts)
    failpoints.registry.arm("tick_fail", every=3)
    try:
        batcher = ContinuousBatcher(
            GenerationEngine(cfg, params=gpu_params, device=cuda),
            BatchingConfig(max_batch_size=4, kv_cache_max_seq=256,
                           prefill_chunk=16, tick_retry_limit=32))
        assert await _serve(batcher, prompts) == ref
    finally:
        failpoints.registry.disarm()
    assert batcher.stats()["replayed_requests"] > 0


def _seq_prompts():
    return [[(i * 13 + s * 71 + 5) % 500 + 1 for i in range(32)] + [400 + s]
            for s in range(4)] * 2


async def _serve_seq(batcher, prompts, max_new=4, **kw):
    """Prompts one after another (deterministic arena pressure); the
    counters are read before stop (stop closes the host pool)."""
    batcher.start()
    try:
        outs = []
        for p in prompts:
            out = []
            async for ids, _ in batcher.submit(p, max_new, SamplingConfig(),
                                               **kw):
                out.extend(ids)
            outs.append(out)
        return outs, batcher.stats()
    finally:
        await batcher.stop()


async def test_host_tier_on_card_matches_cpu(cuda):
    """tiny-llama float32: the host page tier on the card (pages gathered
    to the host and written back) gives the CPU's greedy tokens and
    demotion / restore counters, and so does a preempt cycle whose
    resume restores the victim's parked pages."""
    from ggrmcp_tpu_torch.core.config import SchedulerConfig

    cfg = tl.CONFIGS["tiny-llama"]
    params = tl.init_params(cfg, torch.device("cpu"), seed=11)
    small = dict(max_batch_size=2, kv_cache_max_seq=128, paged_kv="on",
                 paged_kv_page_size=8, paged_kv_pages=16,
                 paged_kv_host_bytes=64 << 20)
    runs = []
    for device, p in (("cpu", params), (cuda, _to(params, cuda))):
        runs.append(await _serve_seq(ContinuousBatcher(
            GenerationEngine(cfg, params=p, device=device),
            BatchingConfig(**small)), _seq_prompts()))
    (ref, ref_stats), (out, stats) = runs
    assert out == ref
    keys = ("kv_host_demotions", "kv_host_restores", "kv_host_bytes_demoted",
            "kv_host_bytes_restored", "paged_pages_reused")
    assert {k: stats[k] for k in keys} == {k: ref_stats[k] for k in keys}
    assert stats["kv_host_restores"] > 0

    victims = [([(i * 7 + 3) % 500 + 1 for i in range(40)], 12)]
    interactive = ([(i * 11 + 2) % 500 + 1 for i in range(56)], 8)
    one = dict(small, max_batch_size=1, paged_kv_pages=12)
    cpu_eng = GenerationEngine(cfg, params=params, device="cpu")
    base = await _preempt_cycle(
        ContinuousBatcher(cpu_eng, BatchingConfig(**one)), victims, None)
    base += await _preempt_cycle(
        ContinuousBatcher(cpu_eng, BatchingConfig(**one)), [interactive],
        None)
    sched = ServingConfig(scheduler=SchedulerConfig(
        enabled=True, preempt_wait_fraction=1e-6))
    batcher = ContinuousBatcher(
        GenerationEngine(cfg, sched, params=_to(params, cuda), device=cuda),
        BatchingConfig(**one))
    assert await _preempt_cycle(batcher, victims, interactive) == base
    stats = batcher.stats()
    assert stats["sched_resumes"] >= 1 and stats["kv_host_restores"] >= 1


async def test_kv_export_import_on_card_matches_cpu(cuda):
    """Pages exported on the card import into another card batcher and
    into a CPU one (and the reverse), bit for bit through the wire codec;
    each decode replica gives the one-replica CPU tokens. A bf16 arena's
    pages round-trip the codec bit for bit."""
    from ggrmcp_tpu_torch.serving import tensors

    cfg = tl.CONFIGS["tiny-llama"]
    params = tl.init_params(cfg, torch.device("cpu"), seed=11)
    small = dict(max_batch_size=2, kv_cache_max_seq=256, paged_kv="on",
                 paged_kv_page_size=8)
    prompt = [(i * 13 + 5) % 500 + 1 for i in range(60)]
    engs = {"cpu": GenerationEngine(cfg, params=params, device="cpu"),
            "cuda": GenerationEngine(cfg, params=_to(params, cuda),
                                     device=cuda)}

    def make(where):
        return ContinuousBatcher(engs[where], BatchingConfig(**small))

    mixed = make("cpu")
    want, _ = await _serve_seq(mixed, [prompt], max_new=10)
    for src_at, dst_at in (("cuda", "cuda"), ("cuda", "cpu"), ("cpu", "cuda")):
        src, dst = make(src_at), make(dst_at)
        src.start()
        dst.start()
        try:
            async for _ in src.submit(prompt, 1, SamplingConfig()):
                pass
            export = await src.run_host_op(lambda: src.export_prompt_kv(prompt))
            k, v, _, _ = tensors.unpack_kv_pages(
                tensors.pack_kv_pages(export["k"], export["v"]))
            imported, _ = await dst.run_host_op(
                lambda: dst.import_prompt_kv(prompt, 0, k, v))
            assert imported == export["pages"] == 7
            again = dst._gather_pages(dst.pages.chain_pages(prompt))
            assert torch.equal(again["k"], export["k"])
        finally:
            await src.stop()
            await dst.stop()
        got, stats = await _serve_seq(dst, [prompt], max_new=10)
        assert got == want, (src_at, dst_at)
    bf16 = dataclasses_replace(cfg, dtype="bfloat16")
    eng = GenerationEngine(bf16, params=_to(
        tl.init_params(bf16, torch.device("cpu"), seed=11), cuda), device=cuda)
    b = ContinuousBatcher(eng, BatchingConfig(**small))
    b.start()
    try:
        async for _ in b.submit(prompt, 1, SamplingConfig()):
            pass
        export = await b.run_host_op(lambda: b.export_prompt_kv(prompt))
    finally:
        await b.stop()
    assert export["k"].dtype == torch.bfloat16
    k, v, _, _ = tensors.unpack_kv_pages(
        tensors.pack_kv_pages(export["k"], export["v"]))
    assert torch.equal(k, export["k"]) and torch.equal(v, export["v"])


def dataclasses_replace(cfg, **kw):
    import dataclasses

    return dataclasses.replace(cfg, **kw)


async def test_lora_on_card_matches_cpu(cuda, tmp_path):
    """Boot-time adapters and the registry arena on the card: a mixed
    burst of base and adapter'd requests (the arena churning its rows)
    gives the CPU's greedy tokens; a zero-b adapter equals base bit for
    bit."""
    from ggrmcp_tpu_torch.core.config import LoraConfig

    cfg = tl.CONFIGS["tiny-llama"]
    params = tl.init_params(cfg, torch.device("cpu"), seed=11)
    out = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    rng = np.random.default_rng(5)
    for name in ("a0", "a1", "a2"):
        np.savez(tmp_path / f"{name}.npz",
                 a=rng.normal(0, 0.25, (cfg.num_layers, cfg.hidden_dim, 4)),
                 b=rng.normal(0, 0.25, (cfg.num_layers, 4, out)))
    np.savez(tmp_path / "zero.npz",
             a=rng.normal(0, 0.25, (cfg.num_layers, cfg.hidden_dim, 4)),
             b=np.zeros((cfg.num_layers, 4, out)))
    # Three rows: each wave's three adapters fit; the second wave's
    # evict the first's.
    serving = ServingConfig(lora=LoraConfig(registry=str(tmp_path), rank=4,
                                            arena_rows=3))
    prompts = _prompts()
    names = ["a0", "", "a1", "a2", "zero", "a0"]
    runs = []
    for device, p in (("cpu", params), (cuda, _to(params, cuda))):
        eng = GenerationEngine(cfg, serving, params=dict(p, layers=dict(
            p["layers"])), device=device)
        batcher = ContinuousBatcher(eng, BatchingConfig(
            max_batch_size=4, kv_cache_max_seq=256, prefill_chunk=16))
        batcher.start()
        try:
            async def one(prompt, name):
                kw = {}
                if name:
                    lease = await batcher.acquire_adapter(name)
                    kw = dict(adapter=lease.row, adapter_key=name,
                              adapter_lease=lease)
                got = []
                async for ids, _ in batcher.submit(prompt, 7,
                                                   SamplingConfig(), **kw):
                    got.extend(ids)
                return got

            outs = []
            for wave in (range(3), range(3, 6)):
                outs += await asyncio.gather(*(
                    one(prompts[i], names[i]) for i in wave))
        finally:
            await batcher.stop()
        base = eng.generate([prompts[4]], max_new_tokens=7)[0][0]
        runs.append((outs, base, eng.lora_stats()))
    (ref, _, ref_stats), (got, base, stats) = runs
    assert got == ref
    assert got[4] == base  # the zero-b adapter is the base model
    assert stats["lora_evictions"] == ref_stats["lora_evictions"] > 0


# -- speculative decoding and the ring ---------------------------------------


async def _drain(batcher, prompt, max_new):
    out = []
    async for ids, _ in batcher.submit(prompt, max_new, SamplingConfig()):
        out.extend(ids)
    return out


def test_verify_window_kernel(cuda):
    """The speculative verify window through B1: [8, gamma + 1 = 5]
    queries at ragged offsets over a strided 1025-position pool slice,
    mistral-7b's head geometry with a window, bf16, against the plain
    version."""
    b, sq, sk, h, kvh, d = 8, 5, 1024, 32, 8, 128
    g = torch.Generator(device="cpu").manual_seed(21)
    q = torch.randn((b, sq, h, d), generator=g).to(cuda, torch.bfloat16)
    kc, vc = (torch.randn((b, sk + 1, kvh, d), generator=g).to(
        cuda, torch.bfloat16) for _ in range(2))
    k, v = kc[:, :sk], vc[:, :sk]
    offs = torch.tensor([16 + 120 * i for i in range(b)], dtype=torch.int32,
                        device=cuda)
    kw = dict(causal=True, q_offset=offs, kv_len=offs + sq, window=512)
    before = tatt.flash_attention.launches
    out = tatt.flash_attention(q, k, v, **kw)
    assert tatt.flash_attention.launches == before + 1
    _assert_close(out, tatt.flash_attention_ref(q, k, v, **kw))


async def test_spec_tick_on_card_matches_cpu(cuda):
    """tiny-llama (float32), a tiny-llama draft of other weights: greedy
    spec-on tokens on the card equal the CPU's and spec-off's, and every
    verify launches B1 once a layer."""
    cfg = tl.CONFIGS["tiny-llama"]
    cpu = torch.device("cpu")
    params = tl.init_params(cfg, cpu, seed=13)
    draft = tl.init_params(cfg, cpu, seed=14)
    serving = ServingConfig(speculative_draft="tiny-llama")
    prompts = [[3, 1, 4, 1], [2, 7, 1], [5, 5, 5, 5, 5], [9, 9]]
    outs, launches = [], []
    for device, spec in (("cpu", "on"), (cuda, "on"), (cuda, "off")):
        p = params if device == "cpu" else _to(params, cuda)
        dp = draft if device == "cpu" else _to(draft, cuda)
        batcher = ContinuousBatcher(
            GenerationEngine(cfg, serving, params=p, device=device,
                             draft_params=dp),
            BatchingConfig(max_batch_size=4, kv_cache_max_seq=256,
                           speculative=spec, max_queue_delay_ms=1000.0))
        if device != "cpu" and spec == "on":
            real = batcher._tick_spec_impl

            def counted(*args, _real=real, **kwargs):
                before = tatt.flash_attention.launches
                out = _real(*args, **kwargs)
                launches.append(tatt.flash_attention.launches - before)
                return out

            batcher._tick_spec_impl = counted
        batcher.start()
        try:
            outs.append(await asyncio.gather(*(
                _drain(batcher, pr, 10) for pr in prompts)))
        finally:
            await batcher.stop()
    assert outs[0] == outs[1] == outs[2]
    assert launches and all(n == cfg.num_layers for n in launches)


def test_ring_step_on_card(cuda):
    """tiny-mistral (float32): chunks through a ring past its capacity on
    the card equal a contiguous cache's logits, and the ring's steps
    never launch B1 (its positions take `attention_ref`)."""
    cfg = tl.CONFIGS["tiny-mistral"]
    params = _to(tl.init_params(cfg, torch.device("cpu"), seed=15), cuda)
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(1, 500, (2, 48))).to(cuda)
    ring = tl.KVCache.create(cfg, 2, 24, cuda)
    flat = tl.KVCache.create(cfg, 2, 64, cuda)
    for off in range(0, 48, 8):
        before = tatt.flash_attention.launches
        r, ring = tl.forward(params, cfg, tokens[:, off:off + 8], ring,
                             ring=True)
        assert tatt.flash_attention.launches == before
        f, flat = tl.forward(params, cfg, tokens[:, off:off + 8], flat,
                             use_flash=False)
        torch.testing.assert_close(r[:, -1], f[:, -1], atol=1e-4, rtol=1e-4)


# -- sparse MoE -------------------------------------------------------------


def test_moe_ffn_on_card(cuda):
    """tiny-moe widths at a binding capacity with padding masked: the
    FFN by index on the card equals the CPU's in float32, and in bf16
    its float32 one-hot form within chip_smoke.py's phase-14 bound."""
    cfg = dataclasses.replace(tm.CONFIGS["tiny-moe"], capacity_factor=0.5)
    params = tm.init_params(cfg, torch.device("cpu"), seed=16)
    lp = {k: v[0] for k, v in params["layers"].items()}
    g = torch.Generator().manual_seed(0)
    x = torch.randn((4, 32, cfg.hidden_dim), generator=g)
    valid = torch.rand((4, 32), generator=g) > 0.2
    ref, _ = tm.moe_ffn(x, lp, cfg, valid)
    on_card = {k: v.to(cuda) for k, v in lp.items()}
    out, _ = tm.moe_ffn(x.to(cuda), on_card, cfg, valid.to(cuda))
    torch.testing.assert_close(out.cpu(), ref, atol=1e-4, rtol=1e-4)
    bf16 = {k: v if k == "router" else v.to(torch.bfloat16)
            for k, v in on_card.items()}
    xb = x.to(cuda, torch.bfloat16)
    outb, _ = tm.moe_ffn(xb, bf16, cfg, valid.to(cuda))
    ref32, _ = tm.moe_ffn_ref(xb.float(), {k: v.float() for k, v in
                                           bf16.items()}, cfg, valid.to(cuda))
    rel = ((outb.float() - ref32).norm() / ref32.norm()).item()
    assert rel <= chip_smoke.MOE_FFN_REL


async def test_moe_batcher_on_card_matches_cpu(cuda):
    """tiny-moe (float32): fused and chunked admissions and the decode
    ticks on the card give the CPU batcher's greedy tokens; the chunked
    route launches B1."""
    cfg = tm.CONFIGS["tiny-moe"]
    params = tm.init_params(cfg, torch.device("cpu"), seed=17)
    small = dict(max_batch_size=4, kv_cache_max_seq=256, prefill_chunk=16,
                 max_queue_delay_ms=1000.0)
    ref = await _serve(ContinuousBatcher(
        GenerationEngine(cfg, params=params, device="cpu"),
        BatchingConfig(**small)), _prompts())
    before = tatt.flash_attention.launches
    batcher = ContinuousBatcher(
        GenerationEngine(cfg, params=_to(params, cuda), device=cuda),
        BatchingConfig(**small))
    out = await _serve(batcher, _prompts())
    assert out == ref
    assert batcher.chunked_admissions > 0 and batcher.fused_admissions > 0
    assert tatt.flash_attention.launches > before


def test_kernel_at_a_tensor_shard_shape(cuda):
    """B1 at one of two tensor shards of llama3-8b (H 16, KVH 4, D 128),
    bf16, from the shard's strided q view of its fused projection and
    its own cache slice, against the plain version: one launch."""
    b, s, h, kvh, d = 4, 256, 16, 4, 128
    g = torch.Generator(device="cpu").manual_seed(23)
    qkv = torch.randn((b, s, (h + 2 * kvh) * d), generator=g).to(
        cuda, torch.bfloat16)
    q = qkv[..., :h * d].reshape(b, s, h, d)
    kc, vc = (torch.randn((b, s + 1, kvh, d), generator=g).to(
        cuda, torch.bfloat16) for _ in range(2))
    k, v = kc[:, :s], vc[:, :s]
    kw = dict(causal=True,
              q_offset=torch.zeros(b, dtype=torch.int32, device=cuda),
              kv_len=torch.full((b,), s, dtype=torch.int32, device=cuda))
    before = tatt.flash_attention.launches
    out = tatt.flash_attention(q, k, v, **kw)
    assert tatt.flash_attention.launches == before + 1
    _assert_close(out, tatt.flash_attention_ref(q, k, v, **kw))


async def test_tensor2_on_card_matches_tensor1(cuda):
    """tiny-llama (float32), two tensor shards on one card against one
    shard: prefill logits within 1e-4, B1 launching once a shard a layer,
    and the batcher's fused and chunked admissions giving the same greedy
    tokens; the mesh's identity in the stats."""
    from ggrmcp_tpu_torch.core.config import MeshConfig
    from ggrmcp_tpu_torch.parallel import mesh as mesh_mod

    cfg = tl.CONFIGS["tiny-llama"]
    params = tl.init_params(cfg, torch.device("cpu"), seed=29)
    dev = torch.device("cuda", 0)
    one = GenerationEngine(cfg, params=_to(params, dev),
                           mesh=mesh_mod.build_mesh(MeshConfig(tensor=1),
                                                    [dev]))
    two = GenerationEngine(cfg, params=_to(params, dev),
                           mesh=mesh_mod.build_mesh(MeshConfig(tensor=2),
                                                    [dev, dev]))
    toks = torch.tensor([_prompts()[4][:40]] * 2, device=dev)
    want, _ = one.prefill_forward(one.params, toks, one.make_cache(2, 64))
    before = tatt.flash_attention.launches
    got, _ = two.prefill_forward(two.params, toks, two.make_cache(2, 64))
    assert tatt.flash_attention.launches == before + 2 * cfg.num_layers
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    small = dict(max_batch_size=4, kv_cache_max_seq=256, prefill_chunk=16,
                 max_queue_delay_ms=1000.0)
    ref = await _serve(ContinuousBatcher(one, BatchingConfig(**small)),
                       _prompts())
    batcher = ContinuousBatcher(two, BatchingConfig(**small))
    assert await _serve(batcher, _prompts()) == ref
    assert batcher.chunked_admissions > 0 and batcher.fused_admissions > 0
    stats = batcher.stats()
    assert (stats["tp_chips"], stats["mesh_devices"], stats["mesh_shape"],
            stats["mesh_spec_downgrades"]) == (2, 2, "tensor=2", 0)


async def test_replicated_kv_shards_launch_the_kernel(cuda):
    """tiny-llama (float32) at tensor=8 on one card: its 4 KV heads do not
    split, so every shard's cache holds them all (a counted downgrade),
    and each shard reads its own group's head through B1: one launch a
    shard a layer, prefill logits within 1e-4 of one shard, and the
    batcher's greedy tokens equal."""
    from ggrmcp_tpu_torch.core.config import MeshConfig
    from ggrmcp_tpu_torch.parallel import mesh as mesh_mod

    cfg = tl.CONFIGS["tiny-llama"]
    params = tl.init_params(cfg, torch.device("cpu"), seed=31)
    dev = torch.device("cuda", 0)
    one = GenerationEngine(cfg, params=_to(params, dev),
                           mesh=mesh_mod.build_mesh(MeshConfig(tensor=1),
                                                    [dev]))
    eight = GenerationEngine(cfg, params=_to(params, dev),
                             mesh=mesh_mod.build_mesh(MeshConfig(tensor=8),
                                                      [dev] * 8))
    toks = torch.tensor([_prompts()[4][:40]] * 2, device=dev)
    want, _ = one.prefill_forward(one.params, toks, one.make_cache(2, 64))
    cache = eight.make_cache(2, 64)
    assert eight.spec_downgrades >= 1
    before = tatt.flash_attention.launches
    got, _ = eight.prefill_forward(eight.params, toks, cache)
    assert tatt.flash_attention.launches == before + 8 * cfg.num_layers
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    small = dict(max_batch_size=4, kv_cache_max_seq=256, prefill_chunk=16,
                 max_queue_delay_ms=1000.0)
    ref = await _serve(ContinuousBatcher(one, BatchingConfig(**small)),
                       _prompts())
    before = tatt.flash_attention.launches
    assert await _serve(ContinuousBatcher(eight, BatchingConfig(**small)),
                        _prompts()) == ref
    assert tatt.flash_attention.launches > before


async def test_whole_blocks_launch_the_kernel_once_a_layer(cuda):
    """tiny-llama (float32) at tensor=3 on one card: no split dim divides
    by 3, so every block is whole, its storage shared by the three
    coordinates and computed once: B1 once a layer, the downgrade count
    the reference's (7 weight dims, the KV heads), prefill logits within
    1e-4 of one shard's and the batcher's greedy tokens equal."""
    from ggrmcp_tpu_torch.core.config import MeshConfig
    from ggrmcp_tpu_torch.parallel import mesh as mesh_mod

    cfg = tl.CONFIGS["tiny-llama"]
    params = tl.init_params(cfg, torch.device("cpu"), seed=32)
    dev = torch.device("cuda", 0)
    one = GenerationEngine(cfg, params=_to(params, dev),
                           mesh=mesh_mod.build_mesh(MeshConfig(tensor=1),
                                                    [dev]))
    three = GenerationEngine(cfg, params=_to(params, dev),
                             mesh=mesh_mod.build_mesh(MeshConfig(tensor=3),
                                                      [dev] * 3))
    assert tl.whole_blocks(cfg, 3) == {"attn", "ffn", "vocab"}
    toks = torch.tensor([_prompts()[4][:40]] * 2, device=dev)
    want, _ = one.prefill_forward(one.params, toks, one.make_cache(2, 64))
    cache = three.make_cache(2, 64)
    assert three.spec_downgrades == 8
    before = tatt.flash_attention.launches
    got, _ = three.prefill_forward(three.params, toks, cache)
    assert tatt.flash_attention.launches == before + cfg.num_layers
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    small = dict(max_batch_size=4, kv_cache_max_seq=256, prefill_chunk=16,
                 max_queue_delay_ms=1000.0)
    ref = await _serve(ContinuousBatcher(one, BatchingConfig(**small)),
                       _prompts())
    assert await _serve(ContinuousBatcher(three, BatchingConfig(**small)),
                        _prompts()) == ref


def test_compile_watcher_counts_the_kernel_library(cuda):
    """In a fresh process (a process loads a library once), the watcher
    installed, B1's library loaded: one compile named flash_attention,
    a hit or a miss as the build directory holds it, none after
    warmup."""
    import subprocess
    import sys

    code = (
        "import json\n"
        "from ggrmcp_tpu_torch.ops import _build\n"
        "from ggrmcp_tpu_torch.serving.compile_watcher import watcher\n"
        "watcher.install(); watcher.mark_cold()\n"
        "_build.load('flash_attention'); watcher.mark_warm()\n"
        "_build.load('flash_attention')\n"
        "print(json.dumps(dict(stats=watcher.stats(), names=[\n"
        "    e.fn_name for e in watcher.snapshot()])))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    stats = res["stats"]
    assert res["names"] == ["flash_attention"]
    assert stats["compile_count"] == 1 and stats["compile_post_warmup"] == 0
    assert stats["compile_cache_hits"] + stats["compile_cache_misses"] == 1
    assert stats["compile_ms"] > 0


def test_ring_and_ulysses_on_card_match_cpu(cuda):
    """Ring and Ulysses attention over two and four sequence shards on
    one card against the same on the CPU (float32, 1e-5): causal,
    non-causal and windowed."""
    from ggrmcp_tpu_torch.core.config import MeshConfig
    from ggrmcp_tpu_torch.ops import ring_attention as tring
    from ggrmcp_tpu_torch.parallel import mesh as mesh_mod

    cpu, dev = torch.device("cpu"), torch.device("cuda", 0)
    q, k, v = _qkv(41, 2, 64, 64, 4, 4, 32, cpu, torch.float32)
    for n in (2, 4):
        meshes = [mesh_mod.build_mesh(MeshConfig(tensor=1, sequence=n),
                                      [d] * n) for d in (cpu, dev)]
        for fn in (tring.ring_attention, tring.ulysses_attention):
            for causal, window in ((True, None), (False, None), (True, 9)):
                want = fn(q, k, v, meshes[0], causal=causal, window=window)
                got = fn(q.to(dev), k.to(dev), v.to(dev), meshes[1],
                         causal=causal, window=window)
                torch.testing.assert_close(got.cpu(), want, atol=1e-5,
                                           rtol=1e-5)


def test_pp_and_sp_forwards_on_card_match_cpu(cuda):
    """tiny-llama (float32) at stage=2 and at sequence=2 (sp prefill on)
    on one card against the same meshes on the CPU: prefill logits within
    1e-5 and greedy tokens equal; a stage's attention never launches the
    kernel, as the reference pins its plain path."""
    from ggrmcp_tpu_torch.core.config import MeshConfig
    from ggrmcp_tpu_torch.parallel import mesh as mesh_mod

    cfg = tl.CONFIGS["tiny-llama"]
    params = tl.init_params(cfg, torch.device("cpu"), seed=43)
    toks = torch.tensor([_prompts()[4][:40] + [7] * 24] * 2)
    for axis in ("stage", "sequence"):
        mcfg = MeshConfig(tensor=1, **{axis: 2})
        serving = ServingConfig(mesh=mcfg, sp_prefill_min_seq=64)
        engines = [GenerationEngine(
            cfg, serving, params=_to(params, d),
            mesh=mesh_mod.build_mesh(mcfg, [d, d]))
            for d in (torch.device("cpu"), torch.device("cuda", 0))]
        logits = []
        for eng in engines:
            before = tatt.flash_attention.launches
            out, _ = eng.prefill_forward(eng.params, toks.to(eng.device),
                                         eng.make_cache(2, 64))
            assert tatt.flash_attention.launches == before
            logits.append(out.cpu())
        torch.testing.assert_close(logits[1], logits[0], atol=1e-5, rtol=0)
        outs = [eng.generate(_prompts()[:3], 8) for eng in engines]
        assert outs[1] == outs[0]


async def test_colaunch_on_card(cuda):
    """The co-launch at tiny width on the card: the sidecar here, the
    gateway a child over a private socket; a greedy Generate tools/call
    answers the tokens of the same request sent by gRPC straight to the
    socket (each alone, so both take the same admission)."""
    import importlib.util
    import socket
    import urllib.request

    import grpc

    from ggrmcp_tpu_torch.rpc.pb import serving_pb2

    if importlib.util.find_spec("aiohttp") is None:
        pytest.skip("the gateway child needs aiohttp, absent here")
    from ggrmcp_tpu_torch.core.config import Config
    from ggrmcp_tpu_torch.serving import launcher

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg = Config(serving=ServingConfig(batching=BatchingConfig(
        max_batch_size=4, kv_cache_max_seq=256)))
    co = launcher.Colaunch(cfg, ["--http-port", str(port)],
                           device="cuda", seed=47)
    await co.start()
    try:
        body = json.dumps({"jsonrpc": "2.0", "method": "tools/call", "id": 1,
                           "params": {"name": "ggrmcp_tpu_generateservice_"
                                      "generate", "arguments": {
                                          "prompt": "hi", "maxNewTokens": 6,
                                          "returnTokens": True}}}).encode()

        def call():
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                return json.loads(resp.read())
        for _ in range(120):
            try:
                data = await asyncio.to_thread(call)
                break
            except OSError:
                assert co.child.returncode is None, co.log_tail()
                await asyncio.sleep(0.5)
        ids = json.loads(data["result"]["content"][0]["text"])["tokenIds"]
        async with grpc.aio.insecure_channel(co.target) as ch:
            resp = await ch.unary_unary(
                "/ggrmcp.tpu.GenerateService/Generate",
                request_serializer=serving_pb2.GenerateRequest
                .SerializeToString,
                response_deserializer=serving_pb2.GenerateResponse.FromString,
            )(serving_pb2.GenerateRequest(prompt="hi", max_new_tokens=6,
                                          return_tokens=True))
        assert ids == list(resp.token_ids) and len(ids) == 6
        assert co.target == f"unix:{cfg.serving.uds_path}"
    finally:
        await co.stop()


@pytest.mark.parametrize("shape", [
    dict(b=2, sq=300, sk=300, h=8, kvh=4, d=64, window=None, ragged=False),
    dict(b=2, sq=256, sk=256, h=32, kvh=8, d=64, window=64, ragged=True),
], ids=["causal", "window_ragged"])
def test_kernel_under_autograd_gives_plain_grads(cuda, shape):
    """A regression test for a silent zero gradient: on CUDA inputs that
    require grad, `flash_attention` launches the kernel and returns a
    tensor with a graph, whose backward (the plain version recomputed)
    gives autograd's dq / dk / dv of `flash_attention_ref`."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    b, sq, sk, h, kvh, d = (shape[k] for k in ("b", "sq", "sk", "h", "kvh",
                                                "d"))
    q0 = torch.randn((b, sq, h, d), generator=gen, device=cuda).bfloat16()
    k0, v0 = (torch.randn((b, sk, kvh, d), generator=gen,
                          device=cuda).bfloat16() for _ in range(2))
    dout = torch.randn((b, sq, h, d), generator=gen, device=cuda).bfloat16()
    kv_len = (torch.tensor([sk, sk - 37], dtype=torch.int32, device=cuda)
              if shape["ragged"] else None)
    kw = dict(causal=True, kv_len=kv_len, window=shape["window"])
    launches = tatt.flash_attention.launches
    recomputes = tatt.flash_attention.backward_recomputes
    got, want = [], []
    for fn, into in ((tatt.flash_attention, got),
                     (tatt.flash_attention_ref, want)):
        q, k, v = (t.clone().requires_grad_(True) for t in (q0, k0, v0))
        out = fn(q, k, v, **kw)
        assert out.grad_fn is not None
        out.backward(dout)
        into.extend([out.detach(), q.grad, k.grad, v.grad])
    assert tatt.flash_attention.launches == launches + 1
    assert tatt.flash_attention.backward_recomputes == recomputes + 1
    _assert_close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.abs().max() > 0
        _assert_close(g, w)


def test_no_grad_path_unchanged(cuda):
    """Serving (no grad) keeps the plain launch: no graph, no recompute."""
    q = torch.randn((1, 64, 8, 64), device=cuda).bfloat16()
    k = v = torch.randn((1, 64, 4, 64), device=cuda).bfloat16()
    with torch.no_grad():
        out = tatt.flash_attention(q.requires_grad_(True), k, v)
    assert out.grad_fn is None


def test_three_adamw_steps_on_card_match_cpu(cuda):
    from ggrmcp_tpu_torch.models import trainer
    from ggrmcp_tpu_torch.models import training

    cfg = tl.CONFIGS["tiny-llama"]
    cpu = torch.device("cpu")
    whole = tl.init_params(cfg, cpu, 11)
    rng = np.random.default_rng(11)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 65)))
               for _ in range(3)]
    results = []
    for dev in (cpu, cuda):
        state = training.make_train_state(  # a copy: trained in place
            {k: ({n: t.clone().to(dev) for n, t in v.items()}
                 if isinstance(v, dict) else v.clone().to(dev))
             for k, v in whole.items()}, cfg)
        launches = tatt.flash_attention.launches
        losses = []
        for batch in batches:
            state, loss = training.train_step(state, batch.to(dev), cfg)
            losses.append(loss.item())
        if dev.type == "cuda":
            assert (tatt.flash_attention.launches - launches
                    == 3 * cfg.num_layers)
        params = trainer.state_tensors(state, cfg)[0]
        results.append((losses, {n: t.cpu() for n, t in params.items()}))
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=1e-4)
    # Each leaf within 1e-4 of its largest entry, save at most one entry
    # in 10^4, each within one learning rate a step (AdamW steps an entry
    # whose gradient sits at summation noise by up to lr either way).
    for name, want in results[0][1].items():
        diff = (results[1][1][name] - want).abs()
        off = int((diff > 1e-4 * want.abs().max()).sum())
        assert off <= diff.numel() * 1e-4, (name, off)
        assert diff.max() <= 3 * 3e-4, name


# -- the data axes and the routes on a mesh -------------------------------------


def _card_mesh(**axes):
    from ggrmcp_tpu_torch.core.config import MeshConfig
    from ggrmcp_tpu_torch.parallel import mesh as mesh_mod

    dev = torch.device("cuda", 0)
    n = int(np.prod(list(axes.values())))
    return mesh_mod.build_mesh(MeshConfig(**{"tensor": 1, **axes}), [dev] * n)


@pytest.mark.parametrize("axes", [dict(data=2), dict(data=2, tensor=2)],
                         ids=["data2", "data2_tensor2"])
async def test_data_blocks_on_card_match_one_device(cuda, axes):
    """tiny-llama (float32) on data blocks on one card against one
    device: prefill logits within 1e-4, B1 launching once a layer, block
    and shard on the block's rows; the batcher's greedy tokens equal."""
    cfg = tl.CONFIGS["tiny-llama"]
    params = tl.init_params(cfg, torch.device("cpu"), seed=37)
    one = GenerationEngine(cfg, params=_to(params, cuda),
                           mesh=_card_mesh())
    many = GenerationEngine(cfg, params=_to(params, cuda),
                            mesh=_card_mesh(**axes))
    toks = torch.tensor([_prompts()[4][:40]] * 4, device=cuda)
    want, _ = one.prefill_forward(one.params, toks, one.make_cache(4, 64))
    before = tatt.flash_attention.launches
    got, _ = many.prefill_forward(many.params, toks, many.make_cache(4, 64))
    shards = int(np.prod(list(axes.values())))
    assert tatt.flash_attention.launches == before + shards * cfg.num_layers
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    small = dict(max_batch_size=4, kv_cache_max_seq=256, prefill_chunk=16,
                 max_queue_delay_ms=1000.0)
    ref = await _serve(ContinuousBatcher(one, BatchingConfig(**small)),
                       _prompts())
    batcher = ContinuousBatcher(many, BatchingConfig(**small))
    assert await _serve(batcher, _prompts()) == ref
    assert batcher.stats()["mesh_shape"] == ",".join(
        f"{a}={n}" for a, n in axes.items())


def test_embedding_engine_at_tensor2_on_card(cuda):
    """bert-tiny at tensor=2 on one card against one device: vectors
    within 1e-5, B1 once a layer and shard."""
    cfg = tb.CONFIGS["bert-tiny"]
    params = tb.init_params(cfg, torch.device("cpu"), 3)
    one = EmbeddingEngine(cfg, params=_to(params, cuda), mesh=_card_mesh())
    two = EmbeddingEngine(cfg, params=_to(params, cuda),
                          mesh=_card_mesh(tensor=2))
    lists = [list(range(5, 5 + n)) for n in (40, 17, 64)]
    want = one.embed(lists)
    before = tatt.flash_attention.launches
    got = two.embed(lists)
    assert tatt.flash_attention.launches == before + 2 * cfg.num_layers
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


async def test_pages_across_tensor_meshes_on_card(cuda):
    """A page arena at tensor=2 on one card: pages written by an
    admission come out as the codec's whole heads, and land in a
    tensor=1 arena bit for bit."""
    cfg = tl.CONFIGS["tiny-llama"]
    params = tl.init_params(cfg, torch.device("cpu"), seed=41)
    paged = dict(max_batch_size=2, kv_cache_max_seq=128, paged_kv="on",
                 paged_kv_page_size=8)
    src = ContinuousBatcher(GenerationEngine(
        cfg, params=_to(params, cuda), mesh=_card_mesh(tensor=2)),
        BatchingConfig(**paged))
    dst = ContinuousBatcher(GenerationEngine(
        cfg, params=_to(params, cuda), mesh=_card_mesh()),
        BatchingConfig(**paged))
    prompt = _prompts()[4][:40]
    src.start()
    dst.start()
    try:
        async for _ in src.submit(prompt, 1, SamplingConfig()):
            pass
        export = await src.run_host_op(lambda: src.export_prompt_kv(prompt))
        placed = await dst.run_host_op(lambda: dst.import_prompt_kv(
            prompt, 0, export["k"], export["v"]))
        landed = await dst.run_host_op(lambda: dst._gather_pages(
            dst.pages.chain_pages(prompt)))
    finally:
        await src.stop()
        await dst.stop()
    assert export["k"].shape[3] == cfg.num_kv_heads
    assert placed == (export["pages"], 0)
    assert torch.equal(landed["k"], export["k"])
    assert torch.equal(landed["v"], export["v"])


def test_data_parallel_train_steps_on_card_match_cpu(cuda):
    """tiny-llama (float32), 3 AdamW steps at data=2 on one card against
    one device on the CPU: losses at rtol 1e-4, B1 once a layer and
    block a step."""
    from ggrmcp_tpu_torch.models import training

    cfg = tl.CONFIGS["tiny-llama"]
    cpu = torch.device("cpu")
    whole = tl.init_params(cfg, cpu, 13)
    rng = np.random.default_rng(13)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 65)))
               for _ in range(3)]
    losses = {}
    for dev, mesh in ((cpu, None), (cuda, _card_mesh(data=2))):
        state = training.make_train_state(
            {k: ({n: t.clone().to(dev) for n, t in v.items()}
                 if isinstance(v, dict) else v.clone().to(dev))
             for k, v in whole.items()}, cfg, mesh=mesh)
        launches = tatt.flash_attention.launches
        run = []
        for batch in batches:
            state, loss = training.train_step(state, batch.to(dev), cfg)
            run.append(loss.item())
        if dev.type == "cuda":
            assert (tatt.flash_attention.launches - launches
                    == 3 * 2 * cfg.num_layers)
        losses[dev.type] = run
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
