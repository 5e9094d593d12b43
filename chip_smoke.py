#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (`ggrmcp_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, any failure exits non-zero and prints no result:

1. card: nvidia-smi's name and power limit, torch and CUDA versions;
2. build: the FlashAttention kernels from ggrmcp_tpu_torch/ops/csrc, with
   ptxas's report of every kernel (registers, spills, shared memory);
   the bf16 kernels must not spill, setmaxnreg must not be ignored and
   their wgmma must not be serialised;
3. kernel vs plain: `flash_attention` against `flash_attention_ref` at
   the shapes the serving path gives it at llama3-8b width (H=32, KVH=8,
   D=128, bf16) and at llama-1b width (D=64), plus a windowed, a
   non-causal, an H=KVH, a ragged and a float32 case, with the kernel's
   and the SDPA yardstick's times (median and spread of 5 runs of 10
   launches), the plain version's time and the card's bound for each;
4. reference: tiny-llama (float32) on the card against the same weights
   on the CPU, and one llama3-8b prefill with the kernel against the
   same prefill through the plain version;
5. serve: the port's gRPC sidecar with llama3-8b (seeded random bf16
   weights, default BatchingConfig) answers concurrent Generate calls
   through both admission routes, one GenerateStream and GetModelInfo;
   the kernel's launch count must rise during this phase;
6. embed: an embed sidecar with bert-base (seeded random bf16 weights)
   answers Embed on texts at the [32, 128] and [32, 512] buckets, on
   token ids with trailing pads, with mean, cls and max pooling, and
   GetModelInfo; every call launches the kernel once a layer, every
   vector has unit norm and matches the same weights in float32 through
   the plain path;
7. HF checkpoint: a checkpoint of llama3-8b's width cut to 2 layers,
   written in two safetensors files under an index, loads onto the card
   bit for bit with bounded host memory, and a sidecar started on it
   answers a greedy Generate with the tokens of an engine on the loaded
   weights; the same with `quantize="int8"`, whose leaves must equal the
   port's `quantize` of the loaded tensors bit for bit;
8. int8: (a) llama3-8b's seeded bf16 weights quantized through the
   engine's path (bytes, peak memory, one layer's `quantize` bitwise
   against the CPU), a [32, 512] prefill on int8 against bf16 weights
   (cosine >= 0.999, the reference's bound) and against the int8
   weights in float32; (b) a sidecar on int8 weights with a bf16 KV
   cache serves a burst through both admission routes (the kernel must
   launch); (c) the same with an int8 KV cache (the kernel must not
   launch; the pool at most 0.52 of the bf16 one; prefill + decode
   within 5 % of the bf16 cache, the reference's bound); (d) the
   synthetic-weight engine's init stays below 1.1x its int8 bytes, and a
   sidecar on synthetic weights serves the same burst; (e) the eager
   dequantizing GEMM, its int8 -> bf16 cast alone and the decode step
   against bf16, timed.

The last lines are the kernels JSON line, the card line, and
{"ok": true, "device": {"platform": "gpu", ...}}.
"""

from __future__ import annotations

import asyncio
import gc
import json
import os
import re
import struct
import subprocess
import sys
import time

SEED = 0
MODEL = "llama3-8b"
# Published H100 SXM peaks (dense): bf16 tensor cores, float32 CUDA
# cores, HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# |kernel - plain| <= atol + rtol * |plain|, elementwise. float32: both
# compute in float32 and differ only in summation order. bfloat16: the
# output is rounded to bf16 on both sides, so one step of the output's
# magnitude (2**-8 to 2**-7 of it) may differ: rtol 1.6e-2 is two steps
# (torch.testing's bf16 rtol); the kernel also rounds P to bf16 for its
# P V product, which near-zero outputs see as atol 1e-2.
TOL = {"bfloat16": (1e-2, 1.6e-2), "float32": (1e-4, 1e-4)}
SERVE_PROMPT_TOKENS = (40, 100, 200, 300, 500, 700, 1500, 3000)
SERVE_NEW_TOKENS = 32


class SmokeError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


# -- timing ---------------------------------------------------------------


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of `fn` over `reps` back-to-back runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_spread(torch, fn, runs: int = 5, reps: int = 10) -> dict:
    """Median, min and max over `runs` runs of `cuda_ms` (`reps`
    launches each, one warm-up before the first)."""
    times = sorted(cuda_ms(torch, fn, reps, warmup=1 if i == 0 else 0)
                   for i in range(runs))
    return dict(ms=times[runs // 2], min=times[0], max=times[-1])


# -- phase 3: kernel vs plain ----------------------------------------------

# name, b, sq, sk, h, kvh, d, causal, q_offset, kv_len, window, dtype,
# what it stands for
CASES = [
    ("fused_1x64", 1, 64, 64, 32, 8, 128, True, 0, 64, None, "bfloat16",
     "fused admission of one request ([1, S], S=64 bucket)"),
    ("fused_32x32", 32, 32, 32, 32, 8, 128, True, 0, 32, None, "bfloat16",
     "fused admission, full pool, smallest bucket"),
    ("fused_32x512", 32, 512, 512, 32, 8, 128, True, 0, 512, None,
     "bfloat16", "fused admission, full pool, largest bucket"),
    ("fused_32x512_d64", 32, 512, 512, 32, 8, 64, True, 0, 512, None,
     "bfloat16", "llama-1b geometry (D=64), fused admission, full pool"),
    ("chunk_4x512_at_2560", 4, 512, 4096, 32, 8, 128, True, 2560, 3072,
     None, "bfloat16",
     "chunked admission, 6th chunk, strided view of a 4096 mini cache"),
    ("window_1x8192", 1, 8192, 8192, 32, 8, 128, True, 0, 8192, 4096,
     "bfloat16", "mistral-7b geometry: window 4096 over 8192"),
    ("non_causal_2x512", 2, 512, 512, 32, 8, 128, False, 0, 512, None,
     "bfloat16", "non-causal"),
    ("mha_2x512", 2, 512, 512, 32, 32, 128, True, 0, 512, None, "bfloat16",
     "H = KVH"),
    ("ragged_2x300", 2, 300, 300, 32, 8, 128, True, 0, 300, None,
     "bfloat16", "Sq = Sk = 300, no tile multiple"),
    ("f32_tiny_2x256", 2, 256, 256, 8, 4, 32, True, 0, 256, None, "float32",
     "tiny-llama geometry in float32"),
    # kv_len None: ragged, each row's length drawn from 17 to S.
    ("bert_32x128", 32, 128, 128, 12, 12, 64, False, 0, None, None,
     "bfloat16", "bert-base embed batch, S=128 bucket, ragged rows"),
    ("bert_32x512", 32, 512, 512, 12, 12, 64, False, 0, None, None,
     "bfloat16", "bert-base embed batch, S=512 bucket, ragged rows"),
]
HEADLINE = "fused_32x512"
DESIGN = ("bf16: TMA-fed wgmma (m64n128k16 S = Q K^T from shared memory, "
          "P V with P in registers), 1 producer + 2 consumer warpgroups, "
          "128 x 128 tiles, 2-stage mbarrier ring, persistent blocks; "
          "float32: CUDA cores")


def _valid_mask(torch, b, sq, sk, causal, q_offset, kv_len, window, dev):
    k_pos = torch.arange(sk, device=dev)[None, None, :]
    mask = k_pos < kv_len.long()[:, None, None]
    if causal:
        q_pos = q_offset.long()[:, None, None] + torch.arange(
            sq, device=dev)[None, :, None]
        mask = mask & (q_pos >= k_pos)
        if window:
            mask = mask & (k_pos > q_pos - window)
    return mask.expand(b, sq, sk)  # [B, Sq, Sk]


def kernel_cases(torch, tatt, dev) -> list[dict]:
    import torch.nn.functional as F

    results = []
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for (name, b, sq, sk, h, kvh, d, causal, off, kvl, window, dtype_name,
         what) in CASES:
        dtype = getattr(torch, dtype_name)
        q = torch.randn((b, sq, h, d), generator=gen, device=dev).to(dtype)
        if name.startswith("bert"):
            # The encoder's operands: q, k and v are strided views of one
            # fused [B, S, 3 H D] projection, read without a copy.
            qkv = torch.randn((b, sq, 3 * h * d), generator=gen,
                              device=dev).to(dtype)
            q, k, v = (t.reshape(b, sq, h, d) for t in qkv.chunk(3, dim=-1))
            check(all(tatt._kernel_layout_ok(t) for t in (q, k, v)),
                  f"{name}: the kernel would copy the split q/k/v views")
        elif name.startswith("chunk"):
            # The model's operand: [:, :S_max] of a [B, S_max + 1, ...]
            # per-layer cache slice (not contiguous).
            kc, vc = (torch.randn((b, sk + 1, kvh, d), generator=gen,
                                  device=dev).to(dtype) for _ in range(2))
            k, v = kc[:, :sk], vc[:, :sk]
        else:
            k, v = (torch.randn((b, sk, kvh, d), generator=gen,
                                device=dev).to(dtype) for _ in range(2))
        q_offset = torch.full((b,), off, dtype=torch.int32, device=dev)
        if kvl is None:
            kv_len = torch.randint(17, sk + 1, (b,), generator=gen,
                                   device=dev, dtype=torch.int32)
        else:
            kv_len = torch.full((b,), kvl, dtype=torch.int32, device=dev)
        full = bool((kv_len == sk).all())
        kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len,
                  window=window)

        out = tatt.flash_attention(q, k, v, **kw)
        ref = tatt.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        atol, rtol = TOL[dtype_name]
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        excess = (diff - rtol * ref.float().abs()).max().item()
        del out, ref, diff
        check(excess <= atol,
              f"kernel vs plain {name}: |err| exceeds {atol} + {rtol}|ref| "
              f"by {excess - atol} (max abs err {err})")

        kernel_t = cuda_ms_spread(
            torch, lambda: tatt.flash_attention(q, k, v, **kw))
        ms = kernel_t["ms"]
        plain_ms = cuda_ms(
            torch, lambda: tatt.flash_attention_ref(q, k, v, **kw), 2)
        torch.cuda.empty_cache()

        # SDPA yardstick on the same function (never called by the port).
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = _valid_mask(torch, b, sq, sk, causal, q_offset, kv_len,
                           window, dev)
        pairs = int(mask.sum().item())
        keys = int(mask.any(dim=1).sum().item())
        plain_causal = causal and off == 0 and full and sq == sk and (
            not window)
        sdpa_kw = (dict(is_causal=True) if plain_causal
                   else dict(attn_mask=mask[:, None]) if causal or not full
                   else {})
        try:
            def lib():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, enable_gqa=kvh != h, **sdpa_kw)
            lib()
        except TypeError:  # a torch without enable_gqa: repeat K/V first
            kt = kt.repeat_interleave(h // kvh, dim=1)
            vt = vt.repeat_interleave(h // kvh, dim=1)

            def lib():
                return F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)
        library_t = cuda_ms_spread(torch, lib)
        library_ms = library_t["ms"]
        del mask, qt, kt, vt
        torch.cuda.empty_cache()

        # The card's least time for this call: each input read once
        # (only the keys some query of the row attends), the output
        # written once, and 4 * D flops per valid (query head, key) pair.
        es = q.element_size()
        nbytes = es * (2 * b * sq * h * d + 2 * keys * kvh * d) + 8 * b
        flops = 4.0 * pairs * h * d
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
        row = dict(
            name=name, what=what, dtype=dtype_name,
            shape=dict(b=b, sq=sq, sk=sk, h=h, kvh=kvh, d=d, causal=causal,
                       q_offset=off, window=window,
                       kv_len=kvl if kvl is not None else
                       f"ragged {kv_len.min().item()}-{kv_len.max().item()}"),
            max_abs_err=err, atol=atol, rtol=rtol, ms=ms,
            ms_min=kernel_t["min"], ms_max=kernel_t["max"], plain_ms=plain_ms,
            library_ms=library_ms, library_ms_min=library_t["min"],
            library_ms_max=library_t["max"], bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            gflop=flops / 1e9, mbytes=nbytes / 1e6,
            tflops=flops / (ms * 1e-3) / 1e12,
        )
        log(f"  {name:22s} err {err:.2e} kernel {ms:.4f} ms "
            f"[{kernel_t['min']:.4f}, {kernel_t['max']:.4f}]  plain "
            f"{plain_ms:9.3f} ms  sdpa {library_ms:.4f} ms "
            f"[{library_t['min']:.4f}, {library_t['max']:.4f}]  bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})  "
            f"{row['tflops']:.1f} TFLOP/s")
        results.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    return results


# -- phase 2: the build's ptxas report ----------------------------------------

BF16_KERNEL = "flash_fwd_wg_kernel"


def ptxas_report(log_text: str) -> None:
    """Print ptxas's lines for every kernel of the library (registers,
    spills, warnings and C75xx notes) and hold the bf16 kernels to no
    spills, an honoured setmaxnreg (C7508 says it was ignored) and
    pipelined wgmma (C7514 says ptxas serialised them)."""
    check(bool(log_text), "no ptxas report for the kernel library")
    check("C7508" not in log_text, "ptxas ignored setmaxnreg (C7508)")
    check("C7514" not in log_text,
          "ptxas serialised the wgmma instructions (C7514)")
    kernel, bf16 = "", set()
    for raw in log_text.splitlines():
        line = raw.strip()
        if "Function properties for" in line:
            kernel = line.split()[-1]
            short = re.search(r"flash_fwd_\w*?kernelILi\d+", kernel)
            log(f"  ptxas: {short.group(0) if short else kernel}")
        elif any(w in line for w in ("registers", "spill", "warning",
                                     "(C75")):
            log(f"  ptxas:   {line}")
        if BF16_KERNEL in kernel and "spill" in line:
            bf16.add(kernel)
            check("0 bytes spill stores, 0 bytes spill loads" in line,
                  f"bf16 kernel {kernel} spills: {line}")
    check(len(bf16) == 3, f"ptxas reported {len(bf16)} bf16 kernels, not 3")


# -- phase 4: reference checks ------------------------------------------------


def _to(params, dev):
    return {
        key: ({n: t.to(dev) for n, t in val.items()} if isinstance(val, dict)
              else val.to(dev))
        for key, val in params.items()
    }


def tiny_reference(torch, dev) -> dict:
    """tiny-llama (float32) on the card vs the CPU on the same weights:
    the CPU run takes the plain versions, the card the kernel."""
    import numpy as np

    from ggrmcp_tpu_torch.models import llama as llama_mod
    from ggrmcp_tpu_torch.serving.engine import GenerationEngine

    cfg = llama_mod.CONFIGS["tiny-llama"]
    cpu_params = llama_mod.init_params(cfg, torch.device("cpu"), SEED)
    gpu_params = _to(cpu_params, dev)
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(3, 500, (2, 100)))
    ref, _ = llama_mod.forward(cpu_params, cfg, toks)
    out, _ = llama_mod.forward(gpu_params, cfg, toks.to(dev))
    err = (out.cpu() - ref).abs().max().item()
    check(err <= 1e-3, f"tiny-llama logits card vs cpu: {err} > 1e-3")
    prompts = [rng.integers(3, 500, n).tolist() for n in (7, 33, 90)]
    cpu_out = GenerationEngine(cfg, params=cpu_params, device="cpu").generate(
        prompts, 16)
    gpu_out = GenerationEngine(cfg, params=gpu_params, device=dev).generate(
        prompts, 16)
    check(gpu_out == cpu_out, "tiny-llama greedy tokens card vs cpu differ")
    return dict(tiny_logits_max_abs_err=err, tiny_greedy_identical=True)


def full_width_reference(torch, tatt, llama_mod, params, cfg, dev) -> dict:
    """One llama3-8b prefill [1, 512] with the kernel against the same
    prefill with every attention through the plain version."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    toks = torch.randint(3, cfg.vocab_size, (1, 512), generator=gen,
                         device=dev)
    with torch.no_grad():
        out, _ = llama_mod.forward(params, cfg, toks)
        kernel_attention = llama_mod.attention

        def plain(q, k, v, **kw):
            kw.pop("use_flash", None)
            if kw.get("k_positions") is None and q.shape[1] > \
                    tatt.GQA_GROUPED_MAX_SQ:
                kw.pop("k_positions", None)
                return tatt.flash_attention_ref(q, k, v, **kw)
            return tatt.attention_ref(q, k, v, **kw)

        llama_mod.attention = plain
        try:
            ref, _ = llama_mod.forward(params, cfg, toks)
        finally:
            llama_mod.attention = kernel_attention
    rel = ((out - ref).norm() / ref.norm()).item()
    agree = (out.argmax(-1) == ref.argmax(-1)).float().mean().item()
    check(torch.isfinite(out).all().item(), "llama3-8b logits not finite")
    # bf16 through 32 random layers: the two attentions round their
    # outputs to bf16 at different summation orders; the logits must
    # still agree closely.
    check(rel <= 2e-2, f"llama3-8b prefill kernel vs plain rel err {rel}")
    return dict(full_width_logits_rel_err=rel, full_width_top1_agree=agree)


# -- phase 5: serve -----------------------------------------------------------


def _prompt_text(n_tokens: int, seed: int) -> str:
    """ASCII text that the byte tokenizer turns into n_tokens ids (BOS +
    one id per byte)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return "".join(chr(c) for c in rng.integers(97, 123, n_tokens - 1))


async def serve_phase(torch, tatt, dev) -> dict:
    import grpc
    import grpc.aio

    from ggrmcp_tpu_torch.core.config import ServingConfig
    from ggrmcp_tpu_torch.models import llama as llama_mod
    from ggrmcp_tpu_torch.rpc.pb import serving_pb2
    from ggrmcp_tpu_torch.serving.sidecar import Sidecar

    cfg = llama_mod.CONFIGS[MODEL]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sidecar = Sidecar(ServingConfig(model=MODEL), seed=SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"  {MODEL}: random weights in {init_s:.1f} s, "
        f"{sidecar.generation.weight_bytes() / 1e9:.2f} GB")
    # The main path's run starts here: every launch count from 0.
    tatt.flash_attention.launches = 0
    port = await sidecar.start(0)
    res: dict = dict(init_s=init_s)
    try:
        async with grpc.aio.insecure_channel(f"localhost:{port}") as ch:
            def unary(method, req, resp):
                return ch.unary_unary(
                    method, request_serializer=req.SerializeToString,
                    response_deserializer=resp.FromString)
            generate = unary("/ggrmcp.tpu.GenerateService/Generate",
                             serving_pb2.GenerateRequest,
                             serving_pb2.GenerateResponse)
            stream = ch.unary_stream(
                "/ggrmcp.tpu.GenerateService/GenerateStream",
                request_serializer=serving_pb2.GenerateRequest
                .SerializeToString,
                response_deserializer=serving_pb2.GenerateChunk.FromString)
            info_rpc = unary("/ggrmcp.tpu.ModelInfoService/GetModelInfo",
                             serving_pb2.ModelInfoRequest,
                             serving_pb2.ModelInfoResponse)
            stats_rpc = unary("/ggrmcp.tpu.ModelInfoService/GetServingStats",
                              serving_pb2.ServingStatsRequest,
                              serving_pb2.ServingStatsResponse)

            def request(n_tokens, seed, max_new=SERVE_NEW_TOKENS):
                return serving_pb2.GenerateRequest(
                    prompt=_prompt_text(n_tokens, seed),
                    max_new_tokens=max_new, return_tokens=True)

            async def timed(req):
                t = time.perf_counter()
                resp = await generate(req, timeout=600)
                return resp, (time.perf_counter() - t) * 1e3

            # The first call pays the process's lazy CUDA set-up (library
            # handles, allocator growth): time it on its own.
            _, res["first_call_ms"] = await timed(request(40, 99, max_new=2))

            # TTFT: a one-token request alone is admission + first token.
            ttft = {}
            for n in (40, 500, 3000):
                resp, ms = await timed(request(n, 100 + n, max_new=1))
                check(resp.completion_tokens <= 1, "max_new 1 overran")
                ttft[n] = ms
            res["ttft_ms"] = ttft

            # The burst: concurrent greedy calls through both routes.
            t = time.perf_counter()
            burst = await asyncio.gather(*(
                timed(request(n, i)) for i, n in
                enumerate(SERVE_PROMPT_TOKENS)))
            burst_s = time.perf_counter() - t
            tokens = 0
            for n, (resp, ms) in zip(SERVE_PROMPT_TOKENS, burst):
                ids = list(resp.token_ids)
                check(resp.prompt_tokens == n,
                      f"prompt of {n} tokens arrived as {resp.prompt_tokens}")
                check(1 <= len(ids) == resp.completion_tokens
                      <= SERVE_NEW_TOKENS, f"bad completion for {n}: {resp}")
                check(all(0 <= i < cfg.vocab_size for i in ids),
                      f"out-of-vocab token for prompt {n}")
                check(resp.finish_reason in ("length", "stop"),
                      f"finish {resp.finish_reason!r} for prompt {n}")
                tokens += len(ids)
            res["burst"] = dict(
                requests=len(burst), wall_s=burst_s, tokens=tokens,
                tok_per_s=tokens / burst_s,
                latency_ms={n: ms for n, (_, ms) in
                            zip(SERVE_PROMPT_TOKENS, burst)})

            # Repeatability: one prompt twice, alone each time.
            again = [await generate(request(SERVE_PROMPT_TOKENS[0], 0))
                     for _ in range(2)]
            check(list(again[0].token_ids) == list(again[1].token_ids),
                  "the same greedy prompt gave different tokens")

            # One stream. Token ids ride the chunks that carry text; a
            # random model mostly picks ids outside the byte range, so
            # the check is that the stream ends cleanly.
            t = time.perf_counter()
            chunks = [c async for c in stream(request(500, 7), timeout=600)]
            res["stream"] = dict(chunks=len(chunks),
                                 ms=(time.perf_counter() - t) * 1e3)
            check(chunks and chunks[-1].done and chunks[-1].finish_reason in
                  ("length", "stop"), f"stream ended badly: {chunks[-1:]}")
            for c in chunks:
                check(all(0 <= i < cfg.vocab_size for i in c.token_ids),
                      "out-of-vocab token in stream")

            info = await info_rpc(serving_pb2.ModelInfoRequest())
            check(info.model_id == MODEL and info.platform == "cuda",
                  f"model info {info}")
            stats = await stats_rpc(serving_pb2.ServingStatsRequest())
            res["stats"] = dict(
                ticks=stats.ticks, admit_rounds=stats.admit_rounds,
                admit_ms=stats.admit_ms, admit_ms_max=stats.admit_ms_max,
                decode_stall_ms_p50=stats.decode_stall_ms_p50,
                kv_cache_bytes=stats.kv_cache_bytes)
        batcher = sidecar.batcher
        res["fused_admissions"] = batcher.fused_admissions
        res["chunked_admissions"] = batcher.chunked_admissions
        check(batcher.fused_admissions > 0 and batcher.chunked_admissions > 0,
              "the burst did not run both admission routes")
    finally:
        await sidecar.stop()
    torch.cuda.synchronize()
    res["launches"] = tatt.flash_attention.launches
    res["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    check(res["launches"] > 0, "the serve phase never launched the kernel")
    res.update(full_width_reference(
        torch, tatt, llama_mod, sidecar.generation.params, cfg, dev))
    return res


# -- phase 6: embed -----------------------------------------------------------

EMBED_MODEL = "bert-base"
# Vectors of the kernel path (bf16) against the plain path in float32 on
# the same weights: bf16 rounding through 12 post-norm layers moves a
# unit vector by a few 1e-3 at most, a cosine of 0.999 or more.
EMBED_MIN_COSINE = 0.999


def _texts(n: int, longest: int, seed: int) -> list[str]:
    """`n` ASCII texts of 17 to `longest` bytes (one of exactly
    `longest`); the byte tokenizer gives one id per byte."""
    import numpy as np

    lengths = np.random.default_rng(seed).integers(17, longest + 1, n)
    lengths[0] = longest
    return [_prompt_text(int(m) + 1, seed + i) for i, m in enumerate(lengths)]


def _plain_embed(tatt, bert_mod, engine, token_lists, pooling):
    """The same weights in float32 on the card, every attention through
    the kernel's plain version."""
    import dataclasses

    from ggrmcp_tpu_torch.serving.engine import EmbeddingEngine

    cfg = dataclasses.replace(engine.cfg, dtype="float32")
    params = {k: ({n: t.float() for n, t in v.items()}
                  if isinstance(v, dict) else v.float())
              for k, v in engine.params.items()}
    kernel_attention = bert_mod.attention
    bert_mod.attention = lambda q, k, v, **kw: tatt.flash_attention_ref(
        q, k, v, **kw)
    try:
        return EmbeddingEngine(cfg, params=params, device=engine.device
                               ).embed(token_lists, pooling)
    finally:
        bert_mod.attention = kernel_attention


async def embed_phase(torch, tatt, dev) -> dict:
    import grpc.aio
    import numpy as np

    from ggrmcp_tpu_torch.core.config import ServingConfig
    from ggrmcp_tpu_torch.models import bert as bert_mod
    from ggrmcp_tpu_torch.rpc.pb import serving_pb2
    from ggrmcp_tpu_torch.serving import tensors
    from ggrmcp_tpu_torch.serving.sidecar import Sidecar

    cfg = bert_mod.CONFIGS[EMBED_MODEL]
    torch.cuda.reset_peak_memory_stats()
    sidecar = Sidecar(ServingConfig(model=EMBED_MODEL), seed=SEED, device=dev)
    engine = sidecar.embedding
    batches = dict(texts_32x128=_texts(32, 128, 1),
                   texts_32x512=_texts(32, 500, 2))
    rng = np.random.default_rng(3)
    ids = np.zeros((8, 256), np.int32)  # trailing pads
    for row, n in enumerate(rng.integers(1, 257, 8)):
        ids[row, :n] = rng.integers(1000, cfg.vocab_size, n)
    calls = [(name, texts, "mean") for name, texts in batches.items()]
    calls += [(f"texts_32x512_{p}", batches["texts_32x512"], p)
              for p in ("cls", "max")]
    # The main path's run starts here: every launch count from 0.
    tatt.flash_attention.launches = 0
    port = await sidecar.start(0)
    res: dict = dict(calls={})
    vectors = {}
    try:
        async with grpc.aio.insecure_channel(f"localhost:{port}") as ch:
            embed = ch.unary_unary(
                "/ggrmcp.tpu.EmbedService/Embed",
                request_serializer=serving_pb2.EmbedRequest.SerializeToString,
                response_deserializer=serving_pb2.EmbedResponse.FromString)
            info_rpc = ch.unary_unary(
                "/ggrmcp.tpu.ModelInfoService/GetModelInfo",
                request_serializer=serving_pb2.ModelInfoRequest
                .SerializeToString,
                response_deserializer=serving_pb2.ModelInfoResponse.FromString)
            requests = [(name, serving_pb2.EmbedRequest(
                texts=texts, pooling=pooling)) for name, texts, pooling in calls]
            requests.append(("token_ids_8x256", serving_pb2.EmbedRequest(
                token_ids=tensors.to_proto(ids))))
            # Each batch three times: the first call pays the lazy CUDA
            # set-up of its shapes.
            for name, req in requests:
                ms = []
                for _ in range(3):
                    before = tatt.flash_attention.launches
                    resp = await embed(req, timeout=600)
                    launched = tatt.flash_attention.launches - before
                    check(launched >= cfg.num_layers,
                          f"embed {name}: {launched} kernel launches, not "
                          f">= {cfg.num_layers}")
                    ms.append(resp.compute_ms)
                vec = tensors.from_proto(resp.embeddings)
                n_rows = len(req.texts) or ids.shape[0]
                check(vec.shape == (n_rows, cfg.hidden_dim)
                      and vec.dtype == np.float32,
                      f"embed {name}: {vec.shape} {vec.dtype}")
                norms = np.linalg.norm(vec, axis=-1)
                check(bool(np.all(np.abs(norms - 1.0) <= 1e-3)),
                      f"embed {name}: norms {norms.min()}..{norms.max()}")
                vectors[name] = vec
                res["calls"][name] = dict(compute_ms=ms, launches=launched)
            info = await info_rpc(serving_pb2.ModelInfoRequest())
            check(info.family == "bert" and info.model_id == EMBED_MODEL
                  and info.platform == "cuda", f"model info {info}")
    finally:
        await sidecar.stop()
    torch.cuda.synchronize()
    res["launches"] = tatt.flash_attention.launches
    res["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["weights_gb"] = engine.weight_bytes() / 1e9

    # The kernel path against the plain float32 path, call by call.
    token_lists = {name: [sidecar.tokenizer.encode(t) for t in texts]
                   for name, texts, _ in calls}
    token_lists["token_ids_8x256"] = [
        row[: int(np.nonzero(row)[0][-1]) + 1].tolist() for row in ids]
    poolings = {name: pooling for name, _, pooling in calls}
    cosines = {}
    for name, vec in vectors.items():
        plain = _plain_embed(tatt, bert_mod, engine, token_lists[name],
                             poolings.get(name, "mean"))
        cosines[name] = float((vec * plain).sum(-1).min())
        check(cosines[name] >= EMBED_MIN_COSINE,
              f"embed {name}: cosine to the float32 plain path "
              f"{cosines[name]} < {EMBED_MIN_COSINE}")
    res["min_cosine_to_plain_f32"] = cosines
    return res


# -- phase 7: HF checkpoint ---------------------------------------------------

# llama3-8b's width with the depth cut to 2 layers (about 3.0 GB in
# bf16), in the HF layout of a Llama-3.1 checkpoint.
HF_CONFIG = dict(
    architectures=["LlamaForCausalLM"], _name_or_path="llama3-8b-2-layers",
    vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=2, num_attention_heads=32, num_key_value_heads=8,
    max_position_embeddings=131072, rms_norm_eps=1e-5, rope_theta=500000.0,
    rope_scaling=dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0,
                      high_freq_factor=4.0,
                      original_max_position_embeddings=8192),
    tie_word_embeddings=False,
)
HF_NEW_TOKENS = 8


def write_safetensors(path: str, tensors: dict) -> None:
    """A safetensors file in a few lines (the card has no `safetensors`
    package): u64 header length, the JSON header (padded to 8 bytes),
    then each tensor's raw bytes in order. One tensor at a time passes
    through host memory."""
    import torch

    names = {torch.bfloat16: "BF16", torch.float16: "F16",
             torch.float32: "F32"}
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = dict(dtype=names[t.dtype], shape=list(t.shape),
                            data_offsets=[offset, offset + n])
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(blob)))
        fh.write(blob)
        for t in tensors.values():
            fh.write(t.detach().contiguous().cpu().view(torch.uint8).numpy())


def hf_tensor_shapes(hf: dict) -> dict:
    """Name → [out, in] shape of every tensor of an HF Llama checkpoint."""
    d, f, vocab = hf["hidden_size"], hf["intermediate_size"], hf["vocab_size"]
    hd = d // hf["num_attention_heads"]
    q_out = hf["num_attention_heads"] * hd
    kv_out = hf["num_key_value_heads"] * hd
    shapes = {"model.embed_tokens.weight": (vocab, d)}
    for i in range(hf["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        shapes.update({
            pre + "input_layernorm.weight": (d,),
            pre + "self_attn.q_proj.weight": (q_out, d),
            pre + "self_attn.k_proj.weight": (kv_out, d),
            pre + "self_attn.v_proj.weight": (kv_out, d),
            pre + "self_attn.o_proj.weight": (d, q_out),
            pre + "post_attention_layernorm.weight": (d,),
            pre + "mlp.gate_proj.weight": (f, d),
            pre + "mlp.up_proj.weight": (f, d),
            pre + "mlp.down_proj.weight": (d, f),
        })
    shapes["model.norm.weight"] = (d,)
    shapes["lm_head.weight"] = (vocab, d)
    return shapes


def write_hf_checkpoint(path: str, hf: dict, torch, dev, seed: int) -> dict:
    """An HF-layout checkpoint of seeded random bf16 weights (std 0.02;
    norm weights about 1): config.json and two safetensors files under a
    model.safetensors.index.json. Returns the written tensors, on `dev`."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    tensors = {}
    for name, shape in hf_tensor_shapes(hf).items():
        t = torch.randn(shape, generator=gen, device=dev) * 0.02
        tensors[name] = (t + 1.0 if len(shape) == 1 else t).to(torch.bfloat16)
    names = list(tensors)
    half = len(names) // 2
    weight_map = {}
    for i, part in enumerate((names[:half], names[half:])):
        fname = f"model-{i + 1:05d}-of-00002.safetensors"
        write_safetensors(os.path.join(path, fname),
                          {n: tensors[n] for n in part})
        weight_map.update(dict.fromkeys(part, fname))
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as fh:
        json.dump({"metadata": {}, "weight_map": weight_map}, fh)
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(hf, fh)
    return tensors


class PeakRss:
    """Peak resident set of this process inside a `with` block, sampled
    from /proc/self/statm every millisecond by a thread (`ru_maxrss`
    keeps the peak of everything before, the writer's included)."""

    def __init__(self):
        import threading

        self._page = os.sysconf("SC_PAGE_SIZE")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self.start = self.peak = 0

    def _rss(self) -> int:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * self._page

    def _run(self) -> None:
        while not self._stop.wait(0.001):
            self.peak = max(self.peak, self._rss())

    def __enter__(self) -> "PeakRss":
        self.start = self.peak = self._rss()
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=10)
        self.peak = max(self.peak, self._rss())


def _check_loaded(torch, params, written, hf: dict) -> None:
    """Every leaf equals the written bytes, bit for bit, after the
    transposes and the q/k/v concatenation."""
    d = hf["hidden_size"]
    hd = d // hf["num_attention_heads"]
    q_out = hf["num_attention_heads"] * hd
    kv_out = hf["num_key_value_heads"] * hd
    layers = params["layers"]
    pairs = [(params["embed"], "model.embed_tokens.weight", False),
             (params["final_norm"], "model.norm.weight", False),
             (params["lm_head"], "lm_head.weight", True)]
    for i in range(hf["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        qkv = layers["wqkv"][i]
        pairs += [
            (layers["attn_norm"][i], pre + "input_layernorm.weight", False),
            (qkv[:, :q_out], pre + "self_attn.q_proj.weight", True),
            (qkv[:, q_out:q_out + kv_out], pre + "self_attn.k_proj.weight",
             True),
            (qkv[:, q_out + kv_out:], pre + "self_attn.v_proj.weight", True),
            (layers["wo"][i], pre + "self_attn.o_proj.weight", True),
            (layers["mlp_norm"][i], pre + "post_attention_layernorm.weight",
             False),
            (layers["w_gate"][i], pre + "mlp.gate_proj.weight", True),
            (layers["w_up"][i], pre + "mlp.up_proj.weight", True),
            (layers["w_down"][i], pre + "mlp.down_proj.weight", True),
        ]
    check(len(pairs) == len(written), "a written tensor is not checked")
    for leaf, name, transposed in pairs:
        src = written[name].T if transposed else written[name]
        check(leaf.dtype == torch.bfloat16 and torch.equal(leaf, src),
              f"loaded {name} differs from the written bytes")


async def hf_phase(torch, tatt, dev) -> dict:
    import tempfile

    import grpc.aio

    from ggrmcp_tpu_torch.core.config import ServingConfig
    from ggrmcp_tpu_torch.ops import quant as tq
    from ggrmcp_tpu_torch.rpc.pb import serving_pb2
    from ggrmcp_tpu_torch.serving.engine import GenerationEngine
    from ggrmcp_tpu_torch.serving.sidecar import Sidecar
    from ggrmcp_tpu_torch.serving.weights import load_hf_checkpoint

    res: dict = {}
    with tempfile.TemporaryDirectory(prefix="hf-ckpt-") as path:
        t = time.perf_counter()
        written = write_hf_checkpoint(path, HF_CONFIG, torch, dev, SEED + 7)
        res["write_s"] = time.perf_counter() - t
        file_bytes = sum(os.path.getsize(os.path.join(path, f))
                         for f in os.listdir(path) if f.endswith(".safetensors"))
        largest = max(x.numel() * x.element_size() for x in written.values())
        gc.collect()
        with PeakRss() as rss:
            t = time.perf_counter()
            cfg, params = load_hf_checkpoint(path, dev)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t
        res.update(
            file_gb=file_bytes / 1e9, load_s=load_s,
            load_gb_per_s=file_bytes / load_s / 1e9,
            host_rss_growth_gb=(rss.peak - rss.start) / 1e9,
            largest_tensor_gb=largest / 1e9)
        check(cfg.rope_scaling == (8.0, 1.0, 4.0, 8192.0)
              and cfg.num_layers == 2 and cfg.hidden_dim == 4096,
              f"config read as {cfg}")
        _check_loaded(torch, params, written, HF_CONFIG)
        check(rss.peak - rss.start <= 2 * largest,
              f"host RSS grew {(rss.peak - rss.start) / 1e9:.2f} GB during "
              f"the load, more than twice the largest tensor "
              f"({largest / 1e9:.2f} GB)")
        del written

        # The sidecar loads the same directory itself; its greedy tokens
        # must be those of an engine on the params loaded above.
        prompt = _prompt_text(60, 11)
        tok = [1] + [b + 3 for b in prompt.encode()]

        async def serve(**fields):
            """Start a sidecar on the directory, one greedy Generate of
            `prompt`; returns (sidecar, token ids, kernel launches)."""
            tatt.flash_attention.launches = 0
            sidecar = Sidecar(ServingConfig(hf_checkpoint_path=path, **fields),
                              device=dev)
            port = await sidecar.start(0)
            try:
                async with grpc.aio.insecure_channel(
                        f"localhost:{port}") as ch:
                    generate = ch.unary_unary(
                        "/ggrmcp.tpu.GenerateService/Generate",
                        request_serializer=serving_pb2.GenerateRequest
                        .SerializeToString,
                        response_deserializer=serving_pb2.GenerateResponse
                        .FromString)
                    resp = await generate(serving_pb2.GenerateRequest(
                        prompt=prompt, max_new_tokens=HF_NEW_TOKENS,
                        return_tokens=True), timeout=600)
            finally:
                await sidecar.stop()
            torch.cuda.synchronize()
            return sidecar, list(resp.token_ids), tatt.flash_attention.launches

        sidecar, res["tokens"], res["launches"] = await serve()
        check(res["launches"] > 0, "the HF sidecar never launched the kernel")
        check(torch.equal(sidecar.generation.params["layers"]["wqkv"],
                          params["layers"]["wqkv"]),
              "the sidecar's weights differ from the loaded ones")
        del sidecar
        ref, _ = GenerationEngine(cfg, params=params, device=dev).generate(
            [tok], HF_NEW_TOKENS, eos_id=2)
        check(res["tokens"] == ref[0],
              f"HF sidecar tokens {res['tokens']} != engine's {ref[0]}")

        # quantize="int8": the loaded weights reach the engine dense and
        # are quantized there, bit for bit the port's `quantize`.
        want = tq.quantize_model(params)
        sidecar, res["int8_tokens"], res["int8_launches"] = await serve(
            quantize="int8")
        check(res["int8_launches"] > 0,
              "the int8 HF sidecar never launched the kernel")
        _check_quantized(torch, tq, sidecar.generation.params, want)
        del sidecar, params
        ref, _ = GenerationEngine(cfg, params=want, device=dev).generate(
            [tok], HF_NEW_TOKENS, eos_id=2)
        check(res["int8_tokens"] == ref[0],
              f"int8 HF sidecar tokens {res['int8_tokens']} != engine's "
              f"{ref[0]}")
    return res


def _check_quantized(torch, tq, got, want) -> None:
    """Every leaf of `got` equals `want`'s bit for bit: int8 values and
    bf16 scales of the quantized leaves, the dense ones as they are."""
    def leaves(tree, prefix=""):
        for key, value in tree.items():
            if isinstance(value, dict):
                yield from leaves(value, f"{prefix}{key}/")
            else:
                yield prefix + key, value

    mine = dict(leaves(got))
    for name, leaf in leaves(want):
        other = mine[name]
        if isinstance(leaf, tq.QuantizedTensor):
            check(isinstance(other, tq.QuantizedTensor)
                  and other.q.dtype == torch.int8
                  and other.scale.dtype == leaf.scale.dtype
                  and torch.equal(other.q, leaf.q)
                  and torch.equal(other.scale, leaf.scale),
                  f"quantized {name} differs from quantize() of the dense "
                  f"leaf")
        else:
            check(torch.equal(other, leaf), f"dense {name} differs")


# -- phase 8: int8 ------------------------------------------------------------

# int8 against bf16 weights, last-position logits: the reference's bound
# (tests/test_quant.py), least row cosine.
INT8_MIN_COSINE = 0.999
# int8 against bf16 KV cache: the reference's bound (tests/test_kv_quant.py),
# max |difference| over max |bf16 logit|.
INT8_KV_MAX_REL = 0.05
INT8_PROMPT_TOKENS = (40, 500, 700, 3000)
INT8_NEW_TOKENS = 16
# The decode GEMM: 32 slots through llama3-8b's gate projection.
GEMM_SHAPE = (32, 4096, 14336)


def _row_cosine(a, b):
    a, b = a.double(), b.double()
    return (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))


def _prefill_last(torch, engine, params, tokens, cache_len: int):
    """A fresh [B, S] prefill through the engine's admission body: (the
    last position's logits [B, V], the cache)."""
    b, s = tokens.shape
    true_len = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    with torch.no_grad():
        return engine._prefill_impl(params, tokens, true_len,
                                    engine.make_cache(b, cache_len))


def _decode_step_ms(torch, engine, params, cache) -> dict:
    """Device time of one decode step of every row of `cache`, always
    at the same cache length (median, min, max of 5 runs of 5 steps)."""
    b = cache.length.shape[0]
    length = cache.length
    cur = torch.full((b, 1), 7, dtype=torch.long, device=length.device)

    def step():
        cache.length = length
        engine.decode_forward(params, cur, cache)

    with torch.no_grad():
        return cuda_ms_spread(torch, step, runs=5, reps=5)


def int8_weights_phase(torch, dev) -> dict:
    """(a) llama3-8b's seeded bf16 weights, quantized through the
    engine's path; bf16 / int8 / float32-int8 prefills compared; (e)'s
    decode steps."""
    import dataclasses

    from ggrmcp_tpu_torch.core.config import ServingConfig
    from ggrmcp_tpu_torch.models import llama as llama_mod
    from ggrmcp_tpu_torch.ops import quant as tq
    from ggrmcp_tpu_torch.serving.engine import GenerationEngine

    cfg = llama_mod.CONFIGS[MODEL]
    res: dict = {}
    params = llama_mod.init_params(cfg, dev, SEED)
    dense = GenerationEngine(cfg, params=params, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    tokens = torch.randint(3, cfg.vocab_size, (32, 512), generator=gen,
                           device=dev)
    last_bf16, cache = _prefill_last(torch, dense, params, tokens, 1024)
    res["decode_step_ms_bf16"] = _decode_step_ms(torch, dense, params, cache)
    del cache

    # One layer's w_gate quantized on the card and on the CPU, bit for
    # bit: as stored (bf16) and widened to float32, whose scales are kept
    # unrounded.
    for w in (params["layers"]["w_gate"][0],
              params["layers"]["w_gate"][0].float()):
        on_card, on_cpu = tq.quantize(w), tq.quantize(w.cpu())
        same = bool(torch.equal(on_card.q.cpu(), on_cpu.q)
                    and torch.equal(on_card.scale.cpu(), on_cpu.scale))
        res[f"layer_quantize_bitwise_{str(w.dtype)[6:]}"] = same
        check(same, f"quantize of w_gate[0] ({w.dtype}) on the card "
              f"differs from the CPU's")
    del w, on_card, on_cpu

    res["bf16_weight_bytes"] = dense.weight_bytes()
    del dense
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    t = time.perf_counter()
    engine = GenerationEngine(cfg, ServingConfig(model=MODEL, quantize="int8"),
                              params=params, device=dev)
    torch.cuda.synchronize()
    res["quantize_s"] = time.perf_counter() - t
    res["quantize_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["quantize_peak_over_start_gb"] = (
        torch.cuda.max_memory_allocated() - start) / 1e9
    res["int8_weight_bytes"] = engine.weight_bytes()
    res["weight_ratio"] = res["int8_weight_bytes"] / res["bf16_weight_bytes"]

    last_int8, cache = _prefill_last(torch, engine, params, tokens, 1024)
    res["decode_step_ms_int8"] = _decode_step_ms(torch, engine, params, cache)
    del cache, engine

    # The int8 model in float32 (int8 x bf16 scale is exact in float32),
    # every attention on the plain path: how far each bf16 run lies from
    # the int8 weights computed without rounding.
    cfg32 = dataclasses.replace(cfg, dtype="float32")

    def widen(leaf):
        if isinstance(leaf, tq.QuantizedTensor):
            return leaf.q.float() * leaf.scale.float()
        return leaf.float()

    params32 = {k: ({n: widen(t) for n, t in v.items()}
                    if isinstance(v, dict) else widen(v))
                for k, v in params.items()}
    del params
    gc.collect()
    with torch.no_grad():
        logits32, _ = llama_mod.forward(params32, cfg32, tokens,
                                        use_flash=False)
    last_f32 = logits32[:, -1].clone()
    del logits32, params32
    gc.collect()
    torch.cuda.empty_cache()

    cos = _row_cosine(last_int8, last_bf16)
    res["min_cosine_int8_vs_bf16"] = cos.min().item()
    res["top1_agree_int8_vs_bf16"] = (
        last_int8.argmax(-1) == last_bf16.argmax(-1)).float().mean().item()
    res["min_cosine_int8_vs_f32_int8"] = _row_cosine(
        last_int8, last_f32).min().item()
    res["min_cosine_bf16_vs_f32_int8"] = _row_cosine(
        last_bf16, last_f32).min().item()
    check(bool(torch.isfinite(last_int8).all()), "int8 logits not finite")
    log(f"  (a) {json.dumps(res)}")
    check(res["weight_ratio"] <= 0.51,
          f"int8 weights are {res['weight_ratio']:.4f} of bf16, not <= 0.51")
    check(res["min_cosine_int8_vs_bf16"] >= INT8_MIN_COSINE,
          f"int8 vs bf16 logits: least row cosine "
          f"{res['min_cosine_int8_vs_bf16']} < {INT8_MIN_COSINE}")

    # (e) the eager dequantizing GEMM at the decode shape.
    m, k, n = GEMM_SHAPE
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device=dev) * 0.02).to(
        torch.bfloat16)
    qw = tq.quantize(w)
    int8_t = cuda_ms_spread(torch, lambda: tq.matmul(x, qw))
    bf16_t = cuda_ms_spread(torch, lambda: x @ w)
    cast_t = cuda_ms_spread(torch, lambda: qw.q.to(torch.bfloat16))
    io = 2 * m * k + 2 * m * n  # x read, the output written
    # int8 path: q read (1 B), its bf16 cast written and read (2 + 2 B).
    res["gemm"] = dict(
        shape=list(GEMM_SHAPE), int8=int8_t, bf16=bf16_t, cast=cast_t,
        cast_bound_ms=3 * k * n / PEAK_BYTES * 1e3,
        int8_bound_ms=(5 * k * n + io + 2 * n) / PEAK_BYTES * 1e3,
        bf16_bound_ms=(2 * k * n + io) / PEAK_BYTES * 1e3,
        flop_bound_ms=2 * m * k * n / PEAK_FLOPS["bfloat16"] * 1e3)
    log(f"  (e) gemm {json.dumps(res['gemm'])}")
    del x, w, qw
    torch.cuda.empty_cache()
    return res


async def _int8_serve(torch, tatt, dev, **fields):
    """A llama3-8b sidecar with `fields`: TTFT alone at 40 / 500 / 3000
    tokens, a concurrent burst across both admission routes, a repeated
    greedy prompt, GetModelInfo and GetServingStats. Returns (results,
    the stopped sidecar)."""
    import grpc.aio

    from ggrmcp_tpu_torch.core.config import ServingConfig
    from ggrmcp_tpu_torch.models import llama as llama_mod
    from ggrmcp_tpu_torch.rpc.pb import serving_pb2
    from ggrmcp_tpu_torch.serving.sidecar import Sidecar

    vocab = llama_mod.CONFIGS[MODEL].vocab_size
    torch.cuda.reset_peak_memory_stats()
    sidecar = Sidecar(ServingConfig(model=MODEL, **fields), seed=SEED,
                      device=dev)
    # The main path's run starts here: every launch count from 0.
    tatt.flash_attention.launches = 0
    port = await sidecar.start(0)
    res: dict = dict(weights_gb=sidecar.generation.weight_bytes() / 1e9)
    try:
        async with grpc.aio.insecure_channel(f"localhost:{port}") as ch:
            def unary(method, req, resp):
                return ch.unary_unary(
                    method, request_serializer=req.SerializeToString,
                    response_deserializer=resp.FromString)
            generate = unary("/ggrmcp.tpu.GenerateService/Generate",
                             serving_pb2.GenerateRequest,
                             serving_pb2.GenerateResponse)
            info_rpc = unary("/ggrmcp.tpu.ModelInfoService/GetModelInfo",
                             serving_pb2.ModelInfoRequest,
                             serving_pb2.ModelInfoResponse)
            stats_rpc = unary("/ggrmcp.tpu.ModelInfoService/GetServingStats",
                              serving_pb2.ServingStatsRequest,
                              serving_pb2.ServingStatsResponse)

            def request(n_tokens, seed, max_new=INT8_NEW_TOKENS):
                return serving_pb2.GenerateRequest(
                    prompt=_prompt_text(n_tokens, seed),
                    max_new_tokens=max_new, return_tokens=True)

            async def timed(req):
                t = time.perf_counter()
                resp = await generate(req, timeout=600)
                return resp, (time.perf_counter() - t) * 1e3

            _, res["first_call_ms"] = await timed(request(40, 99, max_new=2))
            res["ttft_ms"] = {}
            for n in (40, 500, 3000):
                _, res["ttft_ms"][n] = await timed(request(n, 100 + n, 1))

            t = time.perf_counter()
            burst = await asyncio.gather(*(
                timed(request(n, i)) for i, n in enumerate(INT8_PROMPT_TOKENS)))
            wall = time.perf_counter() - t
            tokens = 0
            for n, (resp, _) in zip(INT8_PROMPT_TOKENS, burst):
                ids = list(resp.token_ids)
                check(resp.prompt_tokens == n,
                      f"prompt of {n} tokens arrived as {resp.prompt_tokens}")
                check(1 <= len(ids) == resp.completion_tokens
                      <= INT8_NEW_TOKENS, f"bad completion for {n}: {resp}")
                check(all(0 <= i < vocab for i in ids),
                      f"out-of-vocab token for prompt {n}")
                check(resp.finish_reason in ("length", "stop"),
                      f"finish {resp.finish_reason!r} for prompt {n}")
                tokens += len(ids)
            res["burst"] = dict(
                wall_s=wall, tokens=tokens, tok_per_s=tokens / wall,
                latency_ms={n: ms for n, (_, ms) in
                            zip(INT8_PROMPT_TOKENS, burst)})

            again = [await generate(request(500, 0)) for _ in range(2)]
            check(list(again[0].token_ids) == list(again[1].token_ids)
                  and len(again[0].token_ids) > 0,
                  "the same greedy prompt gave different tokens")

            info = await info_rpc(serving_pb2.ModelInfoRequest())
            check(info.model_id == MODEL and info.platform == "cuda",
                  f"model info {info}")
            res["num_params_million"] = info.num_params_million
            stats = await stats_rpc(serving_pb2.ServingStatsRequest())
            res["stats"] = dict(
                kv_cache_bytes=stats.kv_cache_bytes,
                memory_weights_bytes=stats.memory_weights_bytes,
                decode_stall_ms_p50=stats.decode_stall_ms_p50,
                ticks=stats.ticks, admit_ms_max=stats.admit_ms_max)
        batcher = sidecar.batcher
        check(batcher.fused_admissions > 0 and batcher.chunked_admissions > 0,
              "the burst did not run both admission routes")
    finally:
        await sidecar.stop()
    torch.cuda.synchronize()
    res["launches"] = tatt.flash_attention.launches
    res["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return res, sidecar


def _kv_int8_accuracy(torch, dev, params) -> dict:
    """One [8, 256] prefill and one decode step through an int8 cache
    against a bf16 cache, on the same int8 weights."""
    from ggrmcp_tpu_torch.models import llama as llama_mod

    cfg = llama_mod.CONFIGS[MODEL]
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    tokens = torch.randint(3, cfg.vocab_size, (8, 256), generator=gen,
                           device=dev)
    step = torch.randint(3, cfg.vocab_size, (8, 1), generator=gen, device=dev)
    outs = {}
    with torch.no_grad():
        for kv in ("", "int8"):
            cache = llama_mod.KVCache.create(cfg, 8, 512, dev, kv)
            prefill, cache = llama_mod.forward(params, cfg, tokens, cache)
            decode, _ = llama_mod.forward(params, cfg, step, cache)
            outs[kv] = (prefill[:, -1].clone(), decode[:, -1])
            del prefill, cache
    rel = [((a - b).abs().max() / a.abs().max()).item()
           for a, b in zip(outs[""], outs["int8"])]
    return dict(prefill_rel=rel[0], decode_rel=rel[1])


async def int8_phase(torch, tatt, dev) -> dict:
    from ggrmcp_tpu_torch.core.config import ServingConfig
    from ggrmcp_tpu_torch.models import llama as llama_mod
    from ggrmcp_tpu_torch.serving.engine import GenerationEngine

    res: dict = dict(weights=int8_weights_phase(torch, dev))
    gc.collect()
    torch.cuda.empty_cache()

    b, sidecar = await _int8_serve(torch, tatt, dev, quantize="int8")
    del sidecar
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  (b) int8 weights, bf16 KV: {json.dumps(b)}")
    check(b["launches"] > 0, "(b) never launched the kernel")
    res["bf16_kv"] = b

    c, sidecar = await _int8_serve(torch, tatt, dev, quantize="int8",
                                   kv_cache_dtype="int8")
    params = sidecar.generation.params
    del sidecar
    gc.collect()
    torch.cuda.empty_cache()
    c["accuracy"] = _kv_int8_accuracy(torch, dev, params)
    del params
    c["kv_ratio"] = (c["stats"]["kv_cache_bytes"]
                     / b["stats"]["kv_cache_bytes"])
    log(f"  (c) int8 weights, int8 KV: {json.dumps(c)}")
    check(c["launches"] == 0,
          f"(c) launched the kernel {c['launches']} times on int8 KV")
    check(c["kv_ratio"] <= 0.52,
          f"(c) int8 KV pool is {c['kv_ratio']:.4f} of bf16, not <= 0.52")
    for key in ("prefill_rel", "decode_rel"):
        check(c["accuracy"][key] < INT8_KV_MAX_REL,
              f"(c) int8 vs bf16 cache {key} {c['accuracy'][key]} >= "
              f"{INT8_KV_MAX_REL}")
    res["int8_kv"] = c
    gc.collect()
    torch.cuda.empty_cache()

    # (d) synthetic int8 weights: the engine alone (the batcher's pool
    # would count), then one Generate through a sidecar.
    synthetic = dict(quantize="int8", synthetic_weights=True)
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    engine = GenerationEngine(llama_mod.CONFIGS[MODEL],
                              ServingConfig(model=MODEL, **synthetic),
                              seed=SEED, device=dev)
    torch.cuda.synchronize()
    d = dict(init_peak_gb=(torch.cuda.max_memory_allocated() - start) / 1e9,
             int8_weight_gb=engine.weight_bytes() / 1e9)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    d["peak_over_weights"] = d["init_peak_gb"] / d["int8_weight_gb"]
    check(d["peak_over_weights"] < 1.1,
          f"(d) synthetic init peak {d['init_peak_gb']:.3f} GB is "
          f"{d['peak_over_weights']:.3f}x its int8 weights, not < 1.1x")
    d["serve"], sidecar = await _int8_serve(torch, tatt, dev, **synthetic)
    del sidecar
    log(f"  (d) synthetic: {json.dumps(d)}")
    res["synthetic"] = d
    return res


# -- main ---------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from ggrmcp_tpu_torch.ops import _build
        from ggrmcp_tpu_torch.ops import attention as tatt
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    try:
        card = card_line()
        log(f"[1/8] card: {card}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

        t = time.perf_counter()
        _build.load("flash_attention")
        log(f"[2/8] build: flash_attention.cu in "
            f"{time.perf_counter() - t:.1f} s")
        ptxas_report(_build.build_log.get("flash_attention", ""))

        log(f"[3/8] kernel vs plain (|err| <= atol + rtol |plain|: {TOL})")
        cases = kernel_cases(torch, tatt, dev)

        log("[4/8] reference: tiny-llama on the card vs the CPU")
        ref = tiny_reference(torch, dev)
        log(f"  {ref}")

        log(f"[5/8] serve: {MODEL} sidecar, default batching")
        serve = asyncio.run(serve_phase(torch, tatt, dev))
        log(f"  {json.dumps(serve)}")
        gc.collect()
        torch.cuda.empty_cache()

        log(f"[6/8] embed: {EMBED_MODEL} sidecar")
        embed = asyncio.run(embed_phase(torch, tatt, dev))
        log(f"  {json.dumps(embed)}")
        gc.collect()
        torch.cuda.empty_cache()

        log("[7/8] HF checkpoint: llama3-8b width, 2 layers, 2 files")
        hf = asyncio.run(hf_phase(torch, tatt, dev))
        log(f"  {json.dumps(hf)}")
        gc.collect()
        torch.cuda.empty_cache()

        log(f"[8/8] int8: {MODEL} weights and KV cache")
        int8 = asyncio.run(int8_phase(torch, tatt, dev))
    except SmokeError as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        return 1

    head = next(c for c in cases if c["name"] == HEADLINE)
    kernels = [dict(
        name="flash_attention", route="cuda",
        source="ggrmcp_tpu_torch/ops/csrc/flash_attention.cu",
        replaces="ggrmcp_tpu/ops/attention.py:286",
        launches=serve["launches"], embed_launches=embed["launches"],
        hf_launches=hf["launches"], hf_int8_launches=hf["int8_launches"],
        int8_launches=int8["bf16_kv"]["launches"],
        int8_kv_launches=int8["int8_kv"]["launches"],
        max_abs_err=max(c["max_abs_err"] for c in cases),
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"],
        ms_min=head["ms_min"], ms_max=head["ms_max"],
        design=DESIGN,
    )]
    log(json.dumps({"cases": cases}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
