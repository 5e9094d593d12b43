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
   the kernel's launch count must rise during this phase.

The last lines are the kernels JSON line, the card line, and
{"ok": true, "device": {"platform": "gpu", ...}}.
"""

from __future__ import annotations

import asyncio
import json
import os
import re
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
        if name.startswith("chunk"):
            # The model's operand: [:, :S_max] of a [B, S_max + 1, ...]
            # per-layer cache slice (not contiguous).
            kc, vc = (torch.randn((b, sk + 1, kvh, d), generator=gen,
                                  device=dev).to(dtype) for _ in range(2))
            k, v = kc[:, :sk], vc[:, :sk]
        else:
            k, v = (torch.randn((b, sk, kvh, d), generator=gen,
                                device=dev).to(dtype) for _ in range(2))
        q_offset = torch.full((b,), off, dtype=torch.int32, device=dev)
        kv_len = torch.full((b,), kvl, dtype=torch.int32, device=dev)
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
        plain_causal = causal and off == 0 and kvl == sk and sq == sk and (
            not window)
        sdpa_kw = (dict(is_causal=True) if plain_causal
                   else dict(attn_mask=mask[:, None]) if causal or kvl < sk
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
                       q_offset=off, kv_len=kvl, window=window),
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
        log(f"[1/5] card: {card}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

        t = time.perf_counter()
        _build.load("flash_attention")
        log(f"[2/5] build: flash_attention.cu in "
            f"{time.perf_counter() - t:.1f} s")
        ptxas_report(_build.build_log.get("flash_attention", ""))

        log(f"[3/5] kernel vs plain (|err| <= atol + rtol |plain|: {TOL})")
        cases = kernel_cases(torch, tatt, dev)

        log("[4/5] reference: tiny-llama on the card vs the CPU")
        ref = tiny_reference(torch, dev)
        log(f"  {ref}")

        log(f"[5/5] serve: {MODEL} sidecar, default batching")
        serve = asyncio.run(serve_phase(torch, tatt, dev))
        log(f"  {json.dumps(serve)}")
    except SmokeError as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        return 1

    head = next(c for c in cases if c["name"] == HEADLINE)
    kernels = [dict(
        name="flash_attention", route="cuda",
        source="ggrmcp_tpu_torch/ops/csrc/flash_attention.cu",
        replaces="ggrmcp_tpu/ops/attention.py:286",
        launches=serve["launches"],
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
