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
   against bf16, timed;
9. KV reuse: the prefix pool, the interleave and paged KV at llama3-8b
   width (phases 9-15, 17, 19, 23 and 24's serving models cut to 4 of
   32 layers, CUT_DEPTH; 12's (b) and (c) to 8) through sidecars
   configured by a `--config` file,
   each against its switch off;
10. grammar: a llama3-8b sidecar with the default GrammarConfig (arena
   4096 states, jump_max 8) answers a burst of 16 Generate calls, 8 of
   them constrained by three tool-output schemas (2 sampled), through
   jump-ahead ticks that launch the kernel; the same burst with jump off
   and with 4 decode steps per tick (identical tokens to jump off); the
   arena's device bytes and the first call on a new schema against a
   warm one; RESOURCE_EXHAUSTED on a full arena, INVALID_ARGUMENT on a
   `pattern` schema, a constrained GenerateStream; tiny-llama float32
   constrained tokens identical jump on, jump off and on the CPU;
11. control plane, at llama3-8b width through sidecars configured by a
   `--config` file: (a) phase 5's burst with the flight recorder on and
   off (tick p50 of both; the median admit / sync / dispatch / wait /
   host split of a plain decode tick from GetFlightRecord; every tick's
   phases close on its duration; the histograms count every request);
   (b) a 1000 ms Profile over gRPC while 32 slots decode (the top 10
   kernels by device time per tick, the device's busy share; no kernel
   event fails the phase); (c) GetMemory with reconcile (every
   component; attributed + unattributed == torch.cuda.memory_allocated);
   (d) 32 batch-class requests, then 4 interactive ones, with the
   scheduler on and off (interactive TTFT, preemptions and resumes, the
   resumed streams' agreement with the uninterrupted ones); (e) a
   sidecar armed with tick_fail and admit_fail serves phase 5's burst by
   replay; (f) queue_deadline_ms 200 with 40 requests on 32 slots, and
   phase 9b's long-prompt wave with p50_budget_ms 500 against 0;
12. the paged plane's remainder and multi-LoRA, at llama3-8b width
   through sidecars configured by a `--config` file on one weight set:
   (a) the host page tier: 16 distinct 2048-token preambles through a
   1024-page arena with 8 GiB of host pool, twice (the second pass
   restores), against an arena that holds every page (first tokens
   identical), the bytes and rates each way, a third pass under
   host_restore_fail (typed recompute), and a restarted sidecar warming
   from the file tier; (b) prefill, decode and mixed sidecars: two-leg
   calls of 1024-3000 tokens (the decode admission reuses every imported
   full page and launches B1 on the tail only), the transfer's pages,
   chunks, bytes and times, the int8 cache shipping about half the
   bytes, kv_transfer_fail (ABORTED) and a page-size mismatch
   (INVALID_ARGUMENT); (c) a registry of four rank-8 adapters: a burst
   of 16 mixing base and all four (tick p50 against the burst all base,
   each stream against its adapter alone, a zero-b adapter equal to
   base), an adapter'd two-leg call, a churning 2-row arena and
   adapter_load_fail (ABORTED); (d) phase 11d's scheduler traffic on an
   arena holding the batch exactly with the host tier attached: the
   resumes restore the parked pages;
13. speculative decoding, ring KV and length tiers at mistral-7b width
   with the llama-1b draft (gamma 4), through sidecars configured by a
   `--config` file on one weight set: (a) a 16-call burst (8 greedy, 4 at
   temperature 0.8, 2 top-k, 2 constrained by phase 10's schemas) with
   `batching.speculative` on and off (tick p50, tokens/s, acceptance,
   greedy streams on vs off counted, B1 launching once a layer a verify
   tick, one sampled round's threefry draws timed); (b) a self-draft (the
   target's own tensors as the draft), 8 greedy calls: acceptance, tokens
   a row a tick, streams against spec off; (c) the micro-path
   (`speculative=off` with the draft): the 8 calls' `speculative_calls`
   against `speculative_requests`, tokens against the batcher's; (d) 8
   prompts of 5000-7000 tokens through the ring (capacity 4607, 8 slots)
   and the contiguous windowed cache at 8192 (streams counted, KV bytes
   from GetMemory, TTFT; the ring never launches B1); (e) tiers [[1024,
   32], [8192, 4]] against one 28-slot pool at 8192 with 24 short calls
   and 4 of 6000 tokens together (each tier's admissions, TTFT of each
   kind, KV bytes);
14. sparse MoE at mixtral-8x7b's widths with the depth cut to 4 of 32
   layers (CUT_DEPTH; seeded random bf16 weights): (a) one layer's `moe_ffn` at the
   [32, 512] admission shape against its float32 one-hot form, a [32,
   512] prefill with B1 against the same prefill through
   `flash_attention_ref` (the plain run's routing held to the kernel
   run's, its own flips counted), tiny-moe float32 on the card against
   the CPU; (b) a sidecar configured by a `--config` file that sets the
   depth answers phase 5's burst through fused and chunked admissions
   and one GenerateStream (GetModelInfo's family and parameter count, B1
   launches, tick p50, TTFT p50, tokens/s, GetMemory's weights and
   reconcile, peak memory); (c) each greedy stream of the burst against
   its prompt alone, counted (expert capacity is batch-global); (d) two
   constrained calls of phase 10's schemas on one-token masked ticks
   (jump-ahead is off for MoE: B1 never launches in their ticks);
15. tensor and expert parallelism, every shard on the one card (the
   mesh's device list names cuda:0 once a shard; llama3-8b at CUT_DEPTH
   in (b)-(c)): (a) B1 at one of two
   tensor shards of llama3-8b's [32, 512] admission (H 16, KVH 4, D
   128, bf16) against its plain version, timed with its bound and SDPA;
   (b) tiny-llama float32 at tensor=2 on the card against tensor=2 on
   the CPU (logits, greedy tokens), and a [32, 512] llama3-8b prefill at
   tensor=2 against tensor=1 from one seeded weight tree (relative L2,
   top-1 agreement); (c) sidecars configured by a `--config` file naming
   the mesh serve phase 5's burst at tensor=1 and then, on the same tree
   sharded in place, at tensor=2 (B1 launches twice as often, once a
   shard a layer an admission forward; GetServingStats' mesh fields;
   GetMemory reconciled; tick p50 of both; the streams counted against
   tensor=1's); (d) phase 7's checkpoint loaded whole and sharded
   (every shard bitwise the whole load's split, the int8 engine's shards
   the whole quantization's split; host RSS of both loads); (e) one
   mixtral-8x7b-width layer's FFN at expert=2 x tensor=2 (four shards)
   against the unsharded one at [32, 512] (the same routing, relative
   L2). One card shows no speed-up and saves no memory;
16. the co-launch at llama3-8b width (default batching, every layer):
   (a) the port's sidecar and gateway on one event loop in this process
   over a private unix socket (serving/launcher.py): initialize,
   tools/list, one traced call (the gateway's span and the sidecar's
   share its trace id), a burst of 8 greedy tools/calls in one admission
   round (B1 launches behind MCP; tokens equal to the same burst sent
   straight to the socket), TTFT and latency through MCP against gRPC;
   (b) 200 GetModelInfo tools/calls over the socket, then over a pinned
   TCP port; (c) the sidecar's server stopped: the supervisor's restart
   and its nudge of the discoverer, the first good tools/call through
   the same gateway, tokens against before, peak memory (one
   sidecar's); (d) `python3 -m ggrmcp_tpu_torch gateway --tpu --model
   llama3-8b` as one process (no child, no process running the JAX
   package): seconds to healthy, one tools/call, the socket, SIGTERM
   (exit 0, the socket gone);
17. sequence and pipeline parallelism, plain and composed, every shard
   of each mesh on the card (llama3-8b at CUT_DEPTH, one seeded tree
   sharded in place from mesh to mesh): (c) tiny-llama float32 at
   sequence 2 and 4 and stage 2 and 4 and (d) their compositions (ring
   and Ulysses on int8 weights, Ulysses on the int8 cache, tensor=2 x
   sequence=2, tensor=2 x stage=2 on int8 weights and on the int8 cache,
   the prefix pool at tensor=2 x stage=2 with a stored prompt and a
   hit), card = CPU; (a) a 2048-token llama3-8b fresh prefill at
   sequence=2 through ring and Ulysses against sequence=1, held to
   twice a same-run witness (B1 against the plain attention), then (f)
   at tensor=2 x sequence=2 (four shards) and (h) on int8 weights and on
   int8 weights with the int8 cache (against sequence=1 on the same int8
   tree, within twice the bf16 witness; B1 never on the int8 cache);
   then sidecars configured by a `--config` file (8 slots,
   `prefill_chunk` 1024, `sp_prefill_min_seq` 1024) serve phase 5's
   burst at stage=1, the baseline, and on the same tree (e) at
   sequence=2 through ring and through Ulysses (the fused [8, 1024]
   admission through the sp
   attention, once a layer; B1 for the admissions under the threshold),
   (f) at tensor=2 x sequence=2, (b) at stage=2, (i) at tensor=2 x
   stage=2, at stage=2 on int8 weights and on the int8 cache against
   stage=1 on each: streams and first tokens counted against the
   baseline, tick p50, TTFT p50 by prompt length, the mesh in
   GetServingStats, GetMemory reconciled, peak memory; (i) phase 9a's
   wave through the prefix pool at stage=2 against the pool off (16
   hits, the hits' first tokens the pool-off run's); (g) mistral-7b
   (window 4096) takes a 6144-token fresh prefill at sequence=2 through
   ring and Ulysses against sequence=1 through windowed B1, within
   twice that run's witness. The sp attention and a stage's attention
   are plain, as the reference's are: B1 launches in neither;
18. training: (a) B1 under autograd at the training step's [8, 1023]
   (llama-1b heads, bf16, causal; windowed and ragged too): the output
   and dq / dk / dv against autograd of the plain version at TOL, timed
   (B1's forward, the backward recompute, SDPA forward + backward, the
   bounds), and one llama-1b layer's gradients through B1 against the
   plain attention; (b) tiny-llama float32, 3 AdamW steps on the card
   against the CPU at tensor 1, tensor 2 and stage 2; (c) `python3 -m
   ggrmcp_tpu_torch train --model llama-1b` (full width, 16 layers) for
   8 steps of [8, 1024] on a text file the script writes, saving at
   step 8 (losses falling, step time p50 over steps 3-8, tokens/s, the
   model-FLOPs share, peak memory, B1 launches and recomputes a step),
   then again to step 12, resuming from step 8; (d) a llama-1b sidecar
   with `serving.checkpoint_path` at step 12's params answers a greedy
   Generate with the tokens of an engine on the loaded tensors; an
   Orbax tree is refused at start;
19. the data axes and the routes once refused on a mesh, every shard on
   the card: (a) B1 at a data block's share of llama3-8b's [32, 512]
   admission ([16, 512], H 32 / KVH 8) and at a data block x tensor
   shard's (H 16 / KVH 4) against the plain version at TOL, with SDPA
   and the bound; (b) tiny-llama float32 card = CPU at data=2, fsdp=2,
   data=2 x tensor=2 and data=2 x stage=2 (B1 once a layer, block and
   shard; none under stage), tiny-moe at data=2 x expert=2 routing pair
   for pair as data=1; (c) phase 5's burst through sidecars configured
   by a `--config` file at data=1 and data=2 on one seeded llama3-8b
   tree at CUT_DEPTH (weights once on the card): B1 launches, tick p50,
   the streams counted, a [32, 512] prefill held to twice a same-run
   witness,
   GetMemory reconciled, peak memory; (d) bert-base at tensor=2 against
   tensor=1 (phase 6's cosine); (e) LoRA through the arena, (f) two-leg
   TransferKV calls from tensor=2 to tensor=1 and back (the landed pages
   bit for bit the shipped ones) and the host tier, (g) the ring and the
   tiers, each at tensor=2 against tensor=1 at llama3-8b's or
   mistral-7b's widths cut to 4 layers; (h) llama-1b, 4 AdamW steps of
   [8, 1024] at data=2 against data=1 (losses step by step, step p50,
   tokens/s, peak memory), and tiny-llama's 3 steps card = CPU at
   data=2 and data=2 x tensor=2;
20. the meshes the axes do not divide, every shard on the card: (a)
   llama-1b at tensor=3 (32 heads, wo, the FFN and the vocabulary do
   not split 3 ways: every block whole, computed once) from one seeded
   tree as tensor=1: `mesh_spec_downgrades` against the reference's
   rule, a [32, 512] prefill held to twice a same-run witness, B1 once
   a layer, greedy streams; (b) bert-base at tensor=4 (the embedding
   replicated and counted once) against tensor=1; (c) two llama-1b
   AdamW steps at tensor=3 and at sequence=2 against tensor=1's losses;
   (d) a sidecar in a fresh process: phase 5's burst, then the compile
   watcher's fields in GetServingStats and GetMemory and its ring in
   GetFlightRecord (B1's library counted at warmup, none after);
21. the replica fleet at llama3-8b width (seeded random weights on int8,
   8 slots): (a) the co-launch with `fleet.enabled` (min_replicas 1,
   max_replicas 2): the port's gateway and supervisor, in this process,
   spawn the port's worker
   (`python -m ggrmcp_tpu_torch.serving.fleet`, its command line read
   from /proc), /admin/fleet lists it, each prompt's greedy tokens from
   the replica equal the co-launched sidecar's (one seed), a burst of
   tools/calls over both while the supervisor's health probe of the
   worker is timed (every one answered within its 2 s timeout), B1 in
   the worker (its kernels in a profile of the worker, taken last, with
   the probes and flap edges the capture costs; its compile watcher's
   load); (b) at the reference's flap threshold, the worker SIGKILLed
   mid-burst: the flap edges before the kill, every call typed or
   complete, the supervisor's process-exit restart in the action log,
   seconds to the new replica's first good call, the card's memory
   before, during and after; (c) the workers armed with replica_crash:
   the worker dies at its Nth call and is healed, and an armed worker's
   exit code is 86; (g) the healed worker paused past the probe's
   timeout and resumed, in turns: the supervisor's flap heal (a restart
   in place), seconds to the next good call; (e) a burst of 32 calls to
   the worker past the TTFT SLO: a second worker spawned, listed, both
   answering with the sidecar's tokens, the card's memory with three
   processes; (f) idle: one worker retired, its memory back, the floor
   of one kept; (d) after stop() no worker is left and the card's
   memory has returned;
22. processes on the one card: (a) two processes of tiny-llama (float32)
   join by `parallel/distributed.py`'s `initialize` over 127.0.0.1
   (gloo: a named card is shared): their cross-process sum is exact and
   three AdamW steps at global data=2 equal the single-process data=2
   steps on the card (losses, final params); (b) llama-1b at full width
   cut to 4 of 16 layers, 2 AdamW steps of a global [8, 1024] batch
   split over two processes
   on cuda:0 against the single-process data=2 run from one seeded tree,
   held to twice a same-run witness (that run through the plain
   attention against B1), with a planted fault (two steps with the
   gradients' reduce skipped) outside that bound: losses, the
   gradients' reduce time, step time p50 of both, each process's
   peak memory, B1 launches a step, the backend; B1 at one process's
   [4, 1023] block against its plain version, timed with SDPA and the
   bound. One pair of processes takes (a)'s steps, then (b)'s;
23. the plain gateway: `python3 -m ggrmcp_tpu_torch gateway --backend
   unix:SOCK` (no --tpu) as a subprocess before a co-launch's llama3-8b
   sidecar (CUT_DEPTH): tools/list equal to the co-launch gateway's,
   a greedy tools/call's tokens equal to the same prompt over gRPC (B1
   launches behind it), /metrics and /debug/ticks 200; with `--workers
   2`, traced tools/calls answered by each worker process;
24. compositions: (a) tests/test_composition.py's maximal sidecar
   (tiny-llama float32: int8 weights and KV cache, tiers [[64, 3], [256,
   2]], the prefix pool, a speculative draft, tensor=2 with both shards
   on the card) over gRPC, its calls (the two long ones in turn) and the
   greedy repeat: greedy tokens card = CPU in this process, the stats of
   that test's checks; (b) the maximal config at published widths:
   mistral-7b (CUT_DEPTH) with the llama-1b draft, int8 weights and
   cache, tensor=2, tiers [[1024, 24], [8192, 4]], the prefix pool:
   greedy calls on the micro-path, top-k calls in the short tier, four
   long prompts sharing a 2048-token preamble in the long tier (prefix
   hits), the greedy repeat identical; the stats, GetMemory reconciled,
   peak memory, TTFT by kind; the greedy calls without the draft
   (greedy first tokens identical, the rest counted); (c) phase 12a's
   host tier on the int8 cache (8 preambles through an arena of half
   their pages, twice) against an int8 arena that holds every page
   (first tokens identical), bytes a page against bf16's, the codec's
   GB/s, a pass under host_restore_fail; (d) phase 12c's adapters on
   int8 weights with the bf16 cache (each stream against its adapter
   alone, a zero-b adapter equal to base, B1 launches); (e) the ring on
   the int8 cache against the contiguous windowed int8 cache; (f) the
   spec tick on the int8 cache against spec off, then under tick_fail
   (every call completes by replay; first tokens identical, the rest
   counted); (g) mixtral-8x7b on int8 weights (banks and router dense)
   with the int8 cache against the bf16 cache: phase 14b's burst,
   GetMemory reconciled, tick p50. B1 never launches on the int8 cache.

Every command line the script starts of the port's CLI runs with
`ggrmcp_tpu` unimportable, and at the end no module of the JAX package
is in this process's `sys.modules`. Each phase runs under a limit
(PHASE_LIMIT_S, twice its time on the card): past it the script dumps
every thread's stack, prints `chip_smoke FAILED: phase N over its
limit` and exits non-zero. The seconds of every phase are printed on one
line before the kernels line.

`python3 chip_smoke.py --only 16,17` runs the card, the build and those
phases and prints no result (fault-finding).

The last lines are the kernels JSON line, the card line, and
{"ok": true, "device": {"platform": "gpu", ...}}.
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import json
import math
import os
import re
import struct
import subprocess
import sys
import threading
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
# Phases 9-15, 17, 19, 22-24 serve (or train) the published widths cut
# to this many layers (serving.num_layers): their checks hold at any
# depth, and their time goes with it; 12's (b) and (c) serve 8 (P12).
# Phases 3-5 and 16 and 21 keep every layer (16's memory bound across a
# restart, 1.25 times the model's, holds only at full depth: at 4
# layers the warmup's transients reached 1.33 times).
CUT_DEPTH = 4
SERVE_NEW_TOKENS = 32


class SmokeError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


# -- the clock ------------------------------------------------------------------

# Each phase's limit in seconds: twice its longest time on an NVIDIA
# H100 80GB HBM3 at 700 W, at least 60 s (PERF.md §6). A phase
# over its limit dumps every thread's stack and ends the script
# (`phase`).
PHASE_LIMIT_S = {
    1: 60, 2: 60, 3: 60, 4: 60, 5: 60, 6: 60, 7: 60, 8: 90, 9: 60, 10: 60,
    11: 115, 12: 130, 13: 105, 14: 60, 15: 60, 16: 130, 17: 100, 18: 225,
    19: 125, 20: 60, 21: 315, 22: 145, 23: 60, 24: 130,
}
# The running phase and when its limit falls (monotonic clock; None
# outside a phase, as in the script's helper processes).
_PHASE = {"n": None, "deadline": None}
# A wait outside any phase.
WAIT_S = 600.0
# Seconds each phase took, in order.
PHASE_SECONDS: dict = {}


def phase_left() -> float:
    """Seconds left before the running phase's limit (WAIT_S outside a
    phase): a wait inside a phase never outlasts the phase."""
    if _PHASE["deadline"] is None:
        return WAIT_S
    return max(1.0, _PHASE["deadline"] - time.monotonic())


def _over_limit(n: int, limit: float) -> None:
    """The watchdog's verdict: name the phase, dump every thread's stack,
    end the processes this one started, exit non-zero (no result)."""
    import faulthandler
    import signal

    msg = f"chip_smoke FAILED: phase {n} over its limit ({limit:.0f} s)"
    print(msg, flush=True)
    print(msg, file=sys.stderr, flush=True)
    faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
    # And every pending asyncio task's chain of awaits, down to the
    # future it waits on: a phase's event loop waits in select while a
    # task waits on what never comes.
    for task in [t for t in gc.get_objects()
                 if isinstance(t, asyncio.Task) and not t.done()]:
        try:
            print(f"pending {task.get_name()}: "
                  f"{' -> '.join(_await_chain(task.get_coro()))} waiting on "
                  f"{getattr(task, '_fut_waiter', None)!r}", file=sys.stderr,
                  flush=True)
        except Exception as exc:  # noqa: BLE001 — the dump goes on
            print(f"pending {task!r}: {exc!r}", file=sys.stderr, flush=True)
    _kill_descendants(os.getpid(), signal.SIGKILL)
    os._exit(3)


def _await_chain(coro) -> list:
    """Each coroutine (or generator) a pending task's awaits pass
    through, with its file and line, innermost last."""
    out = []
    while coro is not None:
        frame = (getattr(coro, "cr_frame", None)
                 or getattr(coro, "gi_frame", None)
                 or getattr(coro, "ag_frame", None))
        name = getattr(coro, "__qualname__", type(coro).__name__)
        out.append(f"{name} ({frame.f_code.co_filename}:{frame.f_lineno})"
                   if frame is not None else name)
        coro = (getattr(coro, "cr_await", None)
                or getattr(coro, "gi_yieldfrom", None)
                or getattr(coro, "ag_await", None))
    return out


def _kill_descendants(pid: int, sig) -> None:
    todo = [pid]
    while todo:
        for child in _children(todo.pop()):
            todo.append(child)
            try:
                os.kill(child, sig)
            except ProcessLookupError:
                pass


@contextlib.contextmanager
def phase(n: int):
    """Run phase `n` under its limit (PHASE_LIMIT_S) and record its
    seconds."""
    limit = PHASE_LIMIT_S[n]
    _PHASE.update(n=n, deadline=time.monotonic() + limit)
    timer = threading.Timer(limit, _over_limit, (n, limit))
    timer.daemon = True
    timer.start()
    t = time.perf_counter()
    try:
        yield
    finally:
        timer.cancel()
        PHASE_SECONDS[n] = round(time.perf_counter() - t, 1)
        _PHASE.update(n=None, deadline=None)


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

# Jump-window rows: offsets spread over 64-3000, then one at 4095.
JUMP_OFFSETS = tuple(64 + (2936 * i) // 30 for i in range(31)) + (4095,)
# Verify-window rows: offsets spread over 64-4000.
VERIFY_OFFSETS = tuple(64 + (3936 * i) // 31 for i in range(32))
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
    # The KV-reuse routes: a prefix-hit wave's suffix step, and an
    # interleave chunk with its rows at different offsets (row 0 is also
    # the launch of an idle row: offset 0, kv_len = the chunk).
    ("pfx_suffix_32x64_at_2048", 32, 64, 4096, 32, 8, 128, True, 2048, 2112,
     None, "bfloat16",
     "prefix-pool hit wave: suffix step of R = B rows over a 4097 mini"),
    ("ilv_4x512_offsets", 4, 512, 4096, 32, 8, 128, True,
     (0, 512, 1536, 2560), (512, 1024, 2048, 3072), None, "bfloat16",
     "interleave chunk, per-row offsets, over the carried 4097 mini"),
    # The jump-ahead tick's window: each row's pending token and forced
    # run at its own length over the 4097 pool; the last row is a slot
    # at the cache's end, its window past Sk (the kernel clips).
    ("jump_window_32x9", 32, 9, 4096, 32, 8, 128, True, JUMP_OFFSETS,
     tuple(o + 9 for o in JUMP_OFFSETS), None, "bfloat16",
     "jump tick: [32, 1 + jump_max] window, ragged offsets, the 4097 "
     "pool; one row's kv_len past Sk by 8"),
    # The speculative verify: each row's pending token and gamma = 4
    # proposals at its own length over the 4097 pool, mistral-7b's
    # window.
    ("verify_window_32x5", 32, 5, 4096, 32, 8, 128, True, VERIFY_OFFSETS,
     tuple(o + 5 for o in VERIFY_OFFSETS), 4096, "bfloat16",
     "spec verify: [32, gamma + 1] window, ragged offsets 64-4000, "
     "mistral-7b's window 4096 over the 4097 pool"),
    # kv_len None: ragged, each row's length drawn from 17 to S.
    ("bert_32x128", 32, 128, 128, 12, 12, 64, False, 0, None, None,
     "bfloat16", "bert-base embed batch, S=128 bucket, ragged rows"),
    ("bert_32x512", 32, 512, 512, 12, 12, 64, False, 0, None, None,
     "bfloat16", "bert-base embed batch, S=512 bucket, ragged rows"),
]
HEADLINE = "fused_32x512"
# The cases phase 3 also times `attention_ref` on (the dispatcher's other
# path at the shape).
REF_TIMED = ("jump_window_32x9", "verify_window_32x5")
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


def kernel_cases(torch, tatt, dev, cases=None) -> list[dict]:
    import torch.nn.functional as F

    results = []
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for (name, b, sq, sk, h, kvh, d, causal, off, kvl, window, dtype_name,
         what) in (cases or CASES):
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
        elif name.startswith(("chunk", "pfx", "ilv", "jump", "verify")):
            # The model's operand: [:, :S_max] of a [B, S_max + 1, ...]
            # per-layer cache slice (not contiguous).
            kc, vc = (torch.randn((b, sk + 1, kvh, d), generator=gen,
                                  device=dev).to(dtype) for _ in range(2))
            k, v = kc[:, :sk], vc[:, :sk]
        else:
            k, v = (torch.randn((b, sk, kvh, d), generator=gen,
                                device=dev).to(dtype) for _ in range(2))
        q_offset = torch.tensor(off if isinstance(off, tuple) else
                                (off,) * b, dtype=torch.int32, device=dev)
        if kvl is None:
            kv_len = torch.randint(17, sk + 1, (b,), generator=gen,
                                   device=dev, dtype=torch.int32)
        else:
            kv_len = torch.tensor(kvl if isinstance(kvl, tuple) else
                                  (kvl,) * b, dtype=torch.int32, device=dev)
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
        ref_ms = None
        if name in REF_TIMED:
            ref_ms = cuda_ms(
                torch, lambda: tatt.attention_ref(q, k, v, **kw), 2)
            torch.cuda.empty_cache()

        # SDPA yardstick on the same function (never called by the port).
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = _valid_mask(torch, b, sq, sk, causal, q_offset, kv_len,
                           window, dev)
        pairs = int(mask.sum().item())
        keys = int(mask.any(dim=1).sum().item())
        plain_causal = causal and not q_offset.any().item() and full and (
            sq == sk and not window)
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
            attention_ref_ms=ref_ms, library_ms=library_ms, library_ms_min=library_t["min"],
            library_ms_max=library_t["max"], bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            gflop=flops / 1e9, mbytes=nbytes / 1e6,
            tflops=flops / (ms * 1e-3) / 1e12,
        )
        log(f"  {name:22s} err {err:.2e} kernel {ms:.4f} ms "
            f"[{kernel_t['min']:.4f}, {kernel_t['max']:.4f}]  plain "
            f"{plain_ms:9.3f} ms  "
            + (f"attention_ref {ref_ms:.3f} ms  " if ref_ms else "")
            + f"sdpa {library_ms:.4f} ms "
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
                resp = await generate(req, timeout=phase_left())
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
            chunks = [c async for c in stream(request(500, 7), timeout=phase_left())]
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
                    resp = await embed(req, timeout=phase_left())
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
                        return_tokens=True), timeout=phase_left())
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
                resp = await generate(req, timeout=phase_left())
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


# -- phase 9: KV reuse --------------------------------------------------------

# A same-preamble wave (the agentic arrival shape): BOS + 2047 bytes of
# preamble, then a 64-byte question whose first byte differs per request.
PREAMBLE_TOKENS = 2048
QUESTION_TOKENS = 64
WAVE = 16
WAVE_NEW = 16
PAGED_NEW = 48
# First-token logits of a prefix-hit row against a cold chunked prefill of
# the same prompt, relative L2: the suffix runs as a [1, 64] step instead
# of inside a [1, 512] chunk, so its GEMMs and attention tiles round in
# bf16 in another order through 32 layers; the bound is phase 4's
# kernel-vs-plain bound for a whole prefill.
HIT_MAX_REL = 2e-2
ILV_SHORTS = 8
ILV_SHORT_TOKENS = 40
ILV_SHORT_NEW = 48
ILV_LONG_TOKENS = 3000
# Worst decode stall under interleave against the long admission's
# duration: the reference's structural bound (tests/test_interleave.py).
ILV_STALL_BOUND = 0.6
TINY_ARENA_PAGES = 8


def _question(i: int) -> str:
    return chr(65 + i) + _prompt_text(QUESTION_TOKENS, 910 + i)


def pfx_hit_vs_cold(torch, batcher, prompt: list[int]):
    """Final-position logits of `prompt` admitted as a prefix-pool hit
    (the entry it matches seeds the mini, one suffix step, as a wave
    row runs it) and cold (the chunked grid from position 0), through
    the batcher's own device bodies, without merging into the pool."""
    import numpy as np

    entry, plen = batcher._pfx_lookup(prompt)
    start, steps = batcher._pfx_plan(len(prompt), plen)
    check(len(steps) == 1, f"hit plan {steps} is not one suffix step")
    width = steps[0][1]
    params = batcher.engine.params
    true_len = batcher._t(np.array([len(prompt)]))
    suffix = np.zeros((1, 1, width), np.int64)
    suffix[0, 0, : len(prompt) - start] = prompt[start:]
    c = min(batcher.cfg.prefill_chunk, batcher.max_seq)
    t_steps = -(-len(prompt) // c)
    grid = np.zeros((1, t_steps * c), np.int64)
    grid[0, : len(prompt)] = prompt
    with torch.no_grad():
        hit = batcher._chunked_scan(
            params, batcher._t(suffix), true_len,
            batcher._pfx_seeded_mini(1, entry, start), start)
        cold = batcher._chunked_scan(
            params, batcher._t(grid.reshape(1, t_steps, c)), true_len,
            batcher._make_mini(1, batcher.max_seq))
    return hit, cold


class _ReuseClient:
    """gRPC stubs of one sidecar: greedy Generate and GetServingStats."""

    def __init__(self, ch):
        from ggrmcp_tpu_torch.rpc.pb import serving_pb2

        self.pb = serving_pb2
        self._gen = ch.unary_unary(
            "/ggrmcp.tpu.GenerateService/Generate",
            request_serializer=serving_pb2.GenerateRequest.SerializeToString,
            response_deserializer=serving_pb2.GenerateResponse.FromString)
        self._stats = ch.unary_unary(
            "/ggrmcp.tpu.ModelInfoService/GetServingStats",
            request_serializer=serving_pb2.ServingStatsRequest
            .SerializeToString,
            response_deserializer=serving_pb2.ServingStatsResponse.FromString)

    async def generate(self, text: str, max_new: int):
        """(token ids, finish reason, client ms)."""
        t = time.perf_counter()
        resp = await self._gen(self.pb.GenerateRequest(
            prompt=text, max_new_tokens=max_new, return_tokens=True),
            timeout=phase_left())
        return (list(resp.token_ids), resp.finish_reason,
                (time.perf_counter() - t) * 1e3)

    async def stats(self):
        return await self._stats(self.pb.ServingStatsRequest())

    async def wait_active(self, n: int) -> None:
        t = time.perf_counter()
        while (await self.stats()).active_slots < n:
            check(time.perf_counter() - t < 120, f"{n} slots never active")
            await asyncio.sleep(0.005)


def _config_sidecar(torch, params, dev, serving: dict, tmp: str):
    """A llama3-8b sidecar (CUT_DEPTH layers) on `params` whose settings
    come from a {"serving": ...} config file, read as the command line
    reads `--config FILE`; the peak memory count starts after it is
    built."""
    from ggrmcp_tpu_torch import __main__ as cli
    from ggrmcp_tpu_torch.serving.sidecar import Sidecar

    path = os.path.join(tmp, "serving.json")
    with open(path, "w") as fh:
        json.dump({"serving": dict(model=MODEL, num_layers=CUT_DEPTH,
                                   **serving)}, fh)
    cfg = cli.serving_config(cli.build_parser().parse_args(
        ["sidecar", "--config", path]))
    sidecar = Sidecar(cfg, params=params, device=dev)
    torch.cuda.reset_peak_memory_stats()
    return sidecar


def _reuse_sidecar(torch, params, dev, batching: dict, tmp: str):
    """A `_config_sidecar` with these batching settings whose batcher
    records each request's TTFT (submit to first-token sample, on the
    server)."""
    sidecar = _config_sidecar(torch, params, dev, dict(batching=batching),
                              tmp)
    batcher = sidecar.batcher
    batcher.ttft_ms = []
    activate = batcher._activate_slot

    def timed_activate(slot_idx, request, first_tok):
        batcher.ttft_ms.append(
            (time.perf_counter() - request.t_submit) * 1e3)
        return activate(slot_idx, request, first_tok)

    batcher._activate_slot = timed_activate
    return sidecar


def _ttft(ms: list) -> dict:
    ordered = sorted(ms)
    return dict(p50=ordered[(len(ordered) - 1) // 2], max=ordered[-1],
                n=len(ordered))


def _agreement(a: list, b: list) -> dict:
    """Greedy token agreement of two runs of the same requests."""
    same = sum(x == y for x, y in zip(a, b))
    pos = [sum(p == q for p, q in zip(x, y)) for x, y in zip(a, b)]
    first = sum(bool(x and y and x[0] == y[0]) for x, y in zip(a, b))
    return dict(identical=same, first_token=first, of=len(a),
                positions=sum(pos),
                positions_of=sum(min(len(x), len(y)) for x, y in zip(a, b)))


async def _wave_run(torch, tatt, dev, params, batching: dict, tmp: str,
                    max_new: int, probe: bool = False) -> dict:
    """(a) and (c): one warm request with the preamble, admitted alone,
    then a wave of WAVE requests with it; stats around the wave, the
    wave's TTFT, B1's launches during the wave. `probe` polls
    GetServingStats while the wave decodes (the kv_pages_shared gauge)."""
    import grpc.aio

    preamble = _prompt_text(PREAMBLE_TOKENS, 900)
    sidecar = _reuse_sidecar(torch, params, dev, batching, tmp)
    batcher = sidecar.batcher
    # The path's run starts here: every launch count from 0.
    tatt.flash_attention.launches = 0
    port = await sidecar.start(0)
    res: dict = {}
    try:
        async with grpc.aio.insecure_channel(f"localhost:{port}") as ch:
            client = _ReuseClient(ch)
            warm = await client.generate(preamble + _question(25), max_new)
            check(warm[1] in ("length", "stop"), f"warm: {warm[1]}")
            before = await client.stats()
            batcher.ttft_ms.clear()
            launched = tatt.flash_attention.launches
            t = time.perf_counter()
            wave = asyncio.ensure_future(asyncio.gather(*(
                client.generate(preamble + _question(i), max_new)
                for i in range(WAVE))))
            peak_shared = peak_active = 0
            while probe and not wave.done():
                live = await client.stats()
                peak_shared = max(peak_shared, live.kv_pages_shared)
                peak_active = max(peak_active, live.active_slots)
                await asyncio.sleep(0.02)
            outs = await wave
            res["wave_s"] = time.perf_counter() - t
            res["wave_launches"] = tatt.flash_attention.launches - launched
            after = await client.stats()
            # The path's count ends here; the logits check below is not
            # the path.
            res["launches"] = tatt.flash_attention.launches
        for ids, reason, _ in outs:
            check(reason in ("length", "stop") and 1 <= len(ids) <= max_new,
                  f"wave request ended {reason!r} with {len(ids)} tokens")
        res["tokens"] = [ids for ids, _, _ in outs]
        res["ttft_ms"] = _ttft(batcher.ttft_ms)
        res["client_ms"] = _ttft([ms for _, _, ms in outs])
        res["stats"] = {k: getattr(after, k) - getattr(before, k) for k in (
            "prefix_cache_hits", "prefix_cache_misses", "paged_prefix_hits",
            "paged_cow_copies", "paged_pages_reused", "paged_pages_admitted",
            "admit_rounds", "ticks")}
        res["stats"].update(
            decode_stall_ms_p50=after.decode_stall_ms_p50,
            decode_stall_ms_max=after.decode_stall_ms_max,
            kv_cache_bytes=after.kv_cache_bytes,
            kv_pages_total=after.kv_pages_total)
        if probe:
            res.update(peak_kv_pages_shared=peak_shared,
                       peak_active_slots=peak_active)
        if batching.get("prefix_cache_entries"):
            tokens = sidecar._prompt_ids(client.pb.GenerateRequest(
                prompt=preamble + _question(3)))
            hit, cold = pfx_hit_vs_cold(torch, batcher, tokens)
            res["hit_vs_cold"] = dict(
                rel_l2=((hit - cold).norm() / cold.norm()).item(),
                max_abs=(hit - cold).abs().max().item(),
                top1_same=bool(hit.argmax() == cold.argmax()))
    finally:
        await sidecar.stop()
    torch.cuda.synchronize()
    res["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del sidecar, batcher
    gc.collect()
    torch.cuda.empty_cache()
    return res


async def _ilv_run(torch, tatt, dev, params, mode: str, tmp: str) -> dict:
    """(b): ILV_SHORTS short requests decoding, then two long prompts at
    once; the long ones ask one token, so their latency is the
    admission's duration."""
    import grpc.aio

    sidecar = _reuse_sidecar(torch, params, dev, dict(
        prefill_interleave=mode, prefill_interleave_rows=4), tmp)
    batcher = sidecar.batcher
    tatt.flash_attention.launches = 0
    port = await sidecar.start(0)
    res: dict = {}
    try:
        async with grpc.aio.insecure_channel(f"localhost:{port}") as ch:
            client = _ReuseClient(ch)
            shorts = asyncio.ensure_future(asyncio.gather(*(
                client.generate(_prompt_text(ILV_SHORT_TOKENS, 950 + i),
                                ILV_SHORT_NEW)
                for i in range(ILV_SHORTS))))
            await client.wait_active(ILV_SHORTS)
            longs = await asyncio.gather(*(
                client.generate(_prompt_text(ILV_LONG_TOKENS, 970 + i), 1)
                for i in range(2)))
            short_out = await shorts
            stats = await client.stats()
        for ids, reason, _ in short_out + longs:
            check(reason in ("length", "stop") and ids,
                  f"request ended {reason!r} with {len(ids)} tokens")
        res["tokens"] = [ids for ids, _, _ in short_out + longs]
        res["admission_ms"] = max(ms for _, _, ms in longs)
        res["stats"] = {k: getattr(stats, k) for k in (
            "interleaved_admissions", "interleaved_chunks",
            "decode_stall_ms_p50", "decode_stall_ms_p99",
            "decode_stall_ms_max", "admit_ms_max", "ticks",
            "kv_cache_bytes")}
        res["chunked_admissions"] = batcher.chunked_admissions
    finally:
        await sidecar.stop()
    torch.cuda.synchronize()
    res["launches"] = tatt.flash_attention.launches
    res["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del sidecar, batcher
    gc.collect()
    torch.cuda.empty_cache()
    return res


async def _tiny_arena_shed(torch, dev, params, tmp: str) -> dict:
    """(c) shed: on an arena of TINY_ARENA_PAGES pages a 500-token prompt
    is refused RESOURCE_EXHAUSTED while a resident request decodes on to
    its end."""
    import grpc
    import grpc.aio

    sidecar = _reuse_sidecar(torch, params, dev, dict(
        paged_kv="on", paged_kv_page_size=16,
        paged_kv_pages=TINY_ARENA_PAGES), tmp)
    port = await sidecar.start(0)
    try:
        async with grpc.aio.insecure_channel(f"localhost:{port}") as ch:
            client = _ReuseClient(ch)
            resident = asyncio.ensure_future(
                client.generate(_prompt_text(40, 990), 32))
            await client.wait_active(1)
            code = None
            try:
                await client.generate(_prompt_text(500, 991), 8)
            except grpc.aio.AioRpcError as exc:
                code = exc.code()
            ids, reason, _ = await resident
            stats = await client.stats()
    finally:
        await sidecar.stop()
    check(code == grpc.StatusCode.RESOURCE_EXHAUSTED,
          f"tiny arena: the 500-token prompt got {code}, not "
          f"RESOURCE_EXHAUSTED")
    check(reason in ("length", "stop") and ids,
          f"tiny arena: the resident request ended {reason!r}")
    res = dict(code=code.name, resident_reason=reason,
               resident_tokens=len(ids), shed_requests=stats.shed_requests,
               kv_pages_total=stats.kv_pages_total)
    del sidecar
    gc.collect()
    torch.cuda.empty_cache()
    return res


async def kv_reuse_phase(torch, tatt, dev) -> dict:
    """(a) the prefix pool, (b) the interleave, (c) paged KV, each at
    llama3-8b width through the sidecar, each against its switch off."""
    import tempfile

    from ggrmcp_tpu_torch.models import llama as llama_mod

    params = llama_mod.init_params(_cut(MODEL, CUT_DEPTH), dev, SEED)
    res: dict = {}
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        pool = dict(prefix_cache_entries=8, prefix_cache_max_seq=2048)
        a_on = await _wave_run(torch, tatt, dev, params, pool, tmp, WAVE_NEW)
        a_off = await _wave_run(torch, tatt, dev, params, {}, tmp, WAVE_NEW)
        check(a_on["stats"]["prefix_cache_hits"] == WAVE,
              f"(a) the wave hit the pool {a_on['stats']['prefix_cache_hits']}"
              f" times, not {WAVE}")
        check(a_on["wave_launches"] > 0, "(a) the hit wave never launched B1")
        hvc = a_on["hit_vs_cold"]
        check(hvc["rel_l2"] <= HIT_MAX_REL,
              f"(a) hit vs cold logits rel {hvc['rel_l2']} > {HIT_MAX_REL}")
        a_on["agreement_with_off"] = _agreement(a_on["tokens"],
                                                a_off["tokens"])
        res["pool"] = dict(on=a_on, off=a_off)
        log(f"  (a) prefix pool: {json.dumps(_brief(res['pool']))}")

        b_on = await _ilv_run(torch, tatt, dev, params, "on", tmp)
        b_off = await _ilv_run(torch, tatt, dev, params, "off", tmp)
        st = b_on["stats"]
        check(st["interleaved_admissions"] == 2,
              f"(b) {st['interleaved_admissions']} interleaved admissions")
        check(st["interleaved_chunks"] >= 12,
              f"(b) {st['interleaved_chunks']} interleaved chunks, not >= 12")
        check(b_on["chunked_admissions"] == 0,
              "(b) a long prompt took the one-call grid under interleave")
        check(st["decode_stall_ms_max"]
              < ILV_STALL_BOUND * b_on["admission_ms"],
              f"(b) worst stall {st['decode_stall_ms_max']} ms >= "
              f"{ILV_STALL_BOUND} x the admission {b_on['admission_ms']} ms")
        check(b_on["launches"] > 0, "(b) the interleave never launched B1")
        b_on["agreement_with_off"] = _agreement(b_on["tokens"],
                                                b_off["tokens"])
        res["interleave"] = dict(on=b_on, off=b_off)
        log(f"  (b) interleave: {json.dumps(_brief(res['interleave']))}")

        c = await _wave_run(torch, tatt, dev, params, dict(
            paged_kv="on", paged_kv_page_size=16), tmp, PAGED_NEW,
            probe=True)
        check(c["stats"]["paged_prefix_hits"] >= WAVE,
              f"(c) paged_prefix_hits {c['stats']['paged_prefix_hits']}")
        check(c["peak_kv_pages_shared"] >= PREAMBLE_TOKENS // 16,
              f"(c) kv_pages_shared peaked at {c['peak_kv_pages_shared']}")
        check(c["wave_launches"] > 0, "(c) the paged wave never launched B1")
        c["agreement_with_contiguous"] = _agreement(
            [t[:WAVE_NEW] for t in c["tokens"]], a_off["tokens"])
        c["shed"] = await _tiny_arena_shed(torch, dev, params, tmp)
        res["paged"] = c
        log(f"  (c) paged: {json.dumps(_brief(c))}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


# -- phase 10: grammar ----------------------------------------------------------

# Three tool-output schemas of the kinds MCP tools declare: a flat record
# (enum, integer, bounded string), a nested call (a bounded-string array
# under maxItems), and a const-heavy envelope whose states force long
# runs (the jump tick's case).
GRAMMAR_SCHEMAS = {
    "flat": {"type": "object", "properties": {
        "status": {"enum": ["ok", "degraded", "failed"]},
        "count": {"type": "integer"},
        "note": {"type": "string", "maxLength": 6}},
        "required": ["status", "count", "note"]},
    "nested": {"type": "object", "properties": {
        "tool": {"type": "string", "maxLength": 6},
        "args": {"type": "object", "properties": {
            "tags": {"type": "array", "maxItems": 2,
                     "items": {"type": "string", "maxLength": 4}}},
            "required": ["tags"]}},
        "required": ["tool", "args"]},
    "const": {"type": "object", "properties": {
        "jsonrpc": {"const": "2.0"},
        "kind": {"const": "structured_tool_result"},
        "schema_version": {"const": "2025-06-18"},
        "ok": {"type": "boolean"}},
        "required": ["jsonrpc", "kind", "schema_version", "ok"]},
}
# A schema first seen in (d), and one the compiler refuses (a pattern).
NEW_SCHEMA = {"type": "object", "properties": {
    "id": {"type": "integer"}, "done": {"type": "boolean"}},
    "required": ["id", "done"]}
PATTERN_SCHEMA = {"type": "string", "pattern": "[a-z]+"}
# (a): 16 concurrent calls, 8 constrained (schema, sampled) and 8 not.
GRAMMAR_BURST = [("flat", False), ("nested", False), ("const", False),
                 ("flat", False), ("nested", False), ("const", False),
                 ("flat", True), ("nested", True)] + [(None, False)] * 8
GRAMMAR_PLAIN_NEW = 24
GRAMMAR_PROMPT_TOKENS = (40, 90, 160, 250)


def longest_output(g) -> int:
    """Tokens on the longest path from the start state to a state with no
    way on but EOS: the most a constrained request can emit. A bounded
    schema's DFA is acyclic; a cycle fails the phase."""
    import numpy as np

    edges = g.allow[:, :256 + 3].copy()
    edges[:, g.eos_id] = False
    trans = g.trans[:, :256 + 3]
    depth = np.full(g.n_states, -1)
    state = np.zeros(g.n_states, np.int8)  # 0 new, 1 on the stack, 2 done
    stack = [g.start]
    while stack:
        s = stack[-1]
        nxt = [int(t) for t in trans[s][edges[s]]]
        if state[s] == 0:
            state[s] = 1
            for t in nxt:
                check(state[t] != 1, "a constrained schema's DFA has a cycle")
                if state[t] == 0:
                    stack.append(t)
            continue
        stack.pop()
        if state[s] == 1:
            depth[s] = 1 + max((depth[t] for t in nxt), default=-1)
            state[s] = 2
    return int(depth[g.start])


class _GrammarClient(_ReuseClient):
    """Phase 9's stubs, plus constrained and sampled requests and
    GenerateStream."""

    def __init__(self, ch):
        super().__init__(ch)
        self._stream = ch.unary_stream(
            "/ggrmcp.tpu.GenerateService/GenerateStream",
            request_serializer=self.pb.GenerateRequest.SerializeToString,
            response_deserializer=self.pb.GenerateChunk.FromString)

    def request(self, text, max_new, schema=None, sampled=False, seed=0):
        sampling = (self.pb.SamplingParams(temperature=0.8, top_p=0.9,
                                           seed=seed) if sampled
                    else self.pb.SamplingParams(seed=seed))
        req = self.pb.GenerateRequest(prompt=text, max_new_tokens=max_new,
                                      return_tokens=True, sampling=sampling)
        if schema is not None:
            req.constraint.json_schema = json.dumps(schema)
        return req

    async def call(self, req):
        """(response, client ms)."""
        t = time.perf_counter()
        resp = await self._gen(req, timeout=phase_left())
        return resp, (time.perf_counter() - t) * 1e3

    async def stream(self, req):
        return [c async for c in self._stream(req, timeout=phase_left())]


def _hold_admission(batcher) -> None:
    """Set `batcher.hold_for = n` to hold its next admission round until
    n requests are queued (a burst then lands in one round, whatever the
    calls' arrival spread). Host ops (an adapter's acquisition) run
    while it holds; it never holds while a slot decodes."""
    batcher.hold_for = 0
    admit = batcher._admit

    async def held_admit():
        loop = asyncio.get_running_loop()
        while (batcher.hold_for and batcher._active_count() == 0
               and batcher.pending.qsize() < batcher.hold_for):
            await batcher._drain_host_ops(loop)
            await asyncio.sleep(0.001)
        batcher.hold_for = 0
        return await admit()

    batcher._admit = held_admit


def _grammar_sidecar(torch, params, dev, serving: dict, tmp: str):
    """A `_config_sidecar` whose batcher holds the first admission round
    of a burst until the whole burst is queued (`hold_for`), so on and
    off runs admit identically, times its tick bodies (synchronised) and
    counts B1's launches inside jump ticks."""
    from ggrmcp_tpu_torch.ops import attention as tatt

    sidecar = _config_sidecar(torch, params, dev, serving, tmp)
    batcher = sidecar.batcher
    _hold_admission(batcher)
    batcher.tick_log = {"jump": [], "plain": [], "jump_launches": 0}

    def timed(kind, body):
        def run(*args, **kwargs):
            launched = tatt.flash_attention.launches
            t = time.perf_counter()
            out = body(*args, **kwargs)
            torch.cuda.synchronize()
            batcher.tick_log[kind].append((time.perf_counter() - t) * 1e3)
            if kind == "jump":
                batcher.tick_log["jump_launches"] += (
                    tatt.flash_attention.launches - launched)
            return out
        return run

    batcher._tick_jump_impl = timed("jump", batcher._tick_jump_impl)
    batcher._tick_impl = timed("plain", batcher._tick_impl)
    return sidecar


def _median(values):
    ordered = sorted(values)
    return ordered[(len(ordered) - 1) // 2] if ordered else None


async def _grammar_burst(torch, batcher, client, grammars, limits) -> dict:
    """(a)/(b)/(c): the 16-call burst in one admission round; every
    constrained output parses, its DFA walk ends accepting, and it ends
    "grammar_complete" or "stop"."""
    before = await client.stats()
    log_before = {k: len(v) for k, v in batcher.tick_log.items()
                  if isinstance(v, list)}
    batcher.hold_for = len(GRAMMAR_BURST)
    reqs = []
    for i, (name, sampled) in enumerate(GRAMMAR_BURST):
        text = _prompt_text(
            GRAMMAR_PROMPT_TOKENS[i % len(GRAMMAR_PROMPT_TOKENS)], 1000 + i)
        reqs.append(client.request(
            text, limits[name] if name else GRAMMAR_PLAIN_NEW,
            GRAMMAR_SCHEMAS[name] if name else None, sampled, seed=7 + i))
    t = time.perf_counter()
    outs = await asyncio.gather(*(client.call(r) for r in reqs))
    wall = time.perf_counter() - t
    after = await client.stats()
    for (name, _), (resp, _) in zip(GRAMMAR_BURST, outs):
        ids = list(resp.token_ids)
        if name is None:
            check(resp.finish_reason in ("length", "stop") and ids,
                  f"unconstrained call ended {resp.finish_reason!r}")
            continue
        g = grammars[name]
        check(resp.finish_reason in ("grammar_complete", "stop"),
              f"{name}: finished {resp.finish_reason!r} after {len(ids)}")
        json.loads(resp.text)
        s = g.start
        for tok in ids:
            s = g.step(s, tok)
        check(bool(g.accept[s]), f"{name}: the DFA walk ends in state {s}, "
              f"not accepting")
    tick = {k: batcher.tick_log[k][log_before[k]:] for k in ("jump", "plain")}
    return dict(
        tokens=[list(resp.token_ids) for resp, _ in outs],
        finish=[resp.finish_reason for resp, _ in outs],
        wall_s=wall, client_ms_max=max(ms for _, ms in outs),
        constrained_tokens=sum(len(resp.token_ids) for (n, _), (resp, _) in
                               zip(GRAMMAR_BURST, outs) if n),
        stats={k: getattr(after, k) - getattr(before, k) for k in (
            "ticks", "grammar_masked_tokens", "grammar_jump_tokens",
            "grammar_jump_runs", "grammar_jump_fallbacks", "admit_rounds")},
        decode_stall_ms_p50=after.decode_stall_ms_p50,
        decode_stall_ms_p99=after.decode_stall_ms_p99,
        jump_ticks=len(tick["jump"]), plain_ticks=len(tick["plain"]),
        jump_tick_ms_p50=_median(tick["jump"]),
        plain_tick_ms_p50=_median(tick["plain"]),
        memory_grammar_arena_bytes=after.memory_grammar_arena_bytes,
        grammar_states_in_use=after.grammar_states_in_use)


async def _first_schema_cost(client, text) -> dict:
    """(d): one-token calls (admission + first token): the first schema
    this sidecar sees (compile, the tables' allocation, its rows'
    upload), the same schema warm, and a second new schema."""
    res = {}
    for key, schema in (("first_schema_ms", NEW_SCHEMA),
                        ("warm_ms", NEW_SCHEMA),
                        ("second_new_schema_ms", GRAMMAR_SCHEMAS["flat"]),
                        ("unconstrained_ms", None)):
        resp, res[key] = await client.call(client.request(text, 1, schema))
        check(len(resp.token_ids) == 1, f"(d) {key}: {resp}")
    stats = await client.stats()
    res.update(grammar_compiles=stats.grammar_compiles,
               grammar_cache_hits=stats.grammar_cache_hits,
               memory_grammar_arena_bytes=stats.memory_grammar_arena_bytes)
    check(stats.grammar_compiles == 2 and stats.grammar_cache_hits == 1,
          f"(d) compiles {stats.grammar_compiles}, hits "
          f"{stats.grammar_cache_hits}")
    return res


async def _typed_refusals(torch, params, dev, grammars, tmp) -> dict:
    """(e): an arena too small for two live schemas sheds the second
    RESOURCE_EXHAUSTED while the first decodes; a `pattern` schema is
    INVALID_ARGUMENT."""
    import grpc
    import grpc.aio

    top = max(grammars["flat"].n_states, grammars["nested"].n_states)
    sidecar = _grammar_sidecar(torch, params, dev, dict(
        grammar=dict(max_states=top, arena_states=top + 1)), tmp)
    port = await sidecar.start(0)
    codes = {}
    try:
        async with grpc.aio.insecure_channel(f"localhost:{port}") as ch:
            client = _GrammarClient(ch)
            live = asyncio.ensure_future(client.call(client.request(
                _prompt_text(40, 1100), 64, GRAMMAR_SCHEMAS["nested"])))
            while not sidecar.batcher.arena._entries:
                await asyncio.sleep(0.001)
            for key, schema in (("arena_full", GRAMMAR_SCHEMAS["flat"]),
                                ("pattern", PATTERN_SCHEMA)):
                try:
                    await client.call(client.request(
                        _prompt_text(40, 1101), 8, schema))
                    codes[key] = "OK"
                except grpc.aio.AioRpcError as exc:
                    codes[key] = exc.code().name
            resp, _ = await live
            codes["live_finish"] = resp.finish_reason
            codes["arena_states"] = top + 1
    finally:
        await sidecar.stop()
    check(codes["arena_full"] == "RESOURCE_EXHAUSTED",
          f"(e) second schema on a full arena: {codes['arena_full']}")
    check(codes["pattern"] == "INVALID_ARGUMENT",
          f"(e) pattern schema: {codes['pattern']}")
    check(codes["live_finish"] in ("grammar_complete", "stop", "length"),
          f"(e) the live request ended {codes['live_finish']!r}")
    del sidecar
    gc.collect()
    torch.cuda.empty_cache()
    return codes


async def tiny_jump_identity(torch, dev) -> dict:
    """(f): tiny-llama (float32) on the card: constrained greedy tokens
    with jump on equal jump off and the CPU batcher's (the bit-identity
    the reference promises, at a width where float32 holds it)."""
    from ggrmcp_tpu_torch.core.config import BatchingConfig, ServingConfig
    from ggrmcp_tpu_torch.grammar import compile_schema
    from ggrmcp_tpu_torch.models import llama as llama_mod
    from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
    from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher
    from ggrmcp_tpu_torch.serving.engine import GenerationEngine

    cfg = llama_mod.CONFIGS["tiny-llama"]
    cpu_params = llama_mod.init_params(cfg, torch.device("cpu"), SEED)

    async def run(device, params, jump_max):
        from ggrmcp_tpu_torch.core.config import GrammarConfig

        engine = GenerationEngine(cfg, ServingConfig(
            grammar=GrammarConfig(jump_max=jump_max)), params=params,
            device=device)
        batcher = ContinuousBatcher(engine, BatchingConfig(
            max_batch_size=4, kv_cache_max_seq=512, max_queue_delay_ms=1000))

        async def one(i, name):
            out = []
            g = compile_schema(GRAMMAR_SCHEMAS[name], cfg.vocab_size)
            async for ids, _ in batcher.submit([3 + i, 1, 4], 200,
                                               SamplingConfig(), grammar=g):
                out.extend(ids)
            return out

        batcher.start()
        try:
            outs = await asyncio.gather(*(one(i, n) for i, n in
                                          enumerate(GRAMMAR_SCHEMAS)))
        finally:
            await batcher.stop()
        return outs, batcher.grammar_jump_runs

    cpu, _ = await run("cpu", cpu_params, 8)
    gpu_params = _to(cpu_params, dev)
    on, runs = await run(dev, gpu_params, 8)
    off, _ = await run(dev, gpu_params, 0)
    check(runs > 0, "(f) tiny-llama never jumped")
    check(on == off == cpu, "(f) tiny-llama float32 constrained greedy "
          "tokens differ between jump on, jump off and the CPU")
    return dict(identical=True, jump_runs=runs, rows=len(on))


async def _grammar_run(torch, tatt, dev, params, key, serving, grammars,
                       limits, tmp, res) -> dict:
    """One sidecar of phase 10 and its burst: "on" also drives a
    constrained stream and is the main path's launch count, "off" also
    measures the arena (d)."""
    import grpc.aio

    sidecar = _grammar_sidecar(torch, params, dev, serving, tmp)
    batcher = sidecar.batcher
    if key == "on":
        # The main path's run starts here: every count from 0.
        tatt.flash_attention.launches = 0
    port = await sidecar.start(0)
    try:
        async with grpc.aio.insecure_channel(f"localhost:{port}") as ch:
            client = _GrammarClient(ch)
            if key == "off":
                res["arena"] = await _first_schema_cost(
                    client, _prompt_text(200, 1200))
            run = await _grammar_burst(torch, batcher, client, grammars,
                                       limits)
            if key == "on":
                run["launches"] = tatt.flash_attention.launches
                run["jump_launches"] = batcher.tick_log["jump_launches"]
                chunks = await client.stream(client.request(
                    _prompt_text(60, 1300), limits["const"],
                    GRAMMAR_SCHEMAS["const"]))
                text = "".join(c.text_delta for c in chunks)
                check(chunks[-1].done and chunks[-1].finish_reason
                      in ("grammar_complete", "stop"),
                      f"(e) stream ended {chunks[-1:]}")
                json.loads(text)
                res["stream"] = dict(chunks=len(chunks), chars=len(text))
    finally:
        await sidecar.stop()
    torch.cuda.synchronize()
    run["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del sidecar, batcher
    gc.collect()
    torch.cuda.empty_cache()
    return run


async def grammar_phase(torch, tatt, dev) -> dict:
    """(a) a mixed burst with jump on (the default GrammarConfig), (b) the
    same burst with jump off, (c) decode_steps_per_tick=4 with jump off,
    (d) the arena's bytes and first-schema cost, (e) typed refusals and a
    constrained stream, (f) tiny-llama float32 identity on the card."""
    import tempfile

    from ggrmcp_tpu_torch.grammar import compile_schema
    from ggrmcp_tpu_torch.models import llama as llama_mod

    cfg = llama_mod.CONFIGS[MODEL]
    t = time.perf_counter()
    grammars = {k: compile_schema(v, cfg.vocab_size)
                for k, v in GRAMMAR_SCHEMAS.items()}
    compile_ms = (time.perf_counter() - t) * 1e3 / len(grammars)
    limits = {k: longest_output(g) + 1 for k, g in grammars.items()}
    res: dict = dict(compile_ms_per_schema=compile_ms, max_new=limits,
                     states={k: g.n_states for k, g in grammars.items()},
                     forced_run_max={k: int(g.jump_len.max())
                                     for k, g in grammars.items()})
    log(f"  schemas: states {res['states']}, max_new {limits}, compile "
        f"{compile_ms:.0f} ms each at V={cfg.vocab_size}")
    params = llama_mod.init_params(_cut(MODEL, CUT_DEPTH), dev, SEED)
    runs = {}
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        for key, serving in (
                ("on", {}),
                ("off", dict(grammar=dict(jump_max=0))),
                ("steps4", dict(grammar=dict(jump_max=0), batching=dict(
                    decode_steps_per_tick=4)))):
            runs[key] = await _grammar_run(torch, tatt, dev, params, key,
                                           serving, grammars, limits, tmp, res)
            log(f"  ({key}) {json.dumps(_brief(runs[key]))}")
        on, off, steps4 = runs["on"], runs["off"], runs["steps4"]
        check(on["launches"] > 0 and on["jump_launches"] > 0,
              "(a) B1 never launched inside a jump tick")
        check(on["stats"]["grammar_jump_tokens"] > 0,
              "(b) no forced token with jump on")
        check(off["stats"]["grammar_jump_tokens"] == 0
              and off["jump_ticks"] == 0, "(b) jump ticks with jump off")
        greedy = [i for i, (n, s) in enumerate(GRAMMAR_BURST) if not s]
        check(all(on["tokens"][i][:1] == off["tokens"][i][:1]
                  for i in greedy), "(b) a first token differs on vs off")
        on["agreement_with_off"] = _agreement(
            [on["tokens"][i] for i in greedy],
            [off["tokens"][i] for i in greedy])
        check(steps4["tokens"] == off["tokens"],
              "(c) decode_steps_per_tick=4 changed the tokens of the burst")
        res["refusals"] = await _typed_refusals(torch, params, dev,
                                                grammars, tmp)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    res["tiny_f32"] = await tiny_jump_identity(torch, dev)
    res.update(runs)
    return res


# -- phase 11: the control plane ------------------------------------------------

CTRL_SLOTS = 32
CTRL_NEW = 64
SCHED_PROMPT_TOKENS = 200
SCHED_INTERACTIVE = 4
SCHED_INTERACTIVE_NEW = 8
FAIL_SPEC = "tick_fail:every=25,admit_fail:times=1"
DEADLINE_REQUESTS = 40
DEADLINE_NEW = 16
# A tick's phases close on its duration_ms (contiguous perf_counter
# marks; the float sum of five differences).
PHASE_CLOSE_MS = 0.01


class _ControlClient(_ReuseClient):
    """Phase 9's stubs, plus calls with a QoS class and DebugService."""

    def __init__(self, ch):
        super().__init__(ch)
        pb = self.pb

        def unary(method, req, resp):
            return ch.unary_unary(method,
                                  request_serializer=req.SerializeToString,
                                  response_deserializer=resp.FromString)

        self._flight = unary("/ggrmcp.tpu.DebugService/GetFlightRecord",
                             pb.FlightRecordRequest, pb.FlightRecordResponse)
        self._memory = unary("/ggrmcp.tpu.DebugService/GetMemory",
                             pb.MemoryRequest, pb.MemoryResponse)
        self._profile = unary("/ggrmcp.tpu.DebugService/Profile",
                              pb.ProfileRequest, pb.ProfileResponse)

    async def generate_as(self, text: str, max_new: int, qos: str):
        """(token ids, finish reason, client ms) of a call in a class."""
        t = time.perf_counter()
        resp = await self._gen(self.pb.GenerateRequest(
            prompt=text, max_new_tokens=max_new, return_tokens=True),
            metadata=(("x-qos-class", qos),), timeout=phase_left())
        return (list(resp.token_ids), resp.finish_reason,
                (time.perf_counter() - t) * 1e3)

    async def flight(self):
        return await self._flight(self.pb.FlightRecordRequest(
            max_ticks=512, max_requests=2048))

    async def memory(self):
        return await self._memory(self.pb.MemoryRequest(reconcile=True))

    async def profile(self, ms: int, label: str):
        return await self._profile(self.pb.ProfileRequest(
            duration_ms=ms, output_dir=label), timeout=120)


def _phase_split(ticks) -> dict:
    """Median of each phase over plain decode ticks (no admission round
    before them, no interleave chunk)."""
    plain = [t for t in ticks if t.phase_admit_ms == 0.0
             and t.interleaved_rows == 0 and t.admitted == 0]
    split = {p: _median([getattr(t, f"phase_{p}_ms") for t in plain])
             for p in ("admit", "sync", "dispatch", "wait", "host")}
    split.update(duration=_median([t.duration_ms for t in plain]),
                 ticks=len(plain))
    return split


def _trace_summary(path: str, tick_ms: float) -> dict:
    """Top 10 kernels by device time per tick (`tick_ms` apart), and the
    device's busy share of the captured window (the union of kernel
    intervals over the span of every event)."""
    with open(path) as fh:
        events = [e for e in json.load(fh).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    check(kernels, f"the profile {path} holds no CUDA kernel event")
    start = min(e["ts"] for e in events)
    window = max(e["ts"] + e["dur"] for e in events) - start
    busy, end = 0.0, start
    for e in sorted(kernels, key=lambda e: e["ts"]):
        lo, hi = max(e["ts"], end), e["ts"] + e["dur"]
        if hi > lo:
            busy += hi - lo
            end = hi
    by_name: dict = {}
    for e in kernels:
        total, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (total + e["dur"], n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    check(tick_ms, "no tick was recorded while the profile ran")
    per_tick = window / 1e3 / tick_ms  # ticks in the window
    return dict(
        window_ms=window / 1e3, kernel_events=len(kernels),
        busy_share=busy / window if window else 0.0, tick_ms=tick_ms,
        ticks_in_window=per_tick,
        device_ms_per_tick=sum(e["dur"] for e in kernels) / 1e3 / per_tick,
        top10=[dict(name=name[:90], ms_per_tick=total / 1e3 / per_tick,
                    launches_per_tick=n / per_tick)
               for name, (total, n) in top])


def _burst_requests():
    return [(_prompt_text(n, i), SERVE_NEW_TOKENS)
            for i, n in enumerate(SERVE_PROMPT_TOKENS)]


async def _ctrl_burst(client) -> list:
    """Phase 5's burst: 8 concurrent greedy calls through both routes."""
    outs = await asyncio.gather(*(client.generate(text, n)
                                  for text, n in _burst_requests()))
    for ids, reason, _ in outs:
        check(reason in ("length", "stop") and ids,
              f"burst request ended {reason!r} with {len(ids)} tokens")
    return outs


async def _observed_run(torch, dev, params, tmp, obs: bool) -> dict:
    """(a) phase 5's burst with the recorder on or off; on, also (b) a
    Profile while every slot decodes and (c) GetMemory with reconcile."""
    import grpc.aio

    serving = {} if obs else dict(observability=dict(enabled=False))
    sidecar = _config_sidecar(torch, params, dev, serving, tmp)
    port = await sidecar.start(0)
    res: dict = {}
    try:
        async with grpc.aio.insecure_channel(f"localhost:{port}") as ch:
            client = _ControlClient(ch)
            outs = await _ctrl_burst(client)
            stats = await client.stats()
            res.update(tokens=[ids for ids, _, _ in outs],
                       decode_stall_ms_p50=stats.decode_stall_ms_p50,
                       decode_stall_ms_p99=stats.decode_stall_ms_p99,
                       ticks=stats.ticks)
            if obs:
                res.update(await _observed_extras(torch, dev, sidecar,
                                                  client, stats, len(outs)))
            else:
                check(stats.ttft_ms_count == 0 and stats.tick_phase_wait_ms
                      == 0, "observability off still recorded")
    finally:
        await sidecar.stop()
    del sidecar
    gc.collect()
    torch.cuda.empty_cache()
    return res


async def _observed_extras(torch, dev, sidecar, client, stats,
                           served: int) -> dict:
    """(a)'s records of the burst just served, (b) and (c)."""
    res: dict = {}
    record = await client.flight()
    check(stats.ttft_ms_count == stats.e2e_ms_count == served
          == len(record.requests),
          f"histograms count {stats.ttft_ms_count} requests, "
          f"served {served}")
    worst = max(abs(t.phase_admit_ms + t.phase_sync_ms
                    + t.phase_dispatch_ms + t.phase_wait_ms
                    + t.phase_host_ms - t.duration_ms)
                for t in record.ticks)
    check(worst <= PHASE_CLOSE_MS,
          f"a tick's phases miss its duration by {worst} ms")
    res.update(split=_phase_split(record.ticks),
               phase_close_worst_ms=worst,
               tick_records=len(record.ticks))
    # (b) a 1000 ms Profile while all slots decode: each slot takes a new
    # request as its last one ends until the capture returns, since the
    # profiler may take longer to start than a request takes to decode.
    captured = asyncio.Event()

    async def decode(i: int) -> list:
        outs = [await client.generate(_prompt_text(40, 1200 + i), CTRL_NEW)]
        while not captured.is_set():
            outs.append(await client.generate(_prompt_text(40, 1200 + i),
                                              CTRL_NEW))
        return outs
    decoding = asyncio.ensure_future(asyncio.gather(*(
        decode(i) for i in range(CTRL_SLOTS))))
    await client.wait_active(CTRL_SLOTS)
    before = sidecar.batcher.timing["ticks"]
    try:
        prof = await client.profile(1000, "phase11")
    finally:
        captured.set()
    after = sidecar.batcher.timing["ticks"]
    done = [out for outs in await decoding for out in outs]
    check(all(r in ("length", "stop") for _, r, _ in done),
          "a decoding request failed under the profile")
    # The window holds window_ms / tick_ms ticks, tick_ms the median
    # duration of the ticks recorded while the call ran.
    during = [t.duration_ms for t in (await client.flight()).ticks
              if before < t.seq <= after]
    res["profile"] = _trace_summary(prof.output_path, _median(during))
    # (c) the ledger, reconciled, with the pool idle (no collection runs
    # between the reconcile and the allocator's count).
    gc.collect()
    mem = await client.memory()
    allocated = torch.cuda.memory_allocated(dev)
    attributed = sum(c.bytes for c in mem.components)
    check(attributed + mem.unattributed_bytes == mem.live_bytes
          == allocated,
          f"ledger: {attributed} + {mem.unattributed_bytes} vs "
          f"live {mem.live_bytes}, allocated {allocated}")
    res["memory"] = dict(
        components_gb={c.component: c.bytes / 1e9
                       for c in mem.components},
        attributed_gb=attributed / 1e9,
        unattributed_gb=mem.unattributed_bytes / 1e9,
        unattributed_arrays=mem.unattributed_arrays,
        memory_allocated_gb=allocated / 1e9)
    comp = {c.component: c.bytes for c in mem.components}
    check(comp["weights"] == sidecar.generation.weight_bytes()
          and comp["kv_arena"] == sidecar.batcher.cache.nbytes(),
          f"ledger components {comp}")
    return res


async def _sched_run(torch, dev, params, tmp, enabled: bool) -> dict:
    """(d) every slot holds a batch-class request; once they decode, the
    interactive ones arrive."""
    import grpc.aio

    serving = dict(scheduler=dict(enabled=True)) if enabled else {}
    sidecar = _config_sidecar(torch, params, dev, serving, tmp)
    port = await sidecar.start(0)
    try:
        async with grpc.aio.insecure_channel(f"localhost:{port}") as ch:
            client = _ControlClient(ch)
            batch = asyncio.ensure_future(asyncio.gather(*(
                client.generate_as(_prompt_text(SCHED_PROMPT_TOKENS,
                                                1100 + i), CTRL_NEW, "batch")
                for i in range(CTRL_SLOTS))))
            await client.wait_active(CTRL_SLOTS)
            start = (await client.stats()).ticks
            while (await client.stats()).ticks < start + 2:
                await asyncio.sleep(0.01)
            inter = await asyncio.gather(*(
                client.generate_as(_prompt_text(40, 1150 + i),
                                   SCHED_INTERACTIVE_NEW, "interactive")
                for i in range(SCHED_INTERACTIVE)))
            batch_out = await batch
            stats = await client.stats()
            record = await client.flight()
    finally:
        await sidecar.stop()
    del sidecar
    gc.collect()
    torch.cuda.empty_cache()
    for ids, reason, _ in batch_out:
        check(len(ids) == CTRL_NEW or reason == "stop",
              f"(d) a batch request ended {reason!r} with {len(ids)} tokens")
    check(all(reason in ("length", "stop") for _, reason, _ in inter),
          "(d) an interactive request failed")
    ttft = [r.ttft_ms for r in record.requests if r.qos_class == "interactive"]
    check(len(ttft) == SCHED_INTERACTIVE, f"(d) {len(ttft)} interactive "
          f"records")
    return dict(
        tokens=[ids for ids, _, _ in batch_out], interactive_ttft_ms=_ttft(
            ttft), interactive_client_ms=_ttft([ms for _, _, ms in inter]),
        batch_stops=sum(r == "stop" for _, r, _ in batch_out),
        **{k: getattr(stats, k) for k in (
            "sched_preemptions", "sched_resumes", "sched_parked",
            "sched_preempt_failures", "replayed_requests",
            "decode_stall_ms_p50")})


async def _failpoint_run(torch, dev, params, tmp) -> dict:
    """(e) a sidecar armed with FAIL_SPEC: its first admission fails (a
    probe call takes it: INTERNAL), then phase 5's burst completes
    through tick failures by replay."""
    import grpc
    import grpc.aio

    from ggrmcp_tpu_torch.utils import failpoints

    sidecar = _config_sidecar(torch, params, dev, dict(
        failpoints=FAIL_SPEC, batching=dict(tick_retry_limit=4)), tmp)
    port = await sidecar.start(0)
    try:
        async with grpc.aio.insecure_channel(f"localhost:{port}") as ch:
            client = _ControlClient(ch)
            code = None
            try:
                await client.generate(_prompt_text(40, 1300), 4)
            except grpc.aio.AioRpcError as exc:
                code = exc.code()
            check(code == grpc.StatusCode.INTERNAL,
                  f"(e) the probe through admit_fail got {code}")
            outs = await _ctrl_burst(client)
            stats = await client.stats()
    finally:
        failpoints.registry.disarm()
        await sidecar.stop()
    del sidecar
    gc.collect()
    torch.cuda.empty_cache()
    check(stats.replayed_requests > 0, "(e) no tick failure was replayed")
    return dict(tokens=[ids for ids, _, _ in outs], probe=code.name,
                replayed_requests=stats.replayed_requests,
                replay_exhausted=stats.replay_exhausted, ticks=stats.ticks)


async def _deadline_run(torch, dev, params, tmp) -> dict:
    """(f) DEADLINE_REQUESTS requests on CTRL_SLOTS slots with
    queue_deadline_ms 200, all queued before the first admission round:
    the ones left queued time out."""
    import grpc.aio

    sidecar = _config_sidecar(torch, params, dev, dict(
        batching=dict(queue_deadline_ms=200.0)), tmp)
    _hold_admission(sidecar.batcher)
    sidecar.batcher.hold_for = DEADLINE_REQUESTS
    port = await sidecar.start(0)
    try:
        async with grpc.aio.insecure_channel(f"localhost:{port}") as ch:
            client = _ControlClient(ch)
            outs = await asyncio.gather(*(
                client.generate(_prompt_text(40, 1400 + i), DEADLINE_NEW)
                for i in range(DEADLINE_REQUESTS)))
            stats = await client.stats()
    finally:
        await sidecar.stop()
    del sidecar
    gc.collect()
    torch.cuda.empty_cache()
    reasons: dict = {}
    for _, reason, _ in outs:
        reasons[reason] = reasons.get(reason, 0) + 1
    check(stats.timed_out == reasons.get("timeout", 0)
          == DEADLINE_REQUESTS - CTRL_SLOTS,
          f"(f) timed_out {stats.timed_out}, reasons {reasons}")
    return dict(timed_out=stats.timed_out, finish_reasons=reasons)


async def _budget_run(torch, dev, params, tmp, budget_ms: float) -> dict:
    """(f) phase 9b's wave (two 3000-token prompts under 8 decoding
    slots, interleave off) with p50_budget_ms set."""
    import grpc.aio

    sidecar = _config_sidecar(torch, params, dev, dict(
        batching=dict(p50_budget_ms=budget_ms)), tmp)
    port = await sidecar.start(0)
    try:
        async with grpc.aio.insecure_channel(f"localhost:{port}") as ch:
            client = _ControlClient(ch)
            shorts = asyncio.ensure_future(asyncio.gather(*(
                client.generate(_prompt_text(ILV_SHORT_TOKENS, 950 + i),
                                ILV_SHORT_NEW) for i in range(ILV_SHORTS))))
            await client.wait_active(ILV_SHORTS)
            longs = await asyncio.gather(*(
                client.generate(_prompt_text(ILV_LONG_TOKENS, 970 + i), 1)
                for i in range(2)))
            short_out = await shorts
            stats = await client.stats()
            sidecar_ema = sidecar.batcher._admit_ema_ms
    finally:
        await sidecar.stop()
    del sidecar
    gc.collect()
    torch.cuda.empty_cache()
    for ids, reason, _ in short_out + longs:
        check(reason in ("length", "stop") and ids,
              f"(f) request ended {reason!r} with {len(ids)} tokens")
    return dict(admit_row_cost_estimate_ms=sidecar_ema, **{
        k: getattr(stats, k) for k in (
            "decode_stall_ms_p50", "decode_stall_ms_p99",
            "decode_stall_ms_max", "admit_ms_max", "admit_rounds")})


async def control_phase(torch, tatt, dev) -> dict:
    """(a) tick phases, observability on and off; (b) Profile; (c)
    GetMemory; (d) the scheduler on and off; (e) failpoints; (f)
    queue_deadline_ms and p50_budget_ms. All at llama3-8b width through
    sidecars configured by a `--config` file."""
    import tempfile

    from ggrmcp_tpu_torch.models import llama as llama_mod

    params = llama_mod.init_params(_cut(MODEL, CUT_DEPTH), dev, SEED)
    res: dict = {}
    # The path's run starts here: every launch count from 0.
    tatt.flash_attention.launches = 0
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        off = await _observed_run(torch, dev, params, tmp, obs=False)
        on = await _observed_run(torch, dev, params, tmp, obs=True)
        res["observed"] = dict(
            split=on["split"], tick_records=on["tick_records"],
            phase_close_worst_ms=on["phase_close_worst_ms"],
            stall_p50_on=on["decode_stall_ms_p50"],
            stall_p50_off=off["decode_stall_ms_p50"],
            stall_p99_on=on["decode_stall_ms_p99"],
            stall_p99_off=off["decode_stall_ms_p99"],
            agreement_on_off=_agreement(on["tokens"], off["tokens"]))
        log(f"  (a) tick phases: {json.dumps(res['observed'])}")
        res["profile"] = on["profile"]
        log(f"  (b) profile: {json.dumps(res['profile'])}")
        res["memory"] = on["memory"]
        log(f"  (c) memory: {json.dumps(res['memory'])}")

        s_on = await _sched_run(torch, dev, params, tmp, True)
        s_off = await _sched_run(torch, dev, params, tmp, False)
        check(s_on["sched_preemptions"] >= 1 and s_on["sched_resumes"]
              == s_on["sched_preemptions"] and s_on["sched_parked"] == 0,
              f"(d) preemptions {s_on['sched_preemptions']}, resumes "
              f"{s_on['sched_resumes']}, parked {s_on['sched_parked']}")
        check(s_off["sched_preemptions"] == 0, "(d) FIFO preempted")
        s_on["agreement_with_fifo"] = _agreement(s_on["tokens"],
                                                 s_off["tokens"])
        res["scheduler"] = dict(on=s_on, off=s_off)
        log(f"  (d) scheduler: {json.dumps(_brief(res['scheduler']))}")

        fail = await _failpoint_run(torch, dev, params, tmp)
        fail["agreement_with_unfailed"] = _agreement(fail["tokens"],
                                                     on["tokens"])
        res["failpoints"] = fail
        log(f"  (e) failpoints: {json.dumps(_brief(fail))}")

        res["deadline"] = await _deadline_run(torch, dev, params, tmp)
        res["budget"] = {
            str(ms): await _budget_run(torch, dev, params, tmp, ms)
            for ms in (500.0, 0.0)}
        log(f"  (f) deadlines: {json.dumps(res['deadline'])} "
            f"{json.dumps(res['budget'])}")
    torch.cuda.synchronize()
    res["launches"] = tatt.flash_attention.launches
    check(res["launches"] > 0, "phase 11 never launched B1")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


# -- phase 12: host page tier, TransferKV with roles, multi-LoRA ---------------

# The card's sizes; a smaller spec drives the same code on the CPU.
P12 = dict(
    # (b) and (c) at 8 layers, not CUT_DEPTH: at 4, (c)'s zero-b adapter
    # stream differed from base's at its 16th token (PERF.md §7).
    model=MODEL, depth=CUT_DEPTH, lora_depth=8, batching={}, page=16,
    # (a) the host tier: 16 distinct preambles (128 pages each, 2048 in
    # all) through a 1024-page arena, twice; the second pass restores.
    arena_pages=1024, host_bytes=8 << 30, big_arena_pages=4096,
    preambles=16, preamble_tokens=2048, question_tokens=64, host_new=8,
    group=4, restart_arena_pages=256, restart_preambles=4,
    restart_file_bytes=1 << 30,
    # (b) disaggregation: prefill, decode and mixed sidecars on one
    # weight set, arenas of 2048 pages.
    disagg_arena_pages=2048, disagg_prompts=(1024, 1500, 2200, 3000),
    disagg_new=16, int8_arena_pages=1024,
    # (c) multi-LoRA: four adapters of rank 8 and a zero-b one; a burst
    # of 16 calls; the churn arena holds 2 rows.
    adapters=("a0", "a1", "a2", "a3"), lora_rank=8, lora_rows=4,
    churn_rows=2, churn_arena_pages=256, lora_burst=16,
    lora_prompt_tokens=(40, 100, 200, 300), lora_new=16,
    # (d) phase 11d's scheduler scenario on a paged arena that holds the
    # 32 batch requests exactly, with the host tier attached; the
    # interactive prompts are as long as the batch ones (14 pages: more
    # than a preemption frees, fewer than it frees and parks).
    sched_slots=CTRL_SLOTS, sched_prompt=SCHED_PROMPT_TOKENS,
    sched_new=CTRL_NEW, sched_interactive=SCHED_INTERACTIVE,
    sched_interactive_prompt=SCHED_PROMPT_TOKENS,
    sched_interactive_new=SCHED_INTERACTIVE_NEW,
)


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _P12Client(_ControlClient):
    """Phase 11's stubs, plus Generate with an adapter, a transfer target
    or a QoS class, and TransferKV."""

    def __init__(self, ch):
        super().__init__(ch)
        pb = self.pb
        self._xfer = ch.unary_unary(
            "/ggrmcp.tpu.KVTransferService/TransferKV",
            request_serializer=pb.KVTransferRequest.SerializeToString,
            response_deserializer=pb.KVTransferResponse.FromString)

    async def call(self, text: str, max_new: int, **fields):
        """(token ids, finish reason, client ms)."""
        metadata = ()
        if "qos" in fields:
            metadata = (("x-qos-class", fields.pop("qos")),)
        t = time.perf_counter()
        resp = await self._gen(self.pb.GenerateRequest(
            prompt=text, max_new_tokens=max_new, return_tokens=True,
            **fields), metadata=metadata, timeout=phase_left())
        return (list(resp.token_ids), resp.finish_reason,
                (time.perf_counter() - t) * 1e3)

    async def transfer(self, **fields):
        return await self._xfer(self.pb.KVTransferRequest(**fields),
                                timeout=60)


def _p12_sidecar(torch, params, dev, serving: dict, tmp: str, spec: dict,
                 name: str = "serving"):
    """A sidecar of `spec`'s model at its depth on `params` (a copy of
    its dicts: a LoRA engine adds its factor stacks to its own, int8
    replaces the matmuls in its own) whose
    settings come from a {"serving": ...} config file, read as the
    command line reads `--config FILE`."""
    from ggrmcp_tpu_torch import __main__ as cli
    from ggrmcp_tpu_torch.serving.sidecar import Sidecar

    serving = dict(serving)
    serving["batching"] = dict(spec["batching"], **serving.get("batching", {}))
    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as fh:
        json.dump({"serving": dict(model=spec["model"],
                                   num_layers=spec["depth"], **serving)}, fh)
    cfg = cli.serving_config(cli.build_parser().parse_args(
        ["sidecar", "--config", path]))
    return Sidecar(cfg, params=_tree_copy(params), device=dev)


def _paged(spec: dict, pages: int, **extra) -> dict:
    return dict(paged_kv="on", paged_kv_page_size=spec["page"],
                paged_kv_pages=pages, **extra)


class _Traffic:
    """Bytes and milliseconds through a batcher's page movers, each call
    synchronised: the device gather to the host (demotion, export), the
    host write to the device (restore, import), and the host tier's
    hooks whole (with the page codec)."""

    def __init__(self, torch, dev, batcher):
        self.log = {k: [0, 0.0] for k in ("d2h", "h2d", "demote", "restore")}

        def timed(key, fn, nbytes):
            def run(*args, **kwargs):
                _sync(torch, dev)
                t = time.perf_counter()
                out = fn(*args, **kwargs)
                _sync(torch, dev)
                self.log[key][0] += nbytes(args, out)
                self.log[key][1] += (time.perf_counter() - t) * 1e3
                return out
            return run

        batcher._gather_pages = timed(
            "d2h", batcher._gather_pages,
            lambda a, out: sum(t.nbytes for t in out.values()))
        batcher._write_arena_pages = timed(
            "h2d", batcher._write_arena_pages,
            lambda a, out: sum(t.nbytes for t in a[1:] if t is not None
                               and hasattr(t, "nbytes")))
        batcher._demote_fetch = timed(
            "demote", batcher._demote_fetch,
            lambda a, out: sum(len(b) for b in out))
        batcher._restore_write = timed(
            "restore", batcher._restore_write,
            lambda a, out: sum(len(b) for b in a[1]))
        if batcher.pages is not None and batcher.pages.host is not None:
            batcher.pages._fetch_pages = batcher._demote_fetch
            batcher.pages._restore_pages = batcher._restore_write

    def summary(self) -> dict:
        return {k: dict(bytes=b, ms=ms, gbps=b / ms / 1e6 if ms else None)
                for k, (b, ms) in self.log.items()}


def _p12_preamble(i: int, spec: dict) -> str:
    return _prompt_text(spec["preamble_tokens"], 3000 + i)


def _p12_question(rnd: int, i: int, spec: dict) -> str:
    return chr(65 + rnd) + _prompt_text(spec["question_tokens"],
                                        5000 + 100 * rnd + i)


async def _host_passes(client, batcher, spec, rounds) -> list:
    """Each round: every preamble with that round's question, `group`
    calls at a time, each group held into one admission round."""
    outs = []
    for rnd in rounds:
        for g in range(0, spec["preambles"], spec["group"]):
            # Past the loop's wait for stragglers of the last round.
            await asyncio.sleep(0.05)
            batcher.hold_for = spec["group"]
            outs += await asyncio.gather(*(
                client.call(_p12_preamble(i, spec)
                            + _p12_question(rnd, i, spec), spec["host_new"])
                for i in range(g, g + spec["group"])))
    for ids, reason, _ in outs:
        check(reason in ("length", "stop") and ids,
              f"(a) a call ended {reason!r} with {len(ids)} tokens")
    return outs


_HOST_KEYS = ("kv_host_demotions", "kv_host_restores",
              "kv_host_bytes_demoted", "kv_host_bytes_restored",
              "kv_host_restore_failures", "kv_host_entries",
              "kv_host_bytes_used", "kv_host_file_entries",
              "kv_host_file_bytes", "paged_prefix_hits",
              "paged_pages_reused", "paged_pages_admitted", "shed_requests")


async def _host_run(torch, dev, params, tmp, spec, host: bool,
                    fail: bool = False, serving=None) -> dict:
    """(a) the two passes on a paged sidecar, with the host tier or with
    an arena that holds every page; with `fail`, a third pass under
    host_restore_fail. `serving`: more settings of the sidecar."""
    import grpc.aio

    from ggrmcp_tpu_torch.utils import failpoints

    batching = (_paged(spec, spec["arena_pages"],
                       paged_kv_host_bytes=spec["host_bytes"]) if host
                else _paged(spec, spec["big_arena_pages"]))
    sidecar = _p12_sidecar(torch, params, dev, dict(
        serving or {}, batching=batching), tmp, spec)
    batcher = sidecar.batcher
    _hold_admission(batcher)
    traffic = _Traffic(torch, dev, batcher)
    ttft: list = []
    activate = batcher._activate_slot

    def timed_activate(slot_idx, request, first_tok):
        ttft.append((time.perf_counter() - request.t_submit) * 1e3)
        return activate(slot_idx, request, first_tok)

    batcher._activate_slot = timed_activate
    port = await sidecar.start(0)
    res: dict = {}
    try:
        async with grpc.aio.insecure_channel(f"localhost:{port}") as ch:
            client = _P12Client(ch)
            passes = []
            for rnd in (0, 1):
                before = await client.stats()
                del ttft[:]
                outs = await _host_passes(client, batcher, spec, [rnd])
                after = await client.stats()
                passes.append(dict(
                    tokens=[ids for ids, _, _ in outs],
                    ttft_ms=_ttft(list(ttft)),
                    stats={k: getattr(after, k) - getattr(before, k)
                           for k in _HOST_KEYS}))
            res["passes"] = passes
            if fail:
                before = await client.stats()
                failpoints.registry.arm("host_restore_fail", every=1)
                try:
                    outs = await _host_passes(client, batcher, spec, [2])
                finally:
                    failpoints.registry.disarm()
                after = await client.stats()
                res["restore_fail"] = dict(
                    completed=len(outs),
                    **{k: getattr(after, k) - getattr(before, k)
                       for k in ("kv_host_restore_failures",
                                 "kv_host_restores", "paged_prefix_hits")})
            final = await client.stats()
            res["kv_cache_bytes"] = final.kv_cache_bytes
            res["kv_host_budget_bytes"] = final.kv_host_budget_bytes
    finally:
        await sidecar.stop()
    res["traffic"] = traffic.summary()
    del sidecar, batcher
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


async def _restart_run(torch, dev, params, tmp, spec) -> list:
    """(a) the file tier: a sidecar serves `restart_preambles` preambles
    one by one through a small arena (demoting to RAM and the file);
    then a second sidecar on the same file serves them again."""
    import grpc.aio

    path = os.path.join(tmp, "host-tier.kv")
    batching = _paged(spec, spec["restart_arena_pages"],
                      paged_kv_host_bytes=spec["host_bytes"] // 4,
                      paged_kv_host_path=path,
                      paged_kv_host_file_bytes=spec["restart_file_bytes"])
    runs = []
    for _ in range(2):
        sidecar = _p12_sidecar(torch, params, dev, dict(batching=batching),
                               tmp, spec)
        port = await sidecar.start(0)
        try:
            async with grpc.aio.insecure_channel(f"localhost:{port}") as ch:
                client = _P12Client(ch)
                outs = [await client.call(
                    _p12_preamble(i, spec) + _p12_question(0, i, spec),
                    spec["host_new"])
                    for i in range(spec["restart_preambles"])]
                stats = await client.stats()
        finally:
            await sidecar.stop()
        del sidecar
        gc.collect()
        runs.append(dict(tokens=[ids for ids, _, _ in outs],
                         **{k: getattr(stats, k) for k in _HOST_KEYS}))
    return runs


async def host_tier_part(torch, dev, params, tmp, spec) -> dict:
    """(a): the host tier against an arena holding everything, a restore
    failure's typed recompute, a warm restart from the file tier."""
    host = await _host_run(torch, dev, params, tmp, spec, host=True,
                           fail=True)
    big = await _host_run(torch, dev, params, tmp, spec, host=False)
    p1, p2 = host["passes"]
    check(p2["stats"]["kv_host_restores"] > 0,
          f"(a) the second pass restored nothing: {p2['stats']}")
    check(p1["stats"]["kv_host_demotions"] > 0, "(a) nothing was demoted")
    for rnd in (0, 1):
        agree = _agreement(host["passes"][rnd]["tokens"],
                           big["passes"][rnd]["tokens"])
        host["passes"][rnd]["agreement_with_big_arena"] = agree
        # A restored page holds the bits the device computed, and each
        # admission runs the same shapes in both runs.
        check(agree["first_token"] == agree["of"],
              f"(a) pass {rnd + 1}: first tokens vs the big arena {agree}")
    fail = host["restore_fail"]
    check(fail["kv_host_restore_failures"] > 0
          and fail["completed"] == spec["preambles"],
          f"(a) host_restore_fail: {fail}")
    restart = await _restart_run(torch, dev, params, tmp, spec)
    check(restart[0]["kv_host_file_entries"] > 0,
          f"(a) nothing reached the file tier: {restart[0]}")
    check(restart[1]["kv_host_restores"] > 0,
          f"(a) the restarted sidecar restored nothing: {restart[1]}")
    # The restart's admissions restore and run one suffix step where the
    # first sidecar's ran the whole prompt: other shapes, so bf16 may
    # round otherwise.
    warm = _agreement(restart[1]["tokens"], restart[0]["tokens"])
    check(warm["first_token"] >= warm["of"] - 1,
          f"(a) restart: first tokens {warm}")
    return dict(host=host, big_arena=big, restart=dict(
        first=_brief(restart[0]), second=_brief(restart[1]),
        agreement=warm))


def _write_adapters(path: str, cfg, spec: dict) -> None:
    """Seeded float32 factors, pre-scaled, in the registry's layout; the
    "zero" adapter's b is all zero."""
    import numpy as np

    out = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    r = spec["lora_rank"]
    for i, name in enumerate(spec["adapters"] + ("zero",)):
        rng = np.random.default_rng(7000 + i)
        a = rng.normal(0, 0.02, (cfg.num_layers, cfg.hidden_dim, r))
        b = (np.zeros((cfg.num_layers, r, out)) if name == "zero"
             else rng.normal(0, 0.5, (cfg.num_layers, r, out)))
        np.savez(os.path.join(path, f"{name}.npz"), a=a.astype(np.float32),
                 b=b.astype(np.float32))


def _lora_cfg(spec, registry, rows) -> dict:
    return dict(registry=registry, rank=spec["lora_rank"], arena_rows=rows)


async def _disagg_prompt(tatt, clients, sides, n, spec, page,
                         adapter: str = "") -> dict:
    """One two-leg call (prefill leg shipping to the decode sidecar, then
    the decode leg) and the same call on the mixed sidecar."""
    p, d, m = clients
    text = _prompt_text(n, 6000 + n)
    ship = sides[0].ship_log
    shipped = len(ship)
    before_p, before_d = await p.stats(), await d.stats()
    launched = tatt.flash_attention.launches
    leg1 = await p.call(text, spec["disagg_new"], adapter=adapter,
                        kv_transfer_target=sides[1].target)
    leg1_launches = tatt.flash_attention.launches - launched
    check(leg1[1] == "transferred", f"(b) leg 1 of {n}: {leg1[1]!r}")
    launched = tatt.flash_attention.launches
    leg2 = await d.call(text, spec["disagg_new"], adapter=adapter)
    leg2_launches = tatt.flash_attention.launches - launched
    after_p, after_d = await p.stats(), await d.stats()
    launched = tatt.flash_attention.launches
    mixed = await m.call(text, spec["disagg_new"], adapter=adapter)
    mixed_launches = tatt.flash_attention.launches - launched
    pages = after_p.kv_transfer_pages_sent - before_p.kv_transfer_pages_sent
    reused = after_d.paged_pages_reused - before_d.paged_pages_reused
    hits = after_d.paged_prefix_hits - before_d.paged_prefix_hits
    check(pages == n // page, f"(b) {n} tokens shipped {pages} pages")
    # The decode admission shares every imported full page up to the
    # reuse cap (one position must run for the sampling logits).
    check(hits == 1 and reused == (n - 1) // page,
          f"(b) {n} tokens: {hits} prefix hits, {reused} pages reused of "
          f"{pages} imported")
    check(leg2[1] in ("length", "stop") and mixed[1] in ("length", "stop"),
          f"(b) {n}: decode {leg2[1]!r}, mixed {mixed[1]!r}")
    ms = [t for t in ship[shipped:]]
    return dict(
        prompt_tokens=n, adapter=adapter, pages=pages,
        chunks=sum(c for _, c, _, _ in ms),
        wire_bytes=after_p.kv_transfer_bytes_sent
        - before_p.kv_transfer_bytes_sent,
        export_ms=sum(e for e, _, _, _ in ms),
        ship_ms=sum(s for _, _, s, _ in ms),
        leg1_ms=leg1[2], leg2_ms=leg2[2], mixed_ms=mixed[2],
        leg1_launches=leg1_launches, leg2_launches=leg2_launches,
        mixed_launches=mixed_launches,
        tokens=leg2[0], mixed_tokens=mixed[0])


def _log_shipping(torch, dev, sidecar) -> None:
    """Record each prefill leg's export and ship: (export ms, chunks,
    ship ms, wire bytes)."""
    sidecar.ship_log = []
    batcher = sidecar.batcher
    export = batcher.export_prompt_kv
    timing = {"export": 0.0}

    def timed_export(*args, **kwargs):
        _sync(torch, dev)
        t = time.perf_counter()
        out = export(*args, **kwargs)
        timing["export"] = (time.perf_counter() - t) * 1e3
        return out

    batcher.export_prompt_kv = timed_export
    ship = sidecar._ship_kv

    async def timed_ship(target, prompt, exported, adapter=""):
        t = time.perf_counter()
        pages, wire = await ship(target, prompt, exported, adapter=adapter)
        per_chunk = max(1, sidecar.TRANSFER_CHUNK_BYTES // max(1, sum(
            a.nbytes for a in exported.values() if hasattr(a, "nbytes"))
            // pages))
        sidecar.ship_log.append((timing["export"], -(-pages // per_chunk),
                                 (time.perf_counter() - t) * 1e3, wire))
        return pages, wire

    sidecar._ship_kv = timed_ship


def _time_ticks(torch, dev, batcher) -> None:
    """Each plain tick's milliseconds (synchronised) in
    `batcher.tick_ms`."""
    batcher.tick_ms = []
    plain = batcher._tick_impl

    def timed_tick(*args, **kwargs):
        t = time.perf_counter()
        out = plain(*args, **kwargs)
        _sync(torch, dev)
        batcher.tick_ms.append((time.perf_counter() - t) * 1e3)
        return out

    batcher._tick_impl = timed_tick


async def _start_all(sides):
    for side in sides:
        await side.start(0)


async def _stop_all(sides):
    for side in sides:
        await side.stop()


async def disagg_lora_parts(torch, tatt, dev, params, tmp, spec, cfg,
                            registry) -> tuple:
    """(b) disaggregation and (c) multi-LoRA on prefill, decode and mixed
    sidecars built once (all LoRA-enabled, one weight set)."""
    import grpc
    import grpc.aio

    from ggrmcp_tpu_torch.utils import failpoints

    page = spec["page"]
    lora = _lora_cfg(spec, registry, spec["lora_rows"])
    sides = [_p12_sidecar(torch, params, dev, dict(
        role=role, lora=lora,
        batching=_paged(spec, spec["disagg_arena_pages"])), tmp, spec, role)
        for role in ("prefill", "decode", "mixed")]
    _log_shipping(torch, dev, sides[0])
    m_batcher = sides[2].batcher
    _hold_admission(m_batcher)
    _time_ticks(torch, dev, m_batcher)
    await _start_all(sides)
    chans = [grpc.aio.insecure_channel(s.target) for s in sides]
    b_res: dict = {}
    c_res: dict = {}
    try:
        clients = [_P12Client(ch) for ch in chans]
        # (b) two-leg calls, base model.
        calls = [await _disagg_prompt(tatt, clients, sides, n, spec, page)
                 for n in spec["disagg_prompts"]]
        agree = _agreement([c.pop("tokens") for c in calls],
                           [c.pop("mixed_tokens") for c in calls])
        check(agree["first_token"] >= agree["of"] - 1,
              f"(b) decode vs mixed first tokens {agree}")
        check(all(c["leg1_launches"] > 0 for c in calls),
              "(b) a prefill leg never launched B1")
        check(all(0 < c["leg2_launches"] < c["mixed_launches"]
                  for c in calls),
              f"(b) decode legs launched B1 "
              f"{[c['leg2_launches'] for c in calls]} times, mixed "
              f"{[c['mixed_launches'] for c in calls]}")
        b_res["calls"] = calls
        b_res["agreement_with_mixed"] = agree
        # kv_transfer_fail: the prefill leg fails typed, ABORTED.
        failpoints.registry.arm("kv_transfer_fail", every=1, times=1)
        code = None
        try:
            await clients[0].call(_prompt_text(1024, 6100), 2,
                                  kv_transfer_target=sides[1].target)
        except grpc.aio.AioRpcError as exc:
            code = exc.code()
        finally:
            failpoints.registry.disarm()
        check(code == grpc.StatusCode.ABORTED,
              f"(b) kv_transfer_fail gave {code}, not ABORTED")
        # A page size the decode sidecar does not use: INVALID_ARGUMENT.
        code = None
        try:
            await clients[1].transfer(prompt_ids=[1] * (4 * page),
                                      page_size=2 * page)
        except grpc.aio.AioRpcError as exc:
            code = exc.code()
        check(code == grpc.StatusCode.INVALID_ARGUMENT,
              f"(b) page-size mismatch gave {code}, not INVALID_ARGUMENT")
        b_res["typed"] = dict(kv_transfer_fail="ABORTED",
                              page_size_mismatch="INVALID_ARGUMENT")
        p_stats, d_stats = await clients[0].stats(), await clients[1].stats()
        b_res["stats"] = dict(
            prefill={k: getattr(p_stats, k) for k in (
                "role", "kv_transfers_sent", "kv_transfer_pages_sent",
                "kv_transfer_bytes_sent", "kv_transfer_failures")},
            decode={k: getattr(d_stats, k) for k in (
                "role", "kv_transfers_received",
                "kv_transfer_pages_received", "kv_transfer_bytes_received",
                "paged_prefix_hits", "paged_pages_reused")})
        # (c) one adapter'd two-leg call: the pages ship in the adapter's
        # key domain.
        c_res["disagg"] = await _disagg_prompt(
            tatt, clients, sides, spec["disagg_prompts"][1], spec, page,
            adapter=spec["adapters"][1])
        c_res["disagg"]["agreement_with_mixed"] = _agreement(
            [c_res["disagg"].pop("tokens")],
            [c_res["disagg"].pop("mixed_tokens")])
        c_res.update(await _lora_burst(torch, dev, clients[2], m_batcher,
                                       spec))
    finally:
        for ch in chans:
            await ch.close()
        await _stop_all(sides)
    del sides, m_batcher
    gc.collect()
    b_res["int8"] = await _int8_transfer(torch, tatt, dev, params, tmp, spec)
    bf16_page = (b_res["stats"]["prefill"]["kv_transfer_bytes_sent"]
                 / b_res["stats"]["prefill"]["kv_transfer_pages_sent"])
    b_res["int8"]["bytes_ratio_to_bf16"] = (
        b_res["int8"]["bytes_per_page"] / bf16_page)
    check(b_res["int8"]["bytes_ratio_to_bf16"] <= 0.6,
          f"(b) int8 pages ship {b_res['int8']['bytes_ratio_to_bf16']:.3f}"
          f" of the bf16 bytes")
    c_res["churn"] = await _lora_churn(torch, dev, params, tmp, spec,
                                       registry)
    return b_res, c_res


async def _int8_transfer(torch, tatt, dev, params, tmp, spec) -> dict:
    """(b) int8 KV: a prefill and a decode sidecar on the int8 cache ship
    one prompt; bytes per page against the bf16 pages."""
    import grpc.aio

    sides = [_p12_sidecar(torch, params, dev, dict(
        role=role, kv_cache_dtype="int8",
        batching=_paged(spec, spec["int8_arena_pages"])), tmp, spec,
        f"int8-{role}") for role in ("prefill", "decode")]
    await _start_all(sides)
    chans = [grpc.aio.insecure_channel(s.target) for s in sides]
    try:
        p, d = [_P12Client(ch) for ch in chans]
        n = spec["disagg_prompts"][2]
        text = _prompt_text(n, 6000 + n)
        leg1 = await p.call(text, spec["disagg_new"],
                            kv_transfer_target=sides[1].target)
        check(leg1[1] == "transferred", f"(b) int8 leg 1: {leg1[1]!r}")
        leg2 = await d.call(text, spec["disagg_new"])
        p_stats, d_stats = await p.stats(), await d.stats()
    finally:
        for ch in chans:
            await ch.close()
        await _stop_all(sides)
    del sides
    gc.collect()
    check(leg2[1] in ("length", "stop") and d_stats.paged_prefix_hits == 1,
          f"(b) int8 decode leg: {leg2[1]!r}, hits "
          f"{d_stats.paged_prefix_hits}")
    pages = p_stats.kv_transfer_pages_sent
    return dict(prompt_tokens=n, pages=pages,
                wire_bytes=p_stats.kv_transfer_bytes_sent,
                bytes_per_page=p_stats.kv_transfer_bytes_sent / pages,
                pages_reused=d_stats.paged_pages_reused)


def _burst_names(spec) -> list:
    names = ("",) + spec["adapters"]
    return [names[i % len(names)] for i in range(spec["lora_burst"])]


def _burst_text(i, spec) -> str:
    lens = spec["lora_prompt_tokens"]
    return _prompt_text(lens[i % len(lens)], 6500 + i)


async def _lora_burst(torch, dev, client, batcher, spec) -> dict:
    """(c) the burst mixing base and every adapter, held into one
    admission round, against the same burst all base (tick p50 of
    each), each adapter'd stream against its adapter served alone, and
    a zero-b adapter against base."""
    names = _burst_names(spec)
    runs = {}
    for kind in ("base", "mixed"):
        del batcher.tick_ms[:]
        before = await client.stats()
        await asyncio.sleep(0.05)  # past the loop's wait for stragglers
        batcher.hold_for = len(names)
        outs = await asyncio.gather(*(
            client.call(_burst_text(i, spec), spec["lora_new"],
                        adapter=name if kind == "mixed" else "")
            for i, name in enumerate(names)))
        after = await client.stats()
        for ids, reason, _ in outs:
            check(reason in ("length", "stop") and ids,
                  f"(c) a {kind} burst call ended {reason!r}")
        runs[kind] = dict(
            tokens=[ids for ids, _, _ in outs],
            tick_ms_p50=_median(batcher.tick_ms), ticks=len(batcher.tick_ms),
            lora={k: getattr(after, k) - getattr(before, k) for k in (
                "lora_loads", "lora_evictions", "lora_hits")})
    alone = []
    for i, name in enumerate(names):
        if name:
            ids, reason, _ = await client.call(_burst_text(i, spec),
                                               spec["lora_new"], adapter=name)
            alone.append(ids)
    burst = [t for t, n in zip(runs["mixed"]["tokens"], names) if n]
    agree = _agreement(burst, alone)
    check(agree["first_token"] >= agree["of"] - 1,
          f"(c) adapter'd burst vs alone: {agree}")
    changed = _agreement(burst, [t for t, n in zip(runs["base"]["tokens"],
                                                   names) if n])
    check(changed["identical"] < changed["of"],
          "(c) every adapter'd stream equals its base stream")
    # A text no call has sent: both admissions are cold, the same shapes.
    text = _prompt_text(spec["lora_prompt_tokens"][1], 6700)
    zero = await client.call(text, spec["lora_new"], adapter="zero")
    base = await client.call(text, spec["lora_new"])
    check(zero[0] == base[0], f"(c) the zero-b adapter differs from base: "
          f"{zero[0]} against {base[0]}")
    stats = await client.stats()
    return dict(
        burst=dict(names=names, tick_ms_p50_mixed=runs["mixed"]["tick_ms_p50"],
                   tick_ms_p50_base=runs["base"]["tick_ms_p50"],
                   ticks_mixed=runs["mixed"]["ticks"],
                   ticks_base=runs["base"]["ticks"],
                   lora=runs["mixed"]["lora"]),
        agreement_with_alone=agree, agreement_with_base=changed,
        zero_b_equals_base=True,
        stats={k: getattr(stats, k) for k in (
            "lora_adapters_registered", "lora_adapters_resident",
            "lora_rows_total", "lora_loads", "lora_evictions", "lora_hits",
            "lora_load_ms", "lora_shed", "memory_lora_bytes")})


async def _lora_churn(torch, dev, params, tmp, spec, registry) -> dict:
    """(c) churn: the adapters in turn through an arena of `churn_rows`
    rows (each first load past the rows evicts), then adapter_load_fail
    (ABORTED) and the next call loading."""
    import grpc
    import grpc.aio

    from ggrmcp_tpu_torch.utils import failpoints

    sidecar = _p12_sidecar(torch, params, dev, dict(
        lora=_lora_cfg(spec, registry, spec["churn_rows"]),
        batching=_paged(spec, spec["churn_arena_pages"])), tmp, spec,
        "churn")
    port = await sidecar.start(0)
    try:
        async with grpc.aio.insecure_channel(f"localhost:{port}") as ch:
            client = _P12Client(ch)
            order = list(spec["adapters"]) * 2
            outs = [await client.call(_prompt_text(40, 6800 + i), 4,
                                      adapter=name)
                    for i, name in enumerate(order)]
            arena = sidecar.generation.adapter_arena
            cold = next(n for n in spec["adapters"] if n not in arena._row_of)
            failpoints.registry.arm("adapter_load_fail", every=1, times=1)
            code = None
            try:
                await client.call(_prompt_text(40, 6900), 4, adapter=cold)
            except grpc.aio.AioRpcError as exc:
                code = exc.code()
            finally:
                failpoints.registry.disarm()
            again = await client.call(_prompt_text(40, 6900), 4,
                                      adapter=cold)
            stats = await client.stats()
            arena.check_invariants()
    finally:
        await sidecar.stop()
    del sidecar
    gc.collect()
    check(all(r in ("length", "stop") for _, r, _ in outs + [again]),
          "(c) a churn call failed")
    check(code == grpc.StatusCode.ABORTED,
          f"(c) adapter_load_fail gave {code}, not ABORTED")
    check(stats.lora_evictions > 0, "(c) the churn evicted no row")
    return dict(adapter_load_fail="ABORTED", **{k: getattr(stats, k) for k in (
        "lora_loads", "lora_evictions", "lora_hits", "lora_load_ms",
        "lora_rows_total")})


async def _sched_host_run(torch, dev, params, tmp, spec, enabled) -> dict:
    """(d) phase 11d's traffic on a paged arena holding the batch
    requests exactly, the host tier attached. An interactive request
    needs more pages than a preemption frees (the victim's unwritten
    ones) and no more than it frees and parks, so its admission evicts
    part of the parked victim's pages and the victim's resume restores
    them."""
    import grpc.aio

    page, n = spec["page"], spec["sched_prompt"]
    per_request = -(-(n + spec["sched_new"] + 1) // page)
    serving = dict(batching=_paged(
        spec, spec["sched_slots"] * per_request,
        paged_kv_host_bytes=spec["host_bytes"]))
    if enabled:
        serving["scheduler"] = dict(enabled=True)
    sidecar = _p12_sidecar(torch, params, dev, serving, tmp, spec, "sched")
    port = await sidecar.start(0)
    try:
        async with grpc.aio.insecure_channel(f"localhost:{port}") as ch:
            client = _P12Client(ch)
            batch = asyncio.ensure_future(asyncio.gather(*(
                client.call(_prompt_text(n, 1100 + i), spec["sched_new"],
                            qos="batch")
                for i in range(spec["sched_slots"]))))
            await client.wait_active(spec["sched_slots"])
            start = (await client.stats()).ticks
            while (await client.stats()).ticks < start + 2:
                await asyncio.sleep(0.01)
            inter = await asyncio.gather(*(
                client.call(_prompt_text(spec["sched_interactive_prompt"],
                                         1150 + i),
                            spec["sched_interactive_new"], qos="interactive")
                for i in range(spec["sched_interactive"])))
            batch_out = await batch
            stats = await client.stats()
    finally:
        await sidecar.stop()
    del sidecar
    gc.collect()
    check(all(r in ("length", "stop") for _, r, _ in batch_out + inter),
          f"(d) a request failed: "
          f"{[r for _, r, _ in batch_out + inter]}")
    return dict(tokens=[ids for ids, _, _ in batch_out],
                interactive_ms=_ttft([ms for _, _, ms in inter]),
                arena_pages=spec["sched_slots"] * per_request,
                **{k: getattr(stats, k) for k in (
                    "sched_preemptions", "sched_resumes", "sched_parked",
                    "kv_host_demotions", "kv_host_restores",
                    "kv_host_restore_failures", "paged_pages_reused",
                    "shed_requests")})


async def paged_lora_phase(torch, tatt, dev, spec=None) -> dict:
    """Phase 12: (a) the host page tier, (b) disaggregated prefill and
    decode over TransferKV, (c) multi-LoRA, (d) preemption with the host
    tier; all through sidecars configured by a `--config` file on one
    seeded weight set."""
    import tempfile

    from ggrmcp_tpu_torch.models import llama as llama_mod

    spec = spec or P12
    cfg = _cut(spec["model"], spec["depth"])
    params = llama_mod.init_params(cfg, dev, SEED)
    lspec = dict(spec, depth=spec["lora_depth"])
    lcfg = _cut(spec["model"], lspec["depth"])
    res: dict = {}
    # The path's run starts here: every launch count from 0.
    tatt.flash_attention.launches = 0
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        registry = os.path.join(tmp, "adapters")
        os.makedirs(registry)
        _write_adapters(registry, lcfg, spec)

        t = time.perf_counter()
        res["host_tier"] = await host_tier_part(torch, dev, params, tmp,
                                                spec)
        res["host_tier"]["launches"] = tatt.flash_attention.launches
        res["host_tier"]["seconds"] = time.perf_counter() - t
        log(f"  (a) host tier: {json.dumps(_brief(res['host_tier']))}")

        t = time.perf_counter()
        launched = tatt.flash_attention.launches
        lparams = llama_mod.init_params(lcfg, dev, SEED)
        res["disagg"], res["lora"] = await disagg_lora_parts(
            torch, tatt, dev, lparams, tmp, lspec, lcfg, registry)
        del lparams
        res["disagg"]["launches"] = tatt.flash_attention.launches - launched
        res["disagg"]["seconds"] = time.perf_counter() - t
        log(f"  (b) disaggregation: {json.dumps(_brief(res['disagg']))}")
        log(f"  (c) multi-LoRA: {json.dumps(_brief(res['lora']))}")

        t = time.perf_counter()
        on = await _sched_host_run(torch, dev, params, tmp, spec, True)
        off = await _sched_host_run(torch, dev, params, tmp, spec, False)
        check(on["sched_preemptions"] >= 1
              and on["sched_resumes"] == on["sched_preemptions"]
              and on["sched_parked"] == 0,
              f"(d) preemptions {on['sched_preemptions']}, resumes "
              f"{on['sched_resumes']}, parked {on['sched_parked']}")
        check(on["kv_host_restores"] > 0,
              f"(d) the resumes restored nothing: {_brief(on)}")
        on["agreement_with_fifo"] = _agreement(on["tokens"], off["tokens"])
        res["preempt"] = dict(on=on, off=off,
                              seconds=time.perf_counter() - t)
        log(f"  (d) preemption: {json.dumps(_brief(res['preempt']))}")
    _sync(torch, dev)
    res["launches"] = tatt.flash_attention.launches
    check(res["launches"] > 0, "phase 12 never launched B1")
    del params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


# -- phase 13: speculative decoding, ring KV, length tiers ---------------------

# The card's sizes; a smaller spec drives the same code on the CPU.
P13 = dict(
    model="mistral-7b", depth=CUT_DEPTH, draft="llama-1b", gamma=4,
    batching=dict(max_batch_size=32), chunk=512,
    # (a) 16 concurrent calls: 8 greedy, 4 at temperature 0.8, 2 top-k,
    # 2 constrained by phase 10's schemas.
    burst_new=16, burst_prompts=(40, 90, 160, 250),
    # (b) self-draft and (c) the micro-path: 8 greedy calls of 32 tokens.
    greedy_calls=8, greedy_new=32,
    # (d) the ring (capacity 4096 + 512 - 1 = 4607): 8 prompts of
    # 5000-7000 tokens, 16 new tokens each, 8 slots; the contiguous
    # windowed cache at 8192.
    ring_prompts=tuple(5000 + 2000 * i // 7 for i in range(8)), ring_new=16,
    ring_slots=8, flat_seq=8192,
    # (e) tiers [[1024, 32], [8192, 4]] against one 28-slot pool at
    # 8192: 24 short calls and 4 of 6000 tokens, together.
    tiers=[[1024, 32], [8192, 4]], tier_short=24, tier_long=4,
    tier_long_tokens=6000, tier_new=16, flat_slots=28,
)
# (a)'s burst: (sampling fields, schema name) per call.
SPEC_BURST = ([({}, None)] * 8 + [(dict(temperature=0.8), None)] * 4
              + [(dict(temperature=0.8, top_k=40), None)] * 2
              + [({}, "flat"), ({}, "const")])


def _device_ms(torch, dev, fn, reps: int) -> float:
    """Mean ms of `fn` over `reps` runs: CUDA events on the card, the
    host clock (synchronised) elsewhere."""
    if dev.type == "cuda":
        return cuda_ms(torch, fn, reps)
    fn()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) * 1e3 / reps


def _spec_ticks(torch, dev, batcher) -> None:
    """Time the batcher's tick bodies (synchronised) and count B1's
    launches inside its spec ticks: `batcher.tick_log`."""
    from ggrmcp_tpu_torch.ops import attention as tatt

    batcher.tick_log = {"spec": [], "plain": [], "spec_launches": 0}

    def timed(kind, body):
        def run(*args, **kwargs):
            launched = tatt.flash_attention.launches
            t = time.perf_counter()
            out = body(*args, **kwargs)
            _sync(torch, dev)
            batcher.tick_log[kind].append((time.perf_counter() - t) * 1e3)
            if kind == "spec":
                batcher.tick_log["spec_launches"] += (
                    tatt.flash_attention.launches - launched)
            return out
        return run

    batcher._tick_spec_impl = timed("spec", batcher._tick_spec_impl)
    # A plain batcher's ticks: one-token ticks, and jump ticks while a
    # constrained row can jump.
    batcher._tick_impl = timed("plain", batcher._tick_impl)
    batcher._tick_jump_impl = timed("plain", batcher._tick_jump_impl)
    _hold_admission(batcher)


def _ttft_log(batcher) -> None:
    """Record each request's (prompt tokens, TTFT ms: submit to first-token
    sample, on the server) in `batcher.ttft_ms`."""
    batcher.ttft_ms = []
    activate = batcher._activate_slot

    def timed_activate(slot_idx, request, first_tok):
        batcher.ttft_ms.append((
            request.n_prompt, (time.perf_counter() - request.t_submit) * 1e3))
        return activate(slot_idx, request, first_tok)

    batcher._activate_slot = timed_activate


async def _spec_serve(torch, tatt, dev, params, tmp, spec, serving, name,
                      calls, hold=True, probe=None):
    """Start a sidecar, send `calls` ((text, max_new, fields) each)
    concurrently (`hold`: in one admission round), stop it. Returns the
    outputs, the stats' deltas, GetMemory's KV bytes and whether it
    closes, the TTFTs, the tick log, B1's launches and `probe(sidecar)`
    when given."""
    import grpc.aio

    side = _p12_sidecar(torch, params, dev, serving, tmp, spec, name)
    if hasattr(side.batcher, "tiers"):
        for tier in side.batcher.tiers:
            _ttft_log(tier)
    else:
        _spec_ticks(torch, dev, side.batcher)
        _ttft_log(side.batcher)
        side.batcher.hold_for = len(calls) if hold else 0
    launched = tatt.flash_attention.launches
    await side.start(0)
    try:
        async with grpc.aio.insecure_channel(side.target) as ch:
            client = _P12Client(ch)
            before = await client.stats()
            t = time.perf_counter()
            outs = await asyncio.gather(*(
                client.call(text, max_new, **fields)
                for text, max_new, fields in calls))
            wall = time.perf_counter() - t
            after = await client.stats()
            memory = await client.memory()
    finally:
        await side.stop()
    _sync(torch, dev)
    batchers = getattr(side.batcher, "tiers", [side.batcher])
    res = dict(
        tokens=[ids for ids, _, _ in outs],
        finish=[r for _, r, _ in outs], wall_s=wall,
        launches=tatt.flash_attention.launches - launched,
        delta={k: getattr(after, k) - getattr(before, k) for k in (
            "ticks", "spec_ticks", "spec_drafted", "spec_accepted",
            "speculative_calls", "speculative_requests",
            "speculative_drafted", "speculative_accepted", "admit_rounds",
            "replayed_requests", "replay_exhausted")},
        kv_arena_bytes=sum(c.bytes for c in memory.components
                           if c.component == "kv_arena"),
        live_bytes=memory.live_bytes,
        unattributed_bytes=memory.unattributed_bytes,
        memory_closes=memory.total_bytes + memory.unattributed_bytes
        == memory.live_bytes,
        draft_cache_bytes=sum(c.bytes for c in memory.components
                              if c.component == "draft_cache"),
        ttft_ms=[ms for b in batchers for ms in getattr(b, "ttft_ms", [])],
        admissions=[b.fused_admissions + b.chunked_admissions
                    for b in batchers],
        tick_log={k: v for k, v in getattr(batchers[0], "tick_log",
                                           {}).items()},
    )
    for ids, reason, _ in outs:
        check(reason in ("length", "stop", "grammar_complete") and ids,
              f"{name}: a call ended {reason!r} after {len(ids)} tokens")
    if probe is not None:
        res["probed"] = probe(side)
    del side
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


def _short_ttft(run, spec, long=False) -> dict:
    """TTFT summary of the short (or the long) calls of a tier run."""
    cut = spec["tier_long_tokens"]
    return _ttft([ms for n, ms in run["ttft_ms"] if (n >= cut) == long])


def _threefry_round_ms(torch, dev, rows: int, vocab: int, gamma: int):
    """One sampled round's draws at [rows, vocab]: gamma proposal Gumbels,
    the accept uniforms and the residual Gumbel (ops/sampling.py's eager
    threefry)."""
    from ggrmcp_tpu_torch.ops import sampling as ts

    keys = ts.fold_in(ts.prng_key(torch.arange(rows, device=dev)), 1)

    def draws():
        for tag in range(1, gamma + 1):
            ts.gumbel(ts.fold_in(keys, tag), vocab)
        ts.uniform(ts.fold_in(keys, 700), gamma)
        ts.gumbel(ts.fold_in(keys, 900), vocab)

    return _device_ms(torch, dev, draws, 5)


async def spec_ring_tier_phase(torch, tatt, dev, spec=None) -> dict:
    """Phase 13: (a) speculative ticks with the draft against plain ticks,
    (b) a self-draft, (c) the micro-path, (d) the ring against the
    contiguous windowed cache, (e) length tiers against one pool; all
    through sidecars configured by a `--config` file on one seeded
    weight set."""
    import tempfile

    from ggrmcp_tpu_torch.grammar import compile_schema
    from ggrmcp_tpu_torch.models import llama as llama_mod
    from ggrmcp_tpu_torch.rpc.pb import serving_pb2 as pb

    spec = spec or P13
    cfg = _cut(spec["model"], spec["depth"])
    params = llama_mod.init_params(cfg, dev, SEED)
    res: dict = {}
    gamma, layers = spec["gamma"], cfg.num_layers
    bnew = spec["burst_new"]
    # The path's run starts here: every launch count from 0.
    tatt.flash_attention.launches = 0
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        t = time.perf_counter()
        limits = {name: longest_output(compile_schema(
            GRAMMAR_SCHEMAS[name], vocab_size=cfg.vocab_size)) + 1
            for name in ("flat", "const")}
        burst = []
        for i, (fields, schema) in enumerate(SPEC_BURST):
            text = _prompt_text(spec["burst_prompts"][
                i % len(spec["burst_prompts"])], 1300 + i)
            f = dict(sampling=pb.SamplingParams(seed=7 + i, **fields))
            if schema:
                f["constraint"] = pb.ConstraintSpec(
                    json_schema=json.dumps(GRAMMAR_SCHEMAS[schema]))
            burst.append((text, limits[schema] if schema else bnew, f))
        greedy = [(_prompt_text(spec["burst_prompts"][i % 4], 1400 + i),
                   spec["greedy_new"], {})
                  for i in range(spec["greedy_calls"])]
        base = dict(grammar=dict(jump_max=8))
        off = await _spec_serve(torch, tatt, dev, params, tmp, spec, base,
                                "spec_off", burst)
        off_greedy = await _spec_serve(torch, tatt, dev, params, tmp, spec,
                                       base, "greedy_off", greedy)
        on = await _spec_serve(torch, tatt, dev, params, tmp, spec, dict(
            base, speculative_draft=spec["draft"],
            speculative_gamma=gamma,
            batching=dict(speculative="on")), "spec_on", burst)
        log_on = on["tick_log"]
        n_spec = len(log_on["spec"])
        check(n_spec > 0 and on["delta"]["spec_ticks"] == n_spec,
              f"(a) spec ticks: {on['delta']}, timed {n_spec}")
        if dev.type == "cuda":
            check(log_on["spec_launches"] == layers * n_spec,
                  f"(a) B1 launched {log_on['spec_launches']} times in "
                  f"{n_spec} spec ticks, not {layers} a verify")
        gtok = [t for t, (f, s) in zip(on["tokens"], SPEC_BURST)
                if not f and not s]
        gref = [t for t, (f, s) in zip(off["tokens"], SPEC_BURST)
                if not f and not s]
        d = on["delta"]
        res["spec"] = dict(
            tick_ms_p50_on=_median(log_on["spec"]),
            tick_ms_p50_off=_median(off["tick_log"]["plain"]),
            ticks_on=n_spec, ticks_off=len(off["tick_log"]["plain"]),
            tokens_per_s_on=sum(map(len, on["tokens"])) / on["wall_s"],
            tokens_per_s_off=sum(map(len, off["tokens"])) / off["wall_s"],
            acceptance=d["spec_accepted"] / max(1, d["spec_drafted"]),
            drafted=d["spec_drafted"], accepted=d["spec_accepted"],
            greedy_on_vs_off=_agreement(gtok, gref),
            finish_on=on["finish"], launches=on["launches"],
            verify_launches=log_on["spec_launches"],
            draft_cache_bytes=on["draft_cache_bytes"],
            threefry_round_ms=_threefry_round_ms(
                torch, dev, spec["batching"]["max_batch_size"],
                cfg.vocab_size, gamma),
            seconds=time.perf_counter() - t)
        log(f"  (a) spec in the batcher: {json.dumps(_brief(res['spec']))}")

        t = time.perf_counter()
        import ggrmcp_tpu_torch.models as models_mod

        real_init, real_get = llama_mod.init_params, models_mod.get_model

        def self_draft(c, device, seed=0):
            # The draft's seeded draw (seed + 1) becomes the target's own
            # tensors: a draft that proposes what the target would.
            if c is cfg and seed == SEED + 1:
                return params
            return real_init(c, device, seed)

        def draft_model(name):
            # The draft named as the target is the target at its depth.
            return ("llama", cfg) if name == spec["model"] else real_get(name)

        llama_mod.init_params = self_draft
        models_mod.get_model = draft_model
        try:
            selfd = await _spec_serve(
                torch, tatt, dev, params, tmp, spec, dict(
                    base, speculative_draft=spec["model"],
                    speculative_gamma=gamma,
                    batching=dict(speculative="on")), "self_draft", greedy)
        finally:
            llama_mod.init_params = real_init
            models_mod.get_model = real_get
        d = selfd["delta"]
        rows_ticks = d["spec_drafted"] / gamma
        if dev.type == "cuda":
            check(selfd["tick_log"]["spec_launches"]
                  == layers * len(selfd["tick_log"]["spec"]),
                  "(b) B1 did not launch once a layer a verify")
        res["self_draft"] = dict(
            acceptance=d["spec_accepted"] / max(1, d["spec_drafted"]),
            tokens_per_row_tick=1 + d["spec_accepted"] / max(1, rows_ticks),
            ticks=d["spec_ticks"],
            tick_ms_p50=_median(selfd["tick_log"]["spec"]),
            tick_ms_p50_off=_median(off_greedy["tick_log"]["plain"]),
            vs_spec_off=_agreement(selfd["tokens"], off_greedy["tokens"]),
            launches=selfd["launches"], seconds=time.perf_counter() - t)
        log(f"  (b) self-draft: {json.dumps(_brief(res['self_draft']))}")

        t = time.perf_counter()
        micro = await _spec_serve(torch, tatt, dev, params, tmp, spec, dict(
            base, speculative_draft=spec["draft"], speculative_gamma=gamma,
            batching=dict(max_queue_delay_ms=200.0)), "micro", greedy,
            hold=False)
        d = micro["delta"]
        check(d["speculative_requests"] == len(greedy) and d["ticks"] == 0,
              f"(c) the micro-path served {d}")
        res["micro"] = dict(
            calls=d["speculative_calls"], requests=d["speculative_requests"],
            acceptance=d["speculative_accepted"]
            / max(1, d["speculative_drafted"]),
            vs_batcher=_agreement(micro["tokens"], off_greedy["tokens"]),
            wall_s=micro["wall_s"], launches=micro["launches"],
            seconds=time.perf_counter() - t)
        log(f"  (c) micro-path: {json.dumps(_brief(res['micro']))}")

        t = time.perf_counter()
        ring_calls = [(_prompt_text(n, 1500 + i), spec["ring_new"], {})
                      for i, n in enumerate(spec["ring_prompts"])]
        one = dict(max_batch_size=spec["ring_slots"],
                   prefill_chunk=spec["chunk"])
        ring = await _spec_serve(torch, tatt, dev, params, tmp, spec, dict(
            kv_ring=True, batching=one), "ring", ring_calls)
        flat = await _spec_serve(torch, tatt, dev, params, tmp, spec, dict(
            batching=dict(one, kv_cache_max_seq=spec["flat_seq"])),
            "flat", ring_calls)
        if dev.type == "cuda":
            check(ring["launches"] == 0,
                  f"(d) the ring launched B1 {ring['launches']} times")
        res["ring"] = dict(
            vs_contiguous=_agreement(ring["tokens"], flat["tokens"]),
            kv_bytes_ring=ring["kv_arena_bytes"],
            kv_bytes_contiguous=flat["kv_arena_bytes"],
            ttft_ring=_ttft([ms for _, ms in ring["ttft_ms"]]),
            ttft_flat=_ttft([ms for _, ms in flat["ttft_ms"]]),
            tick_ms_p50_ring=_median(ring["tick_log"]["plain"]),
            tick_ms_p50_flat=_median(flat["tick_log"]["plain"]),
            ring_launches=ring["launches"], flat_launches=flat["launches"],
            seconds=time.perf_counter() - t)
        log(f"  (d) ring: {json.dumps(_brief(res['ring']))}")

        t = time.perf_counter()
        long_calls = [(_prompt_text(spec["tier_long_tokens"], 1600 + i),
                       spec["tier_new"], {}) for i in range(spec["tier_long"])]
        short_calls = [(_prompt_text(spec["burst_prompts"][i % 4], 1700 + i),
                        spec["tier_new"], {})
                       for i in range(spec["tier_short"])]
        calls = long_calls + short_calls
        tiered = await _spec_serve(torch, tatt, dev, params, tmp, spec, dict(
            batching=dict(kv_tiers=spec["tiers"], max_queue_delay_ms=50.0)),
            "tiers", calls, hold=False)
        untiered = await _spec_serve(torch, tatt, dev, params, tmp, spec,
                                     dict(batching=dict(
                                         max_batch_size=spec["flat_slots"],
                                         kv_cache_max_seq=spec["flat_seq"],
                                         max_queue_delay_ms=50.0)),
                                     "untiered", calls, hold=False)
        n_long = spec["tier_long"]
        check(tiered["admissions"] == [spec["tier_short"], n_long],
              f"(e) tier admissions {tiered['admissions']}")
        res["tiers"] = dict(
            admissions=tiered["admissions"],
            short_ttft_tiered=_short_ttft(tiered, spec),
            short_ttft_untiered=_short_ttft(untiered, spec),
            long_ttft_tiered=_short_ttft(tiered, spec, long=True),
            long_ttft_untiered=_short_ttft(untiered, spec, long=True),
            kv_bytes_tiered=tiered["kv_arena_bytes"],
            kv_bytes_untiered=untiered["kv_arena_bytes"],
            vs_untiered=_agreement(tiered["tokens"], untiered["tokens"]),
            launches=tiered["launches"], seconds=time.perf_counter() - t)
        log(f"  (e) tiers: {json.dumps(_brief(res['tiers']))}")
    _sync(torch, dev)
    res["launches"] = tatt.flash_attention.launches
    del params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


# -- phase 14: the sparse-MoE family -------------------------------------------

# The card's sizes; a smaller spec drives the same code on the CPU.
# mixtral-8x7b at its published widths with its depth cut to CUT_DEPTH
# of 32 layers: a layer's bf16 expert banks are 3 · 8 · 4096 · 14336
# values, so 32 layers exceed the card's 80 GB (16 layers and the
# default pool, 32 slots of 4097 positions, fit; this phase ran 16
# before the budget).
P14 = dict(model="mixtral-8x7b", layers=CUT_DEPTH, admit=(32, 512),
           prompts=SERVE_PROMPT_TOKENS, new=SERVE_NEW_TOKENS, batching={},
           tiny="tiny-moe")
# (a) moe_ffn (bf16, by index) against its one-hot form in float32
# (`route`'s dispatch and combine tensors) on the same inputs and
# weights. Both take the same routing (the float32 router on the same
# bf16 input); the bf16 path rounds the expert input, the gate and up
# products, their SwiGLU product and the output: five roundings of at
# most 2^-9 each, under 1e-2 in relative L2.
MOE_FFN_REL = 1e-2
# (a) The [32, 512] prefill with B1 against the same prefill through
# flash_attention_ref: phase 4's bound, relative L2 of the logits <=
# 2e-2, with the plain run's routing held to the kernel run's. Routing
# is discontinuous: where bf16 attention outputs differ by a rounding
# step, a near-tie of the router flips an expert, and the position then
# differs by a routing decision, not by rounding. Those flips (the plain
# run's own top-2 against the kernel run's) are counted, not bounded.
MOE_PREFILL_REL = 2e-2
# (d) Two constrained calls of phase 10's schemas.
MOE_SCHEMAS = ("flat", "const")


def _moe_ffn_check(torch, dev, spec) -> dict:
    """(a) One layer's moe_ffn at the admission shape against its float32
    one-hot form; the drops of both are the same."""
    import dataclasses

    from ggrmcp_tpu_torch.models import moe as moe_mod
    from ggrmcp_tpu_torch.utils.device import set_float_policy

    set_float_policy()
    cfg = dataclasses.replace(moe_mod.CONFIGS[spec["model"]], num_layers=1)
    params = moe_mod.init_params(cfg, dev, SEED + 2)
    lp = {k: v[0] for k, v in params["layers"].items()}
    del params
    b, s = spec["admit"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    x = torch.randn((b, s, cfg.hidden_dim), generator=gen, device=dev,
                    dtype=torch.float32).to(cfg.torch_dtype)
    with torch.no_grad():
        out, _ = moe_mod.moe_ffn(x, lp, cfg, aux=False)
        _sync(torch, dev)
        ms = _device_ms(torch, dev, lambda: moe_mod.moe_ffn(
            x, lp, cfg, aux=False), 3)
        # The decode tick's FFN: one token a slot (T = 32, capacity 16),
        # every expert's bank read once.
        step = x[:, :1].contiguous()
        decode_ms = _device_ms(torch, dev, lambda: moe_mod.moe_ffn(
            step, lp, cfg, aux=False), 10)
        bank_bytes = sum(lp[k].numel() * lp[k].element_size()
                         for k in ("w_gate", "w_up", "w_down"))
        lp32 = {k: v.float() for k, v in lp.items()}
        ref, _ = moe_mod.moe_ffn_ref(x.float(), lp32, cfg)
        t = b * s
        cap = moe_mod._capacity(cfg, t)
        dispatch, _, _ = moe_mod.route(x.reshape(t, -1), lp["router"], cfg,
                                       cap)
        kept = dispatch.sum().item()
        del dispatch, lp32
        rel = ((out.float() - ref).norm() / ref.norm()).item()
    check(torch.isfinite(out).all().item(), "(a) moe_ffn output not finite")
    check(rel <= MOE_FFN_REL,
          f"(a) moe_ffn vs its one-hot form: rel err {rel} > {MOE_FFN_REL}")
    res = dict(tokens=t, capacity=cap, pairs_kept=int(kept),
               pairs_dropped=t * cfg.experts_per_token - int(kept),
               rel_err=rel, max_abs_err=(out.float() - ref).abs().max().item(),
               ms=ms, bound_ms=_ffn_bound_ms(cfg, int(kept)),
               decode_ms=decode_ms, decode_bound_ms=bank_bytes / PEAK_BYTES
               * 1e3)
    del out, ref, lp, x
    return res


def _ffn_bound_ms(cfg, pairs: int) -> float:
    """The least time of the FFN's expert products for `pairs` routed
    (token, k) pairs (this run's data: capacity rows left empty need no
    work): three [D] x [D, F]-sized products a pair in bf16 over the
    card's peak, or the banks read once over the memory rate, whichever
    is larger."""
    e, d, f = cfg.num_experts, cfg.hidden_dim, cfg.ffn_dim
    flops = 3 * 2 * pairs * d * f
    return max(flops / PEAK_FLOPS["bfloat16"],
               3 * e * d * f * 2 / PEAK_BYTES) * 1e3


def _moe_prefill_check(torch, tatt, moe_mod, llama_mod, params, cfg, dev,
                       spec) -> dict:
    """(a) A [32, 512] prefill with B1 against the same prefill with every
    attention through the plain version, the plain run's routing held to
    the kernel run's (its own top-2 counted against it)."""
    b, s = spec["admit"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    toks = torch.randint(3, cfg.vocab_size, (b, s), generator=gen,
                         device=dev)
    real_assign = moe_mod._assign
    kernel_attention = llama_mod.attention
    routes: list = []
    flips = [0, 0]

    def record(*args, **kwargs):
        out = real_assign(*args, **kwargs)
        routes.append(out)
        return out

    def replay(*args, **kwargs):
        own = real_assign(*args, **kwargs)
        pinned = routes[flips[1]]
        flips[0] += int((own[2] != pinned[2]).any(-1).sum().item())
        flips[1] += 1
        return pinned

    def plain(q, k, v, **kw):
        kw.pop("use_flash", None)
        kw.pop("k_positions", None)
        return tatt.flash_attention_ref(q, k, v, **kw)

    launched = tatt.flash_attention.launches
    with torch.no_grad():
        moe_mod._assign = record
        try:
            out, _ = moe_mod.forward(params, cfg, toks)
        finally:
            moe_mod._assign = real_assign
        launches = tatt.flash_attention.launches - launched
        moe_mod._assign, llama_mod.attention = replay, plain
        try:
            ref, _ = moe_mod.forward(params, cfg, toks)
        finally:
            moe_mod._assign = real_assign
            llama_mod.attention = kernel_attention
        rel = ((out - ref).norm() / ref.norm()).item()
        agree = (out.argmax(-1) == ref.argmax(-1)).float().mean().item()
        finite = torch.isfinite(out).all().item()
    decisions = b * s * cfg.num_layers
    del out, ref, routes
    check(finite, "(a) mixtral logits not finite")
    if dev.type == "cuda":
        check(launches == cfg.num_layers,
              f"(a) the prefill launched B1 {launches} times")
    check(rel <= MOE_PREFILL_REL,
          f"(a) mixtral prefill kernel vs plain rel err {rel}")
    return dict(logits_rel_err=rel, top1_agree=agree, b1_launches=launches,
                routing_flips=flips[0], routing_decisions=decisions,
                flip_share=flips[0] / decisions)


def _tiny_moe_check(torch, dev, spec) -> dict:
    """(a) tiny-moe (float32) on the card against the same weights on the
    CPU: identical greedy tokens."""
    import numpy as np

    from ggrmcp_tpu_torch.models import moe as moe_mod
    from ggrmcp_tpu_torch.serving.engine import GenerationEngine

    cfg = moe_mod.CONFIGS[spec["tiny"]]
    cpu_params = moe_mod.init_params(cfg, torch.device("cpu"), SEED)
    rng = np.random.default_rng(SEED + 5)
    toks = torch.from_numpy(rng.integers(3, 500, (2, 100)))
    ref, _ = moe_mod.forward(cpu_params, cfg, toks)
    out, _ = moe_mod.forward(_to(cpu_params, dev), cfg, toks.to(dev))
    err = (out.cpu() - ref).abs().max().item()
    check(err <= 1e-3, f"(a) tiny-moe logits card vs cpu: {err} > 1e-3")
    prompts = [rng.integers(3, 500, n).tolist() for n in (7, 33, 90)]
    cpu_out = GenerationEngine(cfg, params=cpu_params, device="cpu").generate(
        prompts, 16)
    dev_out = GenerationEngine(cfg, params=_to(cpu_params, dev),
                               device=dev).generate(prompts, 16)
    check(dev_out == cpu_out, "(a) tiny-moe greedy tokens card vs cpu differ")
    return dict(logits_max_abs_err=err, greedy_identical=True)


class _PairTally:
    """Routed (token, k) pairs of every MoE layer while installed, on the
    device (no sync): real pairs and the pairs kept within capacity, per
    kind of forward ("admit" unless a tick body runs)."""

    def __init__(self, torch, dev, moe_mod):
        self.mod, self.assign = moe_mod, moe_mod._assign
        self.kind = "admit"
        self.counts = {kind: torch.zeros(2, dtype=torch.int64, device=dev)
                       for kind in ("admit", "tick")}

    def install(self) -> None:
        def counted(x, router, cfg, capacity, valid):
            out = self.assign(x, router, cfg, capacity, valid)
            real = x.shape[0] if valid is None else valid.sum()
            self.counts[self.kind][0] += real * cfg.experts_per_token
            self.counts[self.kind][1] += out[4].sum()
            return out

        self.mod._assign = counted

    def remove(self) -> None:
        self.mod._assign = self.assign

    def read(self, reset: bool = True) -> dict:
        out = {}
        for kind, c in self.counts.items():
            pairs, kept = (int(v) for v in c.tolist())
            out[kind] = dict(pairs=pairs, dropped=pairs - kept)
            if reset:
                c.zero_()
        return out


def _moe_ticks(torch, dev, batcher, tally) -> None:
    """Time the plain tick body (synchronised), count B1's launches inside
    it (`batcher.tick_log`) and tally its routed pairs apart; hold
    admission rounds (`hold_for`)."""
    from ggrmcp_tpu_torch.ops import attention as tatt

    batcher.tick_log = {"ms": [], "launches": 0}
    body = batcher._tick_impl

    def timed(*args, **kwargs):
        launched = tatt.flash_attention.launches
        tally.kind = "tick"
        t = time.perf_counter()
        try:
            out = body(*args, **kwargs)
            _sync(torch, dev)
        finally:
            tally.kind = "admit"
        batcher.tick_log["ms"].append((time.perf_counter() - t) * 1e3)
        batcher.tick_log["launches"] += tatt.flash_attention.launches - launched
        return out

    batcher._tick_impl = timed
    _hold_admission(batcher)
    _ttft_log(batcher)


async def moe_phase(torch, tatt, dev, spec=None) -> dict:
    """Phase 14: (a) the MoE FFN against its one-hot form, a [32, 512]
    prefill with B1 against the plain version, tiny-moe card vs CPU; (b) a
    sidecar on the depth-cut model (`num_layers` in its `--config` file)
    answers phase 5's burst through fused and chunked admissions and one
    GenerateStream; (c) each greedy stream of the burst against its prompt
    alone, counted; (d) two constrained calls on one-token masked ticks
    (jump-ahead is gated off for MoE: no B1 launch in their ticks)."""
    import dataclasses
    import tempfile

    import grpc.aio

    from ggrmcp_tpu_torch import __main__ as cli
    from ggrmcp_tpu_torch.grammar import compile_schema
    from ggrmcp_tpu_torch.models import llama as llama_mod
    from ggrmcp_tpu_torch.models import moe as moe_mod
    from ggrmcp_tpu_torch.models.common import param_bytes
    from ggrmcp_tpu_torch.serving.sidecar import Sidecar

    spec = spec or P14
    cfg = dataclasses.replace(moe_mod.CONFIGS[spec["model"]],
                              num_layers=spec["layers"])
    res: dict = {}
    t = time.perf_counter()
    res["ffn"] = _moe_ffn_check(torch, dev, spec)
    _free(torch, dev)
    log(f"  (a) moe_ffn vs one-hot: {json.dumps(res['ffn'])}")
    res["tiny"] = _tiny_moe_check(torch, dev, spec)
    log(f"  (a) {spec['tiny']} card vs cpu: {json.dumps(res['tiny'])}")

    # The path's run starts here: every launch count from 0.
    tatt.flash_attention.launches = 0
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        path = os.path.join(tmp, "moe.json")
        with open(path, "w") as fh:
            json.dump({"serving": dict(
                model=spec["model"], num_layers=spec["layers"],
                batching=spec["batching"])}, fh)
        serving = cli.serving_config(cli.build_parser().parse_args(
            ["sidecar", "--config", path]))
        _sync(torch, dev)
        t_init = time.perf_counter()
        side = Sidecar(serving, seed=SEED, device=dev)
        _sync(torch, dev)
        res["init_s"] = time.perf_counter() - t_init
        engine, batcher = side.generation, side.batcher
        check(engine.cfg == cfg and side.family == "moe",
              f"(b) the sidecar serves {engine.cfg.name} as {side.family}")
        check(batcher._is_moe and batcher._jump_max == 0,
              "(d) jump-ahead was not gated off for MoE")
        tally = _PairTally(torch, dev, moe_mod)
        _moe_ticks(torch, dev, batcher, tally)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        texts = [_prompt_text(n, 1800 + i)
                 for i, n in enumerate(spec["prompts"])]
        limits = {name: longest_output(compile_schema(
            GRAMMAR_SCHEMAS[name], vocab_size=cfg.vocab_size)) + 1
            for name in MOE_SCHEMAS}
        await side.start(0)
        tally.install()
        try:
            async with grpc.aio.insecure_channel(side.target) as ch:
                client = _GrammarClient(ch)
                ctl = _ControlClient(ch)
                info = await ch.unary_unary(
                    "/ggrmcp.tpu.ModelInfoService/GetModelInfo",
                    request_serializer=client.pb.ModelInfoRequest
                    .SerializeToString,
                    response_deserializer=client.pb.ModelInfoResponse
                    .FromString)(client.pb.ModelInfoRequest())
                check(info.family == "moe" and info.model_id == cfg.name
                      and info.num_params_million
                      == moe_mod.num_params(cfg) // 10 ** 6,
                      f"(b) GetModelInfo {info}")

                # (b) the burst in one admission round.
                tally.read()
                batcher.hold_for = len(texts)
                routes0 = (batcher.fused_admissions,
                           batcher.chunked_admissions)
                t_burst = time.perf_counter()
                burst = await asyncio.gather(*(
                    client.generate(text, spec["new"]) for text in texts))
                wall = time.perf_counter() - t_burst
                burst_pairs = tally.read()
                routes = (batcher.fused_admissions - routes0[0],
                          batcher.chunked_admissions - routes0[1])
                ticks_ms = list(batcher.tick_log["ms"])
                ttft = [ms for _, ms in batcher.ttft_ms]
                for n, (ids, reason, _) in zip(spec["prompts"], burst):
                    check(reason in ("length", "stop") and ids
                          and all(0 <= i < cfg.vocab_size for i in ids),
                          f"(b) prompt of {n} tokens: {reason}, {len(ids)}")
                chunks = await client.stream(client.request(
                    _prompt_text(spec["prompts"][4], 1900), spec["new"]))
                check(chunks and chunks[-1].done
                      and chunks[-1].finish_reason in ("length", "stop"),
                      f"(b) the stream ended badly: {chunks[-1:]}")
                memory = await ctl.memory()
                tokens = sum(len(ids) for ids, _, _ in burst)
                comps = {c.component: c.bytes for c in memory.components
                         if not c.scope}
                check(comps["weights"] == param_bytes(engine.params),
                      f"(b) GetMemory weights {comps['weights']} != "
                      f"{param_bytes(engine.params)}")
                check(memory.total_bytes + memory.unattributed_bytes
                      == memory.live_bytes, "(b) the ledger does not close")
                res["serve"] = dict(
                    requests=len(burst), tokens=tokens, wall_s=wall,
                    tok_per_s=tokens / wall, tick_ms_p50=_median(ticks_ms),
                    ticks=len(ticks_ms), ttft=_ttft(ttft),
                    fused_admissions=routes[0], chunked_admissions=routes[1],
                    stream_chunks=len(chunks),
                    weights_bytes=comps["weights"],
                    kv_arena_bytes=comps.get("kv_arena", 0),
                    live_bytes=memory.live_bytes,
                    unattributed_bytes=memory.unattributed_bytes,
                    num_params_million=info.num_params_million,
                    routed_pairs=burst_pairs,
                    launches=tatt.flash_attention.launches)
                check(res["serve"]["fused_admissions"] > 0
                      and res["serve"]["chunked_admissions"] > 0,
                      "(b) the burst did not take both admission routes")
                log(f"  (b) serve: {json.dumps(res['serve'])}")

                # (c) each burst prompt alone.
                tally.read()
                alone = [(await client.generate(text, spec["new"]))[0]
                         for text in texts]
                res["batch_dependence"] = dict(_agreement(
                    [ids for ids, _, _ in burst], alone),
                    routed_pairs_alone=tally.read())
                log(f"  (c) burst vs alone: "
                    f"{json.dumps(res['batch_dependence'])}")

                # (d) two constrained calls on masked one-token ticks.
                launched = batcher.tick_log["launches"]
                n_ticks = len(batcher.tick_log["ms"])
                batcher.hold_for = len(MOE_SCHEMAS)
                outs = await asyncio.gather(*(client.call(client.request(
                    texts[i], limits[name], schema=GRAMMAR_SCHEMAS[name]))
                    for i, name in enumerate(MOE_SCHEMAS)))
                tick_launches = batcher.tick_log["launches"] - launched
                for name, (resp, _) in zip(MOE_SCHEMAS, outs):
                    check(resp.finish_reason in ("grammar_complete", "stop"),
                          f"(d) {name}: finish {resp.finish_reason!r}")
                    json.loads(resp.text)
                res["constrained"] = dict(
                    finish=[r.finish_reason for r, _ in outs],
                    tokens=[r.completion_tokens for r, _ in outs],
                    ticks=len(batcher.tick_log["ms"]) - n_ticks,
                    tick_launches=tick_launches)
                check(tick_launches == 0,
                      f"(d) B1 launched {tick_launches} times in the "
                      f"constrained calls' ticks")
                log(f"  (d) constrained: {json.dumps(res['constrained'])}")
        finally:
            tally.remove()
            await side.stop()
    _sync(torch, dev)
    res["launches"] = tatt.flash_attention.launches
    if dev.type == "cuda":
        check(res["serve"]["launches"] > 0,
              "(b) the serve never launched the kernel")
        res["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    params = engine.params
    del side, engine, batcher
    _free(torch, dev)
    res["prefill"] = _moe_prefill_check(torch, tatt, moe_mod, llama_mod,
                                        params, cfg, dev, spec)
    log(f"  (a) prefill B1 vs plain: {json.dumps(res['prefill'])}")
    del params
    _free(torch, dev)
    res["seconds"] = time.perf_counter() - t
    return res


# -- phase 15: tensor and expert parallelism -----------------------------------

# One card holds every shard: the mesh's device list names cuda:0 once a
# shard (the single-controller mesh, parallel/mesh.py). What this shows
# is the sharded path at real widths (B1 at a shard's head count, the
# all-reduces and all-gathers at real sizes, the sharded loader's real
# windows), not a speed-up or a per-card memory saving.
P15 = dict(model=MODEL, serve_depth=CUT_DEPTH, tensor=2,
           prompts=SERVE_PROMPT_TOKENS,
           new=SERVE_NEW_TOKENS, prefill=(32, 512), moe="mixtral-8x7b",
           moe_admit=(32, 512), tiny="tiny-llama", tiny_downgrade=8,
           hf=HF_CONFIG, batching={})
# (a) B1 at one of two tensor shards of llama3-8b's [32, 512] admission.
SHARD_CASE = ("shard_32x512", 32, 512, 512, 16, 4, 128, True, 0, 512, None,
              "bfloat16", "llama3-8b fused admission [32, 512] on one of "
              "two tensor shards (H 16, KVH 4)")
# (b) The [32, 512] prefill at tensor=2 against tensor=1 on the same
# weights. Each row-parallel product is two float32 partials summed and
# rounded once to bf16, as the one unsharded GEMM rounds once; what
# differs is the order of float32 sums (the column-parallel GEMMs take
# other shapes). 32 random bf16 layers amplify any such reordering to
# about 1e-2 relative L2 (phase 9a's hit against cold prefill, phase
# 14's kernel against plain attention), so the bound is relative to a
# witness measured in the same run on the same weights and tokens:
# tensor=1 with its plain attention against tensor=1 with B1. Tensor=2
# may move the logits at most TP_PREFILL_WITNESS times as far; the top-1
# floor catches a fault that moves few logits far.
TP_PREFILL_WITNESS = 2.0
TP_PREFILL_TOP1 = 0.9
# (b) tiny-llama float32 at tensor=2, card against CPU: float32 sums in
# another order only (the llama parity bound of the tests).
TP_TINY_ATOL = 1e-4
# (e) One mixtral layer's FFN at expert=2 x tensor=2 against the
# unsharded one (bf16): the same routing; each expert output is the sum
# of two bf16 partial products over F/2 instead of one over F, so the
# outputs differ by bf16 rounding of the down projection: at most a
# rounding step of the output's magnitude (2^-8), under 1e-2 in
# relative L2.
EP_FFN_REL = 1e-2


def _split_like_engine(torch, cfg, tree, mesh, specs):
    """`tree` split by `specs` over `mesh` as the engine splits it (the
    wqkv head-aligned), leaf by leaf: {path: Sharded or (q, scale)}."""
    from ggrmcp_tpu_torch.models import llama as llama_mod
    from ggrmcp_tpu_torch.ops import quant as tq
    from ggrmcp_tpu_torch.parallel import mesh as mesh_mod
    from ggrmcp_tpu_torch.parallel.collectives import shard

    out = {}
    for key, spec in specs.items():
        group = spec if isinstance(spec, dict) else {key: spec}
        for name, sp in group.items():
            leaf = tree["layers"][name] if isinstance(spec, dict) else (
                tree[name])

            def fn(dim, block, n, name=name):
                return (llama_mod.qkv_columns(cfg, n, block)
                        if name == "wqkv" and dim == 2 else None)

            def cut(t):
                return shard(t, mesh_mod.compatible_spec(sp, t.shape, mesh),
                             mesh, fn)

            out[name] = (tq.QuantizedTensor(q=cut(leaf.q),
                                            scale=cut(leaf.scale))
                         if isinstance(leaf, tq.QuantizedTensor) else cut(leaf))
    return out


def _same_shards(torch, got_tree, want: dict, what: str) -> int:
    """Every part of every leaf of `got_tree` equals `want`'s, bit for
    bit and dtype; returns the parts compared."""
    from ggrmcp_tpu_torch.ops import quant as tq

    n = 0
    flat = dict(got_tree["layers"])
    flat.update({k: v for k, v in got_tree.items() if k != "layers"})
    check(set(flat) == set(want), f"{what}: leaves {sorted(flat)}")
    for name, ref in want.items():
        got = flat[name]
        pairs = ([(got.q, ref.q), (got.scale, ref.scale)]
                 if isinstance(ref, tq.QuantizedTensor) else [(got, ref)])
        for g, r in pairs:
            check(len(g.parts) == len(r.parts), f"{what}: {name} parts")
            for a, b in zip(g.parts, r.parts):
                check(a.dtype == b.dtype and torch.equal(a, b),
                      f"{what}: a shard of {name} differs")
                n += 1
    return n


def _tiny_tp_check(torch, tatt, dev, spec) -> dict:
    """(b) tiny-llama float32 on the card against the same mesh on the
    CPU, same weights: logits, greedy tokens and B1's launches, at
    tensor=2 and at tensor=8, whose 4 KV heads do not split (every
    shard's cache holds them all, a counted downgrade, and each shard
    reads its own group's head through B1)."""
    import numpy as np

    from ggrmcp_tpu_torch.core.config import MeshConfig
    from ggrmcp_tpu_torch.models import llama as llama_mod
    from ggrmcp_tpu_torch.parallel import mesh as mesh_mod
    from ggrmcp_tpu_torch.serving.engine import GenerationEngine

    cfg = llama_mod.CONFIGS[spec["tiny"]]
    cpu = torch.device("cpu")
    params = llama_mod.init_params(cfg, cpu, SEED + 15)
    rng = np.random.default_rng(SEED + 15)
    toks = torch.from_numpy(rng.integers(3, 500, (2, 100)))
    prompts = [rng.integers(3, 500, n).tolist() for n in (7, 33, 90)]
    res = {}
    for t in (spec["tensor"], spec["tiny_downgrade"]):
        engines = [GenerationEngine(
            cfg, params=_to(params, d), mesh=mesh_mod.build_mesh(
                MeshConfig(tensor=t), [d] * t)) for d in (cpu, dev)]
        logits = []
        for eng in engines:
            before = tatt.flash_attention.launches
            with torch.no_grad():
                out, _ = eng.prefill_forward(
                    eng.params, toks.to(eng.device), eng.make_cache(2, 128))
            launches = tatt.flash_attention.launches - before
            logits.append(out.cpu())
        check(dev.type != "cuda" or launches == t * cfg.num_layers,
              f"(b) {cfg.name} tensor={t}: B1 launched {launches} times in "
              f"a prefill forward (want {t} a layer)")
        err = (logits[1] - logits[0]).abs().max().item()
        check(err <= TP_TINY_ATOL, f"(b) {cfg.name} tensor={t} card vs cpu "
              f"logits {err} > {TP_TINY_ATOL}")
        outs = [eng.generate(prompts, 16) for eng in engines]
        check(outs[1] == outs[0], f"(b) {cfg.name} tensor={t} greedy "
              f"tokens card vs cpu differ")
        mesh = engines[1].mesh_stats()
        check((mesh["mesh_spec_downgrades"] > 0)
              == (cfg.num_kv_heads % t != 0),
              f"(b) {cfg.name} tensor={t}: downgrades {mesh}")
        res[f"tensor={t}"] = dict(
            logits_max_abs_err=err, greedy_identical=True, launches=launches,
            mesh=mesh["mesh_shape"],
            downgrades=mesh["mesh_spec_downgrades"])
    return res


async def _tp_serve(torch, tatt, dev, params, mesh, spec, tmp: str,
                    settings: dict = None) -> dict:
    """(c) A sidecar (configured by a `--config` file naming the mesh and
    the serving `settings`) on `params` serves phase 5's burst in one
    admission round, one stream, GetServingStats and GetMemory; returns
    the run's numbers and tokens. The sidecar's engine shards `params`
    in place (and quantizes them, on int8 weights). On a sequence mesh
    each prefill that takes the sp attention must call it once a tensor
    shard a layer, and B1 launches for the rest; on the int8 cache and
    under a stage B1 never launches."""
    import grpc.aio

    from ggrmcp_tpu_torch import __main__ as cli
    from ggrmcp_tpu_torch.parallel import mesh as mesh_mod
    from ggrmcp_tpu_torch.serving.sidecar import Sidecar

    axes = {a: n for a, n in mesh.shape.items() if n > 1}
    label = mesh_mod.mesh_shape_str(mesh)
    path = os.path.join(tmp, f"mesh-{label}.json")
    with open(path, "w") as fh:
        json.dump({"serving": dict(
            model=spec["model"], num_layers=spec.get("serve_depth", 0),
            batching=spec["batching"], mesh={"tensor": 1, **axes},
            **(settings or {}))}, fh)
    serving = cli.serving_config(cli.build_parser().parse_args(
        ["sidecar", "--config", path]))
    side = Sidecar(serving, params=params, mesh=mesh)
    batcher = side.batcher
    vocab = side.generation.cfg.vocab_size

    class _NoTally:
        kind = "admit"

    _moe_ticks(torch, dev, batcher, _NoTally())
    # Count the forwards that reach B1 (prefill-shaped queries), so that
    # the launches are held to t a layer a forward whatever the rounds;
    # on data blocks, a forward counts once a block (one block when the
    # blocks do not divide its batch).
    engine = side.generation
    prefills = [0]
    forward = engine.decode_forward

    def counted(params_, tokens, *args, **kwargs):
        if tokens.shape[1] > tatt.GQA_GROUPED_MAX_SQ:
            prefills[0] += len(mesh_mod.data_blocks(mesh, tokens.shape[0]))
        return forward(params_, tokens, *args, **kwargs)

    engine.decode_forward = counted
    # The prefills that took the sequence-parallel attention, each held to
    # one call a tensor shard a layer.
    sp_forwards = [0]
    prefill_forward = engine.prefill_forward

    def sp_counted(*args, **kwargs):
        before = engine.sp_calls
        out = prefill_forward(*args, **kwargs)
        if engine.sp_calls != before:
            sp_forwards[0] += 1
            check(engine.sp_calls - before == (
                mesh.shape["tensor"] * engine.cfg.num_layers),
                  f"(c) one sp prefill called the sp attention "
                  f"{engine.sp_calls - before} times at {label}")
        return out

    engine.prefill_forward = sp_counted
    texts = [_prompt_text(n, i) for i, n in enumerate(spec["prompts"])]
    tatt.flash_attention.launches = 0
    await side.start(0)
    res: dict = {}
    try:
        async with grpc.aio.insecure_channel(side.target) as ch:
            client = _GrammarClient(ch)
            ctl = _ControlClient(ch)
            batcher.hold_for = len(texts)
            t = time.perf_counter()
            burst = await asyncio.gather(*(
                client.generate(text, spec["new"]) for text in texts))
            wall = time.perf_counter() - t
            burst_launches = tatt.flash_attention.launches
            burst_prefills = prefills[0]
            burst_sp = sp_forwards[0]
            for n, (ids, reason, _) in zip(spec["prompts"], burst):
                check(reason in ("length", "stop") and ids
                      and all(0 <= i < vocab for i in ids),
                      f"(c) prompt of {n} tokens: {reason}, {len(ids)}")
            chunks = await client.stream(client.request(
                _prompt_text(spec["prompts"][4], 1500), spec["new"]))
            check(chunks and chunks[-1].done
                  and chunks[-1].finish_reason in ("length", "stop"),
                  f"(c) the stream ended badly: {chunks[-1:]}")
            stats = await ctl.stats()
            memory = await ctl.memory()
            check(memory.total_bytes + memory.unattributed_bytes
                  == memory.live_bytes, "(c) the ledger does not close")
            tokens = sum(len(ids) for ids, _, _ in burst)
            res = dict(
                tokens_by_prompt=[ids for ids, _, _ in burst],
                wall_s=wall, tok_per_s=tokens / wall,
                tick_ms_p50=_median(batcher.tick_log["ms"]),
                ticks=len(batcher.tick_log["ms"]),
                ttft=_ttft([ms for _, ms in batcher.ttft_ms]),
                ttft_by_prompt={n: ms for n, ms in batcher.ttft_ms[
                    :len(texts)]},
                fused_admissions=batcher.fused_admissions,
                chunked_admissions=batcher.chunked_admissions,
                burst_launches=burst_launches, burst_prefills=burst_prefills,
                burst_sp_prefills=burst_sp, sp_calls=engine.sp_calls,
                admit_rounds=stats.admit_rounds,
                tick_launches=batcher.tick_log["launches"],
                stream_chunks=len(chunks),
                mesh=dict(tp_chips=stats.tp_chips,
                          mesh_devices=stats.mesh_devices,
                          mesh_shape=stats.mesh_shape,
                          mesh_spec_downgrades=stats.mesh_spec_downgrades),
                weights_bytes={c.component: c.bytes
                               for c in memory.components
                               if not c.scope}["weights"],
                kv_arena_bytes=stats.memory_kv_arena_bytes,
                live_bytes=memory.live_bytes,
                unattributed_bytes=memory.unattributed_bytes)
            if dev.type == "cuda":
                res["max_memory_allocated_gb"] = (
                    torch.cuda.max_memory_allocated() / 1e9)
            check(res["fused_admissions"] > 0 and res["chunked_admissions"] > 0,
                  "(c) the burst did not take both admission routes")
    finally:
        await side.stop()
    _sync(torch, dev)
    res["launches"] = tatt.flash_attention.launches
    res["prefills"] = prefills[0]
    res["sp_prefills"] = sp_forwards[0]
    engine.decode_forward = forward
    engine.prefill_forward = prefill_forward
    res["engine"] = engine
    del side, batcher
    layers = engine.cfg.num_layers
    t = mesh.shape["tensor"]
    log(f"  serve at {label}{' ' + json.dumps(settings) if settings else ''}: "
        f"{json.dumps({k: v for k, v in res.items() if k not in ('engine', 'tokens_by_prompt')})}")
    if mesh.shape["stage"] > 1 or engine.kv_dtype:
        # A stage's attention is pinned to the plain path, and so is
        # attention on the int8 cache.
        check(res["launches"] == 0, f"B1 launched {res['launches']} times "
              f"at {label} {settings}")
    else:
        check(dev.type != "cuda" or 0 < res["launches"] == (
            t * layers * res["prefills"]),
              f"(c) B1 launched {res['launches']} times for "
              f"{res['prefills']} prefill forwards at tensor={t} (want {t} "
              f"a layer a forward)")
    return res


def _tp_prefill(torch, engine, toks, use_flash=None):
    """(b) The engine's [B, S] prefill logits (float32); `use_flash`
    False runs its plain attention (the witness)."""
    from ggrmcp_tpu_torch.models import llama as llama_mod

    with torch.no_grad():
        out, _ = llama_mod.forward(
            engine.params, engine.cfg, toks, engine.make_cache(*toks.shape),
            use_flash=engine.use_flash if use_flash is None else use_flash)
    return out


def _rel_top1(torch, got, want) -> tuple[float, float]:
    rel = ((got - want).norm() / want.norm()).item()
    return rel, (got.argmax(-1) == want.argmax(-1)).float().mean().item()


def _tp_loader_check(torch, dev, spec) -> dict:
    """(d) Phase 7's 2-layer llama3-8b-width checkpoint loaded whole and
    sharded at tensor=2: every shard equals the whole load's split bit
    for bit, and the int8 engine's shards the whole quantization's
    split; host RSS of both loads."""
    import tempfile

    from ggrmcp_tpu_torch.core.config import MeshConfig, ServingConfig
    from ggrmcp_tpu_torch.models import llama as llama_mod
    from ggrmcp_tpu_torch.ops import quant as tq
    from ggrmcp_tpu_torch.parallel import mesh as mesh_mod
    from ggrmcp_tpu_torch.serving import weights as weights_mod
    from ggrmcp_tpu_torch.serving.engine import GenerationEngine

    t = spec["tensor"]
    mesh = mesh_mod.build_mesh(MeshConfig(tensor=t), [dev] * t)
    res: dict = {}
    with tempfile.TemporaryDirectory(prefix="hf-tp-") as path:
        write_hf_checkpoint(path, spec["hf"], torch, dev, SEED + 7)
        gc.collect()
        with PeakRss() as rss:
            cfg, whole = weights_mod.load_hf_checkpoint(path, dev)
            _sync(torch, dev)
        res["whole_host_rss_growth_gb"] = (rss.peak - rss.start) / 1e9
        with PeakRss() as rss:
            t0 = time.perf_counter()
            _, sharded = weights_mod.load_hf_checkpoint_sharded(path, mesh)
            _sync(torch, dev)
            res["sharded_load_s"] = time.perf_counter() - t0
        res["sharded_host_rss_growth_gb"] = (rss.peak - rss.start) / 1e9
        res["bytes_read"] = weights_mod.last_load_stats[
            "weight_load_bytes_read"]
    specs = llama_mod.param_specs(cfg)
    res["parts_bitwise"] = _same_shards(
        torch, sharded, _split_like_engine(torch, cfg, whole, mesh, specs),
        "(d) sharded load")
    qwhole = tq.quantize_model(whole)
    del whole
    _free(torch, dev)
    eng = GenerationEngine(cfg, ServingConfig(quantize="int8"),
                           params=sharded, mesh=mesh)
    res["int8_parts_bitwise"] = _same_shards(
        torch, eng.params, _split_like_engine(torch, cfg, qwhole, mesh,
                                              specs), "(d) int8 shards")
    del eng, sharded, qwhole
    _free(torch, dev)
    return res


def _ep_ffn_check(torch, dev, spec) -> dict:
    """(e) One mixtral-8x7b-width layer's FFN at expert=2 x tensor=2 (4
    shards on the card) against the unsharded `moe_ffn` at [32, 512]:
    the sharded call routes once, and its routing equals the unsharded
    call's; relative L2 of the outputs."""
    import dataclasses

    from ggrmcp_tpu_torch.core.config import MeshConfig
    from ggrmcp_tpu_torch.models import common as common_mod
    from ggrmcp_tpu_torch.models import moe as moe_mod
    from ggrmcp_tpu_torch.parallel import mesh as mesh_mod
    from ggrmcp_tpu_torch.serving.engine import GenerationEngine

    cfg = dataclasses.replace(moe_mod.CONFIGS[spec["moe"]], num_layers=1)
    params = moe_mod.init_params(cfg, dev, SEED + 2)
    b, s = spec["moe_admit"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    x = torch.randn((b, s, cfg.hidden_dim), generator=gen, device=dev,
                    dtype=torch.float32).to(cfg.torch_dtype)
    x = common_mod.rms_norm(x, params["layers"]["mlp_norm"][0], cfg.norm_eps)
    seen = []
    real = moe_mod._assign

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append(out)
        return out

    moe_mod._assign = spy
    try:
        with torch.no_grad():
            lp = {k: v[0] for k, v in params["layers"].items()}
            ref, _ = moe_mod.moe_ffn(x, lp, cfg, aux=False)
            del lp
            mesh = mesh_mod.build_mesh(MeshConfig(expert=2, tensor=2),
                                       [dev] * 4)
            eng = GenerationEngine(cfg, params=params, mesh=mesh)
            del params
            _sync(torch, dev)
            out = moe_mod.moe_ffn_sharded([x], eng.params["layers"], 0,
                                          cfg)[0][dev]
            _sync(torch, dev)
    finally:
        moe_mod._assign = real
    with torch.no_grad():
        ms = _device_ms(torch, dev, lambda: moe_mod.moe_ffn_sharded(
            [x], eng.params["layers"], 0, cfg), 3)
    check(len(seen) == 2, f"(e) {len(seen)} routings for two FFN calls")
    (_, _, i0, s0, k0), (_, _, i1, s1, k1) = seen
    same = bool(torch.equal(i0, i1) and torch.equal(s0, s1)
                and torch.equal(k0, k1))
    check(same, "(e) the sharded FFN routed otherwise")
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    check(rel <= EP_FFN_REL, f"(e) EP x TP FFN rel err {rel} > {EP_FFN_REL}")
    res = dict(mesh=eng.mesh_stats(), routing_identical=same,
               pairs=int(k0.numel()), dropped=int((~k0).sum().item()),
               rel_l2=rel, ms=ms)
    del eng, out, ref, x
    _free(torch, dev)
    return res


async def tp_phase(torch, tatt, dev, spec=None) -> dict:
    """Phase 15: (a) B1 at a tensor shard's shape; (b) tiny-llama float32
    at tensor=2 card = CPU, and a [32, 512] llama3-8b prefill at tensor=2
    against tensor=1 from one seeded weight tree; (c) phase 5's burst
    through a sidecar at tensor=1 and then at tensor=2 (two shards on
    the card): B1 launches, the mesh's stats, GetMemory, tick p50, the
    streams counted against tensor=1's; (d) the sharded loader; (e) one
    mixtral layer's FFN at expert=2 x tensor=2."""
    import tempfile

    from ggrmcp_tpu_torch.core.config import MeshConfig
    from ggrmcp_tpu_torch.models import llama as llama_mod
    from ggrmcp_tpu_torch.parallel import mesh as mesh_mod

    spec = spec or P15
    t_phase = time.perf_counter()
    res: dict = {}
    if dev.type == "cuda":
        res["kernel"] = kernel_cases(torch, tatt, dev, [SHARD_CASE])[0]
    res["tiny"] = _tiny_tp_check(torch, tatt, dev, spec)
    log(f"  (b) {spec['tiny']} card vs cpu: "
        f"{json.dumps(res['tiny'])}")

    cfg = _cut(spec["model"], spec["serve_depth"])
    t = spec["tensor"]
    one = mesh_mod.build_mesh(MeshConfig(tensor=1), [dev])
    two = mesh_mod.build_mesh(MeshConfig(tensor=t), [dev] * t)
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    toks = torch.randint(3, cfg.vocab_size, spec["prefill"], generator=gen,
                         device=dev)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        # One seeded whole tree serves both meshes.
        params = llama_mod.init_params(cfg, dev, SEED)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        runs = {}
        runs[1] = await _tp_serve(torch, tatt, dev, params, one, spec, tmp)
        # Held on the host while the tensor=2 sidecar runs, so that its
        # GetMemory reconciles the serving stack alone.
        engine = runs[1].pop("engine")
        want = _tp_prefill(torch, engine, toks)
        witness = _rel_top1(
            torch, _tp_prefill(torch, engine, toks, use_flash=False), want)
        want = want.cpu()
        del engine
        _free(torch, dev)
        # The sidecar shards the tree in place: each whole leaf is freed
        # as soon as its shards exist.
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        runs[t] = await _tp_serve(torch, tatt, dev, params, two, spec, tmp)
        del params
        engine = runs[t].pop("engine")
        got = _tp_prefill(torch, engine, toks)
        del engine
        want = want.to(dev)
    rel, agree = _rel_top1(torch, got, want)
    check(torch.isfinite(got).all().item(), "(b) tensor=2 logits not finite")
    bound = TP_PREFILL_WITNESS * witness[0]
    check(rel <= bound, f"(b) [32, 512] prefill tensor={t} vs 1: rel err "
          f"{rel} > {TP_PREFILL_WITNESS} x the plain-attention witness's "
          f"{witness[0]}")
    check(agree >= TP_PREFILL_TOP1, f"(b) [32, 512] prefill tensor={t} vs "
          f"1: top-1 agreement {agree} < {TP_PREFILL_TOP1}")
    del got, want
    _free(torch, dev)
    res["prefill"] = dict(logits_rel_err=rel, top1_agree=agree,
                          bound=bound, witness_rel_err=witness[0],
                          witness_top1_agree=witness[1])
    log(f"  (b) [32, 512] prefill tensor={t} vs 1: "
        f"{json.dumps(res['prefill'])}")
    a, b = runs[1], runs[t]
    check(b["mesh"] == dict(tp_chips=t, mesh_devices=t,
                            mesh_shape=f"tensor={t}",
                            mesh_spec_downgrades=0),
          f"(c) GetServingStats mesh {b['mesh']}")
    check(a["mesh"]["mesh_shape"] == "single", f"(c) tensor=1 {a['mesh']}")
    check((b["fused_admissions"], b["chunked_admissions"])
          == (a["fused_admissions"], a["chunked_admissions"]),
          "(c) the two runs admitted otherwise")
    # The admission rounds may group the burst otherwise on each side, so
    # B1 is held per prefill forward of each burst: once a shard a layer.
    layers = cfg.num_layers
    for n, run in ((1, a), (t, b)):
        check(0 < run["burst_launches"] == n * layers * run["burst_prefills"],
              f"(c) B1 launched {run['burst_launches']} times in the burst "
              f"at tensor={n} for {run['burst_prefills']} prefill forwards "
              f"(want {n} a layer a forward)")
    res["serve"] = {str(k): {x: y for x, y in v.items()
                             if x != "tokens_by_prompt"}
                    for k, v in runs.items()}
    res["streams"] = _agreement(b["tokens_by_prompt"], a["tokens_by_prompt"])
    res["launches"] = b["launches"]
    log(f"  (c) streams tensor={t} vs 1: {json.dumps(res['streams'])}")
    res["loader"] = _tp_loader_check(torch, dev, spec)
    log(f"  (d) sharded loader: {json.dumps(res['loader'])}")
    res["ep"] = _ep_ffn_check(torch, dev, spec)
    log(f"  (e) EP x TP FFN: {json.dumps(res['ep'])}")
    res["seconds"] = time.perf_counter() - t_phase
    return res


# -- phase 16: the co-launch ---------------------------------------------------

P16 = dict(model=MODEL, prompts=(64, 100, 200, 300, 500, 700, 1000, 1500),
           new=SERVE_NEW_TOKENS, ttft_prompts=(64, 500, 1500), ttft_reps=3,
           hop_calls=200, alone=(100, 1500))
GENERATE_TOOL = "ggrmcp_tpu_generateservice_generate"
INFO_TOOL = "ggrmcp_tpu_modelinfoservice_getmodelinfo"


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mcp(port: int, method: str, params=None, timeout: float = None):
    """One JSON-RPC call to the gateway over urllib: (result, ms); it
    waits until the phase's limit unless given a `timeout`."""
    import urllib.request

    timeout = timeout or phase_left()
    body = {"jsonrpc": "2.0", "method": method, "id": 1}
    if params is not None:
        body["params"] = params
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        data = json.loads(resp.read())
    ms = (time.perf_counter() - t) * 1e3
    check("result" in data, f"{method}: {data}")
    return data["result"], ms


def _mcp_generate(port: int, text: str, max_new: int):
    """(token ids, ms) of a greedy Generate tools/call."""
    result, ms = _mcp(port, "tools/call", {
        "name": GENERATE_TOOL, "arguments": {
            "prompt": text, "maxNewTokens": max_new, "returnTokens": True}})
    check(not result.get("isError"), f"tools/call failed: {result}")
    return json.loads(result["content"][0]["text"])["tokenIds"], ms


def _get(port: int, path: str):
    """GET `path` from the gateway: (status, body text)."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=phase_left()) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def _traced_generate(port: int, text: str, trace_id: str) -> set:
    """One greedy tools/call sent with `X-Trace-Id`, then the names of
    the spans of that trace in the gateway's /debug/traces."""
    import urllib.request

    body = {"jsonrpc": "2.0", "method": "tools/call", "id": 1, "params": {
        "name": GENERATE_TOOL, "arguments": {"prompt": text,
                                             "maxNewTokens": 2}}}
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", "X-Trace-Id": trace_id})
    with urllib.request.urlopen(req, timeout=phase_left()) as resp:
        check("result" in json.loads(resp.read()), "traced tools/call")
    _, text = _get(port, "/debug/traces")
    return {x["name"] for x in json.loads(text)["spans"]
            if x["traceId"] == trace_id}


def _healthy(port: int) -> bool:
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=5) as resp:
            return json.loads(resp.read()).get("status") == "healthy"
    except OSError:
        return False


async def _until(pred, timeout: float, what: str) -> float:
    """Seconds until `pred()` (run in a thread) holds."""
    t = time.perf_counter()
    while not await asyncio.to_thread(pred):
        check(time.perf_counter() - t < timeout, what)
        await asyncio.sleep(0.1)
    return time.perf_counter() - t


async def _direct(target: str, texts, max_new: int, batcher=None):
    """Greedy Generates straight to the sidecar's socket, concurrently:
    [(token ids, ms)]; `batcher` holds the round for the whole burst."""
    import grpc.aio

    if batcher is not None:
        batcher.hold_for = len(texts)
    async with grpc.aio.insecure_channel(target) as ch:
        client = _ReuseClient(ch)
        out = await asyncio.gather(*(client.generate(t, max_new)
                                     for t in texts))
    return [(ids, ms) for ids, _, ms in out]


async def _mcp_burst(port: int, texts, max_new: int, batcher):
    batcher.hold_for = len(texts)
    return await asyncio.gather(*(
        asyncio.to_thread(_mcp_generate, port, t, max_new) for t in texts))


async def _hop(port: int, calls: int) -> dict:
    """`calls` sequential GetModelInfo tools/calls (no model compute)."""
    ms = []
    t = time.perf_counter()
    for _ in range(calls):
        result, one = await asyncio.to_thread(
            _mcp, port, "tools/call", {"name": INFO_TOOL, "arguments": {}})
        check(not result.get("isError"), f"getmodelinfo failed: {result}")
        ms.append(one)
    wall = time.perf_counter() - t
    return dict(calls=calls, calls_per_s=calls / wall, p50_ms=_median(ms),
                max_ms=max(ms))


def _colaunch_factory(torch, dev, serving, params=None):
    """Sidecars of the co-launch: each one's batcher can hold a burst's
    admission round (`hold_for`), so the MCP and the direct bursts are
    admitted alike."""
    from ggrmcp_tpu_torch.serving.sidecar import Sidecar

    def make():
        sidecar = Sidecar(serving(), params=params, seed=SEED, device=dev)
        _hold_admission(sidecar.batcher)
        return sidecar
    return make


# The JAX package: no process of the port's may load or run it.
REFERENCE_PACKAGE = "ggrmcp_tpu"
# The port's CLI with the JAX package made unimportable: every command
# line the smoke starts runs through it (`_port_cli`).
_NO_REFERENCE = (
    "import sys\n"
    "sys.modules['ggrmcp_tpu'] = None\n"
    "from ggrmcp_tpu_torch.__main__ import main\n"
    "sys.exit(main(sys.argv[1:]))\n"
)


def _port_cli(*args: str) -> list[str]:
    """`python -m ggrmcp_tpu_torch ARGS` with `ggrmcp_tpu` unimportable."""
    return [sys.executable, "-c", _NO_REFERENCE, *args]


def _reference_processes() -> dict:
    """Live processes that run a module of the JAX package (`-m
    ggrmcp_tpu...`): pid -> command line."""
    out = {}
    for pid in filter(str.isdigit, os.listdir("/proc")):
        cmd = _cmdline(int(pid))
        if any(a == "-m" and b.split(".")[0] == REFERENCE_PACKAGE
               for a, b in zip(cmd, cmd[1:])):
            out[int(pid)] = cmd
    return out


def _cmdline(pid: int) -> list[str]:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as fh:
            return [a.decode(errors="replace")
                    for a in fh.read().split(b"\0") if a]
    except OSError:
        return []


def _children(pid: int) -> list[int]:
    """The child processes of `pid`, each once. The kernel's lists may
    also name a child's threads, which are no processes (their Tgid is
    another id)."""
    out = set()
    for tid in os.listdir(f"/proc/{pid}/task"):
        try:
            with open(f"/proc/{pid}/task/{tid}/children") as fh:
                out.update(int(c) for c in fh.read().split())
        except OSError:
            continue
    return sorted(c for c in out if _tgid(c) == c)


def _tgid(pid: int):
    try:
        with open(f"/proc/{pid}/status") as fh:
            for line in fh:
                if line.startswith("Tgid:"):
                    return int(line.split()[1])
    except OSError:
        return None


async def _cli_colaunch(torch, dev, spec, want: list, text: str) -> dict:
    """(d) `python3 -m ggrmcp_tpu_torch gateway --tpu --model M
    --http-port P` as one process (`ggrmcp_tpu` unimportable in it):
    seconds to healthy, one tools/call (the in-process run's tokens: the
    same seed, the same card), the socket, no child and no process of
    the JAX package, SIGTERM."""
    import signal
    import tempfile

    port = _free_port()
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryFile() as err:
        t = time.perf_counter()
        proc = subprocess.Popen(
            _port_cli("gateway", "--tpu", "--model", spec["model"],
                      "--http-port", str(port))
            + (["--device", "cpu"] if dev.type == "cpu" else []),
            cwd=here, stdout=subprocess.DEVNULL, stderr=err)
        sock = os.path.join(tempfile.gettempdir(),
                            f"ggrmcp-sidecar-{proc.pid}.sock")
        res: dict = {}
        try:
            def ready():
                if proc.poll() is not None:
                    err.seek(0)
                    raise SmokeError("the CLI co-launch died: " + err.read()
                                     .decode(errors="replace")[-3000:])
                return _healthy(port)
            await _until(ready, phase_left(), "(d) the CLI co-launch never "
                         "healthy")
            res["healthy_s"] = time.perf_counter() - t
            ids, res["call_ms"] = await asyncio.to_thread(
                _mcp_generate, port, text, spec["new"])
            check(ids == want, "(d) the CLI co-launch's tokens differ from "
                  "the in-process co-launch's on the same seed")
            res["socket"] = os.path.exists(sock)
            check(res["socket"], f"(d) no socket at {sock}")
            res["children"] = _children(proc.pid)
            res["reference_processes"] = _reference_processes()
            check(res["children"] == [] and res["reference_processes"] == {},
                  f"(d) the co-launch is not one process of the port: {res}")
        finally:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
            try:
                code = proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                proc.kill()
                code = proc.wait()
        err.seek(0)
        check(code == 0, f"(d) exit {code} on SIGTERM: "
              + err.read().decode(errors="replace")[-2000:])
    res["exit_code"] = code
    res["socket_removed"] = not os.path.exists(sock)
    check(res["socket_removed"], f"(d) SIGTERM left {res}")
    return res


async def colaunch_phase(torch, tatt, dev, spec=None) -> dict:
    """Phase 16: (a) the co-launch in this process (the port's gateway
    and sidecar on this event loop) over a private socket: initialize,
    tools/list, a burst of greedy tools/calls (B1 behind the MCP path;
    tokens equal to the same burst sent straight to the socket), TTFT
    and latency through MCP against gRPC; (b) the hop: GetModelInfo
    tools/calls over the socket, then over a pinned TCP port; (c) a
    sidecar death: restart, the discoverer nudged, time to the first
    good tools/call through the same gateway, tokens against before,
    peak memory; (d) the CLI as one process."""
    import dataclasses

    from ggrmcp_tpu_torch.core.config import Config, ServingConfig
    from ggrmcp_tpu_torch.serving import launcher

    spec = spec or P16
    t_phase = time.perf_counter()
    res: dict = {}
    texts = [_prompt_text(n, 1600 + i) for i, n in enumerate(spec["prompts"])]
    alone = [_prompt_text(n, 1700 + n) for n in spec["alone"]]
    cfg = Config(serving=ServingConfig(model=spec["model"]))
    # The gateway's rate limiter off: (b) makes 200 calls in a row.
    cfg.server.rate_limit.enabled = False
    cfg.server.port = port = _free_port()
    co = launcher.Colaunch(
        cfg, sidecar_factory=_colaunch_factory(torch, dev,
                                               lambda: cfg.serving))
    launcher.resolve_colaunch_transport(cfg)
    sock = cfg.serving.uds_path
    t = time.perf_counter()
    await co.start()
    try:
        res["healthy_s"] = time.perf_counter() - t + await _until(
            lambda: _healthy(port), phase_left(),
            "(a) the gateway never healthy")
        check(co.target == f"unix:{sock}" and os.path.exists(sock),
              f"(a) sidecar target {co.target}")
        init, _ = await asyncio.to_thread(_mcp, port, "initialize", {})
        tools = {x["name"] for x in
                 (await asyncio.to_thread(_mcp, port, "tools/list"))[0]
                 ["tools"]}
        check(GENERATE_TOOL in tools, f"(a) tools/list: {sorted(tools)}")
        res["tools"] = len(tools)
        await asyncio.to_thread(_mcp_generate, port, texts[0], 2)  # warm
        # One process, one tracer: the gateway's span and the sidecar's
        # (the reference's spans) share the call's trace id.
        res["spans"] = sorted(await asyncio.to_thread(
            _traced_generate, port, texts[0], f"smoke-16-{os.getpid()}"))
        check({"gateway.tools/call", "sidecar.generate"} <= set(res["spans"]),
              f"(a) spans of the traced call: {res['spans']}")

        # The main path: a burst of greedy tools/calls in one round. (No
        # local names the batcher: a frame's stale locals could keep the
        # dead sidecar's engine alive across the restart in (c).)
        def routes():
            b = co.sidecar.batcher
            return b.fused_admissions, b.chunked_admissions
        tatt.flash_attention.launches = 0
        fused, chunked = routes()
        t = time.perf_counter()
        mcp = await _mcp_burst(port, texts, spec["new"], co.sidecar.batcher)
        burst_s = time.perf_counter() - t
        res["colaunch_launches"] = tatt.flash_attention.launches
        check(res["colaunch_launches"] > 0 or dev.type == "cpu",
              "(a) B1 never launched behind the MCP burst")
        check(routes()[0] > fused and routes()[1] > chunked,
              "(a) the MCP burst did not take both admission routes")
        direct = await _direct(co.target, texts, spec["new"],
                               co.sidecar.batcher)
        same = [m[0] == d[0] for m, d in zip(mcp, direct)]
        check(all(same), f"(a) MCP tokenIds differ from direct gRPC's "
              f"for {same.count(False)} of {len(same)} prompts")
        for ids, _ in mcp:
            check(1 <= len(ids) <= spec["new"], f"(a) completion {ids}")
        res["burst"] = dict(
            requests=len(texts), identical=sum(same),
            mcp_wall_s=burst_s,
            mcp_latency_p50_ms=_median(ms for _, ms in mcp),
            direct_latency_p50_ms=_median(ms for _, ms in direct),
            tok_per_s=sum(len(ids) for ids, _ in mcp) / burst_s)
        ttft = {"mcp": {}, "direct": {}}
        for n in spec["ttft_prompts"]:
            text = _prompt_text(n, 1800 + n)
            ttft["mcp"][n] = _median([(await asyncio.to_thread(
                _mcp_generate, port, text, 1))[1]
                for _ in range(spec["ttft_reps"])])
            ttft["direct"][n] = _median([(await _direct(co.target, [text], 1))
                                      [0][1]
                                      for _ in range(spec["ttft_reps"])])
        res["ttft_ms"] = ttft
        before = [(await asyncio.to_thread(_mcp_generate, port, x,
                                           spec["new"]))[0] for x in alone]
        log(f"  (a) {json.dumps(res)}")

        res["hop_uds"] = await _hop(port, spec["hop_calls"])
        log(f"  (b) UDS hop: {json.dumps(res['hop_uds'])}")

        # (c) A death: the sidecar's server stops under the gateway.
        held_gb = None
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held_gb = torch.cuda.memory_allocated() / 1e9
        dead = co.sidecar
        t = time.perf_counter()
        await dead.server.stop(None)
        del dead
        await _until(lambda: co.restarts == 1, phase_left(),
                     "(c) the sidecar was never restarted")
        restart_s = time.perf_counter() - t

        # Each attempt's start after the death and its time, to split the
        # recovery into routing again and the new sidecar's first call.
        attempts = []

        def served():
            t0 = time.perf_counter()
            try:
                ids = _mcp_generate(port, alone[0], spec["new"])[0]
            except (OSError, SmokeError):
                ids = None
            attempts.append((t0 - t, time.perf_counter() - t0, ids))
            return ids
        await _until(lambda: served() is not None, phase_left(),
                     "(c) no tools/call succeeded after the restart")
        recover_s = time.perf_counter() - t
        good_at, good_s, _ = attempts[-1]
        after = [(await asyncio.to_thread(_mcp_generate, port, x,
                                          spec["new"]))[0] for x in alone]
        check(after == before, "(c) tokens after the restart differ")
        check(co.gateway is not None, "(c) the gateway stopped")
        res["restart"] = dict(
            restart_s=restart_s, first_good_call_s=recover_s,
            first_good_sent_s=good_at, first_good_call_ms=good_s * 1e3,
            failed_calls=len(attempts) - 1,
            tokens_equal=after == before, restarts=co.restarts,
            allocated_before_gb=held_gb,
            max_memory_allocated_gb=(torch.cuda.max_memory_allocated() / 1e9
                                     if dev.type == "cuda" else None),
            backoff_base_s=cfg.fleet.backoff_base_s)
        if dev.type == "cuda":
            # The dead engine is freed before the replacement is built:
            # the restart never holds two models.
            check(res["restart"]["max_memory_allocated_gb"]
                  <= 1.25 * held_gb, f"(c) peak across the restart "
                  f"{res['restart']}: the dead sidecar was not freed")
        log(f"  (c) {json.dumps(res['restart'])}")
        params = co.sidecar.generation.params
    finally:
        await co.stop()
    check(not os.path.exists(sock) and co.gateway is None,
          "(a) stop left the socket or the gateway")

    # (b) The same hop with the sidecar on a pinned TCP port (the same
    # weights, no second draw).
    tcp = Config(serving=dataclasses.replace(cfg.serving, uds_path="",
                                             port=_free_port()))
    tcp.server.rate_limit.enabled = False
    tcp.server.port = port2 = _free_port()
    co2 = launcher.Colaunch(
        tcp, sidecar_factory=_colaunch_factory(torch, dev,
                                               lambda: tcp.serving, params))
    launcher.resolve_colaunch_transport(tcp)
    check(tcp.serving.uds_path == "", "(b) a pinned port took the UDS")
    await co2.start()
    try:
        await _until(lambda: _healthy(port2), phase_left(), "(b) TCP gateway")
        check(co2.target.startswith("localhost:"), f"(b) {co2.target}")
        res["hop_tcp"] = await _hop(port2, spec["hop_calls"])
    finally:
        await co2.stop()
    log(f"  (b) TCP hop: {json.dumps(res['hop_tcp'])}")
    del params
    _free(torch, dev)

    res["cli"] = await _cli_colaunch(torch, dev, spec, before[0], alone[0])
    log(f"  (d) {json.dumps(res['cli'])}")
    res["seconds"] = time.perf_counter() - t_phase
    return res


# -- phase 17: sequence- and pipeline-parallel serving, plain and composed -----

P17 = dict(model=MODEL, serve_depth=CUT_DEPTH, sp_prefill=(1, 2048),
           sequence=2, stage=2, tensor=2,
           # Phase 5's prompts, 16 new tokens each (the budget).
           prompts=SERVE_PROMPT_TOKENS, new=16,
           # Every sidecar of the phase (stage=1 the baseline of each):
           # a fused admission buckets to at most prefill_chunk, so the
           # burst's fused [8, 1024] forward (8 slots, the burst's size)
           # reaches sp_prefill_min_seq on a sequence mesh; the 1500-
           # and 3000-token prompts take chunked admissions and the
           # 500-token stream a fused one under the threshold (B1 on
           # both).
           batching={"prefill_chunk": 1024, "max_batch_size": 8},
           serving={"sp_prefill_min_seq": 1024},
           tiny="tiny-llama", tiny_meshes=(
               ({"sequence": 2}, {}), ({"sequence": 4}, {}),
               ({"stage": 2}, {}), ({"stage": 4}, {}),
               # (d) the compositions, after one device on the int8
               # cache (the witness of their tolerance).
               ({}, {"kv_cache_dtype": "int8"}),
               ({"sequence": 2}, {"sp_prefill": "ring", "quantize": "int8"}),
               ({"sequence": 2}, {"sp_prefill": "ulysses",
                                  "quantize": "int8"}),
               ({"sequence": 2}, {"sp_prefill": "ulysses",
                                  "kv_cache_dtype": "int8"}),
               ({"tensor": 2, "sequence": 2}, {}),
               ({"tensor": 2, "stage": 2}, {"quantize": "int8"}),
               ({"tensor": 2, "stage": 2}, {"kv_cache_dtype": "int8"})),
           tiny_pool=dict(prefix_cache_entries=4, prefix_cache_min_seq=16,
                          prefix_cache_max_seq=128),
           window_model="mistral-7b", window_prefill=(1, 6144),
           pool=dict(prefix_cache_entries=8, prefix_cache_max_seq=2048))
# (a) The 2048-token prefill at sequence=2 against sequence=1 with B1,
# held to twice a same-run witness (sequence=1 through its plain
# attention against B1), with top-1 agreement >= 0.9: phase 15's rule.
# (f), (g), (h) hold their prefills the same way.
SP_PREFILL_WITNESS = 2.0
SP_PREFILL_TOP1 = 0.9
# (c), (d) tiny-llama float32 on the card against the CPU, same mesh.
PP_TINY_ATOL = 1e-5
# On the int8 cache each forward quantizes its K/V, and the card's
# float32 reordering (about 5e-6) flips an int8 rounding now and then:
# tests/test_torch_quant.py's int8-KV tolerance, the device itself its
# witness (one device, no mesh, card against the CPU).
PP_TINY_INT8_KV_ATOL = 1e-2


def _shallow(params):
    """A tree of the same tensors in new dicts: an engine that shards its
    tree in place leaves the caller's whole."""
    return {k: dict(v) if isinstance(v, dict) else v
            for k, v in params.items()}


def _label_of(axes: dict, serving: dict) -> str:
    return (",".join(f"{a}={n}" for a, n in axes.items()) or "single") + (
        "".join(f" {k}={v}" for k, v in serving.items()))


def _mesh_engine(torch, dev, cfg, params, axes: dict, serving: dict):
    """An engine on the mesh `axes` (every coordinate on `dev`) over a
    shallow copy of `params` (sharded, and quantized on int8 weights, in
    the copy)."""
    from ggrmcp_tpu_torch.core.config import MeshConfig, ServingConfig
    from ggrmcp_tpu_torch.parallel import mesh as mesh_mod
    from ggrmcp_tpu_torch.serving.engine import GenerationEngine

    mcfg = MeshConfig(**{"tensor": 1, **axes})
    n = math.prod(axes.values()) if axes else 1
    return GenerationEngine(cfg, ServingConfig(mesh=mcfg, **serving),
                            params=_shallow(params),
                            mesh=mesh_mod.build_mesh(mcfg, [dev] * n))


def _tiny_sp_pp_check(torch, tatt, dev, spec) -> dict:
    """(c) tiny-llama float32 on sequence and stage meshes and (d) their
    compositions (sp on int8 weights and the int8 cache, tensor x
    sequence, tensor x stage on int8 weights and the int8 cache): the
    card against the CPU (a [2, 128] fresh prefill's logits, greedy
    tokens; the sp attention once a tensor shard a layer). Returns the
    results and the CPU weights."""
    import numpy as np

    from ggrmcp_tpu_torch.models import llama as llama_mod

    cfg = llama_mod.CONFIGS[spec["tiny"]]
    cpu = torch.device("cpu")
    params = llama_mod.init_params(cfg, cpu, SEED + 17)
    rng = np.random.default_rng(SEED + 17)
    toks = torch.from_numpy(rng.integers(3, 500, (2, 128)))
    prompts = [rng.integers(3, 500, n).tolist() for n in (7, 70, 100)]
    res = {}
    for axes, serving in spec["tiny_meshes"]:
        label = _label_of(axes, serving)
        serving = dict(sp_prefill_min_seq=64, **serving)
        engines = [_mesh_engine(torch, d, cfg, _to(params, d), axes, serving)
                   for d in (cpu, dev)]
        sp = "sequence" in axes
        check(bool(engines[1].sp_prefill) == sp
              and engines[1].pp_serving == ("stage" in axes),
              f"(c) {label}: sp {engines[1].sp_prefill!r}, pp "
              f"{engines[1].pp_serving}")
        logits = []
        for eng in engines:
            with torch.no_grad():
                out, _ = eng.prefill_forward(
                    eng.params, toks.to(eng.device), eng.make_cache(2, 128))
            logits.append(out.cpu())
            check(eng.sp_calls == (sp and axes.get("tensor", 1)
                                   * cfg.num_layers),
                  f"(c) {label}: {eng.sp_calls} sp attention calls")
        err = (logits[1] - logits[0]).abs().max().item()
        atol = (PP_TINY_INT8_KV_ATOL if serving.get("kv_cache_dtype")
                else PP_TINY_ATOL)
        check(err <= atol, f"(c) {cfg.name} {label} card vs cpu "
              f"logits {err} > {atol}")
        outs = [eng.generate(prompts, 16) for eng in engines]
        check(outs[1] == outs[0], f"(c) {cfg.name} {label} greedy "
              f"tokens card vs cpu differ")
        res[label] = dict(logits_max_abs_err=err, greedy_identical=True)
    return res, params


async def _tiny_pp_pool(torch, dev, params, spec) -> dict:
    """(d) The prefix pool at stage=2 x tensor=2 on the card and on the
    CPU: a stored prompt, then a hit that extends it; tokens card = CPU,
    one hit each."""
    from ggrmcp_tpu_torch.core.config import BatchingConfig
    from ggrmcp_tpu_torch.models import llama as llama_mod
    from ggrmcp_tpu_torch.ops.sampling import SamplingConfig
    from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher

    cfg = llama_mod.CONFIGS[spec["tiny"]]
    pre = [3 + (i * 13 % 490) for i in range(40)]
    prompts = [pre + [7, 8], pre + [9]]
    out, hits = [], []
    for d in (torch.device("cpu"), dev):
        batcher = ContinuousBatcher(
            _mesh_engine(torch, d, cfg, _to(params, d),
                         {"tensor": 2, "stage": 2}, {}),
            BatchingConfig(max_batch_size=4, prefill_chunk=16,
                           **spec["tiny_pool"]))
        batcher.start()
        got = []
        try:
            for prompt in prompts:
                ids = []
                async for chunk, _ in batcher.submit(prompt, 8,
                                                     SamplingConfig(),
                                                     seed=0):
                    ids.extend(chunk)
                got.append(ids)
        finally:
            await batcher.stop()
        out.append(got)
        hits.append(batcher.prefix_hits)
    check(hits == [1, 1] and out[0] == out[1] and all(out[1]),
          f"(d) the pool at tensor=2,stage=2: hits {hits}, tokens card = "
          f"cpu {out[0] == out[1]}")
    return dict(prefix_hits=hits[1], greedy_identical=True)


def _fresh_prefill(torch, dev, engine, toks, use_flash=None):
    """The engine's fresh prefill of `toks` (`prefill_forward`; with
    `use_flash` given, `llama.forward` with it), run twice: the second's
    logits and ms."""
    from ggrmcp_tpu_torch.models import llama as llama_mod

    out = ms = None
    for _ in range(2):
        out = None
        cache = engine.make_cache(*toks.shape)
        _sync(torch, dev)
        t = time.perf_counter()
        with torch.no_grad():
            if use_flash is not None:
                out, _ = llama_mod.forward(engine.params, engine.cfg, toks,
                                           cache, use_flash=use_flash)
            else:
                out, _ = engine.prefill_forward(engine.params, toks, cache)
        _sync(torch, dev)
        ms = (time.perf_counter() - t) * 1e3
    return out, ms


def _sp_prefill_check(torch, tatt, dev, cfg, params, runs, what: str,
                      spec, serving: dict = None, witness=None) -> dict:
    """A [1, S] fresh prefill (`spec`'s `sp_prefill`, or `window_prefill`
    for a windowed model) through each mesh of `runs` ((name, axes,
    sp mode) each, every shard on the card) against sequence=1 with its
    attention's route (B1 on the model's cache, the plain one on the
    int8 cache), held to twice the witness: sequence=1 through the plain
    attention against B1, from this run unless `witness` (rel err, top-1)
    is given. `serving` sets int8 weights or the int8 cache in every
    engine. Each prefill timed (the second of two); B1's launches in the
    sp runs must be 0, and the sp attention once a tensor shard a layer
    a prefill."""
    serving = dict(spec["serving"], **(serving or {}))
    shape = (spec["window_prefill"] if cfg.sliding_window
             else spec["sp_prefill"])
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    toks = torch.randint(3, cfg.vocab_size, shape, generator=gen, device=dev)
    one = _mesh_engine(torch, dev, cfg, params, {}, serving)
    tatt.flash_attention.launches = 0
    want, b1_ms = _fresh_prefill(torch, dev, one, toks)
    res = dict(shape=list(shape), sequence1_ms=b1_ms,
               sequence1_launches=tatt.flash_attention.launches)
    int8_kv = bool(serving.get("kv_cache_dtype"))
    serving.pop("sp_prefill", None)
    check(res["sequence1_launches"] == (
        0 if int8_kv or dev.type != "cuda" else 2 * cfg.num_layers),
          f"{what} sequence=1 {serving}: B1 launched "
          f"{res['sequence1_launches']} times in two prefills")
    if witness is None:
        plain, res["sequence1_plain_ms"] = _fresh_prefill(
            torch, dev, one, toks, use_flash=False)
        witness = _rel_top1(torch, plain, want)
        del plain
    del one
    res.update(witness_rel_err=witness[0], witness_top1_agree=witness[1],
               bound=SP_PREFILL_WITNESS * witness[0])
    tatt.flash_attention.launches = 0
    for name, axes, mode in runs:
        eng = _mesh_engine(torch, dev, cfg, params, axes,
                           dict(serving, sp_prefill=mode))
        check(eng.sp_prefill == mode, f"{what} sp_prefill {eng.sp_prefill!r}")
        got, ms = _fresh_prefill(torch, dev, eng, toks)
        calls = eng.sp_calls
        del eng
        rel, agree = _rel_top1(torch, got, want)
        del got
        check(calls == 2 * axes.get("tensor", 1) * cfg.num_layers,
              f"{what} {name}: {calls} sp attention calls in two prefills")
        check(rel <= res["bound"], f"{what} {name} {serving} vs sequence=1: "
              f"rel err {rel} > {SP_PREFILL_WITNESS} x the witness's "
              f"{witness[0]}")
        check(agree >= SP_PREFILL_TOP1, f"{what} {name}: top-1 {agree}")
        res[name] = dict(ms=ms, logits_rel_err=rel, top1_agree=agree,
                         sp_calls=calls)
    res["sp_launches"] = tatt.flash_attention.launches
    check(res["sp_launches"] == 0, f"{what}: B1 launched "
          f"{res['sp_launches']} times in the sp prefills")
    del want
    _free(torch, dev)
    return res


async def _pp_pool_wave(torch, tatt, dev, params, mesh, spec, batching: dict,
                        tmp: str) -> dict:
    """(i) Phase 9a's wave through a sidecar on `mesh` configured by a
    `--config` file: one warm request with the 2048-token preamble, then
    WAVE requests with it in one round; the pool's hits, the wave's first
    tokens and TTFT, B1's launches (none under a stage)."""
    import grpc.aio

    from ggrmcp_tpu_torch import __main__ as cli
    from ggrmcp_tpu_torch.parallel import mesh as mesh_mod
    from ggrmcp_tpu_torch.serving.sidecar import Sidecar

    axes = {a: n for a, n in mesh.shape.items() if n > 1}
    path = os.path.join(tmp, "pool.json")
    with open(path, "w") as fh:
        json.dump({"serving": dict(
            model=spec["model"], num_layers=spec["serve_depth"],
            batching=batching, mesh={"tensor": 1, **axes})}, fh)
    side = Sidecar(cli.serving_config(cli.build_parser().parse_args(
        ["sidecar", "--config", path])), params=params, mesh=mesh)
    batcher = side.batcher
    _hold_admission(batcher)
    _ttft_log(batcher)
    preamble = _prompt_text(PREAMBLE_TOKENS, 900)
    tatt.flash_attention.launches = 0
    await side.start(0)
    try:
        async with grpc.aio.insecure_channel(side.target) as ch:
            client = _ReuseClient(ch)
            warm = await client.generate(preamble + _question(25), WAVE_NEW)
            check(warm[1] in ("length", "stop"), f"(i) warm: {warm[1]}")
            before = await client.stats()
            batcher.ttft_ms.clear()
            batcher.hold_for = WAVE
            t = time.perf_counter()
            outs = await asyncio.gather(*(
                client.generate(preamble + _question(i), WAVE_NEW)
                for i in range(WAVE)))
            wave_s = time.perf_counter() - t
            after = await client.stats()
    finally:
        await side.stop()
    for ids, reason, _ in outs:
        check(reason in ("length", "stop") and ids,
              f"(i) a wave request ended {reason!r} with {len(ids)} tokens")
    res = dict(
        mesh=mesh_mod.mesh_shape_str(mesh), wave_s=wave_s,
        tokens=[ids for ids, _, _ in outs],
        ttft=_ttft([ms for _, ms in batcher.ttft_ms]),
        prefix_cache_hits=(after.prefix_cache_hits
                           - before.prefix_cache_hits),
        launches=tatt.flash_attention.launches)
    if dev.type == "cuda":
        res["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del side, batcher
    _free(torch, dev)
    return res


async def sp_pp_phase(torch, tatt, dev, spec=None) -> dict:
    """Phase 17: (c) tiny-llama float32 at sequence 2 and 4 and stage 2
    and 4 and (d) their compositions, card = CPU; (a) a 2048-token
    llama3-8b prefill at sequence=2 through ring and Ulysses against
    sequence=1, (f) the same at tensor=2 x sequence=2 and (h) on int8
    weights and on the int8 cache; then on the same seeded tree, sharded
    in place, sidecars serving phase 5's burst: stage=1 (the baseline),
    (e) sequence=2 ring and Ulysses, (f) tensor=2 x sequence=2, (b)
    stage=2, (i) tensor=2 x stage=2, and stage=1 against stage=2 on int8
    weights and on the int8 cache, and phase 9a's wave through the prefix
    pool at stage=2 against the pool off; (g) the windowed sp prefill at
    mistral-7b's widths."""
    import tempfile

    from ggrmcp_tpu_torch.core.config import MeshConfig
    from ggrmcp_tpu_torch.models import llama as llama_mod
    from ggrmcp_tpu_torch.parallel import mesh as mesh_mod

    spec = spec or P17
    t_phase = time.perf_counter()
    tiny, tiny_params = _tiny_sp_pp_check(torch, tatt, dev, spec)
    tiny["pool"] = await _tiny_pp_pool(torch, dev, tiny_params, spec)
    res: dict = {"tiny": tiny}
    # Each part's seconds, in order.
    marks = {"tiny": time.perf_counter() - t_phase}
    log(f"  (c), (d) {spec['tiny']} card vs cpu: {json.dumps(tiny)}")
    cfg = _cut(spec["model"], spec["serve_depth"])
    params = llama_mod.init_params(cfg, dev, SEED)
    n, t, st = spec["sequence"], spec["tensor"], spec["stage"]
    res["sp"] = _sp_prefill_check(
        torch, tatt, dev, cfg, params,
        [(mode, {"sequence": n}, mode) for mode in ("ring", "ulysses")],
        "(a)", spec)
    log(f"  (a) {json.dumps(res['sp'])}")
    witness = (res["sp"]["witness_rel_err"], res["sp"]["witness_top1_agree"])
    res["sp_tensor"] = _sp_prefill_check(
        torch, tatt, dev, cfg, params,
        [(mode, {"tensor": t, "sequence": n}, mode)
         for mode in ("ring", "ulysses")], "(f)", spec, witness=witness)
    log(f"  (f) tensor={t} x sequence={n}: {json.dumps(res['sp_tensor'])}")
    res["sp_int8"] = {}
    for key, serving in (("int8_weights", {"quantize": "int8"}),
                         ("int8_kv", {"quantize": "int8",
                                      "kv_cache_dtype": "int8"})):
        res["sp_int8"][key] = _sp_prefill_check(
            torch, tatt, dev, cfg, params,
            [(mode, {"sequence": n}, mode) for mode in ("ring", "ulysses")],
            "(h)", spec, serving, witness=witness)
        log(f"  (h) {key}: {json.dumps(res['sp_int8'][key])}")
    marks["prefills"] = time.perf_counter() - t_phase - sum(marks.values())

    def mesh_of(axes):
        k = math.prod(axes.values()) if axes else 1
        return mesh_mod.build_mesh(MeshConfig(**{"tensor": 1, **axes}),
                                   [dev] * k)

    int8w = {"quantize": "int8"}
    int8kv = {"quantize": "int8", "kv_cache_dtype": "int8"}
    # name, mesh axes, serving settings, the run its streams are held to.
    plan = [("single", {}, {}, None)]
    plan += [(f"sequence={n} {m}", {"sequence": n}, {"sp_prefill": m},
              "single") for m in ("ring", "ulysses")]
    plan += [
        (f"tensor={t},sequence={n} ring", {"tensor": t, "sequence": n},
         {"sp_prefill": "ring"}, "single"),
        (f"stage={st}", {"stage": st}, {}, "single"),
        (f"tensor={t},stage={st}", {"tensor": t, "stage": st}, {}, "single"),
        ("single int8_weights", {}, int8w, None),
        (f"stage={st} int8_weights", {"stage": st}, int8w,
         "single int8_weights"),
        ("single int8_kv", {}, int8kv, None),
        (f"stage={st} int8_kv", {"stage": st}, int8kv, "single int8_kv")]
    runs = {}
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        for name, axes, serving, _ in plan:
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            k = math.prod(axes.values()) if axes else 1
            mesh = mesh_mod.build_mesh(MeshConfig(**{"tensor": 1, **axes}),
                                       [dev] * k)
            runs[name] = await _tp_serve(
                torch, tatt, dev, _shallow(params), mesh, spec, tmp,
                dict(spec["serving"], **serving))
            runs[name].pop("engine")
            _free(torch, dev)
        marks["serve"] = time.perf_counter() - t_phase - sum(marks.values())
        pool = {}
        for on in ("on", "off"):
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            pool[on] = await _pp_pool_wave(
                torch, tatt, dev, _shallow(params), mesh_mod.build_mesh(
                    MeshConfig(tensor=1, stage=st), [dev] * st),
                spec, spec["pool"] if on == "on" else {}, tmp)
    del params
    _free(torch, dev)
    marks["pool"] = time.perf_counter() - t_phase - sum(marks.values())

    res["serve"] = {}
    for name, axes, serving, ref in plan:
        run = runs[name]
        check(run["mesh"]["mesh_shape"] == name.split(" ")[0],
              f"GetServingStats mesh {run['mesh']} for {name}")
        if "sequence" in axes:
            check(run["burst_sp_prefills"] >= 1,
                  f"(e) {name}: no admission took the sp attention")
        out = {x: y for x, y in run.items() if x != "tokens_by_prompt"}
        if ref is not None:
            out["streams"] = _agreement(run["tokens_by_prompt"],
                                        runs[ref]["tokens_by_prompt"])
            log(f"  streams {name} vs {ref}: {json.dumps(out['streams'])}")
        res["serve"][name] = out
    pool_on, pool_off = pool["on"], pool["off"]
    check(pool_on["prefix_cache_hits"] >= WAVE,
          f"(i) the wave hit the pool {pool_on['prefix_cache_hits']} times "
          f"at stage={st}, not {WAVE}")
    check(pool_off["prefix_cache_hits"] == 0, "(i) hits with the pool off")
    check(pool_on["launches"] == pool_off["launches"] == 0,
          f"(i) B1 launched under a stage: {pool_on['launches']}, "
          f"{pool_off['launches']}")
    first = _agreement(pool_on.pop("tokens"), pool_off.pop("tokens"))
    check(first["first_token"] == WAVE,
          f"(i) the hits' first tokens against the pool off: {first}")
    res["pool"] = dict(on=pool_on, off=pool_off, agreement=first)
    log(f"  (i) the pool at stage={st}: {json.dumps(res['pool'])}")
    res["pp_launches"] = runs[f"stage={st}"]["launches"]
    res["sp_serve_launches"] = {m: runs[f"sequence={n} {m}"]["launches"]
                                for m in ("ring", "ulysses")}
    res["sp_tensor_serve_launches"] = runs[
        f"tensor={t},sequence={n} ring"]["launches"]

    wcfg = _cut(spec["window_model"], spec["serve_depth"])
    wparams = llama_mod.init_params(wcfg, dev, SEED)
    res["window"] = _sp_prefill_check(
        torch, tatt, dev, wcfg, wparams,
        [(mode, {"sequence": n}, mode) for mode in ("ring", "ulysses")],
        "(g)", spec)
    log(f"  (g) {wcfg.name} window {wcfg.sliding_window}: "
        f"{json.dumps(res['window'])}")
    del wparams
    _free(torch, dev)
    marks["window"] = time.perf_counter() - t_phase - sum(marks.values())
    res["part_seconds"] = marks
    log(f"  part seconds {json.dumps(marks)}")
    res["seconds"] = time.perf_counter() - t_phase
    return res


# -- phase 18: training --------------------------------------------------

P18 = dict(
    model="llama-1b", tiny="tiny-llama", batch=8, seq_len=1024, steps=8,
    resume_to=12, save_every=8, timed_from=3, serve_new=16,
    # (a) B1 under autograd at the training step's attention shape
    # ([8, 1023]: seq_len 1024 less the shifted target), llama-1b heads.
    attn=[("train_8x1023", None, False), ("train_8x1023_window", 256, False),
          ("train_8x1023_ragged", None, True)],
    tiny_meshes=[("tensor", 1), ("tensor", 2), ("stage", 2)],
)
P18_TEXT = ("The quick brown fox jumps over the lazy dog. A port trains on "
            "the card what the reference trained on its chip. ")
# (a) one llama-1b layer's wqkv gradient through B1 against the plain
# attention (bf16 model: the kernel and the plain version round their
# outputs to bf16 differently, the rest of the layer is the same ops).
TRAIN_LAYER_REL = 1e-2
# (b) tiny-llama float32, card against CPU after 3 AdamW steps: losses at
# rtol 1e-4; each leaf elementwise within 1e-4 of its largest entry, save
# at most one entry in 10^4, each of those within one learning rate
# (3e-4) a step (an entry whose gradient sits at summation noise may take
# AdamW's step another way on each device; one such entry of the
# embedding is 7e-5 of its L2 norm, so a norm would measure AdamW).
TRAIN_TINY_REL = 1e-4
TRAIN_LR = 3e-4


def _train_attention(torch, tatt, dev, spec) -> dict:
    """(a) B1 forward under autograd at [8, 1023] (H 32, KVH 8, D 64,
    bf16, causal), windowed and ragged too: output and dq / dk / dv
    against autograd of `flash_attention_ref` at TOL; the causal case
    timed: B1's forward, the backward recompute, the plain forward, SDPA
    forward and forward + backward, with the bounds."""
    import torch.nn.functional as F

    cfg = _llama_cfg(spec["model"])
    b, sq = spec["batch"], spec["seq_len"] - 1
    h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    atol, rtol = TOL["bfloat16"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    res: dict = {"cases": []}
    for name, window, ragged in spec["attn"]:
        q0 = torch.randn((b, sq, h, d), generator=gen, device=dev).bfloat16()
        k0, v0 = (torch.randn((b, sq, kvh, d), generator=gen,
                              device=dev).bfloat16() for _ in range(2))
        dout = torch.randn((b, sq, h, d), generator=gen,
                           device=dev).bfloat16()
        kv_len = (torch.randint(sq // 2, sq + 1, (b,), generator=gen,
                                device=dev, dtype=torch.int32)
                  if ragged else None)
        kw = dict(causal=True, kv_len=kv_len, window=window)
        outs = []
        for fn in (tatt.flash_attention, tatt.flash_attention_ref):
            q, k, v = (t.clone().requires_grad_(True) for t in (q0, k0, v0))
            out = fn(q, k, v, **kw)
            check(out.grad_fn is not None,
                  f"(a) {name}: {fn.__name__} gave no graph")
            out.backward(dout)
            outs.append([out.detach(), q.grad, k.grad, v.grad])
        errs = {}
        for what, got, want in zip(("out", "dq", "dk", "dv"), *outs):
            diff = (got.float() - want.float()).abs()
            excess = (diff - rtol * want.float().abs()).max().item()
            check(excess <= atol and want.abs().max().item() > 0,
                  f"(a) {name} {what}: |err| exceeds {atol} + {rtol}|ref| "
                  f"by {excess - atol}")
            errs[what] = diff.max().item()
        res["cases"].append(dict(name=name, window=window, ragged=ragged,
                                 max_abs_err=errs))
        del outs
        if name != spec["attn"][0][0]:
            continue
        q, k, v = (t.clone().requires_grad_(True) for t in (q0, k0, v0))
        with torch.no_grad():
            fwd = cuda_ms_spread(torch, lambda: tatt.flash_attention(
                q, k, v, **kw))
            plain_ms = cuda_ms(torch, lambda: tatt.flash_attention_ref(
                q, k, v, **kw), 2)
        out = tatt.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.autograd.grad(out, (q, k, v), dout, retain_graph=True)
        recompute_peak = torch.cuda.max_memory_allocated() - base
        bwd = cuda_ms_spread(torch, lambda: torch.autograd.grad(
            out, (q, k, v), dout, retain_graph=True))
        del out
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True)
                      for t in (q0, k0, v0))
        dt = dout.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

        with torch.no_grad():
            lib_fwd = cuda_ms_spread(torch, sdpa)
        lib = cuda_ms_spread(torch, lambda: torch.autograd.grad(
            sdpa(), (qt, kt, vt), dt))
        pairs = b * sq * (sq + 1) // 2
        es = 2
        io = b * sq * h * d + 2 * b * sq * kvh * d  # q, k, v elements
        t_bytes = (es * (io + b * sq * h * d) + 8 * b) / PEAK_BYTES * 1e3
        t_ops = 4.0 * pairs * h * d / PEAK_FLOPS["bfloat16"] * 1e3
        # Forward + backward: q, k, v, dout read, out, dq, dk, dv written;
        # 4 D flops a valid pair forward, 8 D backward (dV, dP, dQ, dK).
        fb_bytes = es * (2 * io + 2 * b * sq * h * d) / PEAK_BYTES * 1e3
        fb_ops = 12.0 * pairs * h * d / PEAK_FLOPS["bfloat16"] * 1e3
        res.update(
            case=name, ms=fwd["ms"], ms_min=fwd["min"], ms_max=fwd["max"],
            backward_ms=bwd["ms"], backward_ms_min=bwd["min"],
            backward_ms_max=bwd["max"], plain_ms=plain_ms,
            library_fwd_ms=lib_fwd["ms"], library_ms=lib["ms"],
            library_ms_min=lib["min"], library_ms_max=lib["max"],
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            fwd_bwd_bound_ms=max(fb_bytes, fb_ops),
            fwd_bwd_bound_by="bytes" if fb_bytes >= fb_ops else "operations",
            recompute_peak_gb=recompute_peak / 1e9)
        del qt, kt, vt
        _free(torch, dev)
    res["max_abs_err"] = max(max(c["max_abs_err"].values())
                             for c in res["cases"])
    return res


def _llama_cfg(name: str):
    from ggrmcp_tpu_torch.models import llama as llama_mod

    return llama_mod.CONFIGS[name]


def _train_layer_check(torch, tatt, dev, spec) -> dict:
    """(a) One llama-1b layer (bf16, seeded): the loss's gradients through
    B1 (one launch, one recompute) against the same layer with the plain
    attention (`flash_attention_ref` through the `attn_impl` hook)."""
    import dataclasses

    from ggrmcp_tpu_torch.models import llama as llama_mod
    from ggrmcp_tpu_torch.models import training

    cfg = dataclasses.replace(_llama_cfg(spec["model"]), num_layers=1)
    params = llama_mod.init_params(cfg, dev, SEED + 18)
    for t in training.stored_tensors(params):
        t.requires_grad_(True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    toks = torch.randint(3, cfg.vocab_size, (spec["batch"], spec["seq_len"]),
                         generator=gen, device=dev)

    def plain(q, k, v, causal=True, window=None):
        return tatt.flash_attention_ref(q, k, v, causal=causal, window=window)

    grads = []
    counts = []
    for impl in (None, plain):
        for t in training.stored_tensors(params):
            t.grad = None
        before = (tatt.flash_attention.launches,
                  tatt.flash_attention.backward_recomputes)
        logits, _ = llama_mod.forward(params, cfg, toks[:, :-1],
                                      attn_impl=impl)
        training.next_token_xent(logits, toks[:, 1:]).backward()
        del logits
        counts.append((tatt.flash_attention.launches - before[0],
                       tatt.flash_attention.backward_recomputes - before[1]))
        grads.append({n: params["layers"][n].grad.float().clone()
                      for n in ("wqkv", "attn_norm")})
    check(counts == [(1, 1), (0, 0)],
          f"(a) one layer: (launches, recomputes) B1 / plain {counts}")
    rel = {}
    for n in grads[0]:
        got, want = grads[0][n], grads[1][n]
        check(got.abs().max().item() > 0, f"(a) {n}.grad is zero through B1")
        rel[n] = ((got - want).norm() / want.norm()).item()
        check(rel[n] <= TRAIN_LAYER_REL, f"(a) {n}.grad through B1 vs plain: "
              f"relative L2 {rel[n]} > {TRAIN_LAYER_REL}")
    del params, grads
    _free(torch, dev)
    return dict(grad_rel_err=rel, bound=TRAIN_LAYER_REL)


def _tiny_train_check(torch, tatt, dev, spec) -> dict:
    """(b) tiny-llama float32: 3 AdamW steps on the card and on the CPU
    from one seeded tree, on each mesh of `spec["tiny_meshes"]` ((axis,
    size) or a dict of axes; every shard of a mesh on the card). B1
    launches once a layer, tensor shard, data block and microbatch."""
    import numpy as np

    from ggrmcp_tpu_torch.core.config import MeshConfig
    from ggrmcp_tpu_torch.models import llama as llama_mod
    from ggrmcp_tpu_torch.models import trainer, training
    from ggrmcp_tpu_torch.parallel import mesh as mesh_mod
    from ggrmcp_tpu_torch.parallel import pipeline

    cfg = _llama_cfg(spec["tiny"])
    cpu = torch.device("cpu")
    whole = llama_mod.init_params(cfg, cpu, SEED + 18)
    rng = np.random.default_rng(SEED + 18)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 65)))
               for _ in range(3)]
    res = {}
    for entry in spec["tiny_meshes"]:
        axes = entry if isinstance(entry, dict) else {entry[0]: entry[1]}
        n = math.prod(axes.values())
        label = ",".join(f"{a}={k}" for a, k in axes.items())
        runs = []
        for d in (cpu, dev):
            mcfg = MeshConfig(**{"tensor": 1, **axes})
            mesh = mesh_mod.build_mesh(mcfg, [d] * n)
            # A copy on either device: training updates its tree in place.
            tree = {k: ({n: t.clone().to(d) for n, t in v.items()}
                        if isinstance(v, dict) else v.clone().to(d))
                    for k, v in whole.items()}
            state = training.make_train_state(tree, cfg, mesh=mesh)
            step = (pipeline.make_pipeline_train_step(cfg, mesh)
                    if axes.get("stage", 1) > 1 else
                    lambda st, t: training.train_step(st, t, cfg))
            tatt.flash_attention.launches = 0
            losses = []
            for batch in batches:
                state, loss = step(state, batch.to(d))
                losses.append(loss.item())
            runs.append((losses, trainer.state_tensors(state, cfg)[0],
                         tatt.flash_attention.launches))
            del state
        (cl, cp, _), (gl, gp, launches) = runs
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
        check(loss_err <= TRAIN_TINY_REL, f"(b) {label}: card losses {gl} "
              f"vs cpu {cl}")
        leaf_rel = leaf_abs = off_frac = 0.0
        for name, want in cp.items():
            diff = (gp[name].cpu() - want).abs()
            off = int((diff > TRAIN_TINY_REL * want.abs().max()).sum())
            off_frac = max(off_frac, off / diff.numel())
            leaf_rel = max(leaf_rel, (diff.norm() / want.norm()).item())
            leaf_abs = max(leaf_abs, diff.max().item())
        check(off_frac <= TRAIN_TINY_REL and leaf_abs <= 3 * TRAIN_LR,
              f"(b) {label}: {off_frac} of a leaf's entries beyond "
              f"{TRAIN_TINY_REL} of its largest, max abs {leaf_abs}")
        # A stage's microbatches (one a stage) each launch once a layer.
        check(dev.type != "cuda" or launches == 3 * cfg.num_layers * n,
              f"(b) {label}: {launches} B1 launches in 3 steps")
        res[label] = dict(loss_rel_err=loss_err, leaf_rel_l2=leaf_rel,
                                  leaf_max_abs=leaf_abs,
                                  leaf_off_fraction=off_frac,
                                  launches=launches, losses=gl)
    return res


_STEP_LINE = re.compile(
    r"step (\d+)/(\d+) loss=(\S+) \(\S+ steps/s, (\S+) ms/step\)")
_SUMMARY = re.compile(
    r"trained steps (\d+)-(\d+): attention kernel launches (\d+), backward "
    r"recomputes (\d+), peak device memory (\S+) GB")


def _train_cli(argv: list, tmp: str, what: str) -> dict:
    """One `python3 -m ggrmcp_tpu_torch train` subprocess (`_port_cli`):
    its step lines, its summary (B1 launches and recomputes of the run,
    peak memory) and its wall time; the log goes to a file under
    `tmp`."""
    here = os.path.dirname(os.path.abspath(__file__))
    log_path = os.path.join(tmp, f"{what}.log")
    t = time.perf_counter()
    with open(log_path, "w") as fh:
        proc = subprocess.run(
            _port_cli("train", *argv), cwd=here, stdout=fh,
            stderr=subprocess.STDOUT, timeout=phase_left())
    seconds = time.perf_counter() - t
    with open(log_path) as fh:
        text = fh.read()
    check(proc.returncode == 0, f"(c) {what}: exit {proc.returncode}; "
          f"{text[-2000:]}")
    steps = [(int(m[1]), float(m[3]), float(m[4]))
             for m in _STEP_LINE.finditer(text)]
    summary = _SUMMARY.search(text)
    check(summary is not None, f"(c) {what}: no summary line")
    return dict(text=text, steps=steps, seconds=seconds,
                launches=int(summary[3]), recomputes=int(summary[4]),
                peak_gb=float(summary[5]))


async def train_phase(torch, tatt, dev, spec=None) -> dict:
    """Phase 18: (a) B1 under autograd at the training shape and one
    llama-1b layer's gradients; (b) tiny-llama card = CPU after 3 AdamW
    steps at tensor 1 and 2 and stage 2; (c) the `train` CLI at llama-1b
    width, P18's steps then a resume to `resume_to`; (d) the trained
    weights served by `serving.checkpoint_path`, an Orbax tree
    refused."""
    import tempfile

    import grpc

    from ggrmcp_tpu_torch.core.config import ServingConfig
    from ggrmcp_tpu_torch.models import llama as llama_mod
    from ggrmcp_tpu_torch.rpc.pb import serving_pb2
    from ggrmcp_tpu_torch.serving import checkpoint
    from ggrmcp_tpu_torch.serving.engine import GenerationEngine
    from ggrmcp_tpu_torch.serving.sidecar import Sidecar

    spec = spec or P18
    t_phase = time.perf_counter()
    res: dict = {"attention": _train_attention(torch, tatt, dev, spec)}
    log(f"  (a) {json.dumps(res['attention'])}")
    res["layer"] = _train_layer_check(torch, tatt, dev, spec)
    log(f"  (a) one layer: {json.dumps(res['layer'])}")
    res["tiny"] = _tiny_train_check(torch, tatt, dev, spec)
    log(f"  (b) {json.dumps(res['tiny'])}")
    cfg = _llama_cfg(spec["model"])
    n_params = llama_mod.num_params(cfg)
    tokens = spec["batch"] * (spec["seq_len"] - 1)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        data = os.path.join(tmp, "corpus.txt")
        with open(data, "w") as fh:
            fh.write(P18_TEXT * 200)
        conf = os.path.join(tmp, "train.json")
        with open(conf, "w") as fh:
            json.dump({"training": {"log_every_steps": 1}}, fh)
        ck = os.path.join(tmp, "ck")
        argv = ["--model", spec["model"], "--batch-size", str(spec["batch"]),
                "--seq-len", str(spec["seq_len"]), "--data", data,
                "--checkpoint-dir", ck, "--save-every",
                str(spec["save_every"]), "--config", conf]
        tatt.flash_attention.launches = 0
        tatt.flash_attention.backward_recomputes = 0
        run = _train_cli(["--steps", str(spec["steps"]), *argv], tmp, "train")
        steps = run.pop("steps")
        check([s for s, _, _ in steps] == list(range(1, spec["steps"] + 1)),
              f"(c) step lines {[s for s, _, _ in steps]}")
        losses = [loss for _, loss, _ in steps]
        check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
              f"(c) losses {losses} not finite and falling")
        per_step = cfg.num_layers * spec["steps"]
        check(run["launches"] == per_step and run["recomputes"] == per_step,
              f"(c) B1 launches {run['launches']}, recomputes "
              f"{run['recomputes']} in {spec['steps']} steps (want "
              f"{cfg.num_layers} a step each)")
        timed = sorted(ms for s, _, ms in steps if s >= spec["timed_from"])
        p50 = timed[len(timed) // 2]
        run.pop("text")
        res["cli"] = dict(
            run, loss_first=losses[0], loss_last=losses[-1], losses=losses,
            step_ms_p50=p50, step_ms_min=timed[0], step_ms_max=timed[-1],
            tokens_per_s=tokens / (p50 / 1e3), n_params=n_params,
            mfu=6 * n_params * tokens / (p50 / 1e3) / PEAK_FLOPS["bfloat16"],
            flops_floor_ms=6 * n_params * tokens / PEAK_FLOPS["bfloat16"]
            * 1e3, launches_per_step=run["launches"] / spec["steps"],
            recomputes_per_step=run["recomputes"] / spec["steps"])
        log(f"  (c) {json.dumps(res['cli'])}")
        resumed = _train_cli(["--steps", str(spec["resume_to"]), *argv], tmp,
                             "resume")
        check(f"resumed from step {spec['steps']}" in resumed["text"],
              "(c) the second run did not resume from step "
              f"{spec['steps']}")
        rsteps = resumed.pop("steps")
        resumed.pop("text")
        check([s for s, _, _ in rsteps] == list(range(spec["steps"] + 1,
                                                     spec["resume_to"] + 1))
              and all(math.isfinite(x) for _, x, _ in rsteps),
              f"(c) resumed steps {rsteps}")
        res["resume"] = dict(resumed, losses=[x for _, x, _ in rsteps])
        log(f"  (c) resume: {json.dumps(res['resume'])}")

        # (d) the trained weights served.
        path = os.path.join(ck, f"step_{spec['resume_to']}", "params")
        prompt = P18_TEXT[:40]
        tok = [1] + [b + 3 for b in prompt.encode()]
        tatt.flash_attention.launches = 0
        sidecar = Sidecar(ServingConfig(model=spec["model"],
                                        checkpoint_path=path), device=dev)
        port = await sidecar.start(0)
        try:
            async with grpc.aio.insecure_channel(f"localhost:{port}") as ch:
                generate = ch.unary_unary(
                    "/ggrmcp.tpu.GenerateService/Generate",
                    request_serializer=serving_pb2.GenerateRequest
                    .SerializeToString,
                    response_deserializer=serving_pb2.GenerateResponse
                    .FromString)
                resp = await generate(serving_pb2.GenerateRequest(
                    prompt=prompt, max_new_tokens=spec["serve_new"],
                    return_tokens=True), timeout=phase_left())
        finally:
            await sidecar.stop()
        served = list(resp.token_ids)
        serve_launches = tatt.flash_attention.launches
        del sidecar
        _free(torch, dev)
        weights = checkpoint.load_params(path, dev, spec["model"])
        ref, _ = GenerationEngine(cfg, params=weights, device=dev).generate(
            [tok], spec["serve_new"], eos_id=2)
        del weights
        check(served == ref[0] and len(served) > 0,
              f"(d) sidecar tokens {served} != engine's {ref[0]}")
        orbax = os.path.join(tmp, "orbax")
        os.makedirs(orbax)
        for marker in ("_CHECKPOINT_METADATA", "manifest.ocdbt"):
            open(os.path.join(orbax, marker), "w").close()
        try:
            Sidecar(ServingConfig(model=spec["model"], checkpoint_path=orbax),
                    device=dev)
            refused = ""
        except ValueError as exc:
            refused = str(exc)
        check("Orbax" in refused, f"(d) an Orbax tree was not refused: "
              f"{refused!r}")
        res["serve"] = dict(tokens=served, launches=serve_launches,
                            refused=refused)
        log(f"  (d) {json.dumps(res['serve'])}")
    _free(torch, dev)
    res["seconds"] = time.perf_counter() - t_phase
    return res


# -- phase 19: the data axes and the routes on a mesh ---------------------------

# Every shard on the one card, as in phases 15 and 17: the mesh's device
# list names cuda:0 once a coordinate. What this shows is each path at
# real widths (B1 at a data block's and a data block x tensor shard's
# shapes, the blocks' caches, the sharded routes), not a speed-up.
P19 = dict(
    model=MODEL, serve_depth=CUT_DEPTH, data=2, prompts=SERVE_PROMPT_TOKENS,
    new=SERVE_NEW_TOKENS, prefill=(32, 512), batching={}, tiny="tiny-llama",
    tiny_moe="tiny-moe",
    tiny_meshes=[dict(data=2), dict(fsdp=2), dict(data=2, tensor=2),
                 dict(data=2, stage=2)],
    embed=EMBED_MODEL, embed_rows=32, embed_longest=512,
    # (e)-(g) at the published widths cut in depth (serving.num_layers).
    depth=4, page=16, lora_rank=8, adapters=("a0", "a1", "a2", "a3"),
    lora_prompts=(40, 100, 200, 300), lora_new=16,
    disagg_prompts=(1024, 2200), disagg_new=16, disagg_arena_pages=512,
    host_arena_pages=320, host_preambles=8, host_preamble_tokens=1024,
    host_new=8, ring_model="mistral-7b", ring_prompts=(5000, 6500),
    ring_new=32, ring_chunk=512, ring_probe=(2, 5120),
    tiers=[[1024, 8], [8192, 2]],
    tier_prompts=(40, 90, 160, 250, 400, 600, 6000, 7000), tier_new=16,
    train="llama-1b", train_steps=4, train_batch=8, train_seq=1024,
    train_tiny_meshes=[dict(data=2), dict(data=2, tensor=2)],
)
# (a) B1 at the shards of llama3-8b's [32, 512] admission on data=2 and
# on data=2 x tensor=2.
DP_CASES = [
    ("dp_16x512", 16, 512, 512, 32, 8, 128, True, 0, 512, None, "bfloat16",
     "llama3-8b fused admission [32, 512] on one of two data blocks "
     "(H 32, KVH 8)"),
    ("dp_tp_16x512", 16, 512, 512, 16, 4, 128, True, 0, 512, None,
     "bfloat16", "llama3-8b fused admission [32, 512] on one data block x "
     "tensor shard of data=2 x tensor=2 (H 16, KVH 4)"),
]
# (g) The ring at tensor=2 against tensor=1: the last chunk's logits of
# a chunked prefill past the window (`ring_probe`), held to twice a
# same-run witness, phase 15's rule with its top-1 floor: tensor=1's
# contiguous cache through B1 against its ring through the plain
# attention, the same function by another valid route.
# (h) llama-1b at data=2 against data=1, bf16, step by step: the weight
# gradients are the blocks' products summed (two bf16 accumulations into
# one `.grad` on the card) where data=1 reduces one product over both
# blocks' rows, so the updates differ by bf16 rounding and the losses
# drift apart (3.4e-4 to 1.4e-3 over 20 steps on an H100). A planted
# fault runs beside it every time: data=1 updated from one data block's
# rows only (a per-block mean over one block; AdamW ignores the
# gradient's scale), its loss read on the whole batch before each step
# (0.106). The bound sits near the two readings' geometric mean, and the
# fault must exceed it.
TRAIN_DP_REL = 1e-2


def _mesh_of(axes: dict, dev):
    from ggrmcp_tpu_torch.core.config import MeshConfig
    from ggrmcp_tpu_torch.parallel import mesh as mesh_mod

    return mesh_mod.build_mesh(MeshConfig(**{"tensor": 1, **axes}),
                               [dev] * math.prod(axes.values() or [1]))


def _label(axes: dict) -> str:
    return ",".join(f"{a}={n}" for a, n in axes.items()) or "single"


def _tiny_dp_check(torch, tatt, dev, spec) -> dict:
    """(b) tiny-llama float32 on the card against the same mesh on the
    CPU, one seeded tree: logits of a [4, 100] prefill, greedy tokens and
    B1's launches (once a layer, data block and tensor shard; none under
    stage) on each data mesh; tiny-moe at data=2 x expert=2 routing pair
    for pair as data=1."""
    import numpy as np

    from ggrmcp_tpu_torch.models import llama as llama_mod
    from ggrmcp_tpu_torch.models import moe as moe_mod
    from ggrmcp_tpu_torch.serving.engine import GenerationEngine

    cfg = llama_mod.CONFIGS[spec["tiny"]]
    cpu = torch.device("cpu")
    params = llama_mod.init_params(cfg, cpu, SEED + 19)
    rng = np.random.default_rng(SEED + 19)
    toks = torch.from_numpy(rng.integers(3, 500, (4, 100)))
    prompts = [rng.integers(3, 500, n).tolist() for n in (7, 33, 90, 12)]
    res = {}
    for axes in spec["tiny_meshes"]:
        label = _label(axes)
        engines = [GenerationEngine(cfg, params=_to(params, d),
                                    mesh=_mesh_of(axes, d))
                   for d in (cpu, dev)]
        logits = []
        for eng in engines:
            before = tatt.flash_attention.launches
            with torch.no_grad():
                out, _ = eng.prefill_forward(
                    eng.params, toks.to(eng.device), eng.make_cache(4, 128))
            launches = tatt.flash_attention.launches - before
            logits.append(out.cpu())
        shards = axes.get("data", 1) * axes.get("fsdp", 1) * axes.get(
            "tensor", 1)
        want = 0 if axes.get("stage", 1) > 1 else shards * cfg.num_layers
        check(dev.type != "cuda" or launches == want,
              f"(b) {label}: B1 launched {launches} times in a prefill "
              f"forward (want {want})")
        err = (logits[1] - logits[0]).abs().max().item()
        check(err <= TP_TINY_ATOL, f"(b) {label} card vs cpu logits {err} "
              f"> {TP_TINY_ATOL}")
        outs = [eng.generate(prompts, 16) for eng in engines]
        check(outs[1] == outs[0], f"(b) {label} greedy tokens card vs cpu "
              f"differ")
        stats = engines[1].mesh_stats()
        check(stats["mesh_shape"] == label, f"(b) {label}: mesh {stats}")
        res[label] = dict(logits_max_abs_err=err, greedy_identical=True,
                          launches=launches, mesh=stats["mesh_shape"])
        del engines
    # tiny-moe: the routing of every layer at data=2 x expert=2 against
    # expert=2 alone, on the card.
    mcfg = moe_mod.CONFIGS[spec["tiny_moe"]]
    mparams = moe_mod.init_params(mcfg, cpu, SEED + 19)
    seen: list = []
    real = moe_mod._assign

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append([t.clone() for t in out[2:]])
        return out

    routes, logits = [], []
    moe_mod._assign = spy
    try:
        for axes in (dict(data=2, expert=2), dict(expert=2)):
            seen.clear()
            eng = GenerationEngine(mcfg, params=_to(mparams, dev),
                                   mesh=_mesh_of(axes, dev))
            with torch.no_grad():
                out, _ = eng.prefill_forward(
                    eng.params, toks.to(dev), eng.make_cache(4, 128))
            routes.append(list(seen))
            logits.append(out.cpu())
            del eng
    finally:
        moe_mod._assign = real
    pairs = sum(int(r[2].sum()) for r in routes[0])
    check(len(routes[0]) == len(routes[1]) == mcfg.num_layers,
          f"(b) {mcfg.name}: {len(routes[0])} routings for "
          f"{mcfg.num_layers} layers")
    check(all(torch.equal(a, b) for ra, rb in zip(*routes)
              for a, b in zip(ra, rb)),
          f"(b) {mcfg.name}: data=2 routed otherwise than data=1")
    err = (logits[0] - logits[1]).abs().max().item()
    check(err <= TP_TINY_ATOL, f"(b) {mcfg.name} data=2 vs 1 logits {err}")
    res["moe"] = dict(pairs_kept=pairs, routing_identical=True,
                      logits_max_abs_err=err)
    return res


async def _dp_serve(torch, tatt, dev, spec, tmp) -> dict:
    """(c) llama3-8b: phase 5's burst through a sidecar configured by a
    `--config` file at data=1 and then at data=2 on one seeded tree (the
    replicated weights used in place: one copy on the card), the [32,
    512] prefill at data=2 against data=1 held to twice a same-run
    witness (data=1's plain attention against its B1), and the streams
    counted against data=1's."""
    from ggrmcp_tpu_torch.models import llama as llama_mod

    cfg = _cut(spec["model"], spec["serve_depth"])
    d = spec["data"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    toks = torch.randint(3, cfg.vocab_size, spec["prefill"], generator=gen,
                         device=dev)
    params = llama_mod.init_params(cfg, dev, SEED)
    runs = {}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    runs[1] = await _tp_serve(torch, tatt, dev, params, _mesh_of({}, dev),
                              spec, tmp)
    engine = runs[1].pop("engine")
    want = _tp_prefill(torch, engine, toks)
    witness = _rel_top1(torch, _tp_prefill(torch, engine, toks,
                                           use_flash=False), want)
    # Held on the host while the data=2 sidecar runs, so that its
    # GetMemory and peak see the serving stack alone.
    want = want.cpu()
    del engine
    _free(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    runs[d] = await _tp_serve(torch, tatt, dev, params,
                              _mesh_of(dict(data=d), dev), spec, tmp)
    del params
    engine = runs[d].pop("engine")
    downgrades = sorted(engine._downgrades_seen)
    before = tatt.flash_attention.launches
    got = _tp_prefill(torch, engine, toks)
    prefill_launches = tatt.flash_attention.launches - before
    del engine
    _free(torch, dev)
    want = want.to(dev)
    rel, agree = _rel_top1(torch, got, want)
    check(torch.isfinite(got).all().item(), "(c) data=2 logits not finite")
    check(dev.type != "cuda"
          or prefill_launches == d * cfg.num_layers,
          f"(c) the [32, 512] prefill at data={d} launched B1 "
          f"{prefill_launches} times (want {d} a layer)")
    bound = TP_PREFILL_WITNESS * witness[0]
    check(rel <= bound, f"(c) [32, 512] prefill data={d} vs 1: rel err "
          f"{rel} > {TP_PREFILL_WITNESS} x the witness's {witness[0]}")
    check(agree >= TP_PREFILL_TOP1, f"(c) [32, 512] prefill data={d}: "
          f"top-1 agreement {agree}")
    a, b = runs[1], runs[d]
    # The one downgrade a data mesh may count: a KV cache whose batch
    # the blocks do not divide (an admission group of an odd row count),
    # as the reference's `_observe_cache_spec` counts it.
    check(b["mesh"] == dict(tp_chips=1, mesh_devices=d,
                            mesh_shape=f"data={d}",
                            mesh_spec_downgrades=len(downgrades))
          and all(dim == 1 for _, dim in downgrades),
          f"(c) GetServingStats mesh {b['mesh']}, downgrades {downgrades}")
    check(b["weights_bytes"] == a["weights_bytes"],
          f"(c) weights counted {b['weights_bytes']} at data={d}, "
          f"{a['weights_bytes']} at data=1")
    for n, run in ((1, a), (d, b)):
        check(dev.type != "cuda" or 0 < run["burst_launches"]
              == cfg.num_layers * run["burst_prefills"],
              f"(c) B1 launched {run['burst_launches']} times in the burst "
              f"at data={n} for {run['burst_prefills']} block prefills")
    streams = _agreement(b["tokens_by_prompt"], a["tokens_by_prompt"])
    return dict(
        prefill=dict(logits_rel_err=rel, top1_agree=agree, bound=bound,
                     witness_rel_err=witness[0],
                     witness_top1_agree=witness[1],
                     launches=prefill_launches),
        serve={str(k): {x: y for x, y in v.items()
                        if x != "tokens_by_prompt"} for k, v in runs.items()},
        streams=streams)


def _dp_embed(torch, tatt, dev, spec, tensor: int = 2) -> dict:
    """(d) bert-base at `tensor` against tensor=1 on one seeded tree:
    the vectors' cosine (phase 6's bound), B1's launches (once a layer
    and shard) and the engine's sharding downgrades."""
    import numpy as np

    from ggrmcp_tpu_torch.models import bert as bert_mod
    from ggrmcp_tpu_torch.serving.engine import EmbeddingEngine

    cfg = bert_mod.CONFIGS[spec["embed"]]
    params = bert_mod.init_params(cfg, dev, SEED)
    rng = np.random.default_rng(SEED + 19)
    lists = [rng.integers(1000, cfg.vocab_size,
                          int(rng.integers(17, spec["embed_longest"] + 1))
                          ).tolist() for _ in range(spec["embed_rows"])]
    lists[0] = lists[0][:1] * spec["embed_longest"]
    out, launches, ms, downgrades = {}, {}, {}, {}
    for t in (1, tensor):
        tree = {k: (dict(v) if isinstance(v, dict) else v)
                for k, v in params.items()}
        eng = EmbeddingEngine(cfg, params=tree,
                              mesh=_mesh_of(dict(tensor=t), dev))
        downgrades[t] = eng.spec_downgrades
        eng.embed(lists[:2])
        _sync(torch, dev)
        before = tatt.flash_attention.launches
        t0 = time.perf_counter()
        out[t] = eng.embed(lists, "mean")
        _sync(torch, dev)
        ms[t] = (time.perf_counter() - t0) * 1e3
        launches[t] = tatt.flash_attention.launches - before
        del eng, tree
    cos = float(np.min(np.sum(out[1] * out[tensor], axis=-1)))
    check(np.isfinite(out[tensor]).all() and cos >= EMBED_MIN_COSINE,
          f"(d) {cfg.name} tensor={tensor} vs 1: min cosine {cos}")
    for t in (1, tensor):
        check(dev.type != "cuda" or launches[t] == t * cfg.num_layers,
              f"(d) {cfg.name} tensor={t}: {launches[t]} B1 launches in an "
              f"Embed of {len(lists)} rows (want {t} a layer)")
    return dict(min_cosine=cos, launches=launches, embed_ms=ms,
                rows=len(lists), downgrades=downgrades)


def _cut(name: str, depth: int):
    import dataclasses

    from ggrmcp_tpu_torch.models import llama as llama_mod

    return dataclasses.replace(llama_mod.CONFIGS[name], num_layers=depth)


def _tree_copy(params):
    return {k: (dict(v) if isinstance(v, dict) else v)
            for k, v in params.items()}


async def _burst(batcher, calls, new, held=True):
    """`calls` of (token ids, submit fields) through a running batcher,
    one admission round when `held`; the token lists."""
    from ggrmcp_tpu_torch.ops.sampling import SamplingConfig

    async def one(ids, fields):
        out = []
        async for chunk, reason in batcher.submit(ids, new, SamplingConfig(),
                                                  **fields):
            out.extend(chunk)
        check(reason in ("length", "stop") and out,
              f"a call ended {reason!r} with {len(out)} tokens")
        return out

    if held:
        batcher.hold_for = len(calls)
    return await asyncio.gather(*(one(ids, f) for ids, f in calls))


async def _lease_fields(batcher, name: str) -> dict:
    if not name:
        return {}
    lease = await batcher.acquire_adapter(name)
    return dict(adapter=lease.row, adapter_key=name, adapter_lease=lease)


async def _dp_lora(torch, tatt, dev, spec, params, cfg, tmp) -> dict:
    """(e) phase 12c's four-adapter burst (a registry of rank-8 adapters
    and a zero-b one, through the arena) at tensor=2 against tensor=1:
    each stream against its adapter served alone on the same engine,
    the zero-b adapter against base, tensor=2 against tensor=1."""
    from ggrmcp_tpu_torch.core.config import (
        BatchingConfig,
        LoraConfig,
        ServingConfig,
    )
    from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher
    from ggrmcp_tpu_torch.serving.engine import GenerationEngine

    registry = os.path.join(tmp, "lora")
    os.makedirs(registry, exist_ok=True)
    _write_adapters(registry, cfg, spec)
    names = list(spec["adapters"]) + ["zero", ""]
    prompts = [_prompt_ids(n, 7100 + i) for i, n in
               enumerate(spec["lora_prompts"] * 2)][:len(names)]
    res, streams = {}, {}
    for t in (1, 2):
        eng = GenerationEngine(cfg, ServingConfig(
            model=spec["model"], num_layers=spec["depth"],
            lora=LoraConfig(registry=registry, rank=spec["lora_rank"],
                            arena_rows=len(names) - 1)),
            params=_tree_copy(params), mesh=_mesh_of(dict(tensor=t), dev))
        batcher = ContinuousBatcher(eng, BatchingConfig(max_batch_size=8))
        _hold_admission(batcher)
        batcher.start()
        try:
            before = tatt.flash_attention.launches
            fields = [await _lease_fields(batcher, n) for n in names]
            burst = await _burst(batcher, list(zip(prompts, fields)),
                                 spec["lora_new"])
            launches = tatt.flash_attention.launches - before
            alone = []
            for ids, n in zip(prompts, names):
                alone += await _burst(
                    batcher, [(ids, await _lease_fields(batcher, n))],
                    spec["lora_new"], held=False)
            base = (await _burst(batcher, [(prompts[4], {})],
                                 spec["lora_new"], held=False))[0]
        finally:
            await batcher.stop()
        agree = _agreement(burst, alone)
        check(agree["first_token"] >= agree["of"] - 1,
              f"(e) tensor={t}: burst vs alone {agree}")
        check(alone[4] == base, f"(e) tensor={t}: the zero-b adapter's "
              f"stream differs from base")
        check(len({tuple(x) for x in alone[:4]}) > 1,
              f"(e) tensor={t}: the adapters gave one stream")
        check(dev.type != "cuda" or launches > 0,
              f"(e) tensor={t}: the burst never launched B1")
        res[f"tensor={t}"] = dict(burst_vs_alone=agree, launches=launches,
                                  zero_b_is_base=True,
                                  lora_loads=eng.lora_stats()["lora_loads"])
        streams[t] = alone
        del eng, batcher
        _free(torch, dev)
    res["tensor2_vs_1"] = _agreement(streams[2], streams[1])
    check(res["tensor2_vs_1"]["first_token"] >= len(names) - 1,
          f"(e) tensor=2 vs 1 {res['tensor2_vs_1']}")
    return res


def _prompt_ids(n: int, seed: int) -> list[int]:
    """`n` token ids of a seeded text (the byte tokenizer's ids)."""
    return list(_prompt_text(n, seed).encode("utf-8"))[:n]


def _p19_sidecar(torch, params, dev, serving: dict, tmp: str, spec: dict,
                 mesh_axes: dict, name: str):
    """`_p12_sidecar` at `spec`'s depth on a mesh of `mesh_axes` (every
    coordinate on the card)."""
    from ggrmcp_tpu_torch import __main__ as cli
    from ggrmcp_tpu_torch.serving.sidecar import Sidecar

    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as fh:
        json.dump({"serving": dict(
            model=spec["model"], num_layers=spec["depth"],
            mesh={"tensor": 1, **mesh_axes}, **serving)}, fh)
    cfg = cli.serving_config(cli.build_parser().parse_args(
        ["sidecar", "--config", path]))
    return Sidecar(cfg, params=_tree_copy(params), mesh=_mesh_of(mesh_axes,
                                                                  dev))


async def _dp_pages(torch, tatt, dev, spec, params, tmp) -> dict:
    """(f) two-leg calls from a prefill sidecar at tensor=2 to a decode
    sidecar at tensor=1 (and a mixed one), then the other way round: the
    pages land in the decode arena as the codec's bytes of the prefill
    side's export, bit for bit, with every KV head; the decode legs'
    first tokens against the mixed sidecar's."""
    import grpc.aio

    page = spec["page"]
    batching = _paged(spec, spec["disagg_arena_pages"])
    res = {}
    for pt, dt in ((2, 1), (1, 2)):
        sides = [_p19_sidecar(torch, params, dev, dict(
            role=role, batching=batching), tmp, spec, dict(tensor=t),
            f"{role}-{pt}{dt}")
            for role, t in (("prefill", pt), ("decode", dt),
                            ("mixed", dt))]
        _log_shipping(torch, dev, sides[0])
        shipped = []
        ship = sides[0]._ship_kv

        async def capture(target, prompt, exported, adapter=""):
            shipped.append((list(prompt), exported))
            return await ship(target, prompt, exported, adapter=adapter)

        sides[0]._ship_kv = capture
        await _start_all(sides)
        chans = [grpc.aio.insecure_channel(s.target) for s in sides]
        try:
            clients = [_P12Client(ch) for ch in chans]
            calls = []
            for n in spec["disagg_prompts"]:
                calls.append(await _disagg_prompt(tatt, clients, sides, n,
                                                  spec, page))
                prompt, exported = shipped[-1]
                decode = sides[1].batcher
                landed = await decode.run_host_op(
                    lambda: decode._gather_pages(
                        decode.pages.chain_pages(prompt)))
                for key in ("k", "v"):
                    check(tuple(exported[key].shape[3:]) == (
                        sides[0].generation.cfg.num_kv_heads,
                        sides[0].generation.cfg.head_dim)
                        and torch.equal(landed[key], exported[key]),
                        f"(f) tensor={pt} to {dt}, {n} tokens: the landed "
                        f"{key} pages differ from the shipped ones")
        finally:
            for ch in chans:
                await ch.close()
            await _stop_all(sides)
        agree = _agreement([c.pop("tokens") for c in calls],
                           [c.pop("mixed_tokens") for c in calls])
        check(agree["first_token"] >= agree["of"] - 1,
              f"(f) tensor={pt} to {dt}: decode vs mixed {agree}")
        res[f"tensor={pt}_to_{dt}"] = dict(calls=calls, agreement=agree,
                                           landed_bitwise=True)
        del sides
        _free(torch, dev)
    res["host_tier"] = await _dp_host_tier(torch, tatt, dev, spec, params)
    return res


async def _dp_host_tier(torch, tatt, dev, spec, params) -> dict:
    """(f) phase 12a's traffic cut in depth: preambles through an arena
    that holds about half of them, twice, with the host tier at tensor=2
    and at tensor=1: demotions in the first pass, restores in the
    second, the streams counted against tensor=1's."""
    from ggrmcp_tpu_torch.core.config import BatchingConfig, ServingConfig
    from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher
    from ggrmcp_tpu_torch.serving.engine import GenerationEngine

    cfg = _paged(spec, spec["host_arena_pages"],
                 paged_kv_host_bytes=4 << 30, max_batch_size=4)
    prompts = [_prompt_ids(spec["host_preamble_tokens"], 3000 + i)
               + _prompt_ids(32, 5000 + 100 * r + i)
               for r in range(2) for i in range(spec["host_preambles"])]
    out, res = {}, {}
    for t in (2, 1):
        eng = GenerationEngine(
            _cut(spec["model"], spec["depth"]),
            ServingConfig(model=spec["model"], num_layers=spec["depth"]),
            params=_tree_copy(params), mesh=_mesh_of(dict(tensor=t), dev))
        batcher = ContinuousBatcher(eng, BatchingConfig(**cfg))
        _hold_admission(batcher)
        batcher.start()
        try:
            outs = []
            for g in range(0, len(prompts), 4):
                outs += await _burst(batcher, [(p, {}) for p in
                                               prompts[g:g + 4]],
                                     spec["host_new"])
            stats = batcher.stats()
        finally:
            await batcher.stop()
        batcher.pages.check_invariants()
        check(stats["kv_host_demotions"] > 0 and stats["kv_host_restores"]
              > 0, f"(f) host tier at tensor={t}: {stats['kv_host_demotions']}"
              f" demotions, {stats['kv_host_restores']} restores")
        out[t] = outs
        res[f"tensor={t}"] = {k: stats[k] for k in _HOST_KEYS}
        del eng, batcher
        _free(torch, dev)
    res["tensor2_vs_1"] = _agreement(out[2], out[1])
    check(res["tensor2_vs_1"]["first_token"] >= len(prompts) - 1,
          f"(f) host tier tensor=2 vs 1: {res['tensor2_vs_1']}")
    return res


async def _dp_ring_tiers(torch, tatt, dev, spec) -> dict:
    """(g) phase 13d/e's traffic at tensor=2 against tensor=1 on
    mistral-7b's widths cut in depth: the ring cache (capacity window +
    chunk - 1) with prompts past the window, which never takes B1, and
    the length tiers with short and long calls together."""
    from ggrmcp_tpu_torch.core.config import BatchingConfig, ServingConfig
    from ggrmcp_tpu_torch.models import llama as llama_mod
    from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher
    from ggrmcp_tpu_torch.serving.engine import GenerationEngine
    from ggrmcp_tpu_torch.serving.tiered import TieredBatcher

    name = spec["ring_model"]
    cfg = _cut(name, spec["depth"])
    params = llama_mod.init_params(cfg, dev, SEED + 13)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    probe = torch.randint(3, cfg.vocab_size, spec["ring_probe"],
                          generator=gen, device=dev)
    res, out, logits = {}, {"ring": {}, "tiers": {}}, {}
    for t in (2, 1):
        mesh = _mesh_of(dict(tensor=t), dev)
        ring = GenerationEngine(cfg, ServingConfig(
            model=name, num_layers=spec["depth"], kv_ring=True,
            batching=BatchingConfig(prefill_chunk=spec["ring_chunk"])),
            params=_tree_copy(params), mesh=mesh)
        batcher = ContinuousBatcher(ring, BatchingConfig(
            max_batch_size=len(spec["ring_prompts"]),
            prefill_chunk=spec["ring_chunk"]))
        _hold_admission(batcher)
        batcher.start()
        try:
            before = tatt.flash_attention.launches
            out["ring"][t] = await _burst(
                batcher, [(_prompt_ids(n, 1300 + n), {})
                          for n in spec["ring_prompts"]], spec["ring_new"])
            launches = tatt.flash_attention.launches - before
        finally:
            await batcher.stop()
        check(launches == 0, f"(g) the ring at tensor={t} launched B1 "
              f"{launches} times")
        check(ring.ring_capacity == cfg.sliding_window
              + spec["ring_chunk"] - 1, f"(g) ring capacity "
              f"{ring.ring_capacity}")
        res[f"ring_tensor={t}"] = dict(launches=launches,
                                       capacity=ring.ring_capacity,
                                       kv_bytes=batcher.cache_bytes())
        logits[t] = _chunked_logits(torch, ring, probe, spec["ring_chunk"],
                                    ring=True)
        if t == 1:
            witness = _rel_top1(torch, _chunked_logits(
                torch, ring, probe, spec["ring_chunk"], ring=False),
                logits[1])
        del ring, batcher
        _free(torch, dev)
        eng = GenerationEngine(cfg, ServingConfig(
            model=name, num_layers=spec["depth"]),
            params=_tree_copy(params), mesh=mesh)
        tiered = TieredBatcher(eng, BatchingConfig(kv_tiers=spec["tiers"],
                                                   max_queue_delay_ms=200.0))
        tiered.start()
        try:
            out["tiers"][t] = await _burst(
                tiered, [(_prompt_ids(n, 1400 + n), {})
                         for n in spec["tier_prompts"]], spec["tier_new"],
                held=False)
            stats = tiered.stats()
        finally:
            await tiered.stop()
        res[f"tiers_tensor={t}"] = dict(mesh=stats["mesh_shape"],
                                        kv_bytes=tiered.cache_bytes())
        del eng, tiered
        _free(torch, dev)
    rel, agree = _rel_top1(torch, logits[2], logits[1])
    bound = TP_PREFILL_WITNESS * witness[0]
    res["ring_logits_tensor2_vs_1"] = dict(
        rel_err=rel, top1_agree=agree, bound=bound,
        witness_rel_err=witness[0], witness_top1_agree=witness[1])
    check(torch.isfinite(logits[2]).all().item(),
          "(g) ring tensor=2 logits not finite")
    check(rel <= bound, f"(g) ring tensor=2 vs 1: rel err {rel} > "
          f"{TP_PREFILL_WITNESS} x the witness's {witness[0]}")
    check(agree >= TP_PREFILL_TOP1,
          f"(g) ring tensor=2 vs 1: top-1 agreement {agree}")
    for key in ("ring", "tiers"):
        agree = _agreement(out[key][2], out[key][1])
        check(agree["first_token"] >= agree["of"] - 1,
              f"(g) {key} tensor=2 vs 1: {agree}")
        res[f"{key}_tensor2_vs_1"] = agree
    return res


def _chunked_logits(torch, engine, toks, chunk: int, ring: bool):
    """(g) The last chunk's float32 logits of `toks` [B, S] prefilled
    `chunk` positions a call into a cache of the engine's ring capacity
    (`ring`) or a contiguous one of S."""
    b, s = toks.shape
    cache = engine.make_cache(b, engine.ring_capacity if ring else s)
    with torch.no_grad():
        for i in range(0, s, chunk):
            out, cache = engine.decode_forward(
                engine.params, toks[:, i:i + chunk], cache, ring=ring)
    return out


def _dp_train(torch, tatt, dev, spec, tmp: str) -> dict:
    """(h) llama-1b: `train_steps` AdamW steps of [batch, seq] on the
    trainer's stream of phase 18's text at data=1 and at data=2 from one
    seeded tree: each step's loss, step p50, tokens/s and peak
    memory."""
    from ggrmcp_tpu_torch.core.config import TrainingConfig
    from ggrmcp_tpu_torch.models import llama as llama_mod
    from ggrmcp_tpu_torch.models import trainer, training

    cfg = llama_mod.CONFIGS[spec["train"]]
    data = os.path.join(tmp, "train.txt")
    with open(data, "w") as fh:
        fh.write(P18_TEXT * 200)
    tcfg = TrainingConfig(model=spec["train"], steps=spec["train_steps"],
                          batch_size=spec["train_batch"],
                          seq_len=spec["train_seq"], seed=SEED,
                          data_path=data)
    runs = {}
    for d in (1, spec["data"]):
        params = llama_mod.init_params(cfg, dev, SEED + 18)
        state = training.make_train_state(
            params, cfg, mesh=_mesh_of(dict(data=d) if d > 1 else {}, dev))
        stream = trainer._data_stream(tcfg, cfg.vocab_size, 0)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        tatt.flash_attention.launches = 0
        losses, ms = [], []
        for _ in range(spec["train_steps"]):
            batch = torch.from_numpy(next(stream)).to(dev)
            _sync(torch, dev)
            t = time.perf_counter()
            state, loss = training.train_step(state, batch, cfg)
            losses.append(loss.item())
            ms.append((time.perf_counter() - t) * 1e3)
        steady = sorted(ms[2:])
        p50 = steady[(len(steady) - 1) // 2]
        runs[d] = dict(
            losses=losses, step_ms_p50=p50,
            tok_per_s=spec["train_batch"] * (spec["train_seq"] - 1)
            / (p50 / 1e3),
            launches=tatt.flash_attention.launches,
            peak_gb=(torch.cuda.max_memory_allocated() / 1e9
                     if dev.type == "cuda" else None))
        check(all(math.isfinite(x) for x in losses),
              f"(h) data={d}: non-finite loss {losses}")
        check(dev.type != "cuda" or runs[d]["launches"]
              == spec["train_steps"] * cfg.num_layers * d,
              f"(h) data={d}: {runs[d]['launches']} B1 launches")
        del state, params
        _free(torch, dev)
    a, b = runs[1]["losses"], runs[spec["data"]]["losses"]
    rel = max(abs(x - y) / abs(y) for x, y in zip(b, a))
    fault = _dp_train_fault(torch, dev, spec, cfg, tcfg)
    fault_rel = max(abs(x - y) / abs(y) for x, y in zip(fault, a))
    log(f"  (h) loss rel data={spec['data']} vs 1 {rel}, one block's rows "
        f"only vs 1 {fault_rel}, bound {TRAIN_DP_REL}")
    check(rel <= TRAIN_DP_REL, f"(h) data={spec['data']} losses {b} vs "
          f"data=1 {a}: rel {rel} > {TRAIN_DP_REL}")
    check(fault_rel > TRAIN_DP_REL, f"(h) the planted fault's losses "
          f"{fault} vs data=1 {a}: rel {fault_rel} <= {TRAIN_DP_REL}, the "
          f"bound cannot fail it")
    res = dict(runs=runs, loss_max_rel=rel, fault_losses=fault,
               fault_loss_max_rel=fault_rel)
    res["tiny"] = _tiny_train_check(torch, tatt, dev, dict(
        tiny=spec["tiny"], tiny_meshes=spec["train_tiny_meshes"]))
    return res


def _dp_train_fault(torch, dev, spec, cfg, tcfg) -> list:
    """(h) The planted fault: data=1 from the same seeded tree and
    stream, each step's update from the first data block's rows only,
    its loss read on the whole batch before the step."""
    from ggrmcp_tpu_torch.models import llama as llama_mod
    from ggrmcp_tpu_torch.models import trainer, training

    state = training.make_train_state(
        llama_mod.init_params(cfg, dev, SEED + 18), cfg,
        mesh=_mesh_of({}, dev))
    stream = trainer._data_stream(tcfg, cfg.vocab_size, 0)
    rows = spec["train_batch"] // spec["data"]
    losses = []
    for _ in range(spec["train_steps"]):
        batch = torch.from_numpy(next(stream)).to(dev)
        with torch.no_grad():
            losses.append(training.lm_loss(state.params, cfg, batch).item())
        state, _ = training.train_step(state, batch[:rows], cfg)
    del state
    _free(torch, dev)
    return losses


async def dp_phase(torch, tatt, dev, spec=None) -> dict:
    """Phase 19: the data axes and the routes once refused on a mesh,
    every shard on the card: (a) B1 at the new shard shapes; (b)
    tiny-llama card = CPU on the data meshes, tiny-moe's routing at
    data=2; (c) llama3-8b's burst at data=2 against data=1; (d) bert-base
    at tensor=2; (e) LoRA, (f) TransferKV across meshes and the host
    tier, (g) the ring and the tiers at tensor=2 (widths cut in depth);
    (h) llama-1b data-parallel training."""
    import tempfile

    from ggrmcp_tpu_torch.models import llama as llama_mod

    spec = spec or P19
    t_phase = time.perf_counter()
    res: dict = {}
    if dev.type == "cuda":
        res["kernels"] = kernel_cases(torch, tatt, dev, DP_CASES)
    res["tiny"] = _tiny_dp_check(torch, tatt, dev, spec)
    log(f"  (b) {json.dumps(res['tiny'])}")
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        t = time.perf_counter()
        res["serve"] = await _dp_serve(torch, tatt, dev, spec, tmp)
        res["serve"]["seconds"] = time.perf_counter() - t
        log(f"  (c) {json.dumps(res['serve'])}")
        _free(torch, dev)
        res["embed"] = _dp_embed(torch, tatt, dev, spec)
        log(f"  (d) {json.dumps(res['embed'])}")
        cfg = _cut(spec["model"], spec["depth"])
        params = llama_mod.init_params(cfg, dev, SEED)
        t = time.perf_counter()
        res["lora"] = await _dp_lora(torch, tatt, dev, spec, params, cfg,
                                     tmp)
        log(f"  (e) {json.dumps(res['lora'])}")
        res["pages"] = await _dp_pages(torch, tatt, dev, spec, params, tmp)
        res["pages"]["seconds"] = time.perf_counter() - t
        log(f"  (f) {json.dumps(res['pages'])}")
        del params
        _free(torch, dev)
        res["ring_tiers"] = await _dp_ring_tiers(torch, tatt, dev, spec)
        log(f"  (g) {json.dumps(res['ring_tiers'])}")
        t = time.perf_counter()
        res["train"] = _dp_train(torch, tatt, dev, spec, tmp)
        res["train"]["seconds"] = time.perf_counter() - t
        log(f"  (h) {json.dumps(res['train'])}")
    res["launches"] = res["serve"]["serve"][str(spec["data"])]["launches"]
    res["seconds"] = time.perf_counter() - t_phase
    return res


# Phase 20: the meshes whose axes do not divide a weight dim or the query
# heads (the leaf replicated and counted; its block held whole on every
# tensor shard and computed once per device), the sequence axis in
# training, and the compile watcher over the kernel build.
P20 = dict(
    model="llama-1b", tensor=3, prefill=(32, 512), prompts=(40, 200, 500,
                                                            1500),
    new=16, embed=EMBED_MODEL, embed_tensor=4, embed_rows=32,
    embed_longest=512, train_steps=2, train_batch=8, train_seq=1024,
    train_meshes=[dict(tensor=3), dict(sequence=2)], watch_depth=2,
)


def _reference_downgrades(cfg, fam, axes: dict) -> int:
    """The (leaf, dim) sites where the reference's `compatible_spec`
    replicates on a mesh of `axes` (a dim its entry's axis product does
    not divide), over the weights and the KV cache's heads: the count
    its `mesh_spec_downgrades` reaches once a cache is built."""
    sizes = {"tensor": 1, **axes}

    def sites(specs, shapes):
        if isinstance(specs, dict):
            return sum(sites(specs[k], shapes[k]) for k in specs)
        n = 0
        for dim, entry in zip(shapes, specs):
            names = (entry if isinstance(entry, tuple)
                     else () if entry is None else (entry,))
            prod = math.prod(sizes.get(a, 1) for a in names)
            n += prod > 1 and dim % prod != 0
        return n

    return (sites(fam.param_specs(cfg), fam.param_shapes(cfg))
            + (cfg.num_kv_heads % sizes["tensor"] != 0))


def _whole_serve(torch, tatt, dev, spec) -> dict:
    """(a) llama-1b at tensor=3, every shard on the card, from one seeded
    tree as tensor=1: 32 heads do not split 3 ways, nor do wo, the FFN or
    the vocabulary, so every block is whole, its storage shared by the
    three coordinates of the card and computed once. The downgrade count
    against the reference's rule, a [32, 512] prefill's logits against
    tensor=1's held to twice a same-run witness (tensor=1's plain
    attention against its B1), B1's launches (once a layer), and greedy
    streams against tensor=1's."""
    from ggrmcp_tpu_torch.models import llama as llama_mod
    from ggrmcp_tpu_torch.models.common import param_bytes
    from ggrmcp_tpu_torch.serving.engine import GenerationEngine

    cfg = llama_mod.CONFIGS[spec["model"]]
    t = spec["tensor"]
    params = llama_mod.init_params(cfg, dev, SEED + 20)
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    toks = torch.randint(3, cfg.vocab_size, spec["prefill"], generator=gen,
                         device=dev)
    prompts = [_prompt_ids(n, i) for i, n in enumerate(spec["prompts"])]
    one = GenerationEngine(cfg, params=_tree_copy(params),
                           mesh=_mesh_of({}, dev))
    want = _tp_prefill(torch, one, toks)
    witness = _rel_top1(torch, _tp_prefill(torch, one, toks,
                                           use_flash=False), want)
    streams_one = one.generate(prompts, spec["new"])[0]
    del one
    _free(torch, dev)
    eng = GenerationEngine(cfg, params=_tree_copy(params),
                           mesh=_mesh_of(dict(tensor=t), dev))
    del params
    whole = sorted(llama_mod.whole_blocks(cfg, t))
    weights_gb = param_bytes(eng.params) / 1e9
    tatt.flash_attention.launches = 0
    got = _tp_prefill(torch, eng, toks)
    launches = tatt.flash_attention.launches
    rel, top1 = _rel_top1(torch, got, want)
    streams = eng.generate(prompts, spec["new"])[0]
    expect = _reference_downgrades(cfg, llama_mod, dict(tensor=t))
    res = dict(whole=whole, downgrades=eng.spec_downgrades,
               reference_downgrades=expect, weights_gb=weights_gb,
               prefill_rel=rel, prefill_top1=top1, bitwise=bool(
                   torch.equal(got, want)),
               witness_rel=witness[0], witness_top1=witness[1],
               prefill_launches=launches,
               first_tokens=sum(a[:1] == b[:1]
                                for a, b in zip(streams, streams_one)),
               whole_streams=sum(a == b for a, b in zip(streams,
                                                        streams_one)),
               streams=len(prompts))
    del eng, got, want
    _free(torch, dev)
    check(whole == ["attn", "ffn", "vocab"],
          f"(a) {cfg.name} at tensor={t}: whole blocks {whole}")
    check(res["downgrades"] == expect,
          f"(a) mesh_spec_downgrades {res['downgrades']}, the reference's "
          f"rule gives {expect}")
    check(math.isfinite(rel) and rel <= TP_PREFILL_WITNESS * witness[0]
          and top1 >= TP_PREFILL_TOP1,
          f"(a) tensor={t} prefill vs tensor=1: rel {rel}, top-1 {top1} "
          f"(witness {witness})")
    check(dev.type != "cuda" or launches == cfg.num_layers,
          f"(a) {launches} B1 launches in a tensor={t} prefill (want "
          f"{cfg.num_layers}: a whole attention block once a layer)")
    check(res["first_tokens"] == len(prompts),
          f"(a) first tokens {res['first_tokens']} of {len(prompts)} equal "
          f"tensor=1's")
    return res


def _whole_train(torch, tatt, dev, spec, tmp: str) -> dict:
    """(c) llama-1b: `train_steps` AdamW steps of [batch, seq] on phase
    18's text at tensor=1, tensor=3 (every block whole) and sequence=2
    (replicated, as the reference's trainer places it) from one seeded
    tree: the losses against tensor=1's (phase 19's bound), B1's
    launches (once a layer a step) and the step time."""
    from ggrmcp_tpu_torch.core.config import TrainingConfig
    from ggrmcp_tpu_torch.models import llama as llama_mod
    from ggrmcp_tpu_torch.models import trainer, training

    cfg = llama_mod.CONFIGS[spec["model"]]
    data = os.path.join(tmp, "train.txt")
    with open(data, "w") as fh:
        fh.write(P18_TEXT * 200)
    tcfg = TrainingConfig(model=spec["model"], steps=spec["train_steps"],
                          batch_size=spec["train_batch"],
                          seq_len=spec["train_seq"], seed=SEED,
                          data_path=data)
    runs = {}
    for axes in [{}] + spec["train_meshes"]:
        state = training.make_train_state(
            llama_mod.init_params(cfg, dev, SEED + 18), cfg,
            mesh=_mesh_of(axes, dev))
        stream = trainer._data_stream(tcfg, cfg.vocab_size, 0)
        tatt.flash_attention.launches = 0
        losses, ms = [], []
        for _ in range(spec["train_steps"]):
            batch = torch.from_numpy(next(stream)).to(dev)
            _sync(torch, dev)
            t = time.perf_counter()
            state, loss = training.train_step(state, batch, cfg)
            losses.append(loss.item())
            ms.append((time.perf_counter() - t) * 1e3)
        runs[_label(axes)] = dict(losses=losses, step_ms=ms,
                                  launches=tatt.flash_attention.launches)
        del state
        _free(torch, dev)
    base = runs["single"]["losses"]
    for label, run in runs.items():
        rel = max(abs(x - y) / abs(y) for x, y in zip(run["losses"], base))
        run["loss_max_rel"] = rel
        check(all(math.isfinite(x) for x in run["losses"])
              and rel <= TRAIN_DP_REL,
              f"(c) {label}: losses {run['losses']} vs tensor=1 {base}")
        check(dev.type != "cuda" or run["launches"]
              == spec["train_steps"] * cfg.num_layers,
              f"(c) {label}: {run['launches']} B1 launches")
    return runs


_WATCH_CODE = r"""
import asyncio, json, sys
sys.path.insert(0, sys.argv[1])
import grpc.aio
import chip_smoke as cs
from ggrmcp_tpu_torch.core.config import ServingConfig
from ggrmcp_tpu_torch.ops import attention as tatt
from ggrmcp_tpu_torch.serving.sidecar import Sidecar


async def main():
    side = Sidecar(ServingConfig(model=sys.argv[2],
                                 num_layers=int(sys.argv[3])),
                   device="cuda:0")
    await side.start(0)
    tatt.flash_attention.launches = 0
    async with grpc.aio.insecure_channel(side.target) as ch:
        client = cs._ControlClient(ch)
        await cs._ctrl_burst(client)
        stats = await client.stats()
        rec = await client.flight()
        mem = await client.memory()
    await side.stop()
    fields = ("compile_count", "compile_ms", "compile_cache_hits",
              "compile_cache_misses", "compile_post_warmup")
    print(json.dumps(dict(
        stats={f: getattr(stats, f) for f in fields},
        memory={f: getattr(mem, f) for f in fields},
        compiles=[dict(fn_name=c.fn_name, duration_ms=c.duration_ms,
                       post_warmup=c.post_warmup) for c in rec.compiles],
        launches=tatt.flash_attention.launches)))


asyncio.run(main())
"""


def _watch_check(spec) -> dict:
    """(d) A sidecar in a fresh process (this one loaded the kernel in
    phase 2, and a process loads a library once): `model` cut to
    `watch_depth` layers, phase 5's burst through gRPC, then
    GetServingStats, GetFlightRecord and GetMemory: the warmup's load of
    B1's library counted (found under its hash after phase 2's build: a
    cache hit), no compile after warmup, the ring naming it."""
    here = os.path.dirname(os.path.abspath(__file__))
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _WATCH_CODE, here, spec["model"],
         str(spec["watch_depth"])],
        capture_output=True, text=True, timeout=600, cwd=here)
    check(proc.returncode == 0, f"(d) the watcher's sidecar exited "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    res["seconds"] = time.perf_counter() - t
    stats = res["stats"]
    check(stats["compile_count"] >= 1 and stats["compile_post_warmup"] == 0
          and stats == res["memory"],
          f"(d) compile fields {stats}, GetMemory {res['memory']}")
    check(any(c["fn_name"] == "flash_attention" for c in res["compiles"])
          and not any(c["post_warmup"] for c in res["compiles"]),
          f"(d) compile ring {res['compiles']}")
    check(res["launches"] > 0, f"(d) the burst launched B1 "
          f"{res['launches']} times")
    return res


async def whole_phase(torch, tatt, dev, spec=None) -> dict:
    """Phase 20: (a) llama-1b at tensor=3, every block whole; (b)
    bert-base at tensor=4 (the embedding replicated and counted); (c)
    llama-1b training at tensor=3 and at sequence=2; (d) the compile
    watcher's fields after a burst."""
    import tempfile

    spec = spec or P20
    t_phase = time.perf_counter()
    res: dict = {}
    t = time.perf_counter()
    res["serve"] = _whole_serve(torch, tatt, dev, spec)
    res["serve"]["seconds"] = time.perf_counter() - t
    log(f"  (a) {json.dumps(res['serve'])}")
    res["embed"] = _dp_embed(torch, tatt, dev, spec, spec["embed_tensor"])
    check(res["embed"]["downgrades"][spec["embed_tensor"]] == 1,
          f"(b) {spec['embed']} at tensor={spec['embed_tensor']}: "
          f"{res['embed']['downgrades']} downgrades (want the embedding's "
          f"one)")
    log(f"  (b) {json.dumps(res['embed'])}")
    _free(torch, dev)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        t = time.perf_counter()
        res["train"] = _whole_train(torch, tatt, dev, spec, tmp)
        res["train_seconds"] = time.perf_counter() - t
    log(f"  (c) {json.dumps(res['train'])}")
    res["watch"] = _watch_check(spec)
    log(f"  (d) {json.dumps(res['watch'])}")
    res["seconds"] = time.perf_counter() - t_phase
    return res


# -- phase 21: the replica fleet --------------------------------------------------

# llama3-8b on int8 weights with 8 slots: a bf16 replica held 26.5 GB
# of the card (PERF.md §6), so two did not fit beside the co-launched
# sidecar; an int8 worker held 15.0-18.0 GB serving (its context and
# allocator cache included), and the sidecar's process and two workers
# 63.5-64.4 GB, so they (max_replicas) do. The SLO (TTFT over 5 s, the histogram's bucket
# above it) holds for (a)-(d)'s traffic (its MCP burst's calls took 3 s
# each) and not for (e)'s burst of 32 calls to one 8-slot worker, whose
# last admissions wait for three rounds of 16 ticks. The flap settings
# are the reference's
# defaults (3 edges in 60 s). The worker's profile comes last: the
# profiler's stop holds the GIL for as long as the capture's kernels
# take to process (seconds on a busy card, scripts/profile_stop_cost.py),
# the supervisor's probe waits as long, and the two edges it counts
# would turn (b)'s process-exit heal into a flap heal.
P21 = dict(model=MODEL, quantize="int8", slots=8,
           prompts=(40, 300, 700, 1500), new=16, burst=8, profile_ms=1500,
           crash_every=32, tiny="tiny-llama", tiny_crash_every=2,
           probe_timeout_ms=2000.0, flap_pause_s=2.5, flap_pauses=4,
           # (e) 32 calls on 8 slots queue four waves deep: the fourth
           # wave's TTFT passes the 5 s SLO only where a wave takes more
           # than 1.7 s. At 16 new tokens a fast card's waves did not
           # (no spawn, the phase at its limit); 48 makes each wave's
           # decode three times as long.
           pressure_calls=32, pressure_new=48, answer_prompts=(0,),
           fleet=dict(enabled=True, min_replicas=1, max_replicas=2,
                      slo_ttft_p99_ms=5000.0, shed_hold_s=0.5,
                      scale_up_sustain_s=1.0,
                      scale_down_sustain_s=3.0, drain_grace_s=2.0,
                      decide_interval_s=0.5, backoff_base_s=0.5,
                      backoff_max_s=2.0, backoff_jitter=0.0,
                      max_actions_per_window=10, action_window_s=10.0))
FLEET_WORKER = "ggrmcp_tpu_torch.serving.fleet"


def _fleet_status(port: int) -> dict:
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/admin/fleet?action=status", data=b"",
        method="POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())["fleet"]


def _worker_pids(gateway: int) -> dict:
    """Live children of the gateway's process: pid -> command line."""
    out = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as fh:
                stat = fh.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{name}/cmdline", "rb") as fh:
                cmd = [a.decode() for a in fh.read().split(b"\0") if a]
        except OSError:
            continue
        if int(stat[1]) == gateway and stat[0] != "Z":
            out[int(name)] = cmd
    return out


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _card_memory(torch) -> dict:
    """The card's free and used GB (every process's), what this process's
    allocator holds, and the compute processes nvidia-smi lists."""
    free, total = torch.cuda.mem_get_info()
    apps = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return dict(free_gb=free / 1e9, used_gb=(total - free) / 1e9,
                reserved_gb=torch.cuda.memory_reserved() / 1e9,
                apps=[a.strip() for a in apps.splitlines() if a.strip()])


class _UsedSampler:
    """The card's used GB every 0.1 s while it runs (a heal's low point:
    the dead worker's memory back before the new one takes its own)."""

    def __init__(self, torch):
        self.torch, self.samples, self._task = torch, [], None

    async def _run(self):
        t = time.perf_counter()
        while True:
            free, total = self.torch.cuda.mem_get_info()
            self.samples.append((time.perf_counter() - t,
                                 (total - free) / 1e9))
            await asyncio.sleep(0.1)

    def __enter__(self):
        self._task = asyncio.ensure_future(self._run())
        return self

    def __exit__(self, *exc):
        self._task.cancel()

    def low(self) -> dict:
        s, gb = min(self.samples, key=lambda x: x[1])
        return dict(min_used_gb=gb, at_s=s, samples=len(self.samples))


class _ProbeSampler:
    """The supervisor's health probe of a replica, a ServerReflection
    ListServices round trip (what the gateway's backend health check
    sends), every 0.1 s on a channel of its own while it runs: the
    round trips' milliseconds by `label` (None for a failed probe), so
    that a probe the supervisor would miss (over its 2 s timeout) is
    seen beside what the worker was doing."""

    def __init__(self, target: str):
        self.target, self.label, self.ms, self._task = target, "", {}, None

    async def _run(self):
        import grpc.aio

        from ggrmcp_tpu_torch.rpc.pb import reflection_pb2

        async with grpc.aio.insecure_channel(self.target) as ch:
            stream = ch.stream_stream(
                "/grpc.reflection.v1alpha.ServerReflection/"
                "ServerReflectionInfo",
                request_serializer=reflection_pb2.ServerReflectionRequest
                .SerializeToString,
                response_deserializer=reflection_pb2.ServerReflectionResponse
                .FromString)
            while True:
                t = time.perf_counter()
                call = stream(timeout=30)
                try:
                    await call.write(reflection_pb2.ServerReflectionRequest(
                        list_services=""))
                    await call.done_writing()
                    await call.read()
                    ms = (time.perf_counter() - t) * 1e3
                except grpc.aio.AioRpcError:
                    ms = None
                finally:
                    call.cancel()
                self.ms.setdefault(self.label, []).append(ms)
                await asyncio.sleep(0.1)

    def __enter__(self):
        self._task = asyncio.ensure_future(self._run())
        return self

    def __exit__(self, *exc):
        self._task.cancel()

    def summary(self) -> dict:
        out = {}
        for label, ms in self.ms.items():
            ok = sorted(m for m in ms if m is not None)
            out[label] = dict(probes=len(ms), failed=len(ms) - len(ok),
                              p50_ms=_median(ok) if ok else None,
                              max_ms=ok[-1] if ok else None,
                              over_2s=sum(m > 2000.0 for m in ok))
        return out


async def _action(port: int, pred, what: str) -> dict:
    """The supervisor's newest action for which `pred` holds, once one
    does."""
    t = time.perf_counter()
    while True:
        st = await asyncio.to_thread(_fleet_status, port)
        hits = [a for a in st["actions"] if pred(a)]
        if hits:
            return hits[0]
        check(time.perf_counter() - t < phase_left(), what)
        await asyncio.sleep(0.2)


async def _serving_replica(port: int, timeout: float, what: str,
                           restarts: int = 0, not_target: str = "") -> dict:
    """/admin/fleet's status once a replica other than `not_target`
    serves and the supervisor has counted `restarts` restarts."""
    def ready():
        try:
            st = _fleet_status(port)
        except OSError:
            return None
        reps = [r for r in st["replicas"]
                if r["state"] == "serving" and r["target"] != not_target]
        return st if reps and st["counters"]["restarts"] >= restarts else None
    t = time.perf_counter()
    while True:
        st = await asyncio.to_thread(ready)
        if st is not None:
            return st
        check(time.perf_counter() - t < timeout, what)
        await asyncio.sleep(0.2)


async def _replica_profile(target: str, texts, new: int, ms: int) -> dict:
    """B1 in the worker: a `torch.profiler` capture of the worker (the
    DebugService Profile RPC) while it answers `texts` in turn until the
    capture ends (the profiler's start-up takes part of the window); the
    trace's B1 kernels counted by name."""
    import grpc.aio

    from ggrmcp_tpu_torch.rpc.pb import serving_pb2

    async with grpc.aio.insecure_channel(target) as ch:
        profile = ch.unary_unary(
            "/ggrmcp.tpu.DebugService/Profile",
            request_serializer=serving_pb2.ProfileRequest.SerializeToString,
            response_deserializer=serving_pb2.ProfileResponse.FromString)
        task = asyncio.ensure_future(profile(serving_pb2.ProfileRequest(
            duration_ms=ms, output_dir="p21-worker"), timeout=120))
        client = _ReuseClient(ch)
        calls = 0
        while not task.done():
            await client.generate(texts[calls % len(texts)], new)
            calls += 1
            await asyncio.sleep(0.2)
        resp = await task
        stats = await client.stats()
    with open(resp.output_path) as fh:
        events = [e for e in json.load(fh).get("traceEvents", [])
                  if e.get("ph") == "X" and e.get("cat") == "kernel"]
    b1 = [e for e in events if "flash_fwd" in e.get("name", "")]
    return dict(trace=resp.output_path, calls=calls, kernels=len(events),
                b1_launches=len(b1), b1_ms=sum(e["dur"] for e in b1) / 1e3,
                compile_count=stats.compile_count,
                compile_cache_hits=stats.compile_cache_hits,
                compile_cache_misses=stats.compile_cache_misses,
                compile_post_warmup=stats.compile_post_warmup)


async def _tiny_crash(spec, dev) -> dict:
    """(c) A standalone worker of `tiny` on `dev` armed with
    replica_crash:every=N: the Nth Generate ends the process with 86."""
    import grpc.aio

    from ggrmcp_tpu_torch.core.config import ServingConfig
    from ggrmcp_tpu_torch.serving import fleet

    env = {**os.environ, **fleet.handshake_environ(
        ServingConfig(model=spec["tiny"]), str(dev), SEED),
        "GGRMCP_FAILPOINTS": f"replica_crash:every={spec['tiny_crash_every']}"}
    here = os.path.dirname(os.path.abspath(__file__))
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", FLEET_WORKER, env=env, cwd=here,
        stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.DEVNULL)
    try:
        line = (await asyncio.wait_for(proc.stdout.readline(), 300)).decode()
        check(line.startswith("TARGET="), f"(c) worker said {line!r}")
        outcomes = []
        async with grpc.aio.insecure_channel(
                line.strip().removeprefix("TARGET=")) as ch:
            client = _ReuseClient(ch)
            for i in range(spec["tiny_crash_every"]):
                try:
                    outcomes.append(len((await client.generate(
                        f"crash {i}", 4))[0]))
                except grpc.aio.AioRpcError as exc:
                    outcomes.append(exc.code().name)
        code = await asyncio.wait_for(proc.wait(), 60)
    finally:
        if proc.returncode is None:
            proc.kill()
            await proc.wait()
    check(code == 86 and isinstance(outcomes[-1], str),
          f"(c) the armed worker exited {code} after {outcomes}")
    return dict(exit_code=code, outcomes=outcomes)


async def fleet_phase(torch, tatt, dev, spec=None) -> dict:
    """Phase 21, every replica and the sidecar on int8 weights: (a) the
    co-launch with `fleet.enabled`: the port's supervisor, in this
    process, spawns the port's worker (its command line, a child of this
    process), lists it in /admin/fleet, each prompt's greedy tokens
    alone from the replica and from the co-launched sidecar are equal
    (one seed), a burst of tools/calls over both with the worker's
    health probes timed, B1 in the worker (a profile of it, taken last,
    its compile watcher); (b) the worker SIGKILLed mid-burst: every call
    typed or complete, the supervisor's process-exit restart, seconds to
    the new replica's first good call, card memory before, during and
    after; (c) the workers armed with replica_crash: one dies at its Nth
    call and is healed, and an armed worker's exit code is 86; (g) that
    heal's replacement paused and resumed in turns (SIGSTOP, SIGCONT):
    healed by flap, seconds to the next good call; (e) a burst past the
    TTFT SLO: a second
    worker spawned, both answering with the sidecar's tokens, the card's
    memory with three processes; (f) idle: one worker retired, its
    memory back, the floor kept; (d) after stop() no worker is left and
    the card's memory has returned."""
    import signal

    import grpc.aio

    from ggrmcp_tpu_torch.core.config import config_from_dict
    from ggrmcp_tpu_torch.models import llama as llama_mod
    from ggrmcp_tpu_torch.serving import launcher
    from ggrmcp_tpu_torch.utils import failpoints  # noqa: F401 — armed now

    spec = spec or P21
    t_phase = time.perf_counter()
    res: dict = {}
    texts = [_prompt_text(n, 2100 + i) for i, n in enumerate(spec["prompts"])]
    port = _free_port()
    cfg = config_from_dict({
        "serving": {"model": spec["model"], "quantize": spec["quantize"],
                    "batching": {"max_batch_size": spec["slots"]}},
        "fleet": spec["fleet"],
        "server": {"port": port, "rate_limit": {"enabled": False}},
    })
    co = launcher.Colaunch(cfg, device=dev, seed=SEED)
    res["memory_before"] = _card_memory(torch)
    # Every worker the supervisor spawns inherits the failpoint (it takes
    # its workers' environment when the gateway starts; this process's
    # registry was armed when it was imported, unarmed).
    os.environ["GGRMCP_FAILPOINTS"] = (
        f"replica_crash:every={spec['crash_every']}")
    t = time.perf_counter()
    # (c)'s standalone armed worker boots beside the fleet's first one.
    standalone = asyncio.ensure_future(_tiny_crash(spec, dev))
    try:
        await co.start()
    finally:
        del os.environ["GGRMCP_FAILPOINTS"]
    pids: set = set()
    try:
        await _until(lambda: _healthy(port), phase_left(),
                     "(a) gateway never healthy")
        status = await _serving_replica(port, phase_left(),
                                        "(a) no replica served")
        res["boot_s"] = time.perf_counter() - t
        crashed = await standalone
        workers = _worker_pids(os.getpid())
        pids |= set(workers)
        check(len(workers) == 1 and all(
            cmd[1:] == ["-m", FLEET_WORKER] for cmd in workers.values()),
            f"(a) the gateway's children {workers}")
        target = status["replicas"][0]["target"]
        res["memory_serving"] = _card_memory(torch)
        log(f"  (a) boot {res['boot_s']:.1f} s, worker {workers}, "
            f"{json.dumps(res['memory_serving'])}")
        # The supervisor's flap edges after each step, and the worker's
        # probe round trips during it.
        edges = {"boot": status["replicas"][0]["flap_edges"]}

        async def edges_after(step: str) -> None:
            st = await asyncio.to_thread(_fleet_status, port)
            edges[step] = st["replicas"][0]["flap_edges"]
        probes = _ProbeSampler(target)
        probes.__enter__()
        probes.label = "alone"

        async def alone(tgt):
            async with grpc.aio.insecure_channel(tgt) as ch:
                client = _ReuseClient(ch)
                return [(await client.generate(x, spec["new"]))[0]
                        for x in texts]
        want = await alone(co.target)
        got = await alone(target)
        check(got == want, "(a) the replica's greedy tokens differ from the "
              "co-launched sidecar's on the same seed")
        res["alone_identical"] = len(texts)
        await edges_after("alone")

        burst = [texts[i % len(texts)] for i in range(spec["burst"])]
        tatt.flash_attention.launches = 0
        probes.label = "burst"
        t = time.perf_counter()
        out = await asyncio.gather(*(
            asyncio.to_thread(_mcp_generate, port, x, spec["new"])
            for x in burst))
        await edges_after("burst")
        res["burst"] = dict(
            calls=len(burst), wall_s=time.perf_counter() - t,
            identical=sum(ids == want[texts.index(x)]
                          for (ids, _), x in zip(out, burst)),
            latency_p50_ms=_median(ms for _, ms in out),
            sidecar_launches=tatt.flash_attention.launches)
        check(all(len(ids) == spec["new"] for ids, _ in out),
              f"(a) burst completions {[len(i) for i, _ in out]}")
        log(f"  (a) {json.dumps(res)}")

        # (b) SIGKILL the worker while a burst is in flight.
        probes.label = "before_kill"
        await asyncio.sleep(1.0)
        probes.__exit__()
        before = await asyncio.to_thread(_fleet_status, port)
        res["probes"] = probes.summary()
        res["flap_edges"] = edges
        log(f"  (a) the worker's probes {json.dumps(res['probes'])}, the "
            f"supervisor's flap edges after each step {json.dumps(edges)}")
        # A worker busy with the burst answers every probe within the
        # supervisor's timeout.
        check(all(p["failed"] == 0 and p["max_ms"] < spec["probe_timeout_ms"]
                  for p in res["probes"].values()),
              f"(a) the worker's probes {res['probes']}")
        (victim,) = _worker_pids(os.getpid())
        (target,) = [r["target"] for r in before["replicas"]]
        calls = [asyncio.ensure_future(asyncio.to_thread(
            _mcp, port, "tools/call", {
                "name": GENERATE_TOOL, "arguments": {
                    "prompt": x, "maxNewTokens": spec["new"],
                    "returnTokens": True}}))
            for x in burst]
        await asyncio.sleep(0.3)
        t = time.perf_counter()
        with _UsedSampler(torch) as sampler:
            os.kill(victim, signal.SIGKILL)
            healed = await _serving_replica(
                port, phase_left(), "(b) never restarted",
                before["counters"]["restarts"] + 1, target)
        during = sampler.low()
        # The adapter kills, then spawns: the dead worker's memory is back
        # before its replacement allocates (a replica holds 16+ GB).
        check(during["min_used_gb"]
              <= res["memory_serving"]["used_gb"] - 10.0,
              f"(b) the card never dropped below {during} during the heal "
              f"from {res['memory_serving']['used_gb']} GB serving")
        (new,) = [r["target"] for r in healed["replicas"]]
        first = None
        while first is None:
            try:
                async with grpc.aio.insecure_channel(new) as ch:
                    first = (await _ReuseClient(ch).generate(
                        texts[0], spec["new"]))[0]
            except grpc.aio.AioRpcError:
                check(phase_left() > 1, "(b) no good call")
                await asyncio.sleep(0.2)
        first_good_s = time.perf_counter() - t
        check(first == want[0], "(b) the new replica's tokens differ")
        results = await asyncio.gather(*calls, return_exceptions=True)
        typed = complete = identical = 0
        for x, r in zip(burst, results):
            if isinstance(r, BaseException):
                check(isinstance(r, (OSError, SmokeError)),
                      f"(b) untyped loss {r!r}")
                typed += 1
                continue
            result, _ = r
            if result.get("isError"):
                typed += 1
                continue
            ids = json.loads(result["content"][0]["text"])["tokenIds"]
            check(len(ids) == spec["new"], f"(b) a short completion {ids}")
            complete += 1
            identical += ids == want[texts.index(x)]
        check(typed + complete == len(burst), "(b) a call was lost")
        restarts = [a for a in healed["actions"]
                    if a["kind"] == "restart" and a["target"] == target]
        check(restarts and "process exited" in restarts[0]["reason"],
              f"(b) action log {healed['actions']}")
        healed_workers = _worker_pids(os.getpid())
        pids |= set(healed_workers)
        check(victim not in healed_workers and len(healed_workers) == 1,
              f"(b) children after the heal {healed_workers}")
        res["kill"] = dict(
            flap_edges_before=before["replicas"][0]["flap_edges"],
            typed=typed, complete=complete, identical=identical,
            restart_action=restarts[0], first_good_call_s=first_good_s,
            memory_during=during, memory_after=_card_memory(torch))
        log(f"  (b) {json.dumps(res['kill'])}")

        # (c) The armed failpoint: the new worker dies at its Nth call.
        (doomed,) = healed_workers
        restarts_before = (await asyncio.to_thread(
            _fleet_status, port))["counters"]["restarts"]
        t = time.perf_counter()
        # Calls straight to the worker until one fails: its count started
        # at its spawn, and (b)'s first good call was one of them.
        outcomes = []
        async with grpc.aio.insecure_channel(new) as ch:
            client = _ReuseClient(ch)
            for i in range(spec["crash_every"]):
                try:
                    outcomes.append(len((await client.generate(
                        f"crash {i}", 2))[0]))
                except grpc.aio.AioRpcError as exc:
                    outcomes.append(exc.code().name)
                    break
        check(isinstance(outcomes[-1], str)
              and all(isinstance(o, int) for o in outcomes[:-1]),
              f"(c) the armed worker's calls {outcomes}")
        await _until(lambda: not _alive(doomed), 60, "(c) still alive")
        healed2 = await _serving_replica(port, phase_left(),
                                         "(c) never healed",
                                         restarts_before + 1, new)
        res["crash"] = dict(
            calls=outcomes, heal_s=time.perf_counter() - t,
            restarts=healed2["counters"]["restarts"])
        # The workers spawned from here on are unarmed: (e)'s burst sends
        # more calls than replica_crash's period.
        del co.gateway._fleet_adapter.factory.env["GGRMCP_FAILPOINTS"]
        res["crash"]["standalone"] = crashed
        log(f"  (c) {json.dumps(res['crash'])}")

        # (g) A flapping worker. The supervisor probes a replica by a
        # reflection round trip, never by the gRPC health service that
        # the health_flap failpoint answers, so the flap is a worker that
        # stops answering, in turns: paused (SIGSTOP) past the probe's
        # timeout, then resumed. The edges reach the threshold and the
        # supervisor heals by flap (a restart in place at the floor);
        # seconds from the first pause to the next good call.
        (flapper,) = _worker_pids(os.getpid())
        pids.add(flapper)
        flapping = healed2["replicas"][0]["target"]
        t = time.perf_counter()
        pauses = 0
        while True:
            st = await asyncio.to_thread(_fleet_status, port)
            heals = [a for a in st["actions"] if a["kind"] == "restart"
                     and a["target"] == flapping]
            if heals or not _alive(flapper):
                break
            check(pauses < spec["flap_pauses"],
                  f"(g) no heal after {pauses} pauses: {st['replicas']}")
            os.kill(flapper, signal.SIGSTOP)
            await asyncio.sleep(spec["flap_pause_s"])
            os.kill(flapper, signal.SIGCONT)
            pauses += 1
            await asyncio.sleep(spec["flap_pause_s"] / 2)
        if _alive(flapper):
            os.kill(flapper, signal.SIGCONT)
        heal = await _action(
            port, lambda a: a["kind"] == "restart"
            and a["target"] == flapping and a["result"],
            "(g) the flapping worker was never replaced")
        check(heal["reason"].startswith("heal: health flapped"),
              f"(g) the restart's reason {heal['reason']!r}")
        healed3 = await _serving_replica(port, phase_left(),
                                         "(g) no replica after the heal",
                                         restarts_before + 2, flapping)
        target = heal["result"]
        async with grpc.aio.insecure_channel(target) as ch:
            check((await _ReuseClient(ch).generate(
                texts[0], spec["new"]))[0] == want[0],
                "(c, g) the healed replica's tokens differ")
        res["flap"] = dict(
            pauses=pauses, pause_s=spec["flap_pause_s"],
            restart_action=heal,
            flap_heals=healed3["counters"]["flap_heals"],
            next_good_call_s=time.perf_counter() - t)
        check(res["flap"]["flap_heals"] >= 1, f"(g) {healed3['counters']}")
        await _until(lambda: not _alive(flapper), 60,
                     "(g) the flapping worker still runs")
        pids |= set(_worker_pids(os.getpid()))
        log(f"  (g) {json.dumps(res['flap'])}")

        # (e) Scale-up: a burst straight to the worker whose TTFT p99
        # passes the SLO, sustained, makes the supervisor spawn a second
        # worker; both answer with the sidecar's tokens.
        res["memory_one_worker"] = _card_memory(torch)
        t = time.perf_counter()
        async with grpc.aio.insecure_channel(target) as ch:
            client = _ReuseClient(ch)
            burst = asyncio.ensure_future(asyncio.gather(*(
                client.generate(texts[i % len(texts)], spec["pressure_new"])
                for i in range(spec["pressure_calls"]))))
            status = await _serving_replica(
                port, phase_left(), "(e) no second worker served", 0, target)
            res["scale_up"] = dict(spawn_s=time.perf_counter() - t)
            out = await burst
        check(all(len(ids) == spec["pressure_new"] for ids, _, _ in out),
              "(e) a burst call ended short")
        workers = _worker_pids(os.getpid())
        pids |= set(workers)
        targets = sorted(r["target"] for r in status["replicas"])
        check(len(workers) == 2 and len(targets) == 2,
              f"(e) workers {workers}, replicas {status['replicas']}")
        res["memory_two_workers"] = _card_memory(torch)
        spawned = [a for a in status["actions"] if a["kind"] == "spawn"
                   and a["reason"].startswith("sustained")]
        check(spawned, f"(e) action log {status['actions']}")
        # The burst's calls are past the window; the calls below give
        # each replica a window under the SLO.
        await asyncio.sleep(2.5)
        for tgt in targets:
            async with grpc.aio.insecure_channel(tgt) as ch:
                client = _ReuseClient(ch)
                got = [(await client.generate(texts[i], spec["new"]))[0]
                       for i in spec["answer_prompts"]]
            check(got == [want[i] for i in spec["answer_prompts"]],
                  f"(e) {tgt}'s tokens differ from the sidecar's")
        used = (res["memory_two_workers"]["used_gb"]
                - res["memory_one_worker"]["used_gb"])
        res["scale_up"].update(
            spawn_action=spawned[0], burst_calls=len(out),
            burst_s=time.perf_counter() - t, replicas=targets,
            answered_by=len(targets), second_worker_gb=used)
        log(f"  (e) {json.dumps(res['scale_up'])}, "
            f"{json.dumps(res['memory_two_workers'])}")

        # (f) Idle drain: no traffic for scale_down_sustain_s retires a
        # worker (drain, then kill); its memory comes back and the floor
        # of one worker stays.
        t = time.perf_counter()
        retire = await _action(
            port, lambda a: a["kind"] == "kill"
            and a["reason"].startswith("retire"), "(f) no worker retired")
        retired = retire["target"]
        await _until(lambda: len(_worker_pids(os.getpid())) == 1, 60,
                     "(f) the retired worker still runs")
        left = await _serving_replica(port, phase_left(),
                                      "(f) the floor replica is gone")
        check([r["target"] for r in left["replicas"]]
              == [x for x in targets if x != retired],
              f"(f) replicas after the retire {left['replicas']}")
        # The card gets back at least a replica's weights (the
        # co-launched sidecar's: the same serving section) once the
        # driver has torn the retired worker's context down.
        weights_gb = co.sidecar.generation.weight_bytes() / 1e9
        two = res["memory_two_workers"]["used_gb"]
        returned_s = await _until(
            lambda: two - _card_memory(torch)["used_gb"] >= weights_gb, 30,
            f"(f) less than a replica's {weights_gb:.2f} GB of weights came "
            f"back")
        res["memory_after_retire"] = _card_memory(torch)
        res["idle_drain"] = dict(
            retire_action=retire, retire_s=time.perf_counter() - t,
            memory_back_gb=two - res["memory_after_retire"]["used_gb"],
            memory_back_s=returned_s, counters=left["counters"])
        log(f"  (f) {json.dumps(res['idle_drain'])}")
        res["status"] = {k: left[k] for k in ("counters", "replicas")}

        # (a, last) B1 in the worker: a profile of the floor replica, its
        # probes and the flap edges the capture's stop costs.
        target = left["replicas"][0]["target"]
        with _ProbeSampler(target) as probes:
            probes.label = "profile"
            res["profile"] = await _replica_profile(
                target, texts[1:3], 4, spec["profile_ms"])
            probes.label = "after"
            await asyncio.sleep(1.0)
        st = await asyncio.to_thread(_fleet_status, port)
        res["profile"].update(probes=probes.summary(), flap_edges=[
            r["flap_edges"] for r in st["replicas"] if r["target"] == target])
        log(f"  (a) the worker's profile {json.dumps(res['profile'])}")
        layers = llama_mod.CONFIGS[spec["model"]].num_layers
        check(res["profile"]["b1_launches"] >= layers
              and res["profile"]["compile_count"] >= 1
              and res["profile"]["compile_post_warmup"] == 0,
              f"(a) B1 in the worker: {res['profile']}")
    finally:
        standalone.cancel()
        await co.stop()
    _free(torch, dev)
    left = [p for p in pids if _alive(p)]
    res["memory_stopped"] = _card_memory(torch)
    check(not left, f"(d) workers left after stop(): {left}")
    # Back to before, but for what this process still holds: its
    # allocator's blocks and its context's growth from the first GEMMs
    # and kernels it loaded (under 3 GB; a worker held 16+ GB).
    before, after = res["memory_before"], res["memory_stopped"]
    grown = after["used_gb"] - before["used_gb"]
    check(len(after["apps"]) <= len(before["apps"])
          and grown <= after["reserved_gb"] - before["reserved_gb"] + 3.0,
          f"(d) the card's memory did not return: before {before}, after "
          f"{after}")
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  (d) no worker left; {json.dumps(res['memory_stopped'])}")
    return res


# -- phase 22: processes on the one card ---------------------------------------

# (b) B1 at one process's block of the llama-1b train step: [4, 1023]
# at llama-1b's heads, D 64, bf16, causal.
P22_CASES = [
    ("dist_4x1023", 4, 1023, 1023, 32, 8, 64, True, 0, 1023, None,
     "bfloat16", "llama-1b train step [8, 1024] over two processes: one "
     "process's [4, 1023] block (H 32, KVH 8, D 64)"),
]
P22 = dict(tiny="tiny-llama", tiny_steps=3, tiny_batch=4, tiny_seq=65,
           model="llama-1b", depth=CUT_DEPTH, steps=2, batch=8, seq=1024,
           processes=2, fault_steps=2)
# (a) tiny-llama float32, two processes against one: the CPU test's
# tolerances (tests/test_torch_distributed.py).
DIST_TINY_RTOL = 1e-4
# (b) llama-1b bf16: the two-process losses against the single-process
# data=2 run's, held to twice a same-run witness (that run through the
# plain attention against it through B1), phase 19's rule.
DIST_WITNESS = 2.0


def _dist_process(spec_json: str) -> int:
    """One process of phase 22 (`chip_smoke.py --dist-process SPECS`, a
    list of runs): joins the group through GGRMCP_COORDINATOR /
    _NUM_PROCESSES / _PROCESS_ID, sums a range over the data axis across
    processes, then for each run takes its AdamW steps over the global
    mesh on its rows and writes what it measured to the run's `out`."""
    import torch

    from ggrmcp_tpu_torch.core.config import MeshConfig
    from ggrmcp_tpu_torch.parallel import collectives, distributed

    specs = json.loads(spec_json)
    check(distributed.initialize(device=specs[0]["device"]),
          "no process group")
    dev = distributed.local_device()
    mesh = distributed.global_mesh(MeshConfig(data=0, tensor=1))
    parts = [torch.tensor(float(i), device=mesh.devices[i])
             for i in mesh.local_indices()]
    total = collectives.process_sum(
        collectives.all_reduce_sum(parts)[0]).item()
    for spec in specs:
        _dist_steps(spec, dev, mesh, total)
        _free(torch, dev)
    torch.distributed.destroy_process_group()
    return 0


def _dist_steps(spec: dict, dev, mesh, total: float) -> None:
    """One run of `_dist_process`: the run's steps (and its planted fault)
    on this process's rows of the global mesh."""
    import numpy as np
    import torch

    from ggrmcp_tpu_torch.models import llama as llama_mod
    from ggrmcp_tpu_torch.models import trainer, training
    from ggrmcp_tpu_torch.ops import attention as tatt

    dist = torch.distributed
    rank = dist.get_rank()
    cfg = (_cut(spec["model"], spec["depth"]) if spec.get("depth")
           else llama_mod.CONFIGS[spec["model"]])
    state = training.make_train_state(
        llama_mod.init_params(cfg, dev, spec["seed"]), cfg, mesh=mesh)
    batches = np.load(spec["batches"])
    cuda = dev.type == "cuda"
    # The gradients' trip over the group, timed on its own: packing,
    # staging through host memory (gloo) and the all-reduce.
    # Of it, the all-reduces alone (gloo's on host buffers, synchronous).
    reduce_ms, gloo_ms, reduced = [], [], sum(
        t.numel() for t in training.stored_tensors(state.params))
    reduce_grads, all_reduce = training.all_reduce_grads, dist.all_reduce

    def timed_all_reduce(t, *args, **kwargs):
        t0 = time.perf_counter()
        out = all_reduce(t, *args, **kwargs)
        gloo_ms[-1] += (time.perf_counter() - t0) * 1e3
        return out

    def timed_reduce(tensors):
        _sync(torch, dev)
        gloo_ms.append(0.0)
        dist.all_reduce = timed_all_reduce
        t0 = time.perf_counter()
        try:
            reduce_grads(tensors)
            _sync(torch, dev)
        finally:
            dist.all_reduce = all_reduce
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
    training.all_reduce_grads = timed_reduce
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    tatt.flash_attention.launches = 0
    losses, ms = [], []
    for batch in batches:
        tokens = torch.from_numpy(batch).to(dev)
        _sync(torch, dev)
        t = time.perf_counter()
        state, loss = training.train_step(state, tokens, cfg)
        losses.append(loss.item())
        ms.append((time.perf_counter() - t) * 1e3)
    out = dict(rank=rank, backend=dist.get_backend(), device=str(dev),
               total=total, sizes=list(mesh.sizes), owners=list(mesh.owners),
               losses=losses, step_ms=ms, reduce_ms=reduce_ms,
               all_reduce_ms=gloo_ms,
               reduce_gb=4 * reduced / 1e9,
               launches=tatt.flash_attention.launches,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda
               else None)
    if spec.get("params"):
        flat = trainer.state_tensors(state, cfg)[0]
        np.savez(f"{spec['out']}{rank}.npz",
                 **{k: v.float().cpu().numpy() for k, v in flat.items()})
    if spec.get("fault_steps"):
        # The planted fault: the first steps again from the same tree
        # with the gradients' reduce skipped, each process training on
        # its own rows; the phase holds its losses outside the bound.
        del state
        _free(torch, dev)
        state = training.make_train_state(
            llama_mod.init_params(cfg, dev, spec["seed"]), cfg, mesh=mesh)
        training.all_reduce_grads = lambda tensors: None
        out["fault_losses"] = []
        for batch in batches[:spec["fault_steps"]]:
            state, loss = training.train_step(
                state, torch.from_numpy(batch).to(dev), cfg)
            out["fault_losses"].append(loss.item())
    training.all_reduce_grads = reduce_grads
    with open(f"{spec['out']}{rank}.json", "w") as fh:
        json.dump(out, fh)


def _dist_run(specs: list, tmp: str, timeout: float) -> list:
    """Two processes of `_dist_process` on the runs' device over a local
    coordinator, each taking `specs` in turn: for each run, each
    process's readings."""
    here = os.path.abspath(__file__)
    env = {**os.environ, "GGRMCP_COORDINATOR": f"127.0.0.1:{_free_port()}",
           "GGRMCP_NUM_PROCESSES": str(P22["processes"])}
    logs = [open(os.path.join(tmp, f"p{r}.log"), "w+b")
            for r in range(P22["processes"])]
    procs = [subprocess.Popen(
        [sys.executable, here, "--dist-process", json.dumps(specs)],
        env={**env, "GGRMCP_PROCESS_ID": str(r)}, cwd=os.path.dirname(here),
        stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(P22["processes"])]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, fh) in enumerate(zip(procs, logs)):
        fh.seek(0)
        tail = fh.read().decode(errors="replace")[-3000:]
        fh.close()
        check(p.returncode == 0, f"process {r} exited {p.returncode}: "
              f"{tail}")
    out = []
    for spec in specs:
        out.append([])
        for r in range(P22["processes"]):
            with open(f"{spec['out']}{r}.json") as fh:
                out[-1].append(json.load(fh))
    return out


def _single_steps(torch, tatt, dev, cfg, seed, batches, loss_fn=None):
    """The single-process data=2 run on the card from the same seeded
    tree: losses, step ms, B1 launches, peak memory, the final state."""
    from ggrmcp_tpu_torch.models import llama as llama_mod
    from ggrmcp_tpu_torch.models import training

    state = training.make_train_state(
        llama_mod.init_params(cfg, dev, seed), cfg,
        mesh=_mesh_of(dict(data=2), dev))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tatt.flash_attention.launches = 0
    losses, ms = [], []
    for batch in batches:
        tokens = torch.from_numpy(batch).to(dev)
        _sync(torch, dev)
        t = time.perf_counter()
        state, loss = training.train_step(state, tokens, cfg, loss_fn)
        losses.append(loss.item())
        ms.append((time.perf_counter() - t) * 1e3)
    return dict(losses=losses, step_ms=ms,
                launches=tatt.flash_attention.launches,
                peak_gb=(torch.cuda.max_memory_allocated() / 1e9
                         if dev.type == "cuda" else None)), state


def _p50(ms: list) -> float:
    steady = sorted(ms[2:] or ms)
    return steady[(len(steady) - 1) // 2]


def dist_phase(torch, tatt, dev, spec=None) -> dict:
    """Phase 22: (a) two processes of tiny-llama (float32) on cuda:0
    join by `initialize`: their cross-process sum is exact, three AdamW
    steps at global data=2 equal the single-process data=2 steps on the
    card (losses and final params); (b) llama-1b at full width, `steps`
    AdamW steps of a global [batch, seq] split over the two processes
    against the single-process data=2 run from one seeded tree, held to
    twice a same-run witness, and a planted fault (the first steps with
    the gradients' reduce skipped) outside that bound; B1 at one
    process's block shape."""
    import tempfile

    import numpy as np

    from ggrmcp_tpu_torch.models import llama as llama_mod
    from ggrmcp_tpu_torch.models import trainer, training

    spec = spec or P22
    t_phase = time.perf_counter()
    res: dict = {}
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here) as tmp:
        # The single-process runs of (a) and (b) first, then one pair of
        # processes takes (a)'s steps and then (b)'s.
        tcfg = llama_mod.CONFIGS[spec["tiny"]]
        rng = np.random.default_rng(SEED + 22)
        batches = rng.integers(0, tcfg.vocab_size, (
            spec["tiny_steps"], spec["tiny_batch"], spec["tiny_seq"]))
        tiny_path = os.path.join(tmp, "tiny.npy")
        np.save(tiny_path, batches)
        one, state = _single_steps(torch, tatt, dev, tcfg, SEED + 22,
                                   batches)
        want = {k: v.float().cpu().numpy()
                for k, v in trainer.state_tensors(state, tcfg)[0].items()}
        del state
        _free(torch, dev)

        case = kernel_cases(torch, tatt, dev, P22_CASES)[0]
        res["kernel"] = case
        cfg = _cut(spec["model"], spec["depth"])
        rng = np.random.default_rng(SEED + 23)
        batches = rng.integers(0, cfg.vocab_size, (
            spec["steps"], spec["batch"], spec["seq"]))
        path = os.path.join(tmp, "llama.npy")
        np.save(path, batches)

        def plain_loss(params, cfg_, tokens):
            logits, _ = llama_mod.forward(params, cfg_, tokens[:, :-1],
                                          use_flash=False)
            return training.next_token_xent(logits, tokens[:, 1:])

        single, state = _single_steps(torch, tatt, dev, cfg, SEED + 23,
                                      batches)
        del state
        _free(torch, dev)
        plain, state = _single_steps(torch, tatt, dev, cfg, SEED + 23,
                                     batches, plain_loss)
        del state
        _free(torch, dev)
        check(plain["launches"] == 0, "(b) the witness run launched B1")
        t = time.perf_counter()
        procs, lprocs = _dist_run([
            dict(model=spec["tiny"], seed=SEED + 22, device=str(dev),
                 batches=tiny_path, out=os.path.join(tmp, "tiny"),
                 params=True),
            dict(model=spec["model"], depth=spec["depth"], seed=SEED + 23,
                 device=str(dev), batches=path,
                 out=os.path.join(tmp, "llama"),
                 fault_steps=spec["fault_steps"])], tmp, phase_left())
        # One pair of processes ran both: its seconds in each's readings.
        seconds = time.perf_counter() - t
        tiny = dict(seconds=seconds,
                    backend=[p["backend"] for p in procs],
                    totals=[p["total"] for p in procs], single=one,
                    processes=procs)
        check(all(p["total"] == 1.0 for p in procs),
              f"(a) cross-process sums {tiny['totals']} (want 0 + 1)")
        check(all(p["backend"] == "gloo" for p in procs),
              f"(a) backends {tiny['backend']} on a shared card")
        worst = 0.0
        for p in procs:
            check(dev.type != "cuda"
                  or p["launches"] == spec["tiny_steps"] * tcfg.num_layers,
                  f"(a) process {p['rank']}: {p['launches']} B1 launches")
            np.testing.assert_allclose(p["losses"], one["losses"],
                                       rtol=DIST_TINY_RTOL)
            with np.load(os.path.join(tmp, f"tiny{p['rank']}.npz")) as got:
                for name, w in want.items():
                    rel = float(np.abs(got[name] - w).max()
                                / np.abs(w).max())
                    worst = max(worst, rel)
        check(worst <= DIST_TINY_RTOL, f"(a) final params {worst} of the "
              f"largest magnitude from the single process's")
        tiny["params_max_rel"] = worst
        res["tiny"] = tiny
        log(f"  (a) {json.dumps(tiny)}")

    # (b) llama-1b at full width, cut in depth.
    procs = lprocs

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))
    witness = rel(plain["losses"], single["losses"])
    bound = DIST_WITNESS * witness
    got = rel(procs[0]["losses"], single["losses"])
    fault = rel(procs[0]["fault_losses"], single["losses"])
    res["llama"] = dict(
        seconds=seconds, backend=[p["backend"] for p in procs],
        losses=procs[0]["losses"], single_losses=single["losses"],
        plain_losses=plain["losses"], loss_max_rel=got,
        witness_max_rel=witness, bound=bound,
        fault_losses=procs[0]["fault_losses"], fault_max_rel=fault,
        step_ms_p50=_p50(procs[0]["step_ms"]),
        step_ms_p50_by_process=[_p50(p["step_ms"]) for p in procs],
        reduce_ms_p50=[_p50(p["reduce_ms"]) for p in procs],
        all_reduce_ms_p50=[_p50(p["all_reduce_ms"]) for p in procs],
        reduce_gb=procs[0]["reduce_gb"],
        single_step_ms_p50=_p50(single["step_ms"]),
        peak_gb=[p["peak_gb"] for p in procs],
        single_peak_gb=single["peak_gb"],
        launches_per_step=[p["launches"] / spec["steps"] for p in procs],
        single_launches_per_step=single["launches"] / spec["steps"])
    log(f"  (b) {json.dumps(res['llama'])}")
    check(all(p["backend"] == "gloo" for p in procs),
          f"(b) backends {res['llama']['backend']}")
    check(all(p["losses"] == procs[0]["losses"] for p in procs),
          "(b) the processes report different losses")
    check(all(math.isfinite(x) for x in procs[0]["losses"]),
          f"(b) non-finite losses {procs[0]['losses']}")
    check(dev.type != "cuda" or all(
        p["launches"] == spec["steps"] * cfg.num_layers for p in procs),
          f"(b) B1 launches {[p['launches'] for p in procs]} (want one a "
          f"layer a step in each process)")
    check(got <= bound, f"(b) two-process losses {procs[0]['losses']} vs "
          f"one process {single['losses']}: rel {got} > {DIST_WITNESS} x "
          f"the witness's {witness}")
    check(fault > bound, f"(b) the planted fault (no gradient reduce) "
          f"stays within the bound: rel {fault} <= {bound}")
    res["seconds"] = time.perf_counter() - t_phase
    return res


# -- phase 23: the plain gateway -------------------------------------------------

P23 = dict(model=MODEL, depth=CUT_DEPTH, prompt=300, new=16, workers=2,
           worker_calls=16)


def _start_gateway(argv: list, port: int) -> tuple:
    """The port's CLI `gateway ARGV --http-port PORT` as a subprocess
    (`ggrmcp_tpu` unimportable in it), its stderr to a file: (process,
    file)."""
    import tempfile

    err = tempfile.TemporaryFile()
    proc = subprocess.Popen(
        _port_cli("gateway", *argv, "--http-port", str(port)),
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.DEVNULL, stderr=err)
    return proc, err


def _stop_gateway(proc, err, what: str) -> int:
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        code = proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        code = proc.wait()
    err.seek(0)
    tail = err.read().decode(errors="replace")[-2000:]
    err.close()
    check(code == 0, f"{what} exit {code} on SIGTERM: {tail}")
    return code


async def _gateway_ready(proc, err, port: int, what: str) -> float:
    def ready():
        if proc.poll() is not None:
            err.seek(0)
            raise SmokeError(f"{what} died: " + err.read().decode(
                errors="replace")[-3000:])
        return _healthy(port)
    return await _until(ready, phase_left(), f"{what} never healthy")


def _worker_spans(port: int, calls: int) -> list:
    """The sets of traced tools/calls that each answer of /debug/traces
    saw: every gateway worker keeps its own span ring, so the distinct
    sets are the workers that answered."""
    seen = set()
    for _ in range(calls):
        _, text = _get(port, "/debug/traces")
        seen.add(frozenset(
            x["traceId"] for x in json.loads(text)["spans"]
            if x["name"] == "gateway.tools/call"
            and x["traceId"].startswith("smoke-23-")))
    return [sorted(x) for x in seen if x]


async def plain_gateway_phase(torch, tatt, dev, spec=None) -> dict:
    """Phase 23: the plain gateway, `gateway --backend unix:SOCK` with no
    --tpu, as a subprocess in front of the co-launch's llama3-8b sidecar
    (this process; every layer): its tools/list equals the co-launch
    gateway's, a greedy tools/call's tokens equal the same prompt's over
    gRPC, B1 launches behind it, /metrics and /debug/ticks answer 200;
    then `--workers 2` answers traced tools/calls through each of its
    worker processes."""
    from ggrmcp_tpu_torch.core.config import Config, ServingConfig
    from ggrmcp_tpu_torch.serving import launcher

    spec = spec or P23
    t_phase = time.perf_counter()
    res: dict = {}
    text = _prompt_text(spec["prompt"], 2300)
    cfg = Config(serving=ServingConfig(model=spec["model"],
                                       num_layers=spec["depth"]))
    cfg.server.rate_limit.enabled = False
    cfg.server.port = co_port = _free_port()
    co = launcher.Colaunch(cfg, sidecar_factory=_colaunch_factory(
        torch, dev, lambda: cfg.serving))
    launcher.resolve_colaunch_transport(cfg)
    await co.start()
    try:
        await _until(lambda: _healthy(co_port), phase_left(),
                     "the co-launch never healthy")
        want_tools, _ = await asyncio.to_thread(_mcp, co_port, "tools/list")
        want = (await _direct(co.target, [text], spec["new"]))[0][0]

        port = _free_port()
        proc, err = _start_gateway(["--backend", co.target], port)
        try:
            res["healthy_s"] = await _gateway_ready(proc, err, port,
                                                    "the plain gateway")
            tools, _ = await asyncio.to_thread(_mcp, port, "tools/list")
            check(tools == want_tools, "tools/list differs from the "
                  "co-launch's")
            res["tools"] = len(tools["tools"])
            tatt.flash_attention.launches = 0
            ids, res["call_ms"] = await asyncio.to_thread(
                _mcp_generate, port, text, spec["new"])
            res["launches"] = tatt.flash_attention.launches
            check(ids == want, f"the plain gateway's tokens {ids} differ "
                  f"from gRPC's {want}")
            check(res["launches"] > 0 or dev.type == "cpu",
                  "B1 never launched behind the plain gateway")
            res["metrics"], body = await asyncio.to_thread(
                _get, port, "/metrics")
            res["debug_ticks"], _ = await asyncio.to_thread(
                _get, port, "/debug/ticks")
            check(res["metrics"] == 200 and res["debug_ticks"] == 200
                  and "gateway_http_requests_total" in body,
                  f"/metrics {res['metrics']}, /debug/ticks "
                  f"{res['debug_ticks']}")
            res["children"] = _children(proc.pid)
            check(res["children"] == [], f"children {res['children']}")
        finally:
            res["exit_code"] = _stop_gateway(proc, err, "the plain gateway")

        port = _free_port()
        proc, err = _start_gateway(
            ["--backend", co.target, "--workers", str(spec["workers"])],
            port)
        try:
            await _gateway_ready(proc, err, port, "--workers 2")
            workers = [pid for pid in _children(proc.pid)
                       if "spawn_main" in " ".join(_cmdline(pid))]
            for i in range(spec["worker_calls"]):
                # Each on a new connection: the kernel spreads them.
                await asyncio.to_thread(_traced_generate, port, text,
                                        f"smoke-23-{i}")
            answered = await asyncio.to_thread(
                _worker_spans, port, 4 * spec["worker_calls"])
            res["workers"] = dict(processes=len(workers),
                                  calls_by_worker=[len(x) for x in answered])
            check(len(workers) == spec["workers"] and len(answered) == (
                spec["workers"]) and sum(len(x) for x in answered) == (
                spec["worker_calls"]),
                  f"--workers {spec['workers']}: {res['workers']}")
        finally:
            _stop_gateway(proc, err, "--workers 2")
        res["reference_processes"] = _reference_processes()
        check(res["reference_processes"] == {},
              f"processes of the JAX package: {res['reference_processes']}")
    finally:
        await co.stop()
    res["seconds"] = time.perf_counter() - t_phase
    return res


# -- phase 24: compositions ---------------------------------------------------------

# The maximal sidecar: every serving feature at once (int8 weights, the
# int8 KV cache, length tiers, the prefix pool, a speculative draft at
# tensor=2, every shard on the card), and the int8 routes held on the
# card. The card's sizes; a smaller spec drives the same code on the
# CPU.
P24 = dict(
    # (a) tests/test_composition.py's maximal config and traffic,
    # tiny-llama float32: the card against the CPU in this process.
    tiny=dict(model="tiny-llama", quantize="int8", kv_cache_dtype="int8",
              speculative_draft="tiny-llama", mesh=dict(tensor=2),
              batching=dict(max_batch_size=4, kv_cache_max_seq=256,
                            kv_tiers=[[64, 3], [256, 2]], prefill_chunk=32,
                            prefix_cache_entries=2, prefix_cache_min_seq=8,
                            prefix_cache_max_seq=32)),
    tiny_long="shared system preamble " * 4, tiny_new=5,
    # (b) the maximal config at published widths: mistral-7b at the
    # phase's depth with the whole llama-1b draft (phase 13's pair).
    # Greedy calls take the micro-path (5 new tokens, as in the
    # reference's test: on random weights no draft token is accepted,
    # and a round took 0.8 s), top-k calls
    # the short tier, four long prompts sharing a 2048-token preamble
    # the long tier (the first stores it in the prefix pool, the rest
    # hit).
    model="mistral-7b", depth=CUT_DEPTH, draft="llama-1b", gamma=4,
    batching={}, tensor=2, tiers=[[1024, 24], [8192, 4]],
    prefix=dict(prefix_cache_entries=2, prefix_cache_min_seq=512,
                prefix_cache_max_seq=2048),
    greedy_prompts=(40, 90, 160, 250) * 2, greedy_new=5,
    sampled_prompts=(40, 90, 160, 250), sampled_new=16, top_k=40,
    preamble_tokens=2048, long_prompts=(2500, 3700, 4800, 6000),
    long_new=16,
    # (c) phase 12a's host tier on the int8 cache at half its traffic: 8
    # preambles (1024 pages) through an arena of half their pages, twice,
    # two calls an admission round (four would need 532 pages).
    paged=dict(P12, preambles=8, arena_pages=512, big_arena_pages=2048,
               group=2),
    # (d) phase 12c's four rank-8 adapters and a zero-b one, a burst of 8,
    # on int8 weights and the bf16 cache.
    lora=dict(P12, lora_burst=8),
    # (e) the ring on the int8 cache (capacity 4096 + 512 - 1 = 4607)
    # against the contiguous windowed int8 cache at 8192.
    ring_prompts=(5000, 5666, 6333, 7000), ring_new=16, ring_slots=4,
    chunk=512, flat_seq=8192,
    # (f) the spec tick on the int8 cache, then under tick_fail.
    spec_calls=8, spec_new=16, fail_every=3, retry_limit=64,
    # (g) mixtral-8x7b on int8 weights (its banks and router stay dense,
    # as the reference keeps them) with the int8 cache, phase 14b's
    # burst.
    moe="mixtral-8x7b", moe_prompts=SERVE_PROMPT_TOKENS,
    moe_new=SERVE_NEW_TOKENS,
)
# GetServingStats fields of tests/test_composition.py's checks.
_COMPOSITION_STATS = ("total_slots", "kv_cache_bytes", "speculative_calls",
                      "speculative_requests", "speculative_drafted",
                      "speculative_accepted", "decode_steps",
                      "prefix_cache_hits", "prefix_cache_misses")


def _composition_sidecar(torch, dev, serving: dict, params, tmp: str,
                         name: str, draft=None):
    """A sidecar of `serving` (a {"serving": ...} config file read as the
    command line reads `--config FILE`) on a copy of `params`, on a mesh
    of its `mesh` axes with every coordinate on `dev`; `draft` (when
    given) replaces the draft model's seeded draw."""
    from ggrmcp_tpu_torch import __main__ as cli
    from ggrmcp_tpu_torch.models import llama as llama_mod
    from ggrmcp_tpu_torch.serving.sidecar import Sidecar

    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as fh:
        json.dump({"serving": serving}, fh)
    cfg = cli.serving_config(cli.build_parser().parse_args(
        ["sidecar", "--config", path]))
    real = llama_mod.init_params

    def seeded(c, device, seed=0):
        if draft is not None and seed == SEED + 1:
            return _to(draft, device)
        return real(c, device, seed)

    llama_mod.init_params = seeded
    try:
        return Sidecar(cfg, params=_tree_copy(params),
                       mesh=_mesh_of(serving.get("mesh") or {}, dev))
    finally:
        llama_mod.init_params = real


async def _composition_traffic(torch, dev, side, calls, long_groups) -> dict:
    """`calls` ((kind, text, max_new, sampling fields) each) concurrently
    beside `long_groups` (lists of the same), each group concurrent and
    the groups in turn; then the first call again. Outputs in order,
    the repeat, the stats of test_composition.py's checks, GetMemory
    reconciled, TTFT on the server for the tiers' calls."""
    import grpc.aio

    from ggrmcp_tpu_torch.rpc.pb import serving_pb2 as pb

    tiers = getattr(side.batcher, "tiers", [side.batcher])
    for tier in tiers:
        _ttft_log(tier)
    await side.start(0)
    try:
        async with grpc.aio.insecure_channel(side.target) as ch:
            client = _P12Client(ch)

            def send(call):
                _, text, new, fields = call
                return client.call(text, new, sampling=pb.SamplingParams(
                    **fields))

            async def in_turn():
                out = []
                for group in long_groups:
                    out += await asyncio.gather(*(send(c) for c in group))
                return out

            *short, longs = await asyncio.gather(
                *(send(c) for c in calls), in_turn())
            again = await send(calls[0])
            stats = await client.stats()
            memory = await client.memory()
    finally:
        await side.stop()
    _sync(torch, dev)
    kinds = [c[0] for c in calls] + [c[0] for g in long_groups for c in g]
    outs = short + longs
    for kind, (ids, reason, _) in zip(kinds, outs + [again]):
        check(reason in ("length", "stop") and ids,
              f"a {kind} call ended {reason!r} after {len(ids)} tokens")
    check(memory.total_bytes + memory.unattributed_bytes == memory.live_bytes,
          "GetMemory does not close")
    return dict(
        kinds=kinds, tokens=[ids for ids, _, _ in outs],
        client_ms=[ms for _, _, ms in outs], repeat=again[0],
        stats={k: getattr(stats, k) for k in _COMPOSITION_STATS},
        memory=dict(live_bytes=memory.live_bytes,
                    unattributed_bytes=memory.unattributed_bytes,
                    kv_arena_bytes=sum(c.bytes for c in memory.components
                                       if c.component == "kv_arena")),
        tier_ttft_ms=[[ms for _, ms in t.ttft_ms] for t in tiers])


def _same_kind(run: dict, kind: str) -> list:
    return [t for t, k in zip(run["tokens"], run["kinds"]) if k == kind]


async def _composition_tiny(torch, dev, spec, tmp) -> dict:
    """(a) tests/test_composition.py's sidecar and traffic (the two long
    calls in turn, so that their draws are the same on both sides) on
    the card and on the CPU, the same target and draft weights."""
    from ggrmcp_tpu_torch.models import llama as llama_mod

    cpu = torch.device("cpu")
    cfg = llama_mod.CONFIGS[spec["tiny"]["model"]]
    params = llama_mod.init_params(cfg, cpu, SEED)
    draft = llama_mod.init_params(cfg, cpu, SEED + 1)
    new, long = spec["tiny_new"], spec["tiny_long"]
    calls = [("greedy", "greedy one", new, {}),
             ("greedy", "greedy two", new, {}),
             ("sampled", "sampled", new, dict(temperature=0.9, seed=7))]
    longs = [[("long", long + q, new, dict(temperature=0.9, seed=7))]
             for q in ("q1", "q2")]
    runs = {}
    for where, d in (("card", dev), ("cpu", cpu)):
        side = _composition_sidecar(torch, d, spec["tiny"], _to(params, d),
                                    tmp, f"tiny-{where}", draft=draft)
        check(side.spec_batcher is not None
              and hasattr(side.batcher, "tiers"),
              "(a) the maximal sidecar has no micro-path or no tiers")
        runs[where] = await _composition_traffic(torch, d, side, calls, longs)
        del side
    card, ref = runs["card"], runs["cpu"]
    check(_same_kind(card, "greedy") == _same_kind(ref, "greedy")
          and card["repeat"] == ref["repeat"] == card["tokens"][0],
          "(a) greedy tokens card vs cpu differ")
    check(card["stats"]["total_slots"] == 5
          and card["stats"]["speculative_requests"] >= 3
          and card["stats"]["decode_steps"] >= 1
          and card["stats"]["prefix_cache_hits"] >= 1,
          f"(a) the card's stats {card['stats']}")
    _free(torch, dev)
    return dict(greedy_identical=True,
                all_identical=card["tokens"] == ref["tokens"],
                sampled_vs_cpu=_agreement(
                    [t for t, k in zip(card["tokens"], card["kinds"])
                     if k != "greedy"],
                    [t for t, k in zip(ref["tokens"], ref["kinds"])
                     if k != "greedy"]),
                stats_card=card["stats"], stats_cpu=ref["stats"])


def _maximal_serving(spec, draft: bool) -> dict:
    serving = dict(
        model=spec["model"], num_layers=spec["depth"], quantize="int8",
        kv_cache_dtype="int8", mesh=dict(tensor=spec["tensor"]),
        batching=dict(spec["batching"], kv_tiers=spec["tiers"],
                      prefill_chunk=spec["chunk"], max_queue_delay_ms=50.0,
                      **spec["prefix"]))
    if draft:
        serving.update(speculative_draft=spec["draft"],
                       speculative_gamma=spec["gamma"])
    return serving


async def _composition_maximal(torch, tatt, dev, spec, params, tmp) -> dict:
    """(b) the maximal config at published widths with its traffic;
    then its greedy calls on the same sidecar without the draft."""
    calls = [("greedy", _prompt_text(n, 2400 + i), spec["greedy_new"], {})
             for i, n in enumerate(spec["greedy_prompts"])]
    calls += [("sampled", _prompt_text(n, 2450 + i), spec["sampled_new"],
               dict(temperature=0.8, top_k=spec["top_k"], seed=7 + i))
              for i, n in enumerate(spec["sampled_prompts"])]
    preamble = _prompt_text(spec["preamble_tokens"], 2480)
    longs = [("long", preamble + _prompt_text(
        n - spec["preamble_tokens"], 2490 + i), spec["long_new"],
        dict(temperature=0.8, seed=17 + i))
        for i, n in enumerate(spec["long_prompts"])]
    greedy = [c for c in calls if c[0] == "greedy"]
    runs = {}
    # Without the draft, the greedy calls alone: their streams are the
    # comparison.
    for name, draft, sent, groups in (
            ("maximal", True, calls, [longs[:1], longs[1:]]),
            ("no_draft", False, greedy, [])):
        launched = tatt.flash_attention.launches
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        side = _composition_sidecar(torch, dev, _maximal_serving(spec, draft),
                                    params, tmp, name)
        check((side.spec_batcher is not None) == draft,
              f"(b) {name}: micro-path {side.spec_batcher}")
        runs[name] = run = await _composition_traffic(torch, dev, side,
                                                      sent, groups)
        run["launches"] = tatt.flash_attention.launches - launched
        if dev.type == "cuda":
            run["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del side
        _free(torch, dev)
    on, off = runs["maximal"], runs["no_draft"]
    st = on["stats"]
    n_greedy = len(spec["greedy_prompts"])
    check(on["repeat"] == on["tokens"][0], "(b) the greedy repeat differs")
    check(st["total_slots"] == sum(s for _, s in spec["tiers"])
          and st["speculative_requests"] == n_greedy + 1
          and st["prefix_cache_hits"] >= 1 and st["decode_steps"] >= 1,
          f"(b) stats {st}")
    check(off["stats"]["speculative_requests"] == 0,
          f"(b) without the draft: {off['stats']}")
    if dev.type == "cuda":
        check(on["launches"] == off["launches"] == 0,
              f"(b) B1 launched on the int8 cache: {on['launches']}, "
              f"{off['launches']}")
    agree = _agreement(_same_kind(on, "greedy"), _same_kind(off, "greedy"))
    # The micro-path's prefill and the tier's admission are the same
    # computation at other shapes; bf16 promises the first token only.
    check(agree["first_token"] == agree["of"],
          f"(b) greedy micro-path vs the tiers: {agree}")

    def ttft(run, kind):
        tier = 0 if kind != "long" else 1
        return _ttft(run["tier_ttft_ms"][tier]) if run[
            "tier_ttft_ms"][tier] else None

    return dict(
        stats=st, stats_no_draft=off["stats"], memory=on["memory"],
        peak_gb=on.get("peak_gb"), peak_gb_no_draft=off.get("peak_gb"),
        micro_call_ms=_ttft([ms for ms, k in zip(on["client_ms"],
                                                 on["kinds"])
                             if k == "greedy"]),
        short_tier_ttft=ttft(on, "sampled"), long_tier_ttft=ttft(on, "long"),
        greedy_vs_no_draft=agree,
        launches=on["launches"] + off["launches"])


def _page_bytes(cfg, page: int, kv_dtype: str) -> int:
    """One page of K and V over every layer: int8 values and a float32
    scale a (position, head), or the model dtype."""
    per = cfg.head_dim + 4 if kv_dtype == "int8" else cfg.head_dim * 2
    return 2 * cfg.num_layers * page * cfg.num_kv_heads * per


async def _composition_host(torch, dev, spec, tmp) -> dict:
    """(c) the paged arena (its prefix sharing) and the host tier on the
    int8 cache: two passes through an arena of half the pages, against
    an int8 arena that holds every page, and a pass under
    host_restore_fail."""
    from ggrmcp_tpu_torch.models import llama as llama_mod

    ps = dict(spec["paged"], depth=spec["depth"])
    cfg = _cut(ps["model"], ps["depth"])
    params = llama_mod.init_params(cfg, dev, SEED)
    int8 = dict(kv_cache_dtype="int8")
    host = await _host_run(torch, dev, params, tmp, ps, host=True, fail=True,
                           serving=int8)
    big = await _host_run(torch, dev, params, tmp, ps, host=False,
                          serving=int8)
    del params
    _free(torch, dev)
    p1, p2 = host["passes"]
    check(p1["stats"]["kv_host_demotions"] > 0
          and p2["stats"]["kv_host_restores"] > 0,
          f"(c) demotions {p1['stats']}, restores {p2['stats']}")
    agree = []
    for rnd in (0, 1):
        a = _agreement(host["passes"][rnd]["tokens"],
                       big["passes"][rnd]["tokens"])
        agree.append(a)
        check(a["first_token"] == a["of"],
              f"(c) pass {rnd + 1}: first tokens vs the whole arena {a}")
    fail = host["restore_fail"]
    check(fail["kv_host_restore_failures"] > 0
          and fail["completed"] == ps["preambles"],
          f"(c) host_restore_fail: {fail}")
    # The codec's bytes a page, the first pass's demotions (the second
    # pass's count pages whose bytes the host tier already holds) and
    # the second's restores: the int8 values and their scales, about half
    # the bf16 page's.
    demoted = (p1["stats"]["kv_host_bytes_demoted"]
               / p1["stats"]["kv_host_demotions"])
    restored = (p2["stats"]["kv_host_bytes_restored"]
                / p2["stats"]["kv_host_restores"])
    bf16 = _page_bytes(cfg, ps["page"], "")
    check(max(demoted, restored) <= 0.6 * bf16,
          f"(c) {demoted:.0f} B a demoted and {restored:.0f} B a restored "
          f"int8 page against {bf16} B a bf16 page")
    return dict(
        passes=[dict(ttft_ms=p["ttft_ms"], stats=p["stats"],
                     agreement_with_whole_arena=a)
                for p, a in zip(host["passes"], agree)],
        restore_fail=fail, bytes_per_demoted_page=demoted,
        bytes_per_restored_page=restored,
        int8_page_bytes=_page_bytes(cfg, ps["page"], "int8"),
        bf16_page_bytes=bf16, ratio_to_bf16=demoted / bf16,
        traffic=host["traffic"], kv_cache_bytes=host["kv_cache_bytes"],
        kv_cache_bytes_whole=big["kv_cache_bytes"])


async def _composition_lora(torch, tatt, dev, spec, tmp) -> dict:
    """(d) phase 12c's burst on int8 weights with the bf16 cache: each
    adapter'd stream against its adapter alone, a zero-b adapter against
    base; B1 launches (the phase's kernel path)."""
    import grpc.aio

    from ggrmcp_tpu_torch.models import llama as llama_mod

    ls = dict(spec["lora"], depth=spec["depth"])
    cfg = _cut(ls["model"], ls["depth"])
    params = llama_mod.init_params(cfg, dev, SEED)
    registry = os.path.join(tmp, "adapters")
    os.makedirs(registry, exist_ok=True)
    _write_adapters(registry, cfg, ls)
    side = _p12_sidecar(torch, params, dev, dict(
        quantize="int8", lora=_lora_cfg(ls, registry, ls["lora_rows"])),
        tmp, ls, "lora-int8")
    batcher = side.batcher
    _hold_admission(batcher)
    _time_ticks(torch, dev, batcher)
    launched = tatt.flash_attention.launches
    await side.start(0)
    try:
        async with grpc.aio.insecure_channel(side.target) as ch:
            res = await _lora_burst(torch, dev, _P12Client(ch), batcher, ls)
    finally:
        await side.stop()
    _sync(torch, dev)
    res["launches"] = tatt.flash_attention.launches - launched
    if dev.type == "cuda":
        check(res["launches"] > 0, "(d) B1 never launched")
    del side, batcher, params
    _free(torch, dev)
    return res


def _mistral_spec(spec) -> dict:
    """The spec `_spec_serve` builds phase 13's sidecars from, at this
    phase's depth."""
    return dict(model=spec["model"], depth=spec["depth"],
                batching=spec["batching"])


async def _composition_ring(torch, tatt, dev, spec, params, tmp) -> dict:
    """(e) the ring on the int8 cache against the contiguous windowed
    int8 cache: streams counted, KV bytes, TTFT; B1 never launches."""
    ms = _mistral_spec(spec)
    calls = [(_prompt_text(n, 2500 + i), spec["ring_new"], {})
             for i, n in enumerate(spec["ring_prompts"])]
    one = dict(max_batch_size=spec["ring_slots"], prefill_chunk=spec["chunk"])
    ring = await _spec_serve(torch, tatt, dev, params, tmp, ms, dict(
        kv_ring=True, kv_cache_dtype="int8", batching=one), "ring-int8",
        calls)
    flat = await _spec_serve(torch, tatt, dev, params, tmp, ms, dict(
        kv_cache_dtype="int8", batching=dict(
            one, kv_cache_max_seq=spec["flat_seq"])), "flat-int8", calls)
    if dev.type == "cuda":
        check(ring["launches"] == flat["launches"] == 0,
              f"(e) B1 launched on the int8 cache: {ring['launches']}, "
              f"{flat['launches']}")
    cfg = _cut(spec["model"], spec["depth"])
    cap = cfg.sliding_window + spec["chunk"] - 1
    bf16 = 2 * cfg.num_layers * spec["ring_slots"] * (cap + 1) * (
        cfg.num_kv_heads * cfg.head_dim * 2)
    return dict(
        vs_contiguous=_agreement(ring["tokens"], flat["tokens"]),
        kv_bytes_ring=ring["kv_arena_bytes"],
        kv_bytes_contiguous=flat["kv_arena_bytes"],
        ring_bf16_bytes=bf16, ratio_to_bf16=ring["kv_arena_bytes"] / bf16,
        ttft_ring=_ttft([m for _, m in ring["ttft_ms"]]),
        ttft_flat=_ttft([m for _, m in flat["ttft_ms"]]),
        tick_ms_p50_ring=_median(ring["tick_log"]["plain"]),
        launches=ring["launches"] + flat["launches"])


async def _composition_spec(torch, tatt, dev, spec, params, tmp) -> dict:
    """(f) the spec tick on the int8 cache against spec off on the same
    cache; then under tick_fail every `fail_every`-th tick."""
    from ggrmcp_tpu_torch.utils import failpoints

    ms = _mistral_spec(spec)
    calls = [(_prompt_text(n, 2600 + i), spec["spec_new"], {})
             for i, n in enumerate(spec["greedy_prompts"][:spec["spec_calls"]])]
    draft = dict(speculative_draft=spec["draft"],
                 speculative_gamma=spec["gamma"])
    on_cfg = dict(kv_cache_dtype="int8", batching=dict(
        speculative="on", tick_retry_limit=spec["retry_limit"]), **draft)
    on = await _spec_serve(torch, tatt, dev, params, tmp, ms, on_cfg,
                           "spec-int8", calls)
    off = await _spec_serve(torch, tatt, dev, params, tmp, ms, dict(
        kv_cache_dtype="int8"), "nospec-int8", calls)
    failpoints.registry.arm("tick_fail", every=spec["fail_every"])
    try:
        armed = await _spec_serve(torch, tatt, dev, params, tmp, ms, on_cfg,
                                  "spec-int8-fail", calls)
    finally:
        failpoints.registry.disarm()
    n_spec = len(on["tick_log"]["spec"])
    check(n_spec > 0 and on["delta"]["spec_ticks"] == n_spec,
          f"(f) spec ticks {on['delta']}")
    vs_off = _agreement(on["tokens"], off["tokens"])
    check(vs_off["first_token"] == vs_off["of"],
          f"(f) spec on vs off first tokens {vs_off}")
    d = armed["delta"]
    check(d["replayed_requests"] > 0 and d["replay_exhausted"] == 0,
          f"(f) tick_fail: {d}")
    replay = _agreement(armed["tokens"], on["tokens"])
    check(replay["first_token"] == replay["of"],
          f"(f) the replayed calls' first tokens {replay}")
    if dev.type == "cuda":
        check(on["launches"] == off["launches"] == armed["launches"] == 0,
              "(f) B1 launched on the int8 cache")
    return dict(
        vs_spec_off=vs_off, replayed_vs_unarmed=replay,
        replayed_requests=d["replayed_requests"],
        replay_exhausted=d["replay_exhausted"],
        spec_ticks=n_spec, tick_ms_p50_on=_median(on["tick_log"]["spec"]),
        tick_ms_p50_off=_median(off["tick_log"]["plain"]),
        acceptance=on["delta"]["spec_accepted"]
        / max(1, on["delta"]["spec_drafted"]),
        draft_cache_bytes=on["draft_cache_bytes"],
        launches=on["launches"] + off["launches"] + armed["launches"])


async def _composition_moe(torch, tatt, dev, spec, tmp) -> dict:
    """(g) mixtral on int8 weights with the int8 cache against the bf16
    cache: phase 14b's burst in one admission round, GetMemory
    reconciled, tick p50; B1 never launches on the int8 cache."""
    import dataclasses

    from ggrmcp_tpu_torch.models import moe as moe_mod
    from ggrmcp_tpu_torch.ops import quant

    cfg = dataclasses.replace(moe_mod.CONFIGS[spec["moe"]],
                              num_layers=spec["depth"])
    params = moe_mod.init_params(cfg, dev, SEED)
    ms = dict(model=spec["moe"], depth=spec["depth"], batching={})
    calls = [(_prompt_text(n, 2700 + i), spec["moe_new"], {})
             for i, n in enumerate(spec["moe_prompts"])]
    runs = {}
    for name, kv in (("int8", "int8"), ("bf16", "")):
        runs[name] = await _spec_serve(
            torch, tatt, dev, params, tmp, ms,
            dict(quantize="int8", kv_cache_dtype=kv), f"moe-{name}", calls,
            probe=lambda side: side.generation.params)
    del params
    _free(torch, dev)
    q = runs["int8"]
    leaves = q.pop("probed")
    runs["bf16"].pop("probed")
    dense = [k for k in ("router", "w_gate", "w_up", "w_down")
             if not isinstance(leaves["layers"][k], quant.QuantizedTensor)]
    check(isinstance(leaves["layers"]["wqkv"], quant.QuantizedTensor)
          and len(dense) == 4, f"(g) dense leaves {dense}")
    check(q["memory_closes"] and runs["bf16"]["memory_closes"],
          "(g) GetMemory does not close")
    if dev.type == "cuda":
        check(q["launches"] == 0,
              f"(g) B1 launched {q['launches']} times on the int8 cache")
    return dict(
        vs_bf16_cache=_agreement(q["tokens"], runs["bf16"]["tokens"]),
        tick_ms_p50_int8=_median(q["tick_log"]["plain"]),
        tick_ms_p50_bf16=_median(runs["bf16"]["tick_log"]["plain"]),
        kv_bytes_int8=q["kv_arena_bytes"],
        kv_bytes_bf16=runs["bf16"]["kv_arena_bytes"],
        live_bytes=q["live_bytes"], unattributed_bytes=q["unattributed_bytes"],
        ttft=_ttft([m for _, m in q["ttft_ms"]]),
        launches_int8=q["launches"], launches_bf16=runs["bf16"]["launches"])


async def composition_phase(torch, tatt, dev, spec=None) -> dict:
    """Phase 24: (a) the maximal sidecar of tests/test_composition.py on
    the card against the CPU; (b) the maximal config at published
    widths; (c) the host tier, (d) LoRA, (e) the ring, (f) the spec
    tick and (g) MoE on int8; sidecars configured by a `--config` file,
    one seeded weight set where parts share a model."""
    import tempfile

    from ggrmcp_tpu_torch.models import llama as llama_mod

    spec = spec or P24
    t_phase = time.perf_counter()
    res: dict = {}
    # The path's run starts here: every launch count from 0.
    tatt.flash_attention.launches = 0
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        parts = [("tiny", "(a) the maximal sidecar, card vs cpu",
                  lambda: _composition_tiny(torch, dev, spec, tmp))]
        cfg = _cut(spec["model"], spec["depth"])
        params = llama_mod.init_params(cfg, dev, SEED)
        parts += [
            ("maximal", "(b) the maximal config at published widths",
             lambda: _composition_maximal(torch, tatt, dev, spec, params,
                                          tmp)),
            ("ring", "(e) the ring on the int8 cache",
             lambda: _composition_ring(torch, tatt, dev, spec, params, tmp)),
            ("spec", "(f) the spec tick on the int8 cache",
             lambda: _composition_spec(torch, tatt, dev, spec, params, tmp)),
        ]
        for key, what, part in parts:
            t = time.perf_counter()
            res[key] = await part()
            res[key]["seconds"] = time.perf_counter() - t
            log(f"  {what}: {json.dumps(_brief(res[key]))}")
        del params
        _free(torch, dev)
        for key, what, part in (
                ("host", "(c) the host tier on the int8 cache",
                 lambda: _composition_host(torch, dev, spec, tmp)),
                ("lora", "(d) LoRA on int8 weights",
                 lambda: _composition_lora(torch, tatt, dev, spec, tmp)),
                ("moe", "(g) MoE on int8 weights and cache",
                 lambda: _composition_moe(torch, tatt, dev, spec, tmp))):
            t = time.perf_counter()
            res[key] = await part()
            res[key]["seconds"] = time.perf_counter() - t
            log(f"  {what}: {json.dumps(_brief(res[key]))}")
    _sync(torch, dev)
    res["launches"] = tatt.flash_attention.launches
    res["seconds"] = time.perf_counter() - t_phase
    return res


def _free(torch, dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _brief(d):
    """`d` without its token lists (for the log)."""
    if isinstance(d, dict):
        return {k: _brief(v) for k, v in d.items() if k != "tokens"}
    return d


# -- main ---------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--dist-process"]:
        # One process of phase 22, on the device its spec names.
        return _dist_process(sys.argv[2])
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
    # `--only 16,17` (fault-finding): the card, the build and those
    # phases, then no result lines.
    only = None
    if sys.argv[1:2] == ["--only"]:
        only = {int(x) for x in sys.argv[2].split(",")}

    def run(n: int) -> bool:
        return only is None or n in only

    def tidy() -> None:
        gc.collect()
        torch.cuda.empty_cache()

    t_start = time.perf_counter()
    try:
        with phase(1):
            card = card_line()
            log(f"[1/24] card: {card}; torch {torch.__version__}, CUDA "
                f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

        with phase(2):
            t = time.perf_counter()
            _build.load("flash_attention")
            log(f"[2/24] build: flash_attention.cu in "
                f"{time.perf_counter() - t:.1f} s")
            ptxas_report(_build.build_log.get("flash_attention", ""))

        if run(3):
            with phase(3):
                log(f"[3/24] kernel vs plain (|err| <= atol + rtol |plain|: "
                    f"{TOL})")
                cases = kernel_cases(torch, tatt, dev)

        if run(4):
            with phase(4):
                log("[4/24] reference: tiny-llama on the card vs the CPU")
                ref = tiny_reference(torch, dev)
                log(f"  {ref}")

        if run(5):
            with phase(5):
                log(f"[5/24] serve: {MODEL} sidecar, default batching")
                serve = asyncio.run(serve_phase(torch, tatt, dev))
                log(f"  {json.dumps(serve)}")
                tidy()

        if run(6):
            with phase(6):
                log(f"[6/24] embed: {EMBED_MODEL} sidecar")
                embed = asyncio.run(embed_phase(torch, tatt, dev))
                log(f"  {json.dumps(embed)}")
                tidy()

        if run(7):
            with phase(7):
                log("[7/24] HF checkpoint: llama3-8b width, 2 layers, 2 files")
                hf = asyncio.run(hf_phase(torch, tatt, dev))
                log(f"  {json.dumps(hf)}")
                tidy()

        if run(8):
            with phase(8):
                log(f"[8/24] int8: {MODEL} weights and KV cache")
                int8 = asyncio.run(int8_phase(torch, tatt, dev))
                tidy()

        if run(9):
            with phase(9):
                log(f"[9/24] KV reuse: {MODEL} prefix pool, interleave, "
                    f"paged KV")
                reuse = asyncio.run(kv_reuse_phase(torch, tatt, dev))
                tidy()

        if run(10):
            with phase(10):
                log(f"[10/24] grammar: {MODEL} constrained burst, jump on / "
                    f"off")
                grammar = asyncio.run(grammar_phase(torch, tatt, dev))
                log(f"  {json.dumps(_brief(grammar))}")
                tidy()

        if run(11):
            with phase(11):
                log(f"[11/24] control plane: {MODEL} tick phases, Profile, "
                    f"GetMemory, scheduler, failpoints, deadlines")
                control = asyncio.run(control_phase(torch, tatt, dev))
                tidy()

        if run(12):
            with phase(12):
                log(f"[12/24] paged plane and LoRA: {MODEL} host tier, "
                    f"TransferKV with roles, adapter arena, preemption with "
                    f"the host tier")
                paged = asyncio.run(paged_lora_phase(torch, tatt, dev))
                tidy()

        if run(13):
            with phase(13):
                t = time.perf_counter()
                log(f"[13/24] speculative decoding, ring KV, tiers: "
                    f"{P13['model']} with the {P13['draft']} draft")
                p13 = asyncio.run(spec_ring_tier_phase(torch, tatt, dev))
                log(f"  phase 13: {time.perf_counter() - t:.1f} s, "
                    f"{p13['launches']} B1 launches")

        if run(14):
            with phase(14):
                log(f"[14/24] sparse MoE: {P14['model']} cut to "
                    f"{P14['layers']} layers, bf16")
                p14 = asyncio.run(moe_phase(torch, tatt, dev))
                log(f"  phase 14: {p14['seconds']:.1f} s, {p14['launches']} B1 "
                    f"launches, peak {p14['max_memory_allocated_gb']:.2f} GB")
                _free(torch, dev)

        if run(15):
            with phase(15):
                log(f"[15/24] tensor and expert parallelism: {P15['model']} "
                    f"at tensor={P15['tensor']} on one card, the sharded "
                    f"loader, {P15['moe']} at expert=2 x tensor=2")
                p15 = asyncio.run(tp_phase(torch, tatt, dev))
                log(f"  phase 15: {p15['seconds']:.1f} s, {p15['launches']} B1 "
                    f"launches at tensor={P15['tensor']}")
                _free(torch, dev)

        if run(16):
            with phase(16):
                log(f"[16/24] co-launch: {P16['model']} sidecar and the "
                    f"port's gateway on one event loop in this process, "
                    f"over a private socket")
                p16 = asyncio.run(colaunch_phase(torch, tatt, dev))
                log(f"  phase 16: {p16['seconds']:.1f} s, "
                    f"{p16['colaunch_launches']} B1 launches behind MCP")
                _free(torch, dev)

        if run(17):
            with phase(17):
                log(f"[17/24] sequence- and pipeline-parallel serving, plain "
                    f"and composed: {P17['model']} at sequence="
                    f"{P17['sequence']} and stage={P17['stage']}, each with "
                    f"tensor={P17['tensor']}, int8 weights, the int8 cache "
                    f"and the prefix pool, sidecars on sequence meshes, "
                    f"{P17['window_model']}'s windowed sp prefill, every "
                    f"shard on one card")
                p17 = asyncio.run(sp_pp_phase(torch, tatt, dev))
                log(f"  phase 17: {p17['seconds']:.1f} s; B1 launches: "
                    f"{p17['sp']['sp_launches']} in the sp prefills, "
                    f"{p17['pp_launches']} at stage={P17['stage']} (a stage's "
                    f"attention and the sp attention are plain, as the "
                    f"reference's are), {p17['sp_serve_launches']} behind "
                    f"the sequence=2 sidecars and "
                    f"{p17['sp_tensor_serve_launches']} behind tensor="
                    f"{P17['tensor']} x sequence={P17['sequence']} (the "
                    f"admissions under sp_prefill_min_seq)")
                _free(torch, dev)

        if run(18):
            with phase(18):
                log(f"[18/24] training: {P18['model']} through the train CLI "
                    f"({P18['steps']} steps at [{P18['batch']}, "
                    f"{P18['seq_len']}], a resume to {P18['resume_to']}), B1 "
                    f"under autograd, {P18['tiny']} card = CPU at tensor and "
                    f"stage 2, the trained weights served")
                p18 = asyncio.run(train_phase(torch, tatt, dev))
                log(f"  phase 18: {p18['seconds']:.1f} s, "
                    f"{p18['cli']['launches']} B1 launches and "
                    f"{p18['cli']['recomputes']} backward recomputes in "
                    f"{P18['steps']} steps")
                _free(torch, dev)

        if run(19):
            with phase(19):
                log(f"[19/24] the data axes and the routes on a mesh: "
                    f"{P19['model']} at data={P19['data']}, {P19['embed']}, "
                    f"LoRA, TransferKV, the host tier, the ring and tiers at "
                    f"tensor=2, {P19['train']} training at data={P19['data']}")
                p19 = asyncio.run(dp_phase(torch, tatt, dev))
                log(f"  phase 19: {p19['seconds']:.1f} s, {p19['launches']} B1 "
                    f"launches at data={P19['data']}")
                _free(torch, dev)

        if run(20):
            with phase(20):
                log(f"[20/24] meshes the axes do not divide: {P20['model']} at "
                    f"tensor={P20['tensor']} (every block whole), "
                    f"{P20['embed']} at tensor={P20['embed_tensor']}, "
                    f"{P20['model']} training at tensor={P20['tensor']} and "
                    f"sequence=2, the compile watcher")
                p20 = asyncio.run(whole_phase(torch, tatt, dev))
                log(f"  phase 20: {p20['seconds']:.1f} s, "
                    f"{p20['serve']['prefill_launches']} B1 launches in a "
                    f"tensor={P20['tensor']} prefill")
                _free(torch, dev)

        if run(21):
            with phase(21):
                log(f"[21/24] the replica fleet: {P21['model']} workers of "
                    f"the port behind the port's supervisor, a SIGKILL and "
                    f"a failpoint healed")
                p21 = asyncio.run(fleet_phase(torch, tatt, dev))
                log(f"  phase 21: {p21['seconds']:.1f} s, "
                    f"{p21['profile']['b1_launches']} B1 launches in the "
                    f"worker's profile")
                _free(torch, dev)

        if run(22):
            with phase(22):
                log(f"[22/24] processes on the one card: {P22['tiny']} and "
                    f"{P22['model']} data-parallel over "
                    f"{P22['processes']} processes")
                p22 = dist_phase(torch, tatt, dev)
                log(f"  phase 22: {p22['seconds']:.1f} s, "
                    f"{p22['llama']['launches_per_step']} B1 launches a step "
                    f"in each process")
                _free(torch, dev)

        if run(23):
            with phase(23):
                log(f"[23/24] the plain gateway: `gateway --backend` (no "
                    f"--tpu) as a subprocess before a {P23['model']} "
                    f"sidecar, then with --workers {P23['workers']}")
                p23 = asyncio.run(plain_gateway_phase(torch, tatt, dev))
                log(f"  phase 23: {p23['seconds']:.1f} s, {json.dumps(p23)}")
                _free(torch, dev)

        if run(24):
            with phase(24):
                log(f"[24/24] compositions: the maximal sidecar (tiny-llama "
                    f"card vs cpu, then {P24['model']} with the "
                    f"{P24['draft']} draft at tensor={P24['tensor']}), the "
                    f"host tier, LoRA, the ring, the spec tick and "
                    f"{P24['moe']} on int8")
                p24 = asyncio.run(composition_phase(torch, tatt, dev))
                log(f"  phase 24: {p24['seconds']:.1f} s, "
                    f"{p24['lora']['launches']} B1 launches in (d), "
                    f"{p24['launches']} in the phase")
                _free(torch, dev)

        # No module of the JAX package ran in this process either.
        loaded = sorted(m for m, mod in sys.modules.items()
                        if mod is not None
                        and m.split(".")[0] == REFERENCE_PACKAGE)
        check(loaded == [], f"modules of the JAX package loaded: {loaded}")
    except SmokeError as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        return 1
    log(json.dumps({"phase_seconds": PHASE_SECONDS}))
    if only is not None:
        log(f"partial run of phases {sorted(only)}: "
            f"{time.perf_counter() - t_start:.1f} s, no result")
        return 0

    head = next(c for c in cases if c["name"] == HEADLINE)
    kernels = [dict(
        name="flash_attention", route="cuda",
        source="ggrmcp_tpu_torch/ops/csrc/flash_attention.cu",
        replaces="ggrmcp_tpu/ops/attention.py:286",
        launches=serve["launches"], embed_launches=embed["launches"],
        hf_launches=hf["launches"], hf_int8_launches=hf["int8_launches"],
        int8_launches=int8["bf16_kv"]["launches"],
        int8_kv_launches=int8["int8_kv"]["launches"],
        pfx_launches=reuse["pool"]["on"]["launches"],
        ilv_launches=reuse["interleave"]["on"]["launches"],
        paged_launches=reuse["paged"]["launches"],
        grammar_launches=grammar["on"]["launches"],
        jump_launches=grammar["on"]["jump_launches"],
        control_launches=control["launches"],
        paged_lora_launches=paged["launches"],
        host_tier_launches=paged["host_tier"]["launches"],
        disagg_lora_launches=paged["disagg"]["launches"],
        prefill_leg_launches=sum(
            c["leg1_launches"] for c in paged["disagg"]["calls"]),
        decode_leg_launches=sum(
            c["leg2_launches"] for c in paged["disagg"]["calls"]),
        spec_launches=p13["spec"]["launches"],
        verify_launches=p13["spec"]["verify_launches"],
        self_draft_launches=p13["self_draft"]["launches"],
        micro_launches=p13["micro"]["launches"],
        ring_launches=p13["ring"]["ring_launches"],
        tier_launches=p13["tiers"]["launches"],
        moe_launches=p14["launches"],
        moe_prefill_rel_err=p14["prefill"]["logits_rel_err"],
        tp_launches=p15["launches"],
        tp_downgrade_launches=p15["tiny"][
            f"tensor={P15['tiny_downgrade']}"]["launches"],
        tp_burst_launches=p15["serve"][str(P15["tensor"])]["burst_launches"],
        colaunch_launches=p16["colaunch_launches"],
        sp_launches=p17["sp"]["sp_launches"], pp_launches=p17["pp_launches"],
        sp_serve_launches=p17["sp_serve_launches"],
        sp_tensor_serve_launches=p17["sp_tensor_serve_launches"],
        sp_int8_launches={k: r["sequence1_launches"] + r["sp_launches"]
                          for k, r in p17["sp_int8"].items()},
        pp_composed_launches={k: r["launches"]
                              for k, r in p17["serve"].items()
                              if "stage" in k},
        sp_window_launches=p17["window"]["sp_launches"],
        train_launches=p18["cli"]["launches"],
        train_recomputes=p18["cli"]["recomputes"],
        train_launches_per_step=p18["cli"]["launches_per_step"],
        resume_launches=p18["resume"]["launches"],
        train_serve_launches=p18["serve"]["launches"],
        train_case=p18["attention"]["case"], train_ms=p18["attention"]["ms"],
        train_backward_ms=p18["attention"]["backward_ms"],
        train_plain_ms=p18["attention"]["plain_ms"],
        train_library_ms=p18["attention"]["library_ms"],
        train_library_fwd_ms=p18["attention"]["library_fwd_ms"],
        train_bound_ms=p18["attention"]["bound_ms"],
        train_bound_by=p18["attention"]["bound_by"],
        train_fwd_bwd_bound_ms=p18["attention"]["fwd_bwd_bound_ms"],
        train_max_abs_err=p18["attention"]["max_abs_err"],
        dp_launches=p19["launches"],
        dp_burst_launches=p19["serve"]["serve"][str(P19["data"])][
            "burst_launches"],
        dp_embed_launches=p19["embed"]["launches"][2],
        dp_lora_launches=p19["lora"]["tensor=2"]["launches"],
        dp_ring_launches=p19["ring_tiers"]["ring_tensor=2"]["launches"],
        dp_train_launches=p19["train"]["runs"][P19["data"]]["launches"],
        whole_launches=p20["serve"]["prefill_launches"],
        whole_embed_launches=p20["embed"]["launches"][P20["embed_tensor"]],
        whole_train_launches={k: r["launches"]
                              for k, r in p20["train"].items()},
        watch_launches=p20["watch"]["launches"],
        fleet_worker_launches=p21["profile"]["b1_launches"],
        composition_lora_launches=p24["lora"]["launches"],
        composition_int8_launches=p24["launches"] - p24["lora"]["launches"],
        fleet_sidecar_launches=p21["burst"]["sidecar_launches"],
        plain_gateway_launches=p23["launches"],
        dist_tiny_launches=[p["launches"]
                            for p in p22["tiny"]["processes"]],
        dist_launches_per_step=p22["llama"]["launches_per_step"],
        dist_case=p22["kernel"]["name"], dist_ms=p22["kernel"]["ms"],
        dist_ms_min=p22["kernel"]["ms_min"],
        dist_ms_max=p22["kernel"]["ms_max"],
        dist_plain_ms=p22["kernel"]["plain_ms"],
        dist_library_ms=p22["kernel"]["library_ms"],
        dist_bound_ms=p22["kernel"]["bound_ms"],
        dist_bound_by=p22["kernel"]["bound_by"],
        dist_max_abs_err=p22["kernel"]["max_abs_err"],
        dp_cases=[{k: c[k] for k in (
            "name", "ms", "ms_min", "ms_max", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "max_abs_err")}
            for c in p19["kernels"]],
        shard_case=p15["kernel"]["name"], shard_ms=p15["kernel"]["ms"],
        shard_bound_ms=p15["kernel"]["bound_ms"],
        shard_library_ms=p15["kernel"]["library_ms"],
        shard_max_abs_err=p15["kernel"]["max_abs_err"],
        max_abs_err=max([c["max_abs_err"] for c in cases + p19["kernels"]]
                        + [p15["kernel"]["max_abs_err"],
                           p18["attention"]["max_abs_err"],
                           p22["kernel"]["max_abs_err"]]),
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
