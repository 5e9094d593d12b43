"""Pipeline parallelism (PP) over the mesh's `stage` axis: the serving
half of `ggrmcp_tpu/parallel/pipeline.py` on the single-controller mesh.

- The stacked [L, ...] layer weights and the KV cache are sharded over
  `stage` on the layer dim (`param_specs_pp`, `cache_specs_pp`): stage s
  holds layers [s·L/S, (s+1)·L/S) on its coordinates' devices. Tensor
  parallelism composes inside a stage (`llama.tp_layers` over the
  stage's tensor shards).
- `pipeline_forward_cached` runs the reference's GPipe schedule: S + M -
  1 ticks over M microbatches (slices of the batch), each live (stage,
  tick) pair running the stage's local layers on its microbatch against
  the stage's cache rows, then the activations move one hop along the
  stage ring (`ppermute`). The reference computes and discards the
  junk fill / drain ticks; here they are skipped, with the same
  result. The embedding runs at stage 0, the final norm and the lm_head
  at the last stage.
- A stage's attention is pinned to the plain path (`use_flash=False`),
  as the reference pins its XLA path (`_run_block_cached`), so B1 does
  not launch under PP.

Dense Llama serving only (the engine refuses the rest); the training
half (`pipeline_forward`, `pipeline_lm_loss`, the train step) waits for
the port of training (ROADMAP A19c).
"""

from __future__ import annotations

import dataclasses

import torch

from ggrmcp_tpu_torch.models import llama as llama_mod
from ggrmcp_tpu_torch.parallel import mesh as mesh_mod
from ggrmcp_tpu_torch.parallel.collectives import ppermute, replicate


def stage_count(mesh: mesh_mod.Mesh) -> int:
    return mesh_mod.axis_size(mesh, "stage")


def param_specs_pp(cfg: llama_mod.LlamaConfig) -> dict:
    """`param_specs` with the stacked layer dim sharded over `stage`
    (the tensor axes unchanged: PP x TP compose)."""
    specs = llama_mod.param_specs(cfg)
    specs["layers"] = {name: ("stage", *spec[1:])
                       for name, spec in specs["layers"].items()}
    return specs


def cache_specs_pp() -> dict:
    """The staged KV cache: layer dim over `stage`, batch over data,
    heads over tensor."""
    spec = ("stage", ("data", "fsdp"), None, "tensor", None)
    return {"k": spec, "v": spec, "length": (("data", "fsdp"),)}


def _run_block_cached(layers, cfg, xs, coords, pos, lens, cache, rows,
                      ring: bool) -> list:
    """This stage's local layer block (at `coords`, its tensor shards)
    on one microbatch's activations, threading the stage's cache rows
    `rows`; attention pinned to the plain path."""
    n_local = layers["attn_norm"].parts[coords[0]].shape[0]
    none = [None] * len(coords)
    return llama_mod.tp_layers(layers, cfg, xs, coords, range(n_local), pos,
                               lens, none, cache, rows=rows,
                               use_flash=False, ring=ring)


def pipeline_forward_cached(
    params: dict,
    cfg: llama_mod.LlamaConfig,
    tokens: torch.Tensor,  # [B, S]
    cache: llama_mod.KVCache,  # k/v [L, B, S_max + 1, KVH, D], staged
    mesh: mesh_mod.Mesh,
    ring: bool = False,
) -> tuple[torch.Tensor, llama_mod.KVCache]:
    """`llama.forward(..., cache=...)` with the layer stack and its KV
    cache pipelined over `stage`: prefill (S > 1) and decode (S = 1)
    alike; microbatches split the batch (one a stage when the stages
    divide it, as the reference's default). `ring`: the cache is a ring of
    its capacity (every stage's block alike: positions and lengths are
    global). Returns (float32 logits [B, S, V] on the controller, the
    cache with its length advanced)."""
    n_stages = stage_count(mesh)
    if n_stages == 1:
        return llama_mod.forward(params, cfg, tokens, cache, ring=ring)
    b, s = tokens.shape
    m_count = n_stages if b % n_stages == 0 else 1
    if cfg.num_layers % n_stages != 0:
        raise ValueError(
            f"{cfg.num_layers} layers not divisible by {n_stages} stages")
    mb = b // m_count
    coords, devs = zip(*(llama_mod.tensor_coords(mesh, stage=st)
                         for st in range(n_stages)))
    lcfg = dataclasses.replace(cfg, num_layers=cfg.num_layers // n_stages)
    steps = torch.arange(s, device=tokens.device)[None, :]
    positions = cache.length.long()[:, None] + steps
    x0 = llama_mod._vocab_embed(params["embed"], tokens, cfg.torch_dtype,
                                coords[0], devs[0])
    rows = [slice(m * mb, (m + 1) * mb) for m in range(m_count)]
    layers = params["layers"]
    state: list = [None] * n_stages  # each stage's input, per tensor shard
    out: list = [None] * m_count
    for tick in range(n_stages + m_count - 1):
        produced: list = [None] * n_stages
        for st in range(n_stages):
            m = tick - st
            if not 0 <= m < m_count:
                continue  # a fill / drain tick: the reference discards it
            xs = ([x[rows[m]] for x in x0] if st == 0 else state[st])
            y = _run_block_cached(
                layers, lcfg, xs, coords[st],
                replicate(positions[rows[m]], devs[st]),
                replicate(cache.length[rows[m]], devs[st]), cache, rows[m],
                ring)
            if st == n_stages - 1:
                out[m] = y
            else:
                produced[st] = y
        # One hop along the stage ring, tensor shard by tensor shard
        # (the last stage sends nothing: its output is `out`).
        hops = [ppermute([None if y is None else y[i] for y in produced],
                         [d[i] for d in devs])
                for i in range(len(coords[0]))]
        state = [None if hops[0][st] is None
                 else [hop[st] for hop in hops] for st in range(n_stages)]
    xs = [torch.cat([o[i] for o in out], dim=0)
          for i in range(len(coords[-1]))]
    logits = llama_mod.tp_head(params, cfg, xs, coords[-1])
    cache.length = cache.length + s
    return logits.to(tokens.device), cache
