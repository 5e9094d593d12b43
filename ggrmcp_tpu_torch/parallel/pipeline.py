"""Pipeline parallelism (PP) over the mesh's `stage` axis: the port of
`ggrmcp_tpu/parallel/pipeline.py` on the single-controller mesh, its
serving half and its training half.

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
- With data blocks (`data` x `fsdp` above 1) each block runs its own
  schedule over its rows on its own coordinates, its microbatches cut
  from its rows; the staged cache is split by slot like the unstaged
  one.

Dense Llama serving only (the engine refuses the rest).

The training half (`pipeline_layers`, `pipeline_forward(_with_aux)`,
`pipeline_lm_loss`, `make_pipeline_train_step`) runs the same schedule
without a cache, for either decoder family: M microbatches (default one
a stage; the batch must divide), each stage's block of layers through
`llama.tp_layers` (a MoE layer's bank over the stage's expert x tensor
coordinates, `moe.sharded_ffn`, routing each microbatch on its own as
the reference does; with data blocks, each block's microbatches on
their own), activations moved by `ppermute`, which autograd
carries back stage to stage. Its attention is the dispatcher's (B1 on
the card), as the reference's training block leaves its attention on
auto. The router's load-balance loss is the mean over every live
(stage, microbatch) block, the reference's psum / (S·M).
"""

from __future__ import annotations

import dataclasses

import torch

from typing import Optional

from ggrmcp_tpu_torch.models import family_module
from ggrmcp_tpu_torch.models import llama as llama_mod
from ggrmcp_tpu_torch.models import moe as moe_mod
from ggrmcp_tpu_torch.parallel import mesh as mesh_mod
from ggrmcp_tpu_torch.parallel.collectives import (
    gather_batch,
    local,
    ppermute,
    replicate,
)


def stage_count(mesh: mesh_mod.Mesh) -> int:
    return mesh_mod.axis_size(mesh, "stage")


def param_specs_pp(cfg: llama_mod.LlamaConfig) -> dict:
    """The family's `param_specs` with the stacked layer dim sharded
    over `stage` (the tensor and expert axes unchanged: PP x TP x EP
    compose)."""
    specs = family_module(cfg).param_specs(cfg)
    specs["layers"] = {name: ("stage", *spec[1:])
                       for name, spec in specs["layers"].items()}
    return specs


def cache_specs_pp() -> dict:
    """The staged KV cache: layer dim over `stage`, batch over data,
    heads over tensor."""
    spec = ("stage", mesh_mod.BATCH_AXES, None, "tensor", None)
    return {"k": spec, "v": spec, "length": (mesh_mod.BATCH_AXES,)}


def _block(at: dict, coords, xs, pos, lens=None, rows=None):
    none = [None] * len(coords)
    return llama_mod.Block(at, list(coords), xs, pos, lens or none, none,
                           none, rows)


def _run_block_cached(layers, cfg, xs, at, coords, pos, lens, cache, rows,
                      ring: bool) -> list:
    """This stage's local layer block (at `coords`, its tensor shards;
    `at` its stage and data coordinate) on one microbatch's activations,
    threading the stage's cache rows `rows`; attention pinned to the
    plain path."""
    n_local = layers["attn_norm"].parts[coords[0]].shape[0]
    blk, = llama_mod.tp_layers(
        layers, cfg, [_block(at, coords, xs, pos, lens, rows)],
        range(n_local), cache, use_flash=False, ring=ring)
    return blk.xs


def _gpipe(n_stages: int, m_count: int, devs, inputs, block) -> list:
    """The GPipe schedule: S + M - 1 ticks; at tick t each stage s with a
    live microbatch m = t - s runs `block(s, m, xs)` on its per-shard
    activations (stage 0 on `inputs(m)`), then the activations move one
    hop along the stage ring, tensor shard by tensor shard (`devs[s]`
    are stage s's shard devices; the last stage sends nothing). The
    reference computes and discards the fill / drain ticks; here they
    are skipped. Returns the last stage's outputs per microbatch."""
    state: list = [None] * n_stages  # each stage's input, per tensor shard
    out: list = [None] * m_count
    for tick in range(n_stages + m_count - 1):
        produced: list = [None] * n_stages
        for st in range(n_stages):
            m = tick - st
            if not 0 <= m < m_count:
                continue
            y = block(st, m, inputs(m) if st == 0 else state[st])
            if st == n_stages - 1:
                out[m] = y
            else:
                produced[st] = y
        hops = [ppermute([None if y is None else y[i] for y in produced],
                         [d[i] for d in devs])
                for i in range(len(devs[0]))]
        state = [None if hops[0][st] is None
                 else [hop[st] for hop in hops] for st in range(n_stages)]
    return out


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
    if cfg.num_layers % n_stages != 0:
        raise ValueError(
            f"{cfg.num_layers} layers not divisible by {n_stages} stages")
    lcfg = dataclasses.replace(cfg, num_layers=cfg.num_layers // n_stages)
    steps = torch.arange(s, device=tokens.device)[None, :]
    positions = cache.length.long()[:, None] + steps
    splits = mesh_mod.data_blocks(mesh, b)
    whole = llama_mod.cache_batch_blocks(cache) == 1
    layers = params["layers"]
    outs = []
    for block_rows, at in splits:
        start, bd = block_rows.start, block_rows.stop - block_rows.start
        m_count = n_stages if bd % n_stages == 0 else 1
        mb = bd // m_count
        coords, devs = zip(*(llama_mod.tensor_coords(mesh, **at, stage=st)
                             for st in range(n_stages)))
        x0 = llama_mod._vocab_embed(params["embed"], tokens[block_rows],
                                    cfg.torch_dtype, coords[0], devs[0])
        # Cache rows are the block's own when the cache is split by slot.
        off = start if whole else 0

        def block(st, m, xs):
            rows = slice(start + m * mb, start + (m + 1) * mb)
            return _run_block_cached(
                layers, lcfg, xs, {**at, "stage": st}, coords[st],
                replicate(positions[rows], devs[st]),
                replicate(cache.length[rows], devs[st]), cache,
                slice(rows.start - start + off, rows.stop - start + off),
                ring)

        out = _gpipe(n_stages, m_count, devs,
                     lambda m: [x[m * mb:(m + 1) * mb] for x in x0], block)
        xs = [torch.cat([o[i] for o in out], dim=0)
              for i in range(len(coords[-1]))]
        outs.append(llama_mod.tp_head(params, cfg, xs, coords[-1]))
    cache.length = cache.length + s
    return gather_batch(outs).to(tokens.device), cache


# ---------------------------------------------------------------------------
# Training over the pipeline
# ---------------------------------------------------------------------------


def shard_params_pp(params: dict, cfg: llama_mod.LlamaConfig,
                    mesh: mesh_mod.Mesh) -> dict:
    """Place a whole tree with PP x TP (x EP) shardings, IN PLACE (the
    layer dim over `stage`; a dim an axis does not divide replicated)."""
    return llama_mod.shard_params(params, cfg, mesh, param_specs_pp(cfg))


def _run_block(layers, cfg, xs: list, at: dict, coords: list[int],
               pos: list, moe: bool):
    """This stage's local layer block on one microbatch's per-shard
    activations, no cache (the training path; `at` the stage and data
    coordinate, a MoE bank over its expert x tensor coordinates).
    Returns (activations, the block's mean router aux loss, or None for
    a dense model)."""
    n_local = local(layers["attn_norm"], coords[0]).shape[0]
    auxes: list = []
    ffn = moe_mod.sharded_ffn(layers, cfg, None, auxes) if moe else None
    blk, = llama_mod.tp_layers(layers, cfg, [_block(at, coords, xs, pos)],
                               range(n_local), ffn=ffn)
    aux = None
    if moe:
        dev = blk.xs[0].device
        aux = torch.stack([a.to(dev) for a in auxes]).mean()
    return blk.xs, aux


def pipeline_layers(
    layers: dict,
    cfg: llama_mod.LlamaConfig,
    x: torch.Tensor,  # [B, S, D]
    positions: torch.Tensor,  # [B, S]
    mesh: mesh_mod.Mesh,
    num_microbatches: Optional[int] = None,
    at: Optional[dict] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The stacked layer block through the stage pipeline at data
    coordinate `at` (default index 0): (activations [B, S, D] on the
    last stage's first device, the mean router aux loss (0 for dense)).
    B must divide into `num_microbatches` (default the stage count) and
    the layers into the stages."""
    n_stages = stage_count(mesh)
    m_count = num_microbatches or n_stages
    b = x.shape[0]
    if b % m_count != 0:
        raise ValueError(
            f"batch {b} not divisible by {m_count} microbatches")
    if cfg.num_layers % n_stages != 0:
        raise ValueError(
            f"{cfg.num_layers} layers not divisible by {n_stages} stages")
    moe = isinstance(cfg, moe_mod.MoEConfig)
    mb = b // m_count
    at = at or {}
    coords, devs = zip(*(llama_mod.tensor_coords(mesh, **at, stage=st)
                         for st in range(n_stages)))
    lcfg = dataclasses.replace(cfg, num_layers=cfg.num_layers // n_stages)
    rows = [slice(m * mb, (m + 1) * mb) for m in range(m_count)]
    auxes: list = []

    def block(st, m, xs):
        y, aux = _run_block(
            layers, lcfg, xs, {**at, "stage": st}, coords[st],
            replicate(positions[rows[m]], devs[st]), moe)
        if aux is not None:
            auxes.append(aux)
        return y

    out = [y[0] for y in _gpipe(n_stages, m_count, devs,
                                lambda m: replicate(x[rows[m]], devs[0]),
                                block)]
    dev = out[0].device
    aux = (torch.stack([a.to(dev) for a in auxes]).mean() if auxes
           else torch.zeros((), device=dev))
    return torch.cat(out, dim=0), aux


def pipeline_forward_with_aux(
    params: dict,
    cfg: llama_mod.LlamaConfig,
    tokens: torch.Tensor,  # [B, S]
    mesh: mesh_mod.Mesh,
    num_microbatches: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The full forward (embed at stage 0, the staged layers, the final
    norm and lm_head at the last stage) for training and scoring: (float32
    logits [B, S, V] on tokens' device, the mean router aux loss). One
    stage is the family's own forward. Each data block pipelines its own
    rows; the aux loss is the mean over every block's."""
    b, s = tokens.shape
    if stage_count(mesh) == 1:
        if isinstance(cfg, moe_mod.MoEConfig):
            logits, _, aux = moe_mod.forward_with_aux(params, cfg, tokens)
            return logits, aux.to(logits.device)
        logits, _ = llama_mod.forward(params, cfg, tokens)
        return logits, torch.zeros((), device=logits.device)
    logits, auxes = [], []
    for rows, at in mesh_mod.data_blocks(mesh, b):
        first, first_devs = llama_mod.tensor_coords(mesh, **at, stage=0)
        last, last_devs = llama_mod.tensor_coords(
            mesh, **at, stage=stage_count(mesh) - 1)
        x = llama_mod._vocab_embed(params["embed"], tokens[rows],
                                   cfg.torch_dtype, first, first_devs)[0]
        positions = torch.arange(s, device=x.device)[None, :].expand(
            x.shape[0], s)
        x, aux = pipeline_layers(params["layers"], cfg, x, positions, mesh,
                                 num_microbatches, at)
        logits.append(llama_mod.tp_head(params, cfg,
                                        replicate(x, last_devs), last))
        auxes.append(aux.to(tokens.device))
    return (gather_batch(logits).to(tokens.device),
            torch.stack(auxes).mean())


def pipeline_forward(
    params: dict,
    cfg: llama_mod.LlamaConfig,
    tokens: torch.Tensor,
    mesh: mesh_mod.Mesh,
    num_microbatches: Optional[int] = None,
) -> torch.Tensor:
    """`pipeline_forward_with_aux`'s logits (the contract of
    `llama.forward(..., cache=None)`)."""
    return pipeline_forward_with_aux(params, cfg, tokens, mesh,
                                     num_microbatches)[0]


def pipeline_lm_loss(params: dict, cfg: llama_mod.LlamaConfig,
                     tokens: torch.Tensor, mesh: mesh_mod.Mesh,
                     num_microbatches: Optional[int] = None) -> torch.Tensor:
    """`training.lm_loss` through the pipeline."""
    from ggrmcp_tpu_torch.models.training import next_token_xent

    logits, aux = pipeline_forward_with_aux(params, cfg, tokens[:, :-1],
                                            mesh, num_microbatches)
    loss = next_token_xent(logits, tokens[:, 1:])
    if isinstance(cfg, moe_mod.MoEConfig):
        loss = loss + cfg.router_aux_weight * aux
    return loss


def make_pipeline_train_step(cfg: llama_mod.LlamaConfig,
                             mesh: mesh_mod.Mesh,
                             num_microbatches: Optional[int] = None):
    """(TrainState, tokens [B, S]) -> (TrainState, loss): `train_step`
    with the forward and backward staged over `stage` (gradients flow
    back through the `ppermute` hops, the reverse schedule)."""
    from ggrmcp_tpu_torch.models import training

    def loss(params, cfg, tokens):
        return pipeline_lm_loss(params, cfg, tokens, mesh, num_microbatches)

    def step(state, tokens):
        return training.train_step(state, tokens, cfg, loss)

    return step
