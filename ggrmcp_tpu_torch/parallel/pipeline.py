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

With stages on several processes (a mesh of parallel/distributed.py's
`global_mesh`), `_lm_loss_across` runs the same schedule with the
stages each process holds: a hop between processes is a send and a
receive, whose backward sends the activation's gradient back; the
loss is formed on the last stage's process, and `train_step` sums it
over the stage group.
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
    coords_group,
    gather_batch,
    local,
    ppermute,
    recv,
    replicate,
    send,
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


def _block(at: dict, coords, xs, pos, lens=None, rows=None, group=None):
    none = [None] * len(coords)
    return llama_mod.Block(at, list(coords), xs, pos, lens or none, none,
                           none, rows, group)


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


def _gpipe(n_stages: int, m_count: int, devs, inputs, block,
           hop=None) -> list:
    """The GPipe schedule: S + M - 1 ticks; at tick t each stage s with a
    live microbatch m = t - s runs `block(s, m, xs)` on its per-shard
    activations (stage 0 on `inputs(m)`), then the activations move one
    hop along the stage ring, tensor shard by tensor shard (`devs[s]`
    are stage s's shard devices; the last stage sends nothing). The
    reference computes and discards the fill / drain ticks; here they
    are skipped. Over processes a stage of other processes (its devices
    all None) is not run here, and `hop(s, m, ys)` moves stage s's
    outputs of microbatch m to stage s + 1 (sends and receives),
    returning that stage's inputs where this process holds it. Returns
    the last stage's outputs per microbatch (None where this process
    does not hold it)."""
    state: list = [None] * n_stages  # each stage's input, per tensor shard
    out: list = [None] * m_count
    for tick in range(n_stages + m_count - 1):
        produced: list = [None] * n_stages
        for st in range(n_stages):
            m = tick - st
            if not 0 <= m < m_count or all(d is None for d in devs[st]):
                continue
            y = block(st, m, inputs(m) if st == 0 else state[st])
            if st == n_stages - 1:
                out[m] = y
            else:
                produced[st] = y
        if hop is not None:
            state = [None] + [
                hop(st, tick - st, produced[st])
                if 0 <= tick - st < m_count else None
                for st in range(n_stages - 1)]
            continue
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
               pos: list, moe: bool, group=None):
    """This stage's local layer block on one microbatch's per-shard
    activations, no cache (the training path; `at` the stage and data
    coordinate, a MoE bank over its expert x tensor coordinates;
    `group` the processes holding the stage's other tensor shards).
    Returns (activations, the block's mean router aux loss, or None for
    a dense model)."""
    held = next(c for c in coords if local(layers["attn_norm"], c)
                is not None)
    n_local = local(layers["attn_norm"], held).shape[0]
    auxes: list = []
    ffn = moe_mod.sharded_ffn(layers, cfg, None, auxes) if moe else None
    blk, = llama_mod.tp_layers(
        layers, cfg, [_block(at, coords, xs, pos, group=group)],
        range(n_local), ffn=ffn)
    aux = None
    if moe:
        dev = blk.xs[llama_mod._first(blk.xs)].device
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
    """`training.lm_loss` through the pipeline (over processes when the
    stage axis crosses them: `_lm_loss_across`)."""
    from ggrmcp_tpu_torch.models.training import next_token_xent

    if (mesh.spans_processes
            and len(mesh_mod.axis_ranks(mesh, ("stage",))) > 1):
        return _lm_loss_across(params, cfg, tokens, mesh, num_microbatches)

    logits, aux = pipeline_forward_with_aux(params, cfg, tokens[:, :-1],
                                            mesh, num_microbatches)
    loss = next_token_xent(logits, tokens[:, 1:])
    if isinstance(cfg, moe_mod.MoEConfig):
        loss = loss + cfg.router_aux_weight * aux
    return loss


def _lm_loss_across(params: dict, cfg: llama_mod.LlamaConfig,
                    tokens: torch.Tensor, mesh: mesh_mod.Mesh,
                    num_microbatches: Optional[int] = None) -> torch.Tensor:
    """`pipeline_lm_loss` with stages on several processes, this
    process's share of it: each of its data blocks (`tokens` are its
    rows) runs the GPipe schedule with the stages it holds; a hop to or
    from another process's stage is a send or a receive (`collectives
    .send` / `recv`, tagged by block, stage and microbatch), whose
    backward carries the activation's gradient back. The embedding runs
    where stage 0 is, the final norm, the lm_head and the cross entropy
    where the last stage is (the reference runs them outside the staged
    block: one stage's process computes each, and the leaves stay
    replicated over stage). Returns the process's part of the loss: the
    cross entropy of its blocks' rows on the last stage's process, its
    stages' router aux losses over the S·M live blocks of every block,
    and the zero each send adds so that backward reaches it; the parts
    of the stage group's processes add up to the loss."""
    from ggrmcp_tpu_torch.models.training import next_token_xent

    n_stages = stage_count(mesh)
    m_count = num_microbatches or n_stages
    if cfg.num_layers % n_stages != 0:
        raise ValueError(
            f"{cfg.num_layers} layers not divisible by {n_stages} stages")
    moe = isinstance(cfg, moe_mod.MoEConfig)
    lcfg = dataclasses.replace(cfg, num_layers=cfg.num_layers // n_stages)
    layers = params["layers"]
    b, s = tokens.shape[0], tokens.shape[1] - 1
    blocks = mesh_mod.data_blocks(mesh, b)
    parts, auxes, sent = [], [], []
    for k, (rows, at) in enumerate(blocks):
        bd = rows.stop - rows.start
        if bd % m_count != 0:
            raise ValueError(
                f"batch {bd} not divisible by {m_count} microbatches")
        mb = bd // m_count
        coords, devs = zip(*(llama_mod.tensor_coords(mesh, **at, stage=st)
                             for st in range(n_stages)))
        # The tensor groups of the stages this process holds (another
        # stage's shards may form a group this process is not in).
        groups = [coords_group(mesh, c) if any(d is not None for d in ds)
                  else None for c, ds in zip(coords, devs)]
        dev = next(d for ds in devs for d in ds if d is not None)
        x0 = None
        if any(d is not None for d in devs[0]):
            x0 = llama_mod._vocab_embed(params["embed"], tokens[rows, :-1],
                                        cfg.torch_dtype, coords[0], devs[0],
                                        groups[0])
        positions = torch.arange(s, device=dev)[None, :].expand(mb, s)
        anchor = torch.zeros((), device=dev, requires_grad=True)
        like = (anchor, (mb, s, cfg.hidden_dim), cfg.torch_dtype)

        def block(st, m, xs):
            y, aux = _run_block(layers, lcfg, xs, {**at, "stage": st},
                                coords[st], replicate(positions, devs[st]),
                                moe, groups[st])
            if aux is not None:
                auxes.append(aux)
            return y

        def hop(st, m, ys):
            return _hop_across(mesh, coords[st], coords[st + 1],
                               devs[st + 1], ys, like,
                               (k * n_stages + st) * m_count + m, sent)

        out = _gpipe(n_stages, m_count, devs,
                     lambda m: [None if x is None else x[m * mb:(m + 1) * mb]
                                for x in x0], block, hop)
        if out[0] is None:
            continue
        xs = [None if o is None else torch.cat([y[i] for y in out], dim=0)
              for i, o in enumerate(out[0])]
        logits = llama_mod.tp_head(params, cfg, xs, coords[-1], groups[-1])
        parts.append(next_token_xent(logits, tokens[rows, 1:]) * (bd / b))
    loss = torch.zeros((), device=dev)
    for part in parts:
        loss = loss + part.to(dev)
    if moe and auxes:
        loss = loss + cfg.router_aux_weight * torch.stack(
            [a.to(dev) for a in auxes]).sum() / (
                n_stages * m_count * len(blocks))
    for zero in sent:
        loss = loss + zero.to(dev)
    return loss


def _hop_across(mesh, src, dst, dst_devs, ys, like, tag, sent) -> list:
    """One pipeline hop of a microbatch from the stage at coordinates
    `src` to the stage at `dst` (a tensor shard each): within this
    process a copy, to another process a send (once to each process; its
    zero into `sent`), from another process a receive of `like` = (the
    anchor its gradient hangs on, shape, dtype), shared by the shards
    this process holds. Returns the next stage's inputs per shard, None
    where this process holds none of it."""
    anchor, shape, dtype = like
    out: list = [None] * len(dst)
    to, got = set(), {}
    for i, (sc, dc) in enumerate(zip(src, dst)):
        a, b = mesh.owners[sc], mesh.owners[dc]
        if a == b == mesh.rank:
            out[i] = ys[i].to(dst_devs[i], non_blocking=True)
        elif a == mesh.rank and b not in to:
            to.add(b)
            sent.append(send(ys[i], b, tag))
        elif b == mesh.rank:
            if a not in got:
                got[a] = recv(anchor, shape, dtype, a, tag)
            out[i] = got[a]
    return out if any(o is not None for o in out) else None


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
