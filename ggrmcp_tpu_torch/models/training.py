"""The training step: LM loss, gradients, AdamW. Port of
`ggrmcp_tpu/models/training.py`.

- `lm_loss` is next-token cross entropy over [B, S] tokens (inputs
  `tokens[:, :-1]`, targets `tokens[:, 1:]`), through the family's
  forward without a cache; a sparse-MoE config adds `router_aux_weight`
  times the mean router load-balance loss (`moe.forward_with_aux`).
  Attention takes the dispatcher's path, so on the card every query
  longer than 8 runs the FlashAttention kernel forward, and its gradient
  is the plain version's (ops/attention.py `FlashAttentionFn`). The
  reference trains through XLA's attention at its default length; the
  function computed is the same.
- The optimizer is `torch.optim.AdamW` with optax `adamw`'s constants
  (b1 0.9, b2 0.999, eps 1e-8, eps_root 0, decay on every leaf): the
  same update up to rounding.
- Params stay the port's dict of stacked [L, ...] leaves, each stored
  tensor a leaf of autograd (`requires_grad`); nothing on the loss path
  writes one in place. On a mesh (`TrainState.specs`) the leaves are
  `Sharded`, the optimizer steps every stored part, and before it does,
  parts that hold the same parameters (a replica of a block, the
  replicated KV columns of the fused wqkv) get the sum of their
  gradients (`collectives.sum_tied_grads`), so replicas never drift
  apart. A `stage` axis above 1 trains through parallel/pipeline.py.
- With data blocks (`data` x `fsdp` above 1) the [B, S] batch splits
  over them (`mesh.data_blocks`): each block's rows run on its own
  coordinates, whose weights are the replicated leaves (on one device
  one stored tensor, which accumulates every block's gradient; on
  several, parts `sum_tied_grads` adds up). The blocks' logits come
  back in batch order and the loss is ONE mean over the global batch's
  tokens (a MoE aux term over the global batch's routing), so the
  blocks' gradients sum to the unsharded gradient. `fsdp` shards the
  batch as `data` does: the reference's specs shard no weight over it.
- On a mesh over several processes (parallel/distributed.py
  `global_mesh`), where any axis may cross processes, each process
  places the params on its own coordinates and runs the forward and
  backward of its rows of the global batch (`mesh.process_rows`) at
  them; the collectives reach the other processes' coordinates
  (parallel/collectives.py). Its loss is that of its rows' tokens over
  the global batch's token count (the MoE aux term, a function of the
  global batch's routing, times the same share), so the losses of the
  processes holding different rows add up to the global mean. A tensor
  or expert group's processes hold the same rows and the same loss:
  their split products give each of them the whole gradient of what
  they replicate (`copy_in`). The sequence axis (and a dense model's
  expert axis) is computed once per process, at its own index: each
  process computes its replica and reduces nothing over it. The
  gradients are then summed over the processes holding other rows (the
  batch axes' group, `collectives.all_reduce_grads`), and a leaf the
  stage axis replicates (the embedding, the final norm, the lm_head,
  which one stage computes) over the stages' processes too; so every
  process's AdamW sees the gradient of one mean over the global batch's
  tokens and its replicas stay the others'. The loss returned is the
  global one, on every process. A stage axis over processes is the
  pipeline's hops as sends and receives (parallel/pipeline.py).
- `TrainState` is mutable: `train_step` advances it in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ggrmcp_tpu_torch.models import common
from ggrmcp_tpu_torch.models import family_module
from ggrmcp_tpu_torch.models import llama as llama_mod
from ggrmcp_tpu_torch.models import moe as moe_mod
from ggrmcp_tpu_torch.parallel import mesh as mesh_mod
from ggrmcp_tpu_torch.parallel.collectives import (
    Sharded,
    all_reduce_grads,
    axis_group,
    group_for,
    process_sum,
    sum_tied_grads,
    wait_sends,
)

Params = common.Params


@dataclasses.dataclass
class TrainState:
    """Params, their optimizer and the count of steps taken. `specs`:
    the spec tree the params were sharded by (None on one device);
    `mesh`: the mesh the state was made for (None on one device), which
    may span processes."""

    params: Params
    optimizer: torch.optim.Optimizer
    step: int = 0
    specs: Optional[Params] = None
    mesh: Optional[mesh_mod.Mesh] = None


def next_token_xent(logits: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy: logits [B, S, V], targets [B, S];
    `log_softmax` in float32, then the targets' entries. The one loss of
    the plain and the pipelined trainers."""
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    picked = logprobs.gather(-1, targets.long().to(logits.device)[..., None])
    return -picked[..., 0].mean()


def lm_loss(params: Params, cfg: llama_mod.LlamaConfig,
            tokens: torch.Tensor,
            use_flash: Optional[bool] = None) -> torch.Tensor:
    """Next-token cross entropy over [B, S] with shift-by-one targets,
    plus the MoE router's weighted load-balance loss. `use_flash`: the
    forward's attention choice (None = auto, False = the plain
    attention)."""
    if isinstance(cfg, moe_mod.MoEConfig):
        logits, _, aux = moe_mod.forward_with_aux(
            params, cfg, tokens[:, :-1], use_flash=use_flash)
        return (next_token_xent(logits, tokens[:, 1:])
                + cfg.router_aux_weight * aux.to(logits.device))
    logits, _ = llama_mod.forward(params, cfg, tokens[:, :-1],
                                  use_flash=use_flash)
    return next_token_xent(logits, tokens[:, 1:])


def _parts(leaf) -> list[torch.Tensor]:
    return leaf.distinct() if isinstance(leaf, Sharded) else [leaf]


def named_leaves(tree: Params, prefix: str = ""):
    """(path, leaf) of every leaf, "layers.wqkv" style, in the tree's
    order."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from named_leaves(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def stored_tensors(params: Params) -> list[torch.Tensor]:
    """Every stored tensor of the tree once, in the tree's order (a
    `Sharded` leaf gives its distinct parts)."""
    out: dict[int, torch.Tensor] = {}
    for _, leaf in named_leaves(params):
        for t in _parts(leaf):
            out.setdefault(id(t), t)
    return list(out.values())


def make_optimizer(params: Params, learning_rate: float = 3e-4,
                   weight_decay: float = 0.01) -> torch.optim.AdamW:
    """AdamW over every stored tensor with optax `adamw`'s constants."""
    return torch.optim.AdamW(
        stored_tensors(params), lr=learning_rate, betas=(0.9, 0.999),
        eps=1e-8, weight_decay=weight_decay)


def mesh_specs(cfg: llama_mod.LlamaConfig,
               mesh: Optional[mesh_mod.Mesh]) -> Optional[Params]:
    """The specs a train state shards its params by on `mesh`: the
    family's, the layer dim over `stage` when the mesh pipelines; None
    on one coordinate."""
    if mesh is None or mesh.size == 1:
        return None
    if mesh_mod.axis_size(mesh, "stage") > 1:
        from ggrmcp_tpu_torch.parallel import pipeline

        return pipeline.param_specs_pp(cfg)
    return family_module(cfg).param_specs(cfg)


def make_train_state(
    params: Params,
    cfg: llama_mod.LlamaConfig,
    learning_rate: float = 3e-4,
    weight_decay: float = 0.01,
    mesh: Optional[mesh_mod.Mesh] = None,
    step: int = 0,
    moments: Optional[tuple[Params, Params]] = None,
) -> TrainState:
    """A train state over a whole tree: sharded IN PLACE onto `mesh`
    (when it has more than one coordinate), every stored tensor made a
    leaf that requires grad, AdamW built over them. `moments`: whole
    (exp_avg, exp_avg_sq) trees of the tree's shapes, with `step` the
    count of updates they hold (a resumed or carried state). On a mesh
    over processes, this process's coordinates only."""
    if mesh is not None and mesh.spans_processes:
        check_across(cfg, mesh)
    specs = mesh_specs(cfg, mesh)
    if specs is not None:
        params = llama_mod.shard_params(params, cfg, mesh, specs)
    for t in stored_tensors(params):
        t.requires_grad_(True)
    optimizer = make_optimizer(params, learning_rate, weight_decay)
    if moments is not None:
        avg, avg_sq = (dict(named_leaves(
            llama_mod.shard_params(m, cfg, mesh, specs) if specs is not None
            else m)) for m in moments)
        for name, leaf in named_leaves(params):
            for p, a, sq in zip(_parts(leaf), _parts(avg[name]),
                                _parts(avg_sq[name])):
                if a.shape != p.shape or sq.shape != p.shape:
                    raise ValueError(
                        f"moments of {name}: {tuple(a.shape)} / "
                        f"{tuple(sq.shape)} for a part of {tuple(p.shape)}")
                optimizer.state[p] = {
                    "step": torch.tensor(float(step)),
                    "exp_avg": a.to(p.device, p.dtype),
                    "exp_avg_sq": sq.to(p.device, p.dtype),
                }
    return TrainState(params, optimizer, step, specs, mesh)


def check_across(cfg: llama_mod.LlamaConfig, mesh: mesh_mod.Mesh) -> None:
    """Refuse what a mesh over processes cannot train, the same on every
    process: the replicated KV heads of a tensor axis that does not
    divide them, split over processes (each shard's gradient of those
    columns is summed within one process only)."""
    t = mesh.shape["tensor"]
    if (t > 1 and cfg.num_kv_heads % t
            and "attn" not in llama_mod.whole_blocks(cfg, t)
            and len(mesh_mod.axis_ranks(mesh, ("tensor",))) > 1):
        raise ValueError(
            f"{cfg.name} at tensor={t} over processes: {cfg.num_kv_heads} "
            f"KV heads replicated on every shard, whose gradients are tied "
            f"across processes; keep the tensor axis in one process or "
            f"make it divide the KV heads")


def init_train_state(
    cfg: llama_mod.LlamaConfig,
    device,
    seed: int = 0,
    learning_rate: float = 3e-4,
    weight_decay: float = 0.01,
    mesh: Optional[mesh_mod.Mesh] = None,
) -> TrainState:
    """A fresh state: the family's `init_params(cfg, device, seed)`."""
    params = family_module(cfg).init_params(cfg, torch.device(device), seed)
    return make_train_state(params, cfg, learning_rate, weight_decay, mesh)


def _tie_grads(params: Params, specs: Params,
               cfg: llama_mod.LlamaConfig) -> None:
    """Sum the gradients of every leaf's replicas (`sum_tied_grads`). A
    whole block's leaf is computed once per device, so each replica
    holds the gradient of its own device's uses, and the sum is the
    whole gradient, not a multiple of it."""
    for key, spec in specs.items():
        group = (params[key].items() if isinstance(spec, dict)
                 else [(key, params[key])])
        subs = spec if isinstance(spec, dict) else {key: spec}
        for name, leaf in group:
            if isinstance(leaf, Sharded):
                whole = llama_mod.whole_leaves(cfg,
                                               leaf.mesh.shape["tensor"])
                adapted = llama_mod.placed_spec(subs[name], leaf.shape,
                                                leaf.mesh, name in whole)
                sum_tied_grads(leaf, adapted,
                               llama_mod.shard_index_fn(cfg, name))


def train_step(
    state: TrainState,
    tokens: torch.Tensor,  # [B, S] on the params' (first) device
    cfg: llama_mod.LlamaConfig,
    loss_fn: Optional[Callable] = None,
) -> tuple[TrainState, torch.Tensor]:
    """One optimization step, in place: `loss_fn(params, cfg, tokens)`
    (default `lm_loss`), its gradients (tied across replicas on a mesh,
    and over processes on a mesh that spans them, where each process
    takes its rows of the global `tokens`), one AdamW update. Returns
    (the state, the loss over all of `tokens`, detached)."""
    state.optimizer.zero_grad(set_to_none=True)
    mesh = state.mesh
    spans = mesh is not None and mesh.spans_processes
    if spans:
        rows = mesh_mod.process_rows(mesh, tokens.shape[0])
        # Its rows' mean over the global batch: every row has as many
        # tokens, so the losses of the processes holding different rows
        # add up to the global mean.
        share = (rows.stop - rows.start) / tokens.shape[0]
        loss = (loss_fn or lm_loss)(state.params, cfg, tokens[rows]) * share
    else:
        loss = (loss_fn or lm_loss)(state.params, cfg, tokens)
    loss.backward()
    if spans:
        wait_sends()
    if state.specs is not None:
        _tie_grads(state.params, state.specs, cfg)
    if spans:
        _reduce_across(state.params, mesh)
        group = axis_group(mesh, _LOSS_AXES)
        if group is not None:
            loss = process_sum(loss, group)
    state.optimizer.step()
    state.step += 1
    return state, loss.detach()


# The processes whose losses add up to the global one: those holding
# other rows, and other stages (the loss is formed on the last).
_LOSS_AXES = (*mesh_mod.BATCH_AXES, "stage")


def _reduce_across(params: Params, mesh: mesh_mod.Mesh) -> None:
    """Sum each stored tensor's gradient over the processes that hold
    its block and computed a different part of it: the batch axes'
    group, and for a leaf the stage axis replicates (one stage uses it)
    the stages' processes too. A tensor no backward reached takes a zero
    gradient, so every process of a group reduces the same buckets."""
    by_group: dict = {}
    for _, leaf in named_leaves(params):
        staged = isinstance(leaf, Sharded) and "stage" in {
            n for e in (leaf.spec or ()) if e is not None
            for n in (e if isinstance(e, tuple) else (e,))}
        axes = mesh_mod.BATCH_AXES if staged else _LOSS_AXES
        ranks = mesh_mod.axis_ranks(mesh, axes)
        for t in _parts(leaf):
            if t.grad is None:
                t.grad = torch.zeros_like(t)
            by_group.setdefault(ranks, {})[id(t)] = t
    # The wider group first: every process then meets its groups in one
    # order (a batch group lies inside its batch-and-stage group).
    for ranks in sorted(by_group, key=lambda r: (-len(r), r)):
        if len(ranks) > 1:
            all_reduce_grads(list(by_group[ranks].values()),
                             group_for(mesh, ranks))
