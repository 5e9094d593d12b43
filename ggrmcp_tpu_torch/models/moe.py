"""Sparse Mixture-of-Experts decoder (Mixtral-style). Port of
`ggrmcp_tpu/models/moe.py`, on one device or over an expert x tensor
mesh (`param_specs`, `moe_ffn_sharded`).

- The attention trunk is `llama.attention_block`, so every cache layout
  the dense family serves reaches MoE unchanged: contiguous, ring and
  int8 KV (a paged cache is refused, as the reference's engine refuses
  it). Weights are stacked [L, ...] like the dense family's; the expert
  banks are [L, E, D, F] / [L, E, F, D] and the router [L, D, E] stays
  float32 whatever the model dtype.
- Routing is the reference's capacity-based top-k: a float32 router,
  softmax, top-k (ties to the lower expert id, as `lax.top_k`), the k
  probabilities renormalised; each (token, k) pair takes the exclusive
  prefix count of its expert in the flattened (token, k) order as its
  slot, and a pair at or past `capacity` is dropped (zero combine
  weight: it rides the residual). `valid` zeroes padding before the
  count, so padding neither takes a slot nor contributes output.
- `route` and `moe_ffn_ref` keep the reference's one-hot form
  (dispatch and combine [T, E, C] tensors, four einsums). `moe_ffn`,
  the serving form, computes the same function by index: each (token,
  k) pair is copied into its [E, C, D] slot (dropped and padding pairs
  into a scratch row), the experts run as three batched products, and
  each token sums its k weighted expert outputs. At a [32, 512]
  admission of mixtral-8x7b the one-hot tensors would hold 16384 · 8 ·
  5120 floats each.
- On a mesh the banks shard over `expert` (the expert dim) and
  `tensor` (the FFN dim); attention is the dense family's tensor
  parallelism. Routing (`moe_ffn_sharded`) runs ONCE, over every data
  block's rows in batch order: the capacity is batch-global, so
  per-shard or per-block routing could drop other pairs. Each block's
  shards run their experts' rows of the one assignment, for the block's
  own tokens, through their slice of the banks, and one all-reduce over
  the block's expert x tensor coordinates sums the weighted outputs.
- Over processes (training on a mesh of parallel/distributed.py's
  `global_mesh`) the routing stays batch-global: a process routes its
  own rows, each pair's slot counts the pairs of the processes before it
  in batch order (an all-gather of their per-expert counts over the
  batch axes' group), the capacity is that of the global token count,
  and the aux loss takes its fractions and mean probabilities over the
  global batch (sums over that group; the mean probability's gradient
  summed back over it, each process's loss carrying its rows' share).
  A bank split over processes (expert, or expert x tensor) runs each
  process's experts on the block's tokens, which every process of the
  block holds, and one all-reduce over their group sums the weighted
  outputs; the tokens and the combine weights enter it by `copy_in`, so
  each process holds the whole gradient of both.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch.autograd import profiler as _profiler

from ggrmcp_tpu_torch.models import common
from ggrmcp_tpu_torch.models import llama
from ggrmcp_tpu_torch.models.llama import KVCache, LlamaConfig  # noqa: F401
from ggrmcp_tpu_torch.ops import quant
from ggrmcp_tpu_torch.ops.quant import QuantizedTensor
from ggrmcp_tpu_torch.parallel import mesh as mesh_mod
from ggrmcp_tpu_torch.parallel.collectives import (
    all_reduce_sum,
    axis_group,
    coords_group,
    copy_in,
    gather_batch,
    local,
    per_device,
    process_gather,
    process_sum,
    replicate,
    sum_across,
)
from ggrmcp_tpu_torch.utils import regions

Params = common.Params


@dataclasses.dataclass(frozen=True)
class MoEConfig(LlamaConfig):
    name: str = "moe"
    num_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    # Router auxiliary-loss weight (the reference's training path).
    router_aux_weight: float = 0.01


# The reference registry, same names and values.
CONFIGS: dict[str, MoEConfig] = {
    "tiny-moe": MoEConfig(
        name="tiny-moe", vocab_size=512, hidden_dim=256, num_layers=2,
        num_heads=8, num_kv_heads=4, head_dim=32, ffn_dim=512,
        max_seq_len=1024, num_experts=4, experts_per_token=2,
        dtype="float32",
    ),
    "moe-2b": MoEConfig(
        name="moe-2b", vocab_size=32000, hidden_dim=2048, num_layers=12,
        num_heads=16, num_kv_heads=8, head_dim=128, ffn_dim=2816,
        max_seq_len=4096, num_experts=8, experts_per_token=2,
    ),
    # The published Mixtral-8x7B architecture.
    "mixtral-8x7b": MoEConfig(
        name="mixtral-8x7b", vocab_size=32000, hidden_dim=4096,
        num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
        ffn_dim=14336, max_seq_len=8192, rope_theta=1000000.0,
        num_experts=8, experts_per_token=2,
    ),
    # Windowed MoE (Mixtral-8x7B-v0.1 carried sliding_window=4096): a
    # 16-key window keeps the ring's wrap testable on the CPU.
    "tiny-moe-sw": MoEConfig(
        name="tiny-moe-sw", vocab_size=512, hidden_dim=256, num_layers=2,
        num_heads=8, num_kv_heads=4, head_dim=32, ffn_dim=512,
        max_seq_len=1024, num_experts=4, experts_per_token=2,
        sliding_window=16, dtype="float32",
    ),
}


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def param_shapes(cfg: MoEConfig) -> Params:
    """The shape of every leaf `init_params` makes, in the same tree."""
    d, n_layers, e, f = (cfg.hidden_dim, cfg.num_layers, cfg.num_experts,
                         cfg.ffn_dim)
    qkv_out = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    return {
        "embed": (cfg.vocab_size, d),
        "layers": {
            "attn_norm": (n_layers, d),
            "wqkv": (n_layers, d, qkv_out),
            "wo": (n_layers, cfg.num_heads * cfg.head_dim, d),
            "mlp_norm": (n_layers, d),
            "router": (n_layers, d, e),
            "w_gate": (n_layers, e, d, f),
            "w_up": (n_layers, e, d, f),
            "w_down": (n_layers, e, f, d),
        },
        "final_norm": (d,),
        "lm_head": (d, cfg.vocab_size),
    }


def init_params(cfg: MoEConfig, device: torch.device, seed: int = 0) -> Params:
    """Random weights at the reference's init scales, drawn on `device`
    from a seeded torch.Generator, one layer (one expert of a bank) at a
    time, so the float32 scratch stays that size. The router is float32;
    every other leaf is in the model dtype. The values differ from JAX's;
    parity tests cross weights through models/convert.py instead."""
    dtype = cfg.torch_dtype
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, n_layers = cfg.hidden_dim, cfg.num_layers
    shapes = param_shapes(cfg)["layers"]
    kw = dict(generator=gen, device=device)

    def stacked(name: str, fan_in: int, leaf_dtype=dtype):
        shape = shapes[name]
        # A 4-D bank draws as L·E stacked [in, out] matrices.
        return common.init_stacked(
            shape[0] * shape[1] if len(shape) == 4 else shape[0],
            shape[-2:], leaf_dtype, scale=fan_in ** -0.5, **kw,
        ).view(shape)

    return {
        "embed": common.init_dense(cfg.vocab_size, d, dtype, scale=0.02, **kw),
        "layers": {
            "attn_norm": torch.ones((n_layers, d), dtype=dtype, device=device),
            "wqkv": stacked("wqkv", d),
            "wo": stacked("wo", cfg.num_heads * cfg.head_dim),
            "mlp_norm": torch.ones((n_layers, d), dtype=dtype, device=device),
            # Routing decisions are precision-sensitive.
            "router": stacked("router", d, torch.float32),
            "w_gate": stacked("w_gate", d),
            "w_up": stacked("w_up", d),
            "w_down": stacked("w_down", cfg.ffn_dim),
        },
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
        "lm_head": common.init_dense(d, cfg.vocab_size, dtype,
                                     scale=d ** -0.5, **kw),
    }


def param_specs(cfg: MoEConfig) -> Params:
    """EP x TP: expert banks sharded over `expert` on the expert dim and
    `tensor` on the FFN dim; the router is replicated; attention is TP
    like the dense family's."""
    specs = llama.param_specs(cfg)
    specs["layers"].update({
        "router": (None, None, None),
        "w_gate": (None, "expert", None, "tensor"),
        "w_up": (None, "expert", None, "tensor"),
        "w_down": (None, "expert", "tensor", None),
    })
    return specs


# ---------------------------------------------------------------------------
# MoE FFN: capacity-based top-k dispatch
# ---------------------------------------------------------------------------


def _capacity(cfg: MoEConfig, num_tokens: int) -> int:
    """Per-expert slot count for `num_tokens` routed tokens: max(8,
    ceil8(capacity_factor · T · k / E))."""
    cap = int(
        cfg.capacity_factor * num_tokens * cfg.experts_per_token
        / cfg.num_experts
    )
    return max(8, -(-cap // 8) * 8)


def _assign(
    x: torch.Tensor, router: torch.Tensor, cfg: MoEConfig, capacity: int,
    valid: Optional[torch.Tensor], group=None,
):
    """The routing decisions of [T, D] tokens: (probs [T, E] float32,
    renormalised top-k probabilities [T, K], expert ids [T, K], slots
    [T, K], kept [T, K]: the pair is a real token's and within
    capacity). `group`: the processes holding the batch's other rows,
    whose pairs before this process's count in every slot."""
    t = x.shape[0]
    e, k = cfg.num_experts, cfg.experts_per_token
    probs = torch.softmax(x.float() @ router.float(), dim=-1)  # [T, E]
    # lax.top_k's order: descending, ties to the lower index.
    topk_p, topk_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    topk_p, topk_i = topk_p[:, :k], topk_i[:, :k]
    topk_p = topk_p / torch.clamp(topk_p.sum(-1, keepdim=True), min=1e-9)
    onehot = F.one_hot(topk_i, e)  # [T, K, E]
    if valid is not None:
        onehot = onehot * valid.long()[:, None, None]
    # Slot of each (token, k) within its expert: the exclusive prefix
    # count over the flattened (token-major, k fastest) order.
    flat = onehot.reshape(t * k, e)
    pos = torch.cumsum(flat, dim=0) - flat
    if group is not None:
        counts = process_gather(flat.sum(0), group)  # [ranks, E]
        mine = torch.distributed.get_rank(group)
        pos = pos + counts[:mine].sum(0)
    slot = (pos * flat).sum(-1).reshape(t, k)
    kept = slot < capacity
    if valid is not None:
        kept = kept & valid[:, None]
    return probs, topk_p, topk_i, slot, kept


def route(
    x: torch.Tensor,  # [T, D]
    router: torch.Tensor,  # [D, E] float32
    cfg: MoEConfig,
    capacity: int,
    valid: Optional[torch.Tensor] = None,  # [T] bool
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's routing tensors: (dispatch [T, E, C] float32 one-hot,
    combine [T, E, C] float32, router probabilities [T, E])."""
    probs, topk_p, topk_i, slot, kept = _assign(x, router, cfg, capacity,
                                                valid)
    disp_tke = F.one_hot(topk_i, cfg.num_experts).float() * kept[..., None]
    # A dropped pair's slot is past C: clamp it into range, its row of
    # disp_tke is zero.
    slot_oh = F.one_hot(torch.clamp(slot, max=capacity - 1), capacity).float()
    dispatch = torch.einsum("tke,tkc->tec", disp_tke, slot_oh)
    combine = torch.einsum("tk,tke,tkc->tec", topk_p, disp_tke, slot_oh)
    return dispatch, combine, probs


def _aux_loss(probs: torch.Tensor, cfg: MoEConfig,
              valid: Optional[torch.Tensor], group=None) -> torch.Tensor:
    """Switch-style load-balance loss E · <fraction routed, mean prob>,
    over valid tokens only. `group`: the processes holding the batch's
    other rows; the fractions and means are then the global batch's."""
    top1 = F.one_hot(probs.argmax(-1), cfg.num_experts).float()
    if group is not None:
        w = (torch.ones_like(probs[:, :1]) if valid is None
             else valid.reshape(-1, 1).float())
        denom = torch.clamp(process_sum((w.sum()), group), min=1.0)
        frac = process_sum((top1 * w).sum(0), group) / denom
        mean_prob = sum_across((probs * w).sum(0), group) / denom
        return cfg.num_experts * torch.sum(frac * mean_prob)
    if valid is not None:
        w = valid.reshape(-1, 1).float()
        denom = torch.clamp(w.sum(), min=1.0)
        frac = (top1 * w).sum(0) / denom
        mean_prob = (probs * w).sum(0) / denom
    else:
        frac = top1.mean(0)
        mean_prob = probs.mean(0)
    return cfg.num_experts * torch.sum(frac * mean_prob)


def _experts(expert_in: torch.Tensor, lp: Params) -> torch.Tensor:
    """The routed SwiGLU over [E, C, D] expert batches → [E, C, D]."""
    gate = F.silu(torch.bmm(expert_in, lp["w_gate"]))
    up = torch.bmm(expert_in, lp["w_up"])
    return torch.bmm(gate * up, lp["w_down"])


def moe_ffn_ref(
    x: torch.Tensor,  # [B, S, D] (already normed)
    lp: Params,
    cfg: MoEConfig,
    valid: Optional[torch.Tensor] = None,  # [B, S] bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain one-hot form (the reference's four einsums through
    `route`'s dispatch and combine tensors), in x's dtype. Returns (out
    [B, S, D], aux loss)."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    vt = valid.reshape(t) if valid is not None else None
    dispatch, combine, probs = route(xt, lp["router"], cfg,
                                     _capacity(cfg, t), vt)
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), xt)
    out = torch.einsum("tec,ecd->td", combine.to(x.dtype),
                       _experts(expert_in, lp))
    return out.reshape(b, s, d), _aux_loss(probs, cfg, vt)


def moe_ffn(
    x: torch.Tensor,  # [B, S, D] (already normed)
    lp: Params,
    cfg: MoEConfig,
    valid: Optional[torch.Tensor] = None,  # [B, S] bool
    aux: bool = True,
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Routed SwiGLU expert bank, by index: `moe_ffn_ref`'s function
    without its [T, E, C] tensors and with no host sync. Each token's k
    weighted outputs sum in float32 (the reference casts the combine
    weights to x's dtype and contracts them in its einsum). Returns (out
    [B, S, D], aux loss, or None with `aux` False). While a profiler
    records, the region `moe.ffn` (utils/regions.py)."""
    if _profiler._is_profiler_enabled:
        return regions.timed("moe.ffn", _moe_ffn)(x, lp, cfg, valid, aux)
    return _moe_ffn(x, lp, cfg, valid, aux)


def _moe_ffn(x, lp, cfg, valid, aux):
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.experts_per_token
    xt = x.reshape(t, d)
    vt = valid.reshape(t) if valid is not None else None
    capacity = _capacity(cfg, t)
    probs, topk_p, topk_i, slot, kept = _assign(xt, lp["router"], cfg,
                                                capacity, vt)
    # Row e·C + slot of the [E·C + 1, D] expert input; dropped and padding
    # pairs all land in the scratch row E·C, which no output reads.
    scratch = e * capacity
    dest = torch.where(kept, topk_i * capacity + slot, scratch).reshape(-1)
    expert_in = xt.new_zeros((scratch + 1, d))
    expert_in.index_copy_(0, dest, xt.repeat_interleave(k, dim=0))
    expert_out = _experts(expert_in[:scratch].view(e, capacity, d), lp)
    gathered = expert_out.reshape(scratch, d)[
        torch.clamp(dest, max=scratch - 1)].view(t, k, d)
    w = torch.where(kept, topk_p, 0.0).to(x.dtype).float()
    out = (gathered.float() * w[..., None]).sum(1).to(x.dtype)
    return out.view(b, s, d), _aux_loss(probs, cfg, vt) if aux else None


def moe_ffn_sharded(
    xs: list,  # per data block: [B_i, S, D] (already normed)
    layers: Params,  # the mesh's sharded stacked layers
    layer: int,
    cfg: MoEConfig,
    valid: Optional[torch.Tensor] = None,  # [B, S] bool, blocks in order
    auxes: Optional[list] = None,
    ats: Optional[list[dict]] = None,
) -> list[dict]:
    """`moe_ffn` of layer `layer` over an expert x tensor mesh, for the
    rows of every data block at once: route ONCE over all of them in
    batch order (capacity is batch-global, so a block routed on its own
    would keep and drop other pairs), build the [E·C + 1, D] expert
    input, then each block's coordinates (e, t) (its `ats` entry fixes
    the data and stage indices; default index 0) run experts [e·E/ep,
    (e+1)·E/ep) on their F/tp bank columns for the pairs of the block's
    own tokens and sum those pairs' weighted outputs in float32; one
    all-reduce over the block's coordinates combines them. Appends the
    layer's aux loss (over every block's tokens) to `auxes` when given.
    A bank held whole over expert or tensor (`llama.whole_blocks`: the
    axis does not divide its expert or FFN dim) runs at that axis' index
    0 alone. Returns, per block, {device: output [B_i, S, D] in x's
    dtype} for every device of its tensor shards."""
    mesh = layers["router"].mesh
    ats = ats or [{}] * len(xs)
    x = gather_batch(xs)
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.experts_per_token
    xt = x.reshape(t, d)
    vt = valid.reshape(t).to(x.device) if valid is not None else None
    # Over processes the batch's other rows are other processes' (the
    # same count each): routing counts them through this group.
    rows = (axis_group(mesh, mesh_mod.BATCH_AXES) if mesh.spans_processes
            else None)
    n_rows = 1 if rows is None else torch.distributed.get_world_size(rows)
    capacity = _capacity(cfg, t * n_rows)
    home = mesh.home
    first = mesh.index(**{**home, **ats[0]})
    router = llama._at(layer, local(layers["router"], first)).to(x.device)
    probs, topk_p, topk_i, slot, kept = _assign(xt, router, cfg, capacity,
                                                vt, rows)
    if auxes is not None:
        auxes.append(_aux_loss(probs, cfg, vt, rows))
    scratch = e * capacity
    w = torch.where(kept, topk_p, 0.0).to(x.dtype).float()
    # A bank the expert axis (tensor) does not split is held whole over
    # it (`llama.whole_blocks`), and computed at its index 0 alone.
    gate = getattr(layers["w_gate"], "q", layers["w_gate"])
    n_ex, n_t = gate.factors[-3], gate.factors[-1]
    per_shard = e // n_ex
    token = torch.arange(t, device=x.device)[:, None]
    outs, lo_t = [], 0
    for xb, at in zip(xs, ats):
        hi_t = lo_t + xb.shape[0] * s
        coords = [mesh.index(**{**home, **at, "expert": ex, "tensor": tt})
                  for ex in range(n_ex) for tt in range(n_t)]
        group = coords_group(mesh, coords)
        xin, wb = copy_in(xt, group), copy_in(w[lo_t:hi_t], group)
        mine_t = kept & (token >= lo_t) & (token < hi_t)
        dest = torch.where(mine_t, topk_i * capacity + slot,
                           scratch).reshape(-1)
        expert_in = xt.new_zeros((scratch + 1, d))
        expert_in.index_copy_(0, dest, xin.repeat_interleave(k, dim=0))
        dest = dest[lo_t * k:hi_t * k]
        partials = []
        for c in coords:
            if not mesh.is_local(c):
                partials.append(None)
                continue
            dev = mesh.devices[c]
            ex = mesh.coord(c)["expert"]
            lo = ex * per_shard * capacity
            hi = lo + per_shard * capacity
            banks = {name: llama._at(layer, local(layers[name], c))
                     for name in ("w_gate", "w_up", "w_down")}
            rows_in = expert_in[lo:hi].to(dev).view(per_shard, capacity, d)
            out = _experts(rows_in, banks).reshape(hi - lo, d)
            mine = ((dest >= lo) & (dest < hi)).to(dev)
            idx = torch.where(mine, dest.to(dev) - lo, 0)
            gathered = torch.where(mine[:, None], out[idx],
                                   torch.zeros_like(out[:1]))
            partials.append((gathered.view(hi_t - lo_t, k, d).float()
                             * wb.to(dev)[..., None]).sum(1))
        summed = all_reduce_sum(partials, group)
        total = summed[llama._first(summed)].to(x.dtype).view(
            xb.shape[0], s, d)
        devs = llama.tensor_coords(mesh, **at)[1]
        outs.append({dev: out for dev, out in zip(devs, replicate(total, devs))
                     if dev is not None})
        lo_t = hi_t
    return outs


def sharded_ffn(layers: Params, cfg: MoEConfig,
                valid: Optional[torch.Tensor] = None,
                auxes: Optional[list] = None):
    """`llama.tp_layers`' `ffn` hook for the expert bank: the MoE norm
    and residual around `moe_ffn_sharded` over every block's rows, each
    block's bank at its own coordinates (`Block.at`), appending each
    layer's aux loss to `auxes`."""

    def ffn(layer, blocks, lps):
        eps = cfg.norm_eps
        normed = []
        for blk, lp_b in zip(blocks, lps):
            each = per_device(lambda x, w: common.rms_norm(x, w, eps),
                              blk.xs, [None if lp is None else lp["mlp_norm"]
                                       for lp in lp_b])
            normed.append(each[llama._first(each)])
        outs = moe_ffn_sharded(normed, layers, layer, cfg, valid, auxes,
                               [blk.at for blk in blocks])
        for blk, out in zip(blocks, outs):
            blk.xs = per_device(torch.add, blk.xs,
                                [None if x is None else out[x.device]
                                 for x in blk.xs])

    return ffn


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layer(
    x: torch.Tensor, lp: Params, cfg: MoEConfig, positions: torch.Tensor,
    cache_k, cache_v, cache_len: Optional[torch.Tensor],
    valid: Optional[torch.Tensor], use_flash: Optional[bool] = None,
    ring: bool = False, aux: bool = False,
):
    x = llama.attention_block(x, lp, cfg, positions, cache_k, cache_v,
                              cache_len, use_flash, ring=ring)
    normed = common.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    out, layer_aux = moe_ffn(normed, lp, cfg, valid, aux)
    return x + out, layer_aux


def forward_with_aux(
    params: Params,
    cfg: MoEConfig,
    tokens: torch.Tensor,  # [B, S]
    cache: Optional[KVCache] = None,
    valid: Optional[torch.Tensor] = None,  # [B, S] bool
    use_flash: Optional[bool] = None,
    ring: bool = False,
    aux: bool = True,
) -> tuple[torch.Tensor, Optional[KVCache], Optional[torch.Tensor]]:
    """`forward` also returning the mean router load-balance loss over
    layers (None with `aux` False)."""
    if isinstance(cache, llama.PagedKVCache):
        raise ValueError("paged_kv supports dense Llama only")
    if llama.is_sharded(params):
        auxes = [] if aux else None
        ffn = sharded_ffn(params["layers"], cfg, valid, auxes)
        logits, cache = llama.forward_tp(params, cfg, tokens, cache,
                                         use_flash, ring, ffn=ffn)
        return logits, cache, torch.stack(auxes).mean() if aux else None
    b, s = tokens.shape
    dtype = cfg.torch_dtype
    x = quant.embed_lookup(params["embed"], tokens, dtype)
    steps = torch.arange(s, device=tokens.device)[None, :]
    positions = (
        cache.length.long()[:, None] + steps if cache is not None
        else steps.expand(b, s)
    )
    layers = params["layers"]
    auxes = []
    for layer in range(cfg.num_layers):
        lp = {name: llama._at(layer, w) for name, w in layers.items()}
        if cache is None:
            x, a = _layer(x, lp, cfg, positions, None, None, None, valid,
                          use_flash, aux=aux)
        else:
            x, a = _layer(x, lp, cfg, positions, llama._at(layer, cache.k),
                          llama._at(layer, cache.v), cache.length, valid,
                          use_flash, ring, aux)
        auxes.append(a)
    if cache is not None:
        cache.length = cache.length + s
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["lm_head"]
    if not isinstance(head, QuantizedTensor):
        head = head.to(dtype)
    logits = quant.matmul(x, head)
    mean_aux = torch.stack(auxes).mean() if aux else None
    return logits.float(), cache, mean_aux


def forward(
    params: Params,
    cfg: MoEConfig,
    tokens: torch.Tensor,  # [B, S]
    cache: Optional[KVCache] = None,
    valid: Optional[torch.Tensor] = None,  # [B, S] bool
    use_flash: Optional[bool] = None,
    ring: bool = False,
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """`llama.forward`'s contract (cache written in place, its length
    advanced by S; float32 logits [B, S, V]). `valid` marks real tokens:
    padding and idle rows never compete for expert capacity. No LoRA and
    no paged cache, as in the reference."""
    logits, cache, _ = forward_with_aux(params, cfg, tokens, cache, valid,
                                        use_flash, ring, aux=False)
    return logits, cache


def num_params(cfg: MoEConfig) -> int:
    d, n_layers, v, e, f = (
        cfg.hidden_dim, cfg.num_layers, cfg.vocab_size, cfg.num_experts,
        cfg.ffn_dim,
    )
    qkv = d * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    per_layer = (
        qkv + cfg.num_heads * cfg.head_dim * d + 2 * d  # attention, norms
        + d * e  # router
        + 3 * e * d * f  # expert banks
    )
    return v * d * 2 + n_layers * per_layer + d


def active_params_per_token(cfg: MoEConfig) -> int:
    """Parameters one token touches (k of the E experts)."""
    d, e, f, k = (cfg.hidden_dim, cfg.num_experts, cfg.ffn_dim,
                  cfg.experts_per_token)
    qkv = d * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    per_layer = (
        qkv + cfg.num_heads * cfg.head_dim * d + 2 * d + d * e + 3 * k * d * f
    )
    return cfg.vocab_size * d * 2 + cfg.num_layers * per_layer + d
