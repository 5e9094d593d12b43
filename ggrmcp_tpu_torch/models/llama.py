"""Llama-family decoder: GQA + RoPE + SwiGLU over stacked [L, ...]
weights. Port of `ggrmcp_tpu/models/llama.py` on the cache-free,
contiguous-cache, ring-cache and paged-cache paths, with int8 weights
(any leaf may be a `QuantizedTensor`, ops/quant.py) and the int8 KV
cache, on one device or over a mesh (`forward_tp`: the batch over data
blocks, heads and FFN columns over tensor shards).

The reference threads the KV cache functionally through `lax.scan` and
donates it; here `forward` writes each layer's new K/V into the cache
tensors IN PLACE and returns the same cache object with its length
advanced.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Optional

import torch
import torch.nn.functional as F

from ggrmcp_tpu_torch.models import common
from ggrmcp_tpu_torch.ops import lora as lora_mod
from ggrmcp_tpu_torch.ops import quant
from ggrmcp_tpu_torch.ops.attention import attention, flash_shardable
from ggrmcp_tpu_torch.ops.quant import QuantizedTensor
from ggrmcp_tpu_torch.ops.rope import apply_rope
from ggrmcp_tpu_torch.parallel import mesh as mesh_mod
from ggrmcp_tpu_torch.parallel.collectives import (
    Sharded,
    all_gather,
    all_reduce_sum,
    block_product,
    coords_group,
    copy_in,
    gather_batch,
    is_split,
    local,
    per_device,
    replicate,
    shard,
)

logger = logging.getLogger("ggrmcp.torch.models.llama")

Params = common.Params


@dataclasses.dataclass(frozen=True)
class LlamaConfig(common.ModelConfig):
    name: str = "llama"
    vocab_size: int = 32000
    hidden_dim: int = 512
    num_layers: int = 4
    num_heads: int = 8
    num_kv_heads: int = 4
    head_dim: int = 64
    ffn_dim: int = 1408
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    # Llama-3 long-context RoPE scaling 4-tuple (ops/rope.py); None = off.
    rope_scaling: Optional[tuple] = None
    # Sliding-window attention (Mistral); None = full causal.
    sliding_window: Optional[int] = None
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"


# The reference registry, same names and values.
CONFIGS: dict[str, LlamaConfig] = {
    "tiny-llama": LlamaConfig(
        name="tiny-llama", vocab_size=512, hidden_dim=256, num_layers=4,
        num_heads=8, num_kv_heads=4, head_dim=32, ffn_dim=704,
        max_seq_len=1024, dtype="float32",
    ),
    "llama-1b": LlamaConfig(
        name="llama-1b", vocab_size=32000, hidden_dim=2048, num_layers=16,
        num_heads=32, num_kv_heads=8, head_dim=64, ffn_dim=5632,
        max_seq_len=4096, rope_theta=10000.0,
    ),
    "llama-1b-8k": LlamaConfig(
        name="llama-1b-8k", vocab_size=32000, hidden_dim=2048,
        num_layers=16, num_heads=32, num_kv_heads=8, head_dim=64,
        ffn_dim=5632, max_seq_len=8192, rope_theta=32000.0,
    ),
    "llama3-8b": LlamaConfig(
        name="llama3-8b", vocab_size=128256, hidden_dim=4096, num_layers=32,
        num_heads=32, num_kv_heads=8, head_dim=128, ffn_dim=14336,
        max_seq_len=8192, rope_theta=500000.0,
    ),
    "mistral-7b": LlamaConfig(
        name="mistral-7b", vocab_size=32000, hidden_dim=4096, num_layers=32,
        num_heads=32, num_kv_heads=8, head_dim=128, ffn_dim=14336,
        max_seq_len=8192, rope_theta=10000.0, sliding_window=4096,
    ),
    "tiny-mistral": LlamaConfig(
        name="tiny-mistral", vocab_size=512, hidden_dim=256, num_layers=4,
        num_heads=8, num_kv_heads=4, head_dim=32, ffn_dim=704,
        max_seq_len=1024, sliding_window=16, dtype="float32",
    ),
    "tiny-llama-8k": LlamaConfig(
        name="tiny-llama-8k", vocab_size=512, hidden_dim=256, num_layers=4,
        num_heads=8, num_kv_heads=4, head_dim=32, ffn_dim=704,
        max_seq_len=8192, dtype="float32",
    ),
    "tiny-mistral-8k": LlamaConfig(
        name="tiny-mistral-8k", vocab_size=512, hidden_dim=256,
        num_layers=4, num_heads=8, num_kv_heads=4, head_dim=32, ffn_dim=704,
        max_seq_len=8192, sliding_window=1024, dtype="float32",
    ),
}


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_params(
    cfg: LlamaConfig, device: torch.device, seed: int = 0
) -> Params:
    """Random weights at the reference's init scales, drawn on `device`
    from a seeded torch.Generator (a host-side draw of 8 B parameters
    would take minutes). The values differ from JAX's; parity tests
    cross weights through models/convert.py instead."""
    dtype = cfg.torch_dtype
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, n_layers = cfg.hidden_dim, cfg.num_layers
    shapes = param_shapes(cfg)["layers"]
    scale = d ** -0.5
    kw = dict(generator=gen, device=device)

    def stacked(name: str, fan_in: int):
        return common.init_stacked(n_layers, shapes[name][1:], dtype,
                                   scale=fan_in ** -0.5, **kw)

    return {
        "embed": common.init_dense(cfg.vocab_size, d, dtype, scale=0.02, **kw),
        "layers": {
            "attn_norm": torch.ones((n_layers, d), dtype=dtype, device=device),
            "wqkv": stacked("wqkv", d),
            "wo": stacked("wo", cfg.num_heads * cfg.head_dim),
            "mlp_norm": torch.ones((n_layers, d), dtype=dtype, device=device),
            "w_gate": stacked("w_gate", d),
            "w_up": stacked("w_up", d),
            "w_down": stacked("w_down", cfg.ffn_dim),
        },
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
        "lm_head": common.init_dense(d, cfg.vocab_size, dtype, scale=scale, **kw),
    }


def param_shapes(cfg: LlamaConfig) -> Params:
    """The shape of every leaf `init_params` makes, in the same tree (the
    engine draws synthetic int8 weights from it)."""
    d, n_layers = cfg.hidden_dim, cfg.num_layers
    qkv_out = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    return {
        "embed": (cfg.vocab_size, d),
        "layers": {
            "attn_norm": (n_layers, d),
            "wqkv": (n_layers, d, qkv_out),
            "wo": (n_layers, cfg.num_heads * cfg.head_dim, d),
            "mlp_norm": (n_layers, d),
            "w_gate": (n_layers, d, cfg.ffn_dim),
            "w_up": (n_layers, d, cfg.ffn_dim),
            "w_down": (n_layers, cfg.ffn_dim, d),
        },
        "final_norm": (d,),
        "lm_head": (d, cfg.vocab_size),
    }


def param_specs(cfg: LlamaConfig) -> Params:
    """The reference's specs over `init_params`' tree: column-parallel
    in-projections, row-parallel out-projections, embedding and lm_head
    vocab-sharded. The fused wqkv's `tensor` split is head-aligned here
    (`qkv_columns`), not a contiguous column window."""
    return {
        "embed": ("tensor", None),
        "layers": {
            "attn_norm": (None, None),
            "wqkv": (None, None, "tensor"),
            "wo": (None, "tensor", None),
            "mlp_norm": (None, None),
            "w_gate": (None, None, "tensor"),
            "w_up": (None, None, "tensor"),
            "w_down": (None, "tensor", None),
        },
        "final_norm": (None,),
        "lm_head": (None, "tensor"),
    }


def qkv_columns(cfg: LlamaConfig, tensor: int, shard: int) -> torch.Tensor:
    """The fused [D, (H + 2 KVH) · Dh] wqkv's columns of tensor shard
    `shard`: its query heads [shard · H/t, (shard + 1) · H/t) and their
    key and value heads. A contiguous window would cross the q / k / v
    boundaries. When `tensor` does not divide KVH every shard takes all
    the key and value heads (the replicated-KV downgrade)."""
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    hq = h // tensor
    q = torch.arange(shard * hq * hd, (shard + 1) * hq * hd)
    if kvh % tensor:
        kv = torch.arange(kvh * hd)
    else:
        n = kvh // tensor
        kv = torch.arange(shard * n * hd, (shard + 1) * n * hd)
    return torch.cat([q, h * hd + kv, (h + kvh) * hd + kv])


# The leaves whose tensor split is head-aligned, and the dim of their
# fused q / k / v columns.
_QKV_DIM = {"wqkv": 2, "lora_qkv_b": 3}


def shard_index_fn(cfg: LlamaConfig, name: str):
    """`shard`'s index_fn for leaf `name`: the fused wqkv's tensor split
    and the LoRA `b` factor's, whose columns extend wqkv's, are
    head-aligned (`qkv_columns`); every other leaf's blocks are
    contiguous (None)."""
    if name not in _QKV_DIM:
        return None
    at = _QKV_DIM[name]
    return lambda dim, block, n: (qkv_columns(cfg, n, block) if dim == at
                                  else None)


def lora_specs() -> dict:
    """The LoRA factor stacks on a mesh: `a` [L, N+1, D, r] replicated,
    `b` [L, N+1, r, (H + 2 KVH) · Dh] split over tensor by wqkv's
    head-aligned columns, so each shard adds the delta of its own heads
    to its qkv product, before its RoPE."""
    return {"lora_qkv_a": (None, None, None, None),
            "lora_qkv_b": (None, None, None, "tensor")}


def shard_lora(factors: dict, cfg: LlamaConfig, mesh) -> dict:
    """Whole factor stacks placed on `mesh` by `lora_specs`, `b` whole on
    every shard when the attention block is (`whole_blocks`; one
    coordinate: unchanged)."""
    if mesh.size == 1:
        return factors
    specs = lora_specs()
    whole = "attn" in whole_blocks(cfg, mesh.shape["tensor"])
    return {name: shard(t, placed_spec(specs[name], t.shape, mesh, whole),
                        mesh, shard_index_fn(cfg, name))
            for name, t in factors.items()}


def set_lora_row(leaf, row: int, value: torch.Tensor,
                 cfg: LlamaConfig) -> None:
    """Write adapter row `row` of a factor stack in place from its whole
    [L, ...] value: every stored part of a sharded stack takes its own
    columns (`b`'s head-aligned ones)."""
    if not isinstance(leaf, Sharded):
        leaf[:, row].copy_(value.to(leaf.device, leaf.dtype))
        return
    t = leaf.factors[-1]
    done = set()
    for i, part in enumerate(leaf.parts):
        if id(part) in done:
            continue
        done.add(id(part))
        block = value
        if t > 1:
            shard_ = leaf.mesh.coord(i)["tensor"]
            block = value[..., qkv_columns(cfg, t, shard_)]
        part[:, row].copy_(block.to(part.device, part.dtype))


# The leaves the tensor axis splits together (either decoder family's;
# a MoE bank's FFN columns too): the attention block (its KV cache
# heads with it), the FFN block and the vocabulary.
BLOCKS = {
    "attn": ("wqkv", "wo", "lora_qkv_b"),
    "ffn": ("w_gate", "w_up", "w_down"),
    "vocab": ("embed", "lm_head"),
}


def whole_blocks(cfg: LlamaConfig, tensor: int) -> frozenset:
    """The blocks (`BLOCKS`) held whole on every coordinate of a
    `tensor`-way axis and computed whole, with no row-parallel reduce:
    those with a leaf whose split dim `tensor` does not divide (the
    reference replicates that leaf and counts it), and the attention
    block when `tensor` does not divide the query heads (the port splits
    wqkv by whole heads, where the reference splits its columns)."""
    if tensor == 1:
        return frozenset()
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    out = set()
    if h % tensor or (h + 2 * kvh) * hd % tensor:
        out.add("attn")
    if cfg.ffn_dim % tensor:
        out.add("ffn")
    if cfg.vocab_size % tensor:
        out.add("vocab")
    return frozenset(out)


def whole_leaves(cfg: LlamaConfig, tensor: int) -> set:
    """The leaf names of `whole_blocks`."""
    return {name for b in whole_blocks(cfg, tensor) for name in BLOCKS[b]}


def placed_spec(spec: tuple, shape, mesh, whole: bool,
                on_downgrade=None) -> tuple:
    """The spec a leaf is placed by: `compatible_spec`'s (which tells
    `on_downgrade(dim, entry, size, axis)` of each dim it replicates),
    without the tensor axis for a leaf of a whole block."""
    adapted = mesh_mod.compatible_spec(spec, shape, mesh, on_downgrade)
    return mesh_mod.drop_axis(adapted, "tensor") if whole else adapted


def shard_params(params: Params, cfg: LlamaConfig, mesh, specs: Params,
                 on_downgrade=None) -> Params:
    """Place a whole tree (either decoder family's) on `mesh` by `specs`,
    IN PLACE, leaf by leaf: each whole leaf of `params` is replaced by
    its shards as soon as they exist; leaves already sharded are kept. A
    quantized leaf takes its q's and its scale's specs from
    `quant.quantize_specs`. `compatible_spec` adapts every spec;
    `on_downgrade(where, dim, entry, size, axis)` hears of each weight
    dim it had to replicate (a scale's size-1 axis replicates silently).
    The leaves of a block `whole_blocks` names are then replicated over
    tensor, uncounted beyond their own downgrades.
    """
    if any(isinstance(leaf, QuantizedTensor)
           for group in (params, params["layers"])
           for leaf in group.values()):
        specs = quant.quantize_specs(specs)
    tensor = mesh.shape["tensor"]
    whole = whole_leaves(cfg, tensor)
    h, hd = cfg.num_heads, cfg.head_dim
    if ("wo" in whole and h * hd % tensor == 0
            and (h + 2 * cfg.num_kv_heads) * hd % tensor == 0):
        logger.warning(
            "%s at tensor=%d: %d query heads do not split %d ways; the "
            "attention block is held whole on every shard (the reference "
            "splits wqkv's columns; not a mesh_spec_downgrades site)",
            cfg.name, tensor, h, tensor)

    def adapt(shape, spec, where, name, observe=True):
        return placed_spec(spec, shape, mesh, name in whole, (
            (lambda *a: on_downgrade(where, *a))
            if observe and on_downgrade else None))

    def cut(x, spec, where, name, observe=True):
        return shard(x, adapt(x.shape, spec, where, name, observe), mesh,
                     shard_index_fn(cfg, name))

    def place(leaf, spec, where, name):
        if isinstance(getattr(leaf, "q", leaf), Sharded):
            # Placed already (the sharded loader): counted here.
            adapt(leaf.shape, getattr(spec, "q", spec), where, name)
            return leaf
        if isinstance(leaf, QuantizedTensor):
            return QuantizedTensor(
                q=cut(leaf.q, spec.q, where, name),
                scale=cut(leaf.scale, spec.scale, where, name, False))
        return cut(leaf, spec, where, name)

    for key, spec in specs.items():
        if isinstance(spec, dict):
            for name, sub in spec.items():
                if name in params[key]:
                    params[key][name] = place(
                        params[key][name], sub, f"['{key}']['{name}']", name)
        else:
            params[key] = place(params[key], spec, f"['{key}']", key)
    return params


def shard_kv_heads(cfg: LlamaConfig, tensor: int,
                   shard: int) -> tuple[int, ...]:
    """The KV heads tensor shard `shard` reads when its cache holds every
    KV head (`tensor` does not divide KVH): its query heads' groups as
    one GQA block where they form one (query head j reading block head
    j // (H/t / n), as the kernel maps them), else one KV head per query
    head."""
    hq = cfg.num_heads // tensor
    group = cfg.num_heads // cfg.num_kv_heads
    per_q = [(shard * hq + j) // group for j in range(hq)]
    block = tuple(range(per_q[0], per_q[-1] + 1))
    n = len(block)
    if hq % n == 0 and all(per_q[j] == block[j // (hq // n)]
                           for j in range(hq)):
        return block
    return tuple(per_q)


def local_config(cfg: LlamaConfig, tensor: int) -> LlamaConfig:
    """The geometry one tensor shard of a split attention block computes:
    H/t query heads, KVH/t key-value heads (all KVH when t does not
    divide them) and F/t FFN columns."""
    kvh = cfg.num_kv_heads
    return dataclasses.replace(
        cfg, num_heads=cfg.num_heads // tensor,
        num_kv_heads=kvh // tensor if kvh % tensor == 0 else kvh,
        ffn_dim=cfg.ffn_dim // tensor,
    )


def is_sharded(params: Params) -> bool:
    """A tree placed on a mesh of more than one coordinate."""
    return isinstance(params["layers"]["attn_norm"], Sharded)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KVCache:
    """Contiguous KV cache. k/v are [L, B, S_max + 1, KVH, Dh]: positions
    0..S_max-1 are the cache proper and position S_max is a SCRATCH slot
    that absorbs every write past the end (the reference's jit drops
    out-of-bounds scatters; torch indexing would raise on the CPU and
    assert on the device). Attention only ever reads [:S_max].

    With kv_dtype "int8" k/v are QuantizedTensors: int8 values [L, B,
    S_max + 1, KVH, Dh] and per-(position, head) scales [L, B, S_max + 1,
    KVH, 1] in the model dtype, the scratch slot in both."""

    k: quant.TensorOrQuant
    v: quant.TensorOrQuant
    length: torch.Tensor  # [B] int32 — valid prefix length

    @property
    def capacity(self) -> int:
        return self.k.shape[2] - 1

    @classmethod
    def create(
        cls, cfg: LlamaConfig, batch: int, max_len: int,
        device: torch.device, kv_dtype: str = "",
    ) -> "KVCache":
        """kv_dtype "" = the model dtype; "int8" = quantized KV
        (serving.kv_cache_dtype)."""
        shape = (
            cfg.num_layers, batch, max_len + 1, cfg.num_kv_heads, cfg.head_dim
        )
        return cls(
            k=_kv_leaf(shape, cfg.torch_dtype, device, kv_dtype),
            v=_kv_leaf(shape, cfg.torch_dtype, device, kv_dtype),
            length=torch.zeros((batch,), dtype=torch.int32, device=device),
        )

    def nbytes(self) -> int:
        return self.k.nbytes + self.v.nbytes + self.length.nbytes


@dataclasses.dataclass
class PagedKVCache:
    """Paged KV cache (batching.paged_kv): one arena of fixed-size pages
    per layer plus per-slot block tables. Position j of slot b lives at
    (table[b, j // P], j % P), so positions, masks and numerics are those
    of the contiguous cache; only the storage is indirected.

    k/v are [L, n_pages + 1, P, KVH, Dh]: pages 0..n_pages-1 are the
    arena proper and page n_pages (the table's SENTINEL id) is a SCRATCH
    page that absorbs every write through a sentinel entry or past the
    table's width (the reference's scatters drop them). Reads of a
    sentinel entry clip to page n_pages - 1, a real page, as the
    reference's gathers do: its values are finite, and `length` masks
    them. With kv_dtype "int8" k/v are QuantizedTensors whose values and
    scales both carry the scratch page."""

    k: quant.TensorOrQuant
    v: quant.TensorOrQuant
    table: torch.Tensor  # [B, S_max // P] int32 page ids
    length: torch.Tensor  # [B] int32 — valid prefix length

    @property
    def n_pages(self) -> int:
        return self.k.shape[1] - 1

    @classmethod
    def create(
        cls, cfg: LlamaConfig, batch: int, max_len: int, n_pages: int,
        page_size: int, device: torch.device, kv_dtype: str = "",
    ) -> "PagedKVCache":
        if max_len % page_size:
            raise ValueError("page_size must divide max_len")
        shape = (
            cfg.num_layers, n_pages + 1, page_size, cfg.num_kv_heads,
            cfg.head_dim,
        )
        return cls(
            k=_kv_leaf(shape, cfg.torch_dtype, device, kv_dtype),
            v=_kv_leaf(shape, cfg.torch_dtype, device, kv_dtype),
            table=torch.full((batch, max_len // page_size), n_pages,
                             dtype=torch.int32, device=device),
            length=torch.zeros((batch,), dtype=torch.int32, device=device),
        )

    def nbytes(self) -> int:
        return self.k.nbytes + self.v.nbytes + self.length.nbytes


def paged_view(arena: quant.TensorOrQuant, table: torch.Tensor):
    """One layer's [N + 1, P, KVH, Dh] arena + [B, W] tables → the
    contiguous per-slot view [B, W·P, KVH, Dh] (view position j is
    absolute position j). Sentinel entries clip to page N - 1; values
    and scales of an int8 arena gather alike."""

    def gather(a):
        idx = torch.clamp(table.long(), max=a.shape[0] - 2).to(a.device)
        v = a[idx]  # [B, W, P, ...]
        return v.reshape(table.shape[0], -1, *a.shape[2:])

    return quant.kv_map(gather, arena)


def paged_view_layers(arena: quant.TensorOrQuant, table: torch.Tensor,
                      out: quant.TensorOrQuant):
    """`paged_view` over a full [L, N + 1, P, KVH, Dh] arena, written into
    the head of `out` (an [L, B, >= W·P, KVH, Dh] tensor or
    QuantizedTensor, e.g. an admission mini cache's leaf) one layer at a
    time, so no [L, B, W·P] temporary is made. Returns `out`."""

    def fill(o, a):
        width = table.shape[1] * a.shape[2]
        for layer in range(a.shape[0]):
            o[layer, :, :width] = paged_view(a[layer], table)
        return o

    return quant.kv_map(fill, out, arena)


def cache_specs() -> dict:
    """KV cache sharding: batch over data x fsdp (each data block holds
    its slots' rows), heads over tensor. The lengths stay whole on the
    controller, which schedules every slot."""
    spec = (None, mesh_mod.BATCH_AXES, None, "tensor", None)
    return {"k": spec, "v": spec, "length": (mesh_mod.BATCH_AXES,)}


def paged_cache_specs() -> dict:
    """Paged arena sharding: heads over tensor only (a page is shared
    across slots, so the page axis cannot ride a batch axis: the data
    blocks' rows read and write one arena per tensor block); the block
    tables and lengths are replicated."""
    spec = (None, None, None, "tensor", None)
    return {"k": spec, "v": spec, "table": (), "length": ()}


def _kv_leaf(shape, dtype, device, kv_dtype: str) -> quant.TensorOrQuant:
    if kv_dtype == "int8":
        return QuantizedTensor(
            q=torch.zeros(shape, dtype=torch.int8, device=device),
            scale=torch.zeros(shape[:-1] + (1,), dtype=dtype, device=device),
        )
    if kv_dtype:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
    return torch.zeros(shape, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def attention_block(
    x: torch.Tensor,  # [B, S, D]
    lp: Params,  # one layer's weights (no leading L)
    cfg: LlamaConfig,
    positions: torch.Tensor,  # [B, S]
    cache_k: Optional[quant.TensorOrQuant],  # [B, S_max + 1, KVH, Dh], in place
    cache_v: Optional[quant.TensorOrQuant],
    cache_len: Optional[torch.Tensor],  # [B]
    use_flash: Optional[bool] = None,
    page_table: Optional[torch.Tensor] = None,  # [B, W] paged block table
    lora_idx: Optional[torch.Tensor] = None,  # [B] adapter ids
    ring: bool = False,
    attn_impl=None,
) -> torch.Tensor:
    """Pre-norm GQA attention with residual: `x + attention_out(norm(x))`."""
    normed = common.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    return x + attention_out(normed, lp, cfg, positions, cache_k, cache_v,
                             cache_len, use_flash, page_table, lora_idx, ring,
                             attn_impl=attn_impl)


def attention_out(
    normed: torch.Tensor,  # [B, S, D], after the attention norm
    lp: Params,
    cfg: LlamaConfig,
    positions: torch.Tensor,
    cache_k: Optional[quant.TensorOrQuant],
    cache_v: Optional[quant.TensorOrQuant],
    cache_len: Optional[torch.Tensor],
    use_flash: Optional[bool] = None,
    page_table: Optional[torch.Tensor] = None,
    lora_idx: Optional[torch.Tensor] = None,
    ring: bool = False,
    kv_heads: Optional[tuple[int, ...]] = None,  # `shard_kv_heads`
    out_dtype: Optional[torch.dtype] = None,  # of the `wo` product
    attn_impl=None,
) -> torch.Tensor:
    """GQA attention through `wo`, without the residual (on a mesh, one
    tensor shard's row-parallel partial, in `out_dtype`). With a cache, the step's
    K/V are written at each row's current length and attention reads
    the whole cache prefix (q_offset = cache_len, kv_len = cache_len +
    S); writes past S_max land in the scratch slot.

    With `page_table`, cache_k/v are one layer's page arena [N + 1, P,
    KVH, Dh] (PagedKVCache): position j of row b is written at (table[b,
    j // P], j % P) — through a sentinel entry or past the table's width
    into the scratch page N — and attention reads the table-gathered
    [B, W·P] view through `attention_ref`, as the reference pins its XLA
    path there.

    An int8 cache (QuantizedTensor leaves): the step's K/V are quantized
    per (position, head), values and scales are written at the same
    clamped positions, and attention reads the dequantized prefix
    through `attention_ref` (use_flash False), as the reference does —
    the current step's K/V round-trip through int8 too.

    `ring` (a sliding-window model's ring cache, docs/kv_ring_design.md):
    the cache's C positions hold absolute position p at slot p % C;
    `cache_len` keeps counting every token. The step's K/V are written
    at (cache_len + i) % C and attention masks each slot by the absolute
    position it holds (`k_positions`, through `attention_ref`). A step
    must not clobber a key still in some query's window: C >= window +
    S - 1 (asserted).

    `lora_idx` with stacked LoRA factors in `lp`: each row's adapter
    delta (ops/lora.py; row 0 = base) is added to the fused qkv
    product.

    `kv_heads` (a tensor shard whose KV heads are replicated, because
    the tensor axis does not divide them): the cache holds every KV
    head, and attention reads the shard's own (`shard_kv_heads`): a
    head range as a view, else one gathered head per query head.

    `attn_impl(q, k, v, causal, window)`: the sequence-parallel prefill
    hook (ops/ring_attention.py), attending this step's keys only, their
    KV heads repeated to the query heads. Valid ONLY for a fresh prefill
    (cache_len 0, the cache sized to the step; the engine gates it):
    then attention over the written prefix equals causal attention over
    the step. Under the int8 cache it attends the step's K/V as the
    cache will replay them (quantized and back), so sp and plain prefill
    carry the same quantization error; the paged path attends the raw
    step K/V, as the reference does."""
    b, s, _ = normed.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = normed.device
    qkv = quant.matmul(normed, lp["wqkv"])  # [B, S, (H + 2 KVH) * Dh]
    if lora_idx is not None and "lora_qkv_a" in lp:
        qkv = qkv + lora_mod.lora_delta(
            normed, lp["lora_qkv_a"], lp["lora_qkv_b"], lora_idx
        )
    q, k, v = qkv.split([h * hd, kvh * hd, kvh * hd], dim=-1)
    q = apply_rope(q.reshape(b, s, h, hd), positions, cfg.rope_theta,
                   cfg.rope_scaling)
    k = apply_rope(k.reshape(b, s, kvh, hd), positions, cfg.rope_theta,
                   cfg.rope_scaling)
    v = v.reshape(b, s, kvh, hd)
    k_positions = None
    k_step, v_step = k, v

    if cache_k is not None and page_table is not None:
        assert not ring, "paged KV does not compose with kv_ring"
        page = cache_k.shape[1]
        n_pages = cache_k.shape[0] - 1
        width = page_table.shape[1]
        write_pos = cache_len.long()[:, None] + torch.arange(
            s, device=dev
        )[None, :]
        w_idx = write_pos // page
        w_page = torch.where(
            w_idx < width,
            torch.gather(page_table.long(), 1, torch.clamp(w_idx, max=width - 1)),
            n_pages,
        )
        w_off = write_pos % page

        def put(arena: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
            arena[w_page, w_off] = new.to(arena.dtype)
            return arena

        if isinstance(cache_k, QuantizedTensor):
            quant.kv_map(put, cache_k, quant.quantize(k, axis=-1))
            quant.kv_map(put, cache_v, quant.quantize(v, axis=-1))
            k_all = quant.dequantize(paged_view(cache_k, page_table))
            v_all = quant.dequantize(paged_view(cache_v, page_table))
        else:
            put(cache_k, k)
            put(cache_v, v)
            k_all = paged_view(cache_k, page_table)
            v_all = paged_view(cache_v, page_table)
        kv_len = (cache_len + s).to(torch.int32)
        q_offset = cache_len.to(torch.int32)
        use_flash = False  # a gathered view: the reference's XLA path
    elif cache_k is not None:
        cap = cache_k.shape[1] - 1
        write_pos = cache_len.long()[:, None] + torch.arange(
            s, device=dev
        )[None, :]
        if ring:
            window = cfg.sliding_window
            assert window is not None, "ring needs a window"
            assert s <= cap, f"step {s} exceeds ring capacity {cap}"
            assert cap >= window + s - 1, (
                f"ring capacity {cap} < window {window} + step {s} - 1 "
                f"(clobber)"
            )
            write_pos = write_pos % cap
        else:
            write_pos = torch.clamp(write_pos, max=cap)  # overflow → scratch
        batch_idx = torch.arange(b, device=dev)[:, None]

        def write(cache: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
            cache[batch_idx, write_pos] = new.to(cache.dtype)
            return cache

        if isinstance(cache_k, QuantizedTensor):
            qk, qv = quant.quantize(k, axis=-1), quant.quantize(v, axis=-1)
            quant.kv_map(write, cache_k, qk)
            quant.kv_map(write, cache_v, qv)
            k_step, v_step = quant.dequantize(qk), quant.dequantize(qv)
            k_all = quant.dequantize(
                quant.kv_map(lambda t: t[:, :cap], cache_k))
            v_all = quant.dequantize(
                quant.kv_map(lambda t: t[:, :cap], cache_v))
            use_flash = False  # the reference's XLA path on int8 KV
        else:
            write(cache_k, k)
            write(cache_v, v)
            k_all, v_all = cache_k[:, :cap], cache_v[:, :cap]
        kv_len = (cache_len + s).to(torch.int32)
        q_offset = cache_len.to(torch.int32)
        if ring:
            # The absolute position slot j holds: the largest p < kv_len
            # with p ≡ j (mod C); negative = never written.
            slots = torch.arange(cap, device=dev)[None, :]
            k_positions = slots + cap * torch.div(
                kv_len.long()[:, None] - 1 - slots, cap,
                rounding_mode="floor")
    else:
        k_all, v_all, kv_len, q_offset = k, v, None, None

    if kv_heads is not None:
        lo, n = kv_heads[0], len(kv_heads)
        if kv_heads == tuple(range(lo, lo + n)):
            def pick(t):
                return t.narrow(2, lo, n)
        else:
            idx = torch.tensor(kv_heads, device=dev)

            def pick(t):
                return t.index_select(2, idx)
        k_all, v_all = pick(k_all), pick(v_all)
        k_step, v_step = pick(k_step), pick(v_step)
    if attn_impl is not None:
        reps = h // k_step.shape[2]
        attn_out = attn_impl(
            q, k_step.repeat_interleave(reps, dim=2),
            v_step.repeat_interleave(reps, dim=2), causal=True,
            window=cfg.sliding_window)
    else:
        attn_out = attention(
            q, k_all, v_all, causal=True, q_offset=q_offset, kv_len=kv_len,
            window=cfg.sliding_window, use_flash=use_flash,
            k_positions=k_positions,
        )
    return quant.matmul(attn_out.reshape(b, s, h * hd), lp["wo"], out_dtype)


def swiglu(normed: torch.Tensor, lp: Params,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The dense FFN after its norm (on a mesh, one shard's partial, in
    `out_dtype`)."""
    gate = F.silu(quant.matmul(normed, lp["w_gate"]))
    return quant.matmul(gate * quant.matmul(normed, lp["w_up"]),
                        lp["w_down"], out_dtype)


def _layer(
    x: torch.Tensor, lp: Params, cfg: LlamaConfig, positions: torch.Tensor,
    cache_k: Optional[quant.TensorOrQuant],
    cache_v: Optional[quant.TensorOrQuant],
    cache_len: Optional[torch.Tensor], use_flash: Optional[bool] = None,
    page_table: Optional[torch.Tensor] = None,
    lora_idx: Optional[torch.Tensor] = None,
    ring: bool = False,
    attn_impl=None,
) -> torch.Tensor:
    x = attention_block(x, lp, cfg, positions, cache_k, cache_v, cache_len,
                        use_flash, page_table, lora_idx, ring, attn_impl)
    normed = common.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + swiglu(normed, lp)


def _at(layer: int, t: quant.TensorOrQuant) -> quant.TensorOrQuant:
    """One layer of a stacked leaf, dense or quantized."""
    return quant.kv_map(lambda x: x[layer], t)


def forward(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, S]
    cache: "Optional[KVCache | PagedKVCache]" = None,
    use_flash: Optional[bool] = None,
    lora_idx: Optional[torch.Tensor] = None,
    ring: bool = False,
    attn_impl=None,
) -> "tuple[torch.Tensor, Optional[KVCache | PagedKVCache]]":
    """Without a cache: plain causal forward. With a cache: tokens are
    appended at each row's cache length (prefill S > 1, decode S = 1);
    the cache is updated in place and its length advanced by S. A
    `PagedKVCache` threads through the same way, its block table riding
    into every layer's attention.
    `use_flash`: None = auto (ops/attention.py), False = `attention_ref`
    everywhere (an int8 cache forces it per layer).
    `lora_idx`: [B] per-row adapter ids when `params["layers"]` carries
    stacked LoRA factors (ops/lora.py); None or absent factors = base.
    `ring`: the contiguous cache is a ring of its capacity (the layout of
    the batcher's caches under serving.kv_ring; attention_block).
    `attn_impl`: the sequence-parallel fresh-prefill hook
    (`attention_out`; on a mesh it also takes `coord`, the tensor
    shard's coordinate).
    Params placed on a mesh (`is_sharded`) take `forward_tp`.
    Returns (float32 logits [B, S, V], cache or None)."""
    if is_sharded(params):
        return forward_tp(params, cfg, tokens, cache, use_flash, ring,
                          attn_impl=attn_impl, lora_idx=lora_idx)
    b, s = tokens.shape
    dtype = cfg.torch_dtype
    x = quant.embed_lookup(params["embed"], tokens, dtype)  # [B, S, D]
    steps = torch.arange(s, device=tokens.device)[None, :]
    positions = (
        cache.length.long()[:, None] + steps if cache is not None
        else steps.expand(b, s)
    )
    layers = params["layers"]
    table = cache.table if isinstance(cache, PagedKVCache) else None
    for layer in range(cfg.num_layers):
        lp = {name: _at(layer, w) for name, w in layers.items()}
        if cache is None:
            x = _layer(x, lp, cfg, positions, None, None, None, use_flash,
                       lora_idx=lora_idx, attn_impl=attn_impl)
        else:
            x = _layer(
                x, lp, cfg, positions, _at(layer, cache.k),
                _at(layer, cache.v), cache.length, use_flash, table,
                lora_idx, ring, attn_impl,
            )
    if cache is not None:
        cache.length = cache.length + s
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["lm_head"]
    if not isinstance(head, QuantizedTensor):
        head = head.to(dtype)
    logits = quant.matmul(x, head)
    return logits.float(), cache


# ---------------------------------------------------------------------------
# Tensor-parallel forward (a mesh of more than one coordinate)
# ---------------------------------------------------------------------------


def forward_tp(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,
    cache: "Optional[KVCache | PagedKVCache]" = None,
    use_flash: Optional[bool] = None,
    ring: bool = False,
    ffn=None,
    attn_impl=None,
    lora_idx: Optional[torch.Tensor] = None,
) -> "tuple[torch.Tensor, Optional[KVCache | PagedKVCache]]":
    """`forward` over params sharded by `param_specs` (Megatron layout),
    the batch split over the data blocks (`mesh.data_blocks`): each data
    block's rows run on its own tensor shards, each shard running its
    query heads' attention, written into its KV heads' cache, and its FFN
    columns; every row-parallel partial (`wo`, `w_down`) of more than one
    tensor shard is a float32 product, all-reduced within the block and
    rounded once to the model dtype before the residual add. A block
    held whole on every shard (`whole_blocks`) is computed once per
    device instead, with no reduce. The embedding is a masked lookup per
    vocab shard, summed (exact: one shard holds each row); the lm_head's
    vocab blocks are all-gathered into whole float32 logits, and the
    blocks' logits come back in batch order, so sampling and grammar
    masks see whole rows of every slot. Activations are replicated over
    a block's shards: one tensor per device, computed once per device.
    Tokens, cache lengths and block tables live on the mesh's first
    device and are copied to each shard's device per call (a no-op on
    the same device). A contiguous cache split by slot (`cache_specs`)
    gives each block its own rows; a paged arena is one per tensor
    block, which every block's rows share. A batch the data blocks do
    not divide runs as one block, its attention through `use_flash` as
    any block's (the reference's dispatcher takes XLA for it: one
    controller has no divisibility to keep). Attention runs at index 0
    of the sequence, expert and stage axes (a sequence axis runs inside
    `attn_impl`, which takes each shard's `coord`); `ffn(layer, blocks,
    lps)` replaces the dense FFN (the MoE family's expert-parallel bank,
    which routes every block's rows at once) and sets each block's
    activations. `lora_idx` [B]: each row's adapter (the factors split
    like wqkv's columns).

    On a mesh over processes (training) `tokens` are this process's
    rows (`mesh.process_rows`) and it computes its own coordinates only:
    its data blocks, its tensor shards of each (a block's `group` the
    processes holding the others, reached by the collectives), and an
    axis it replicates (sequence, a dense model's expert) at its own
    index of it (`Mesh.home`): each process computes its replica and
    reduces nothing over that axis."""
    mesh = params["layers"]["attn_norm"].mesh
    b, s = tokens.shape
    splits = mesh_mod.data_blocks(mesh, b)
    steps = torch.arange(s, device=tokens.device)[None, :]
    positions = (cache.length.long()[:, None] + steps if cache is not None
                 else steps.expand(b, s))
    paged = isinstance(cache, PagedKVCache)
    whole = (cache is not None and not paged and len(splits) > 1
             and cache_batch_blocks(cache) == 1)
    blocks = []
    for rows, at in splits:
        coords, devs = tensor_coords(mesh, **at)
        group = coords_group(mesh, coords)

        def each(t):
            return ([None] * len(devs) if t is None
                    else replicate(t[rows], devs))

        blocks.append(Block(
            at, coords,
            _vocab_embed(params["embed"], tokens[rows], cfg.torch_dtype,
                         coords, devs, group),
            each(positions), each(None if cache is None else cache.length),
            each(cache.table if paged else None), each(lora_idx),
            rows if whole else None, group))
    blocks = tp_layers(params["layers"], cfg, blocks, range(cfg.num_layers),
                       cache, use_flash=use_flash, ring=ring, ffn=ffn,
                       attn_impl=attn_impl)
    if cache is not None:
        cache.length = cache.length + s
    return gather_batch([tp_head(params, cfg, blk.xs, blk.coords, blk.group)
                         for blk in blocks]), cache


def cache_batch_blocks(cache) -> int:
    """How many data blocks a contiguous (or staged) cache's slots are
    split into: 1 when its parts hold every slot."""
    leaf = cache.k.q if isinstance(cache.k, QuantizedTensor) else cache.k
    if not isinstance(leaf, Sharded) or leaf.bases is None:
        return 1
    return leaf.factors[leaf.batch_dim]


@dataclasses.dataclass
class Block:
    """One data block's share of a tensor-parallel forward: `at` its
    data (and stage) coordinate, `coords` its tensor shards' flat
    coordinates, and per shard its activations, positions, cache
    lengths, block tables and adapter ids (None entries where absent).
    `rows`: the rows of the cache's parts it reads and writes when those
    parts hold more than its rows (a pipeline microbatch, a cache the
    data blocks do not split); None = the whole part. `group`: the
    other processes holding tensor shards of the block (None: this
    process holds them all); the entries of their shards are None."""

    at: dict
    coords: list[int]
    xs: list
    pos: list
    lens: list
    tables: list
    lora: list
    rows: Optional[slice] = None
    group: Optional[object] = None


def tensor_coords(mesh, **fixed: int) -> tuple[list[int], list]:
    """The flat coordinates of the tensor shards at index `fixed` on
    every other axis (this process's own index, `Mesh.home`, for any
    axis not named: 0 on a mesh of one process), and their devices
    (None for another process's shard)."""
    at = {**mesh.home, **fixed}
    coords = [mesh.index(**{**at, "tensor": i})
              for i in range(mesh.shape["tensor"])]
    return coords, [mesh.devices[c] if mesh.is_local(c) else None
                    for c in coords]


def _first(xs: list) -> int:
    """The index of the first entry this process holds."""
    return next(i for i, x in enumerate(xs) if x is not None)


def tp_layers(layers, cfg: LlamaConfig, blocks: list[Block], layer_ids,
              cache=None, use_flash=None, ring=False, ffn=None,
              attn_impl=None) -> list[Block]:
    """Layers `layer_ids` (indices into each coordinate's local stack) of
    the tensor-parallel forward over every block's per-shard
    activations, the cache's parts at each block's coordinates written
    in place (`Block.rows` of them when given). The all-reduces stay
    within a block. Sets and returns the blocks."""
    t = len(blocks[0].coords)
    # A block held whole (`whole_blocks`) is computed whole.
    split_attn = is_split(layers["wo"], -2)
    split_ffn = "w_down" in layers and is_split(layers["w_down"], -2)
    lcfg = local_config(cfg, t) if split_attn else cfg
    # Row-parallel partials in float32, summed and rounded once; a whole
    # product rounds as `forward`'s does.
    partial_attn = torch.float32 if split_attn else None
    partial_ffn = torch.float32 if split_ffn else None
    if not split_attn or flash_shardable(t, cfg.num_kv_heads)[0]:
        kv_heads = [None] * t
    else:
        # Replicated KV: every shard reads its query heads' groups.
        kv_heads = [shard_kv_heads(cfg, t, i) for i in range(t)]

    def cache_at(leaf, layer: int, c: int, rows):
        part = _at(layer, local(leaf, c))
        if rows is not None:
            part = quant.kv_map(lambda x: x[rows], part)
        return part

    def norm(xs, lps, name, group=None):
        out = per_device(lambda x, w: common.rms_norm(x, w, cfg.norm_eps),
                         xs, [None if lp is None else lp[name] for lp in lps])
        if group is None:
            return out
        # A split block's input over processes: the shards this process
        # holds share its one device, so one tensor, whose gradient the
        # group sums (`copy_in`).
        y = copy_in(out[_first(out)], group)
        return [None if o is None else y for o in out]

    def at_layer(layer, c, views):
        if local(layers["attn_norm"], c) is None:
            return None  # another process's coordinate
        # One view a stored tensor: the shards on a device share their
        # replicated leaves' views, so `per_device` computes a norm once
        # a device and its gradient reaches the leaf once.
        out = {}
        for name, w in layers.items():
            part = local(w, c)
            key = (name, id(getattr(part, "q", part)))
            if key not in views:
                views[key] = _at(layer, part)
            out[name] = views[key]
        return out

    for layer in layer_ids:
        views: dict = {}
        lps = [[at_layer(layer, c, views) for c in blk.coords]
               for blk in blocks]
        for blk, lp in zip(blocks, lps):
            normed = norm(blk.xs, lp, "attn_norm",
                          blk.group if split_attn else None)

            def attn(i):
                c = blk.coords[i]
                ck = cv = None
                if cache is not None:
                    ck = cache_at(cache.k, layer, c, blk.rows)
                    cv = cache_at(cache.v, layer, c, blk.rows)
                impl = (None if attn_impl is None else functools.partial(
                    attn_impl, coord={**blk.at, "tensor": i}))
                return attention_out(
                    normed[i], lp[i], lcfg, blk.pos[i], ck, cv, blk.lens[i],
                    use_flash, blk.tables[i], blk.lora[i], ring, kv_heads[i],
                    partial_attn, attn_impl=impl)

            blk.xs = per_device(_residual, blk.xs, block_product(
                blk.xs, split_attn, attn, blk.group))
        if ffn is not None:
            ffn(layer, blocks, lps)
            continue
        for blk, lp in zip(blocks, lps):
            normed = norm(blk.xs, lp, "mlp_norm",
                          blk.group if split_ffn else None)
            # A view a shard: the gradients of a shard's two products sum
            # before the shards' do, in one process as across processes.
            blk.xs = per_device(_residual, blk.xs, block_product(
                blk.xs, split_ffn,
                lambda i: swiglu(normed[i].view_as(normed[i]), lp[i],
                                 partial_ffn), blk.group))
    return blocks


def tp_head(params: Params, cfg: LlamaConfig, xs: list,
            coords: list[int], group=None) -> torch.Tensor:
    """The final norm and the vocab-parallel lm_head at `coords`: whole
    float32 logits on the first shard's device (a whole lm_head's, of
    the first shard alone; over processes, of the first shard this
    process holds). `group`: the processes holding the other shards,
    whose vocab blocks are gathered."""
    if not is_split(params["lm_head"], -1):
        i = _first(xs)
        coords, xs, group = coords[i:i + 1], xs[i:i + 1], None
    finals = [local(params["final_norm"], c) for c in coords]
    xs = per_device(lambda x, w: common.rms_norm(x, w, cfg.norm_eps), xs,
                    finals)
    if group is not None:
        y = copy_in(xs[_first(xs)], group)
        xs = [None if x is None else y for x in xs]
    blocks = []
    for x, c in zip(xs, coords):
        if x is None:
            blocks.append(None)
            continue
        head = local(params["lm_head"], c)
        if not isinstance(head, QuantizedTensor):
            head = head.to(cfg.torch_dtype)
        blocks.append(quant.matmul(x, head))
    return all_gather(blocks, dim=-1, group=group).float()


def _residual(x: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """`x` plus a reduced row-parallel product, rounded to x's dtype."""
    return x + total.to(x.dtype)


def _vocab_embed(embed, tokens: torch.Tensor, dtype: torch.dtype,
                 coords: list[int], devs: list,
                 group=None) -> list[torch.Tensor]:
    """Vocab-parallel embedding: each shard looks up the tokens its row
    block holds, zeros elsewhere, and the blocks are summed (exactly:
    one shard holds each row; over `group` too when other processes
    hold shards). A whole table is looked up once, by the first shard
    this process holds, and replicated. Returns the activations per
    shard (None for another process's)."""
    if not is_split(embed, -2):
        i = _first(devs)
        table = local(embed, coords[i])
        return replicate(quant.embed_lookup(
            table, tokens.long().to(devs[i]), dtype), devs)
    partials = []
    for i, (c, dev) in enumerate(zip(coords, devs)):
        if dev is None:
            partials.append(None)
            continue
        table = local(embed, c)
        rows = table.shape[0]
        tok = tokens.long().to(dev) - i * rows
        ok = (tok >= 0) & (tok < rows)
        e = quant.embed_lookup(table, torch.where(ok, tok, 0), dtype)
        partials.append(torch.where(ok[..., None], e, torch.zeros_like(e)))
    return all_reduce_sum(partials, group)


def num_params(cfg: LlamaConfig) -> int:
    d, n_layers, v = cfg.hidden_dim, cfg.num_layers, cfg.vocab_size
    qkv = d * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    per_layer = qkv + cfg.num_heads * cfg.head_dim * d + 2 * d + 3 * d * cfg.ffn_dim
    return v * d * 2 + n_layers * per_layer + d
