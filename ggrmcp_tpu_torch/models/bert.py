"""BERT-class bidirectional encoder for the embedding endpoint. Port of
`ggrmcp_tpu/models/bert.py` over the same stacked [L, ...] weights.

Post-norm layers: x = LN(x + attention(x)), then x = LN(x + MLP(x)), the
MLP with tanh-approximated GELU (`jax.nn.gelu`'s default). Padding is
trailing and masked by a per-row key length; attention goes through the
port's dispatcher, so a sequence longer than GQA_GROUPED_MAX_SQ on the
card runs the FlashAttention kernel (non-causal, per-row kv_len). One
difference from the reference's `attention_xla`: a row with no real
token (kv_len 0) comes out of the kernel as zeros where the reference
spreads uniform weights; such rows exist only as padding.

On a mesh (`param_specs`, `shard_params`) `encode` splits the batch
over the data blocks, each block's rows on its tensor shards
(head-aligned q / k / v columns, row-parallel `wo` and `w_out`
all-reduced in float32 within the block, the vocab-parallel
embedding), the kernel once per (data block x tensor shard).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import torch
import torch.nn.functional as F

from ggrmcp_tpu_torch.models import common, llama
from ggrmcp_tpu_torch.ops import quant
from ggrmcp_tpu_torch.ops.attention import attention
from ggrmcp_tpu_torch.parallel import mesh as mesh_mod
from ggrmcp_tpu_torch.parallel.collectives import (
    Sharded,
    block_product,
    gather_batch,
    local,
    per_device,
    replicate,
    shard,
)

logger = logging.getLogger("ggrmcp.torch.models.bert")

Params = common.Params


@dataclasses.dataclass(frozen=True)
class BertConfig(common.ModelConfig):
    name: str = "bert"
    vocab_size: int = 30522
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    head_dim: int = 64
    ffn_dim: int = 3072
    max_seq_len: int = 512
    norm_eps: float = 1e-12
    dtype: str = "bfloat16"
    pad_token_id: int = 0


# The reference registry, same names and values.
CONFIGS: dict[str, BertConfig] = {
    "bert-tiny": BertConfig(
        name="bert-tiny", vocab_size=30522, hidden_dim=128, num_layers=2,
        num_heads=2, head_dim=64, ffn_dim=512, max_seq_len=512,
        dtype="float32",
    ),
    "bert-base": BertConfig(name="bert-base"),
}


def init_params(
    cfg: BertConfig, device: torch.device, seed: int = 0
) -> Params:
    """Random weights at the reference's init scales, drawn on `device`
    from a seeded torch.Generator (the values differ from JAX's)."""
    dtype = cfg.torch_dtype
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, n, f = cfg.hidden_dim, cfg.num_layers, cfg.ffn_dim
    scale = d ** -0.5
    kw = dict(generator=gen, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "embed": common.init_dense(cfg.vocab_size, d, dtype, scale=0.02, **kw),
        "pos_embed": common.init_dense(
            cfg.max_seq_len, d, dtype, scale=0.02, **kw
        ),
        "embed_norm_w": ones(d),
        "embed_norm_b": zeros(d),
        "layers": {
            "wqkv": common.init_stacked(n, (d, 3 * d), dtype, scale=scale,
                                        **kw),
            "wo": common.init_stacked(n, (d, d), dtype, scale=scale, **kw),
            "attn_norm_w": ones(n, d),
            "attn_norm_b": zeros(n, d),
            "w_in": common.init_stacked(n, (d, f), dtype, scale=scale, **kw),
            "w_out": common.init_stacked(n, (f, d), dtype, scale=f ** -0.5,
                                         **kw),
            "mlp_norm_w": ones(n, d),
            "mlp_norm_b": zeros(n, d),
        },
    }


def param_specs(cfg: BertConfig) -> Params:
    """The reference's specs: column-parallel wqkv and w_in,
    row-parallel wo and w_out, the embedding vocab-sharded, the rest
    replicated. The fused wqkv's split is head-aligned here
    (`qkv_columns`)."""
    return {
        "embed": ("tensor", None),
        "pos_embed": (None, None),
        "embed_norm_w": (None,),
        "embed_norm_b": (None,),
        "layers": {
            "wqkv": (None, None, "tensor"),
            "wo": (None, "tensor", None),
            "attn_norm_w": (None, None),
            "attn_norm_b": (None, None),
            "w_in": (None, None, "tensor"),
            "w_out": (None, "tensor", None),
            "mlp_norm_w": (None, None),
            "mlp_norm_b": (None, None),
        },
    }


def qkv_columns(cfg: BertConfig, tensor: int, shard_: int) -> torch.Tensor:
    """The fused [D, 3 · H · Dh] wqkv's columns of tensor shard `shard_`:
    its heads' q, k and v columns, in that order."""
    width = cfg.num_heads // tensor * cfg.head_dim
    own = torch.arange(shard_ * width, (shard_ + 1) * width)
    d = cfg.num_heads * cfg.head_dim
    return torch.cat([own, d + own, 2 * d + own])


# The leaves the tensor axis splits together (`llama.BLOCKS`' rule).
BLOCKS = {"attn": ("wqkv", "wo"), "ffn": ("w_in", "w_out"),
          "vocab": ("embed",)}


def whole_blocks(cfg: BertConfig, tensor: int) -> frozenset:
    """The blocks held whole on every coordinate of a `tensor`-way axis:
    those with a dim `tensor` does not divide, and attention when it does
    not divide the heads (`llama.whole_blocks`)."""
    if tensor == 1:
        return frozenset()
    out = set()
    if cfg.num_heads % tensor:
        out.add("attn")
    if cfg.ffn_dim % tensor:
        out.add("ffn")
    if cfg.vocab_size % tensor:
        out.add("vocab")
    return frozenset(out)


def shard_params(params: Params, cfg: BertConfig, mesh,
                 on_downgrade=None) -> Params:
    """Place a whole tree on `mesh` by `param_specs`, IN PLACE.
    `on_downgrade(where, dim, entry, size, axis)` hears of each dim
    `compatible_spec` replicates (the reference's count); the leaves of
    a block `whole_blocks` names are then replicated over tensor."""
    tensor = mesh.shape["tensor"]
    whole = whole_blocks(cfg, tensor)
    if "attn" in whole and 3 * cfg.num_heads * cfg.head_dim % tensor == 0:
        logger.warning(
            "%s at tensor=%d: %d heads do not split %d ways; the attention "
            "block is held whole on every shard (the reference splits "
            "wqkv's columns; not a mesh_spec_downgrades site)", cfg.name,
            tensor, cfg.num_heads, tensor)
    strip = {name for b in whole for name in BLOCKS[b]}

    def cut(x, spec, where, name):
        adapted = llama.placed_spec(spec, x.shape, mesh, name in strip, (
            None if on_downgrade is None
            else lambda *a: on_downgrade(where, *a)))
        index_fn = None
        if name == "wqkv":
            def index_fn(dim, block, n):
                return qkv_columns(cfg, n, block) if dim == 2 else None
        return shard(x, adapted, mesh, index_fn)

    for key, spec in param_specs(cfg).items():
        if isinstance(spec, dict):
            for name, sub in spec.items():
                params[key][name] = cut(params[key][name], sub,
                                        f"['{key}']['{name}']", name)
        else:
            params[key] = cut(params[key], spec, f"['{key}']", key)
    return params


def is_sharded(params: Params) -> bool:
    return isinstance(params["layers"]["wqkv"], Sharded)


def encode(
    params: Params,
    cfg: BertConfig,
    tokens: torch.Tensor,  # [B, S]
    attention_mask: Optional[torch.Tensor] = None,  # [B, S] 1 = real
) -> torch.Tensor:  # [B, S, D] final hidden states, model dtype
    """The encoder over one device's params, or over params placed by
    `shard_params`: each data block's rows on its tensor shards, the
    blocks' hidden states back in batch order on the mesh's first
    device."""
    b, s = tokens.shape
    if attention_mask is None:
        attention_mask = (tokens != cfg.pad_token_id).to(torch.int32)
    # Pads are trailing (the tokenizer's contract): a per-row key length
    # masks them.
    kv_len = attention_mask.sum(dim=-1).to(torch.int32)  # [B]
    if not is_sharded(params):
        x = params["embed"].to(cfg.torch_dtype)[tokens.long()]
        return _encode_shards(cfg, [params], [x], [kv_len])
    mesh = params["layers"]["wqkv"].mesh
    outs = []
    for rows, at in mesh_mod.data_blocks(mesh, b):
        coords, devs = llama.tensor_coords(mesh, **at)
        xs = llama._vocab_embed(params["embed"], tokens[rows],
                                cfg.torch_dtype, coords, devs)
        outs.append(_encode_shards(cfg, [local(params, c) for c in coords],
                                   xs, replicate(kv_len[rows], devs)))
    return gather_batch(outs)


def _encode_shards(cfg: BertConfig, shards: list, xs: list,
                   lens: list) -> torch.Tensor:
    """The positional add, the embedding LayerNorm and every layer over
    one block's tensor shards: per shard its params, its embedded rows
    and their key lengths. Every row-parallel partial of a split block
    is a float32 product, all-reduced within the block and rounded once
    before the residual add and its LayerNorm; a block held whole
    (`whole_blocks`) is computed once per device. Returns the first
    shard's hidden states."""
    t = len(shards)
    b, s = xs[0].shape[:2]
    layers = shards[0]["layers"]
    split_attn = layers["wo"].shape[1] < cfg.num_heads * cfg.head_dim
    split_ffn = layers["w_out"].shape[1] < cfg.ffn_dim
    h = cfg.num_heads // t if split_attn else cfg.num_heads
    hd, eps = cfg.head_dim, cfg.norm_eps
    partial_attn = torch.float32 if split_attn else None
    partial_ffn = torch.float32 if split_ffn else None

    def add_norm(xs, totals, lps, name):
        return per_device(
            lambda x, tot, w, bias: common.layer_norm(
                x + tot.to(x.dtype), w, bias, eps),
            xs, totals, [lp[f"{name}_w"] for lp in lps],
            [lp[f"{name}_b"] for lp in lps])

    xs = per_device(
        lambda x, pe, w, bias: common.layer_norm(x + pe[None, :s], w, bias,
                                                 eps),
        xs, *([p[k] for p in shards]
              for k in ("pos_embed", "embed_norm_w", "embed_norm_b")))
    for layer in range(cfg.num_layers):
        lps = [{n: w[layer] for n, w in p["layers"].items()} for p in shards]

        def attn(i):
            # q, k, v stay strided views of the fused projection; the
            # kernel reads them in place.
            q, k, v = (u.reshape(b, s, h, hd)
                       for u in (xs[i] @ lps[i]["wqkv"]).chunk(3, dim=-1))
            out = attention(q, k, v, causal=False, kv_len=lens[i])
            return quant.matmul(out.reshape(b, s, h * hd), lps[i]["wo"],
                                partial_attn)

        xs = add_norm(xs, block_product(xs, split_attn, attn), lps,
                      "attn_norm")
        xs = add_norm(xs, block_product(xs, split_ffn, lambda i: quant.matmul(
            F.gelu(xs[i] @ lps[i]["w_in"], approximate="tanh"),
            lps[i]["w_out"], partial_ffn)), lps, "mlp_norm")
    return xs[0]


def embed(
    params: Params,
    cfg: BertConfig,
    tokens: torch.Tensor,  # [B, S]
    attention_mask: Optional[torch.Tensor] = None,
    pooling: str = "mean",  # mean | cls | max
) -> torch.Tensor:  # [B, D] float32, L2-normalized
    if attention_mask is None:
        attention_mask = (tokens != cfg.pad_token_id).to(torch.int32)
    hidden = encode(params, cfg, tokens, attention_mask).float()
    mask = attention_mask[..., None].float().to(hidden.device)
    if pooling == "cls":
        pooled = hidden[:, 0]
    elif pooling == "max":
        pooled = torch.where(mask > 0, hidden, float("-inf")).amax(dim=1)
    else:  # mean
        pooled = (hidden * mask).sum(dim=1) / mask.sum(dim=1).clamp(min=1.0)
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / norm.clamp(min=1e-9)
