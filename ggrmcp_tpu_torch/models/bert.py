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
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ggrmcp_tpu_torch.models import common
from ggrmcp_tpu_torch.ops.attention import attention

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


def encode(
    params: Params,
    cfg: BertConfig,
    tokens: torch.Tensor,  # [B, S]
    attention_mask: Optional[torch.Tensor] = None,  # [B, S] 1 = real
) -> torch.Tensor:  # [B, S, D] final hidden states, model dtype
    b, s = tokens.shape
    if attention_mask is None:
        attention_mask = (tokens != cfg.pad_token_id).to(torch.int32)
    x = params["embed"].to(cfg.torch_dtype)[tokens.long()]
    x = x + params["pos_embed"][None, :s]
    x = common.layer_norm(
        x, params["embed_norm_w"], params["embed_norm_b"], cfg.norm_eps
    )
    # Pads are trailing (the tokenizer's contract): a per-row key length
    # masks them.
    kv_len = attention_mask.sum(dim=-1).to(torch.int32)  # [B]
    h, hd = cfg.num_heads, cfg.head_dim
    layers = params["layers"]
    for layer in range(cfg.num_layers):
        lp = {name: w[layer] for name, w in layers.items()}
        # q, k, v stay strided views of the fused projection; the kernel
        # reads them in place.
        q, k, v = (
            t.reshape(b, s, h, hd)
            for t in (x @ lp["wqkv"]).chunk(3, dim=-1)
        )
        attn = attention(q, k, v, causal=False, kv_len=kv_len)
        attn = attn.reshape(b, s, h * hd) @ lp["wo"]
        x = common.layer_norm(
            x + attn, lp["attn_norm_w"], lp["attn_norm_b"], cfg.norm_eps
        )
        mlp = F.gelu(x @ lp["w_in"], approximate="tanh") @ lp["w_out"]
        x = common.layer_norm(
            x + mlp, lp["mlp_norm_w"], lp["mlp_norm_b"], cfg.norm_eps
        )
    return x


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
    mask = attention_mask[..., None].float()  # [B, S, 1]
    if pooling == "cls":
        pooled = hidden[:, 0]
    elif pooling == "max":
        pooled = torch.where(mask > 0, hidden, float("-inf")).amax(dim=1)
    else:  # mean
        pooled = (hidden * mask).sum(dim=1) / mask.sum(dim=1).clamp(min=1.0)
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / norm.clamp(min=1e-9)
