"""Llama-family decoder: GQA + RoPE + SwiGLU over stacked [L, ...]
weights. Port of `ggrmcp_tpu/models/llama.py` on the cache-free and
contiguous-cache paths (no int8, ring or paged KV in this package yet).

The reference threads the KV cache functionally through `lax.scan` and
donates it; here `forward` writes each layer's new K/V into the cache
tensors IN PLACE and returns the same cache object with its length
advanced.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ggrmcp_tpu_torch.models import common
from ggrmcp_tpu_torch.ops.attention import attention
from ggrmcp_tpu_torch.ops.rope import apply_rope

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
    qkv_out = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    scale = d ** -0.5
    kw = dict(generator=gen, device=device)
    return {
        "embed": common.init_dense(cfg.vocab_size, d, dtype, scale=0.02, **kw),
        "layers": {
            "attn_norm": torch.ones((n_layers, d), dtype=dtype, device=device),
            "wqkv": common.init_stacked(
                n_layers, (d, qkv_out), dtype, scale=scale, **kw
            ),
            "wo": common.init_stacked(
                n_layers, (cfg.num_heads * cfg.head_dim, d), dtype,
                scale=(cfg.num_heads * cfg.head_dim) ** -0.5, **kw,
            ),
            "mlp_norm": torch.ones((n_layers, d), dtype=dtype, device=device),
            "w_gate": common.init_stacked(
                n_layers, (d, cfg.ffn_dim), dtype, scale=scale, **kw
            ),
            "w_up": common.init_stacked(
                n_layers, (d, cfg.ffn_dim), dtype, scale=scale, **kw
            ),
            "w_down": common.init_stacked(
                n_layers, (cfg.ffn_dim, d), dtype,
                scale=cfg.ffn_dim ** -0.5, **kw,
            ),
        },
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
        "lm_head": common.init_dense(d, cfg.vocab_size, dtype, scale=scale, **kw),
    }


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KVCache:
    """Contiguous KV cache. k/v are [L, B, S_max + 1, KVH, Dh]: positions
    0..S_max-1 are the cache proper and position S_max is a SCRATCH slot
    that absorbs every write past the end (the reference's jit drops
    out-of-bounds scatters; torch indexing would raise on the CPU and
    assert on the device). Attention only ever reads [:S_max]."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor  # [B] int32 — valid prefix length

    @property
    def capacity(self) -> int:
        return self.k.shape[2] - 1

    @classmethod
    def create(
        cls, cfg: LlamaConfig, batch: int, max_len: int,
        device: torch.device,
    ) -> "KVCache":
        shape = (
            cfg.num_layers, batch, max_len + 1, cfg.num_kv_heads, cfg.head_dim
        )
        return cls(
            k=torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            v=torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            length=torch.zeros((batch,), dtype=torch.int32, device=device),
        )

    def nbytes(self) -> int:
        return sum(
            t.numel() * t.element_size() for t in (self.k, self.v, self.length)
        )


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def attention_block(
    x: torch.Tensor,  # [B, S, D]
    lp: Params,  # one layer's weights (no leading L)
    cfg: LlamaConfig,
    positions: torch.Tensor,  # [B, S]
    cache_k: Optional[torch.Tensor],  # [B, S_max + 1, KVH, Dh], written in place
    cache_v: Optional[torch.Tensor],
    cache_len: Optional[torch.Tensor],  # [B]
) -> torch.Tensor:
    """Pre-norm GQA attention with residual. With a cache, the step's
    K/V are written at each row's current length and attention reads
    the whole cache prefix (q_offset = cache_len, kv_len = cache_len +
    S); writes past S_max land in the scratch slot."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    normed = common.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    qkv = normed @ lp["wqkv"]  # [B, S, (H + 2 KVH) * Dh]
    q, k, v = qkv.split([h * hd, kvh * hd, kvh * hd], dim=-1)
    q = apply_rope(q.reshape(b, s, h, hd), positions, cfg.rope_theta,
                   cfg.rope_scaling)
    k = apply_rope(k.reshape(b, s, kvh, hd), positions, cfg.rope_theta,
                   cfg.rope_scaling)
    v = v.reshape(b, s, kvh, hd)

    if cache_k is not None:
        cap = cache_k.shape[1] - 1
        write_pos = cache_len.long()[:, None] + torch.arange(
            s, device=x.device
        )[None, :]
        write_pos = torch.clamp(write_pos, max=cap)  # overflow → scratch
        batch_idx = torch.arange(b, device=x.device)[:, None]
        cache_k[batch_idx, write_pos] = k.to(cache_k.dtype)
        cache_v[batch_idx, write_pos] = v.to(cache_v.dtype)
        k_all, v_all = cache_k[:, :cap], cache_v[:, :cap]
        kv_len = (cache_len + s).to(torch.int32)
        q_offset = cache_len.to(torch.int32)
    else:
        k_all, v_all, kv_len, q_offset = k, v, None, None

    attn_out = attention(
        q, k_all, v_all, causal=True, q_offset=q_offset, kv_len=kv_len,
        window=cfg.sliding_window,
    )
    return x + attn_out.reshape(b, s, h * hd) @ lp["wo"]


def _layer(
    x: torch.Tensor, lp: Params, cfg: LlamaConfig, positions: torch.Tensor,
    cache_k: Optional[torch.Tensor], cache_v: Optional[torch.Tensor],
    cache_len: Optional[torch.Tensor],
) -> torch.Tensor:
    x = attention_block(x, lp, cfg, positions, cache_k, cache_v, cache_len)
    normed = common.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    gate = F.silu(normed @ lp["w_gate"])
    up = normed @ lp["w_up"]
    return x + (gate * up) @ lp["w_down"]


def forward(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, S]
    cache: Optional[KVCache] = None,
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """Without a cache: plain causal forward. With a cache: tokens are
    appended at each row's cache length (prefill S > 1, decode S = 1);
    the cache is updated in place and its length advanced by S.
    Returns (float32 logits [B, S, V], cache or None)."""
    b, s = tokens.shape
    dtype = cfg.torch_dtype
    x = params["embed"].to(dtype)[tokens.long()]  # [B, S, D]
    steps = torch.arange(s, device=tokens.device)[None, :]
    positions = (
        cache.length.long()[:, None] + steps if cache is not None
        else steps.expand(b, s)
    )
    layers = params["layers"]
    for layer in range(cfg.num_layers):
        lp = {name: w[layer] for name, w in layers.items()}
        if cache is None:
            x = _layer(x, lp, cfg, positions, None, None, None)
        else:
            x = _layer(
                x, lp, cfg, positions, cache.k[layer], cache.v[layer],
                cache.length,
            )
    if cache is not None:
        cache.length = cache.length + s
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ params["lm_head"].to(dtype)
    return logits.float(), cache


def num_params(cfg: LlamaConfig) -> int:
    d, n_layers, v = cfg.hidden_dim, cfg.num_layers, cfg.vocab_size
    qkv = d * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    per_layer = qkv + cfg.num_heads * cfg.head_dim * d + 2 * d + 3 * d * cfg.ffn_dim
    return v * d * 2 + n_layers * per_layer + d
