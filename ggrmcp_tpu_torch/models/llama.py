"""Llama-family decoder: GQA + RoPE + SwiGLU over stacked [L, ...]
weights. Port of `ggrmcp_tpu/models/llama.py` on the cache-free and
contiguous-cache paths, with int8 weights (any leaf may be a
`QuantizedTensor`, ops/quant.py) and the int8 KV cache; no ring or paged
KV in this package yet.

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
from ggrmcp_tpu_torch.ops import quant
from ggrmcp_tpu_torch.ops.attention import attention
from ggrmcp_tpu_torch.ops.quant import QuantizedTensor
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
        dtype = cfg.torch_dtype
        if kv_dtype == "int8":
            def leaf():
                return QuantizedTensor(
                    q=torch.zeros(shape, dtype=torch.int8, device=device),
                    scale=torch.zeros(shape[:-1] + (1,), dtype=dtype,
                                      device=device),
                )
        elif kv_dtype:
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
        else:
            def leaf():
                return torch.zeros(shape, dtype=dtype, device=device)
        return cls(
            k=leaf(), v=leaf(),
            length=torch.zeros((batch,), dtype=torch.int32, device=device),
        )

    def nbytes(self) -> int:
        return self.k.nbytes + self.v.nbytes + self.length.nbytes


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
) -> torch.Tensor:
    """Pre-norm GQA attention with residual. With a cache, the step's
    K/V are written at each row's current length and attention reads
    the whole cache prefix (q_offset = cache_len, kv_len = cache_len +
    S); writes past S_max land in the scratch slot.

    An int8 cache (QuantizedTensor leaves): the step's K/V are quantized
    per (position, head), values and scales are written at the same
    clamped positions, and attention reads the dequantized prefix
    through `attention_ref` (use_flash False), as the reference does —
    the current step's K/V round-trip through int8 too."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    normed = common.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    qkv = quant.matmul(normed, lp["wqkv"])  # [B, S, (H + 2 KVH) * Dh]
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

        def write(cache: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
            cache[batch_idx, write_pos] = new.to(cache.dtype)
            return cache

        if isinstance(cache_k, QuantizedTensor):
            quant.kv_map(write, cache_k, quant.quantize(k, axis=-1))
            quant.kv_map(write, cache_v, quant.quantize(v, axis=-1))
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
    else:
        k_all, v_all, kv_len, q_offset = k, v, None, None

    attn_out = attention(
        q, k_all, v_all, causal=True, q_offset=q_offset, kv_len=kv_len,
        window=cfg.sliding_window, use_flash=use_flash,
    )
    return x + quant.matmul(attn_out.reshape(b, s, h * hd), lp["wo"])


def _layer(
    x: torch.Tensor, lp: Params, cfg: LlamaConfig, positions: torch.Tensor,
    cache_k: Optional[quant.TensorOrQuant],
    cache_v: Optional[quant.TensorOrQuant],
    cache_len: Optional[torch.Tensor], use_flash: Optional[bool] = None,
) -> torch.Tensor:
    x = attention_block(x, lp, cfg, positions, cache_k, cache_v, cache_len,
                        use_flash)
    normed = common.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    gate = F.silu(quant.matmul(normed, lp["w_gate"]))
    up = quant.matmul(normed, lp["w_up"])
    return x + quant.matmul(gate * up, lp["w_down"])


def _at(layer: int, t: quant.TensorOrQuant) -> quant.TensorOrQuant:
    """One layer of a stacked leaf, dense or quantized."""
    return quant.kv_map(lambda x: x[layer], t)


def forward(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, S]
    cache: Optional[KVCache] = None,
    use_flash: Optional[bool] = None,
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """Without a cache: plain causal forward. With a cache: tokens are
    appended at each row's cache length (prefill S > 1, decode S = 1);
    the cache is updated in place and its length advanced by S.
    `use_flash`: None = auto (ops/attention.py), False = `attention_ref`
    everywhere (an int8 cache forces it per layer).
    Returns (float32 logits [B, S, V], cache or None)."""
    b, s = tokens.shape
    dtype = cfg.torch_dtype
    x = quant.embed_lookup(params["embed"], tokens, dtype)  # [B, S, D]
    steps = torch.arange(s, device=tokens.device)[None, :]
    positions = (
        cache.length.long()[:, None] + steps if cache is not None
        else steps.expand(b, s)
    )
    layers = params["layers"]
    for layer in range(cfg.num_layers):
        lp = {name: _at(layer, w) for name, w in layers.items()}
        if cache is None:
            x = _layer(x, lp, cfg, positions, None, None, None, use_flash)
        else:
            x = _layer(
                x, lp, cfg, positions, _at(layer, cache.k),
                _at(layer, cache.v), cache.length, use_flash,
            )
    if cache is not None:
        cache.length = cache.length + s
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["lm_head"]
    if not isinstance(head, QuantizedTensor):
        head = head.to(dtype)
    logits = quant.matmul(x, head)
    return logits.float(), cache


def num_params(cfg: LlamaConfig) -> int:
    d, n_layers, v = cfg.hidden_dim, cfg.num_layers, cfg.vocab_size
    qkv = d * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    per_layer = qkv + cfg.num_heads * cfg.head_dim * d + 2 * d + 3 * d * cfg.ffn_dim
    return v * d * 2 + n_layers * per_layer + d
