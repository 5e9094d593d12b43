"""Shared model building blocks: config base, RMSNorm, LayerNorm,
initializers.

Port of `ggrmcp_tpu/models/common.py`. Parameters are plain dicts of
tensors with per-layer weights STACKED along a leading layer axis
([L, in, out]), the reference's layout, so weights cross between the
two packages without transposes (models/convert.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ggrmcp_tpu_torch.ops.quant import QuantizedTensor

Params = dict[str, Any]

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    vocab_size: int = 32000
    hidden_dim: int = 512
    num_layers: int = 4
    num_heads: int = 8
    head_dim: int = 64
    max_seq_len: int = 2048
    dtype: str = "bfloat16"

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """RMSNorm with the reference's cast order: normalize in float32,
    cast to the input dtype, THEN multiply by the weight."""
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype) * weight


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
    eps: float = 1e-12,
) -> torch.Tensor:
    """LayerNorm with the reference's cast order: normalize in float32
    with the population variance (`jnp.var`), cast to the input dtype,
    THEN `* weight + bias`."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    normed = (x32 - mean) * torch.rsqrt(var + eps)
    return normed.to(x.dtype) * weight + bias


def _trunc_normal(
    shape: tuple[int, ...], scale: float, dtype: torch.dtype,
    generator: torch.Generator, device: torch.device,
) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * scale).to(dtype)


def init_dense(
    in_dim: int, out_dim: int, dtype: torch.dtype,
    generator: torch.Generator, device: torch.device,
    scale: float | None = None,
) -> torch.Tensor:
    """Truncated-normal fan-in init (±2σ), stored in the model dtype —
    the reference's scales; the values differ from JAX's draws."""
    scale = scale if scale is not None else in_dim ** -0.5
    return _trunc_normal((in_dim, out_dim), scale, dtype, generator, device)


def init_stacked(
    num_layers: int, shape: tuple[int, ...], dtype: torch.dtype,
    generator: torch.Generator, device: torch.device, scale: float,
) -> torch.Tensor:
    """One stacked parameter for all layers: [L, *shape]. Drawn one
    layer at a time so the float32 scratch stays one layer's size."""
    out = torch.empty((num_layers, *shape), dtype=dtype, device=device)
    for layer in range(num_layers):
        out[layer] = _trunc_normal(shape, scale, dtype, generator, device)
    return out


def _leaves(params: Params):
    """Every tensor of the tree; a quantized leaf gives its q and its
    scale, as the reference's pytree leaves do."""
    for value in params.values():
        if isinstance(value, dict):
            yield from _leaves(value)
        elif isinstance(value, QuantizedTensor):
            yield value.q
            yield value.scale
        else:
            yield value


def count_params(params: Params) -> int:
    return sum(t.numel() for t in _leaves(params))


def param_bytes(params: Params) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(params))
