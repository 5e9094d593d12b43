"""Model registry: name → (family, config), the counterpart of
`ggrmcp_tpu/models/__init__.py`. Families: "llama" (dense generation),
"moe" (sparse-MoE generation, served by the same engine) and "bert"
(embeddings)."""

from __future__ import annotations

from typing import Any

from ggrmcp_tpu_torch.models import bert, llama, moe


def available_models() -> list[str]:
    return sorted([*llama.CONFIGS, *moe.CONFIGS, *bert.CONFIGS])


def get_model(name: str) -> tuple[str, Any]:
    if name in llama.CONFIGS:
        return "llama", llama.CONFIGS[name]
    if name in moe.CONFIGS:
        return "moe", moe.CONFIGS[name]
    if name in bert.CONFIGS:
        return "bert", bert.CONFIGS[name]
    raise ValueError(
        f"unknown model {name!r}; this package serves {available_models()}"
    )


def family_module(cfg):
    """The decoder family module (llama or moe) of `cfg`: the engine and
    the batcher resolve `init_params`, `param_shapes` and `forward`
    here."""
    return moe if isinstance(cfg, moe.MoEConfig) else llama
