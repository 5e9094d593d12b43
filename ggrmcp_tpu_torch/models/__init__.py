"""Model registry: name → (family, config), the counterpart of
`ggrmcp_tpu/models/__init__.py` for the families this package serves:
"llama" (dense generation) and "bert" (embeddings)."""

from __future__ import annotations

from typing import Any

from ggrmcp_tpu_torch.models import bert, llama


def available_models() -> list[str]:
    return sorted([*llama.CONFIGS, *bert.CONFIGS])


def get_model(name: str) -> tuple[str, Any]:
    if name in llama.CONFIGS:
        return "llama", llama.CONFIGS[name]
    if name in bert.CONFIGS:
        return "bert", bert.CONFIGS[name]
    raise ValueError(
        f"unknown model {name!r}; this package serves {available_models()}"
    )
