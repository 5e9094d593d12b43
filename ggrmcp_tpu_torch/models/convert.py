"""The one way weights cross from the reference into this package.

`params_from_numpy` takes the reference's parameter tree after the
caller has turned every leaf into a numpy array (for a JAX tree:
`jax.tree.map(np.asarray, params)`) and returns this package's dict of
tensors, for either family (a Llama or a BERT tree). Both packages use
the same stacked [L, in, out] layout (models/llama.py, models/bert.py),
so no leaf is transposed or reshaped.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def _leaf(a: Any, device: torch.device, dtype: Optional[torch.dtype]):
    arr = np.asarray(a)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        # ml_dtypes bfloat16 has no torch counterpart in from_numpy;
        # widening to float32 is exact.
        arr = arr.astype(np.float32)
    t = torch.from_numpy(np.array(arr, copy=True, order="C"))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(
    tree: dict, device, dtype: Optional[torch.dtype] = None
) -> dict:
    """Nested dict of numpy arrays → the same nesting of tensors on
    `device`; floating leaves cast to `dtype` when given."""
    dev = torch.device(device)
    return {
        key: (
            params_from_numpy(value, dev, dtype) if isinstance(value, dict)
            else _leaf(value, dev, dtype)
        )
        for key, value in tree.items()
    }
