"""Device resolution and the port's float settings.

Every entry point of the port runs on CUDA unless the caller asks for
the CPU. A CUDA request on a machine without a usable card raises; it
never quietly runs on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def set_float_policy() -> None:
    """Full-precision float32 products and float32 reductions inside
    bf16 products: a float32 matmul must not run in TF32 (three decimal
    digits), and a bf16 GEMM must not reduce in bf16. The reference
    computes both at full width, so the port does too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` → cuda:0. "cpu" only when asked. Raises RuntimeError when
    CUDA is asked for and absent, ValueError for any other device type."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' (or --device cpu) to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}")
    set_float_policy()
    return dev

