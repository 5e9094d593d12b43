"""Attention ops: the plain reference path, the FlashAttention kernel's
plain version and wrapper, and the dispatcher.

Port of `ggrmcp_tpu/ops/attention.py`. Layout is [batch, seq, heads,
head_dim]; K/V may carry fewer (KV) heads (GQA).

- `attention_ref` — masked softmax in float32 (the counterpart of
  `attention_xla`): grouped GQA for decode-shaped queries
  (sq <= GQA_GROUPED_MAX_SQ), K/V repeated for longer ones.
- `flash_attention_ref` — the plain PyTorch version of the kernel's
  function (float32 throughout, rows with no valid key → 0).
- `flash_attention` — the wrapper of the hand-written CUDA kernel
  (`csrc/flash_attention.cu`). A CPU tensor takes `flash_attention_ref`;
  a CUDA tensor launches the kernel or raises — never a fallback.
- `attention` — the dispatcher: every query longer than
  GQA_GROUPED_MAX_SQ without ring positions (every admission prefill
  and chunk) goes to `flash_attention`; decode stays on `attention_ref`,
  as decode never reaches Pallas in the reference. `use_flash=False`
  (the int8 KV cache) sends everything to `attention_ref`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ggrmcp_tpu_torch.ops import _build

NEG_INF = -1e30

# Decode-shaped GQA calls (sq at or below this) contract grouped.
GQA_GROUPED_MAX_SQ = 8


def attention_ref(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, H or KVH, D]
    v: torch.Tensor,  # [B, Sk, H or KVH, D]
    causal: bool = True,
    q_offset: Optional[torch.Tensor] = None,  # [B] absolute pos of q[0]
    kv_len: Optional[torch.Tensor] = None,  # [B] valid kv length
    window: Optional[int] = None,
    k_positions: Optional[torch.Tensor] = None,  # [B, Sk]; < 0 = unwritten
) -> torch.Tensor:
    """Masked softmax attention; scores and products in float32, the
    softmax weights cast to v's dtype before the PV product (the
    reference's cast point). Fully masked rows get uniform weights over
    all keys, exactly like the reference's masked softmax."""
    if window is not None and not causal:
        raise ValueError("sliding window requires causal")
    if k_positions is not None and (not causal or q_offset is None):
        raise ValueError("k_positions requires causal + q_offset")
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    grouped = kvh != h and sq <= GQA_GROUPED_MAX_SQ
    if kvh != h and not grouped:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    scale = d ** -0.5
    if grouped:
        g = h // kvh
        qg = q.float().reshape(b, sq, kvh, g, d)
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()).reshape(
            b, h, sq, sk
        ) * scale
    else:
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    dev = q.device
    mask = None
    if causal:
        q_pos = torch.arange(sq, device=dev)[:, None]  # [Sq, 1]
        if q_offset is not None:
            q_pos = q_offset.to(dev).long()[:, None, None] + q_pos[None]
        if k_positions is not None:
            k_pos = k_positions.long()[:, None, :]  # [B, 1, Sk]
            causal_mask = (q_pos >= k_pos) & (k_pos >= 0)
        else:
            k_pos = torch.arange(sk, device=dev)[None, :]  # [1, Sk]
            causal_mask = q_pos >= k_pos
        if window is not None:
            causal_mask = causal_mask & (k_pos > q_pos - window)
        mask = causal_mask if causal_mask.dim() == 3 else causal_mask[None]
    if kv_len is not None:
        kl = kv_len.to(dev).long()[:, None, None]
        if k_positions is not None:
            valid = k_positions.long()[:, None, :] < kl
        else:
            valid = torch.arange(sk, device=dev)[None, None, :] < kl
        mask = valid if mask is None else mask & valid
    if mask is not None:
        scores = torch.where(
            mask[:, None, :, :], scores, torch.full_like(scores, NEG_INF)
        )
    weights = torch.softmax(scores, dim=-1).to(v.dtype).float()
    if grouped:
        g = h // kvh
        wg = weights.reshape(b, kvh, g, sq, sk)
        out = torch.einsum("bhgqk,bkhd->bqhgd", wg, v.float()).reshape(
            b, sq, h, d
        )
    else:
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v.float())
    return out.to(q.dtype)


def flash_attention_ref(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, KVH, D]
    v: torch.Tensor,  # [B, Sk, KVH, D]
    causal: bool = True,
    q_offset: Optional[torch.Tensor] = None,
    kv_len: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: float32 scores, softmax
    and PV product; mask k < kv_len (and causal / window); rows with no
    valid key are written as 0; output in q's dtype."""
    if window is not None and not causal:
        raise ValueError("sliding window requires causal")
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    dev = q.device
    kf = k.float().repeat_interleave(h // kvh, dim=2)
    vf = v.float().repeat_interleave(h // kvh, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * d ** -0.5, kf)
    if q_offset is None:
        q_offset = torch.zeros(b, dtype=torch.int32, device=dev)
    if kv_len is None:
        kv_len = torch.full((b,), sk, dtype=torch.int32, device=dev)
    k_pos = torch.arange(sk, device=dev)[None, None, :]  # [1, 1, Sk]
    mask = k_pos < kv_len.long()[:, None, None]  # [B, 1, Sk]
    if causal:
        q_pos = (
            q_offset.long()[:, None, None]
            + torch.arange(sq, device=dev)[None, :, None]
        )  # [B, Sq, 1]
        mask = mask & (q_pos >= k_pos)
        if window is not None:
            mask = mask & (k_pos > q_pos - window)
    mask = mask.expand(b, sq, sk)[:, None]  # [B, 1, Sq, Sk]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, vf)
    live = mask.any(dim=-1)[:, 0, :, None, None]  # [B, Sq, 1, 1]
    return torch.where(live, out, torch.zeros_like(out)).to(q.dtype)


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_LL = ctypes.c_longlong
_PTR = ctypes.c_void_p
_INT = ctypes.c_int


def _kernel_strides(t: torch.Tensor) -> tuple[int, int, int]:
    """Element strides of batch, seq and heads as the kernel takes them.
    A dimension of size 1 is never stepped, so torch may give it any
    stride; it gets the packed one, which TMA accepts."""
    b, s, h, d = t.shape
    sb, ss, sh = t.stride()[:3]
    if h == 1:
        sh = d
    if s == 1:
        ss = sh * h
    if b == 1:
        sb = ss * s
    return sb, ss, sh


def _kernel_layout_ok(t: torch.Tensor) -> bool:
    """Can the kernel read `t` through its strides as it is? The
    head_dim stride must be 1. For bfloat16, whose tensor maps TMA reads,
    also TMA's rules: a 16-byte-aligned base, and byte strides (those of
    `_kernel_strides`) that are positive multiples of 16 below 2**40."""
    if t.stride(-1) != 1:
        return False
    if t.dtype != torch.bfloat16:
        return True
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        0 < s * es < 2 ** 40 and s * es % 16 == 0 for s in _kernel_strides(t)
    )


def _launch_error(err: int) -> str:
    """What a nonzero return of `flash_attention_fwd` means."""
    if err == -1:
        return "dtype, head_dim or shape not supported by the kernel"
    if err == -2:
        return "the driver has no cuTensorMapEncodeTiled"
    if err <= -1000:
        return f"tensor map encoding failed (CUresult {-1000 - err})"
    return f"CUDA error {err}"


def _kernel_fn():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = (
            [_PTR] * 6 + [_INT] * 6 + [_LL] * 12 + [_INT] * 3 + [_PTR]
        )
        fn.restype = _INT
    return fn


def flash_attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, KVH, D]
    v: torch.Tensor,  # [B, Sk, KVH, D]
    causal: bool = True,
    q_offset: Optional[torch.Tensor] = None,  # [B] int32
    kv_len: Optional[torch.Tensor] = None,  # [B] int32
    window: Optional[int] = None,
) -> torch.Tensor:
    """FlashAttention over [B, S, H, D] with native GQA. CPU tensors run
    `flash_attention_ref`. CUDA tensors launch the kernel on the current
    stream and bump `flash_attention.launches`; anything the kernel does
    not take raises.

    Strides: q/k/v are passed as strided views — the per-layer slice of
    a [L, B, S_max + 1, KVH, D] cache is not contiguous. A view that
    `_kernel_layout_ok` refuses (for bfloat16, one that TMA cannot
    address) is copied first."""
    if q.device.type == "cpu":
        return flash_attention_ref(
            q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len,
            window=window,
        )
    if window is not None and not causal:
        raise ValueError("sliding window requires causal")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: bad shapes q {tuple(q.shape)} "
            f"k {tuple(k.shape)} v {tuple(v.shape)}"
        )
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError("flash_attention: q and k/v disagree on B or D")
    if h % kvh != 0:
        raise ValueError(f"q heads {h} not a multiple of kv heads {kvh}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
            f"the kernel takes float32 or bfloat16, all alike"
        )
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {_HEAD_DIMS}")
    if q_offset is None:
        q_offset = torch.zeros(b, dtype=torch.int32, device=q.device)
    if kv_len is None:
        kv_len = torch.full((b,), sk, dtype=torch.int32, device=q.device)
    for name, t in (("q_offset", q_offset), ("kv_len", kv_len)):
        if t.dtype != torch.int32 or t.device != q.device or t.shape != (b,):
            raise ValueError(
                f"flash_attention: {name} must be int32 [{b}] on {q.device}"
            )
    q_offset, kv_len = q_offset.contiguous(), kv_len.contiguous()
    # A refused view is copied (a contiguous one too: its base may be
    # misaligned, which .contiguous() would keep).
    q, k, v = (
        t if _kernel_layout_ok(t)
        else t.clone(memory_format=torch.contiguous_format)
        for t in (q, k, v)
    )
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if sq == 0:
        return out
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q_offset.data_ptr(), kv_len.data_ptr(),
        b, sq, sk, h, kvh, d,
        *_kernel_strides(q), *_kernel_strides(k), *_kernel_strides(v),
        *_kernel_strides(out),
        int(causal), int(window or 0), _DTYPE_CODES[q.dtype], stream,
    )
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: {_launch_error(err)}"
        )
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, KVH, D]
    v: torch.Tensor,  # [B, Sk, KVH, D]
    causal: bool = True,
    q_offset: Optional[torch.Tensor] = None,
    kv_len: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    k_positions: Optional[torch.Tensor] = None,
    use_flash: Optional[bool] = None,
) -> torch.Tensor:
    """`use_flash=None` (auto): prefill-shaped queries (sq >
    GQA_GROUPED_MAX_SQ) take `flash_attention` — the kernel on a CUDA
    tensor, its plain version on a CPU tensor; everything else takes
    `attention_ref`. No minimum length: the H100 crossover is not
    measured yet. `use_flash=False` forces `attention_ref` (the int8 KV
    cache's path, as in the reference), True forces `flash_attention`.
    Ring positions (`k_positions`) always take `attention_ref`."""
    if k_positions is not None:
        use_flash = False
    if use_flash is None:
        use_flash = q.shape[1] > GQA_GROUPED_MAX_SQ
    if use_flash:
        return flash_attention(
            q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len,
            window=window,
        )
    return attention_ref(
        q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len,
        window=window, k_positions=k_positions,
    )
