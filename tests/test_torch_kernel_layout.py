"""The FlashAttention wrapper's host-side rules, on the CPU: which views
the bf16 kernel's tensor maps can address as they are (TMA: 16-byte
aligned base, byte strides that are positive multiples of 16 below
2**40, unit stride over head_dim) and the strides it hands the kernel.
The operands are the model's own views: the per-layer cache slice, q
from the fused wqkv projection and RoPE, and a head_dim slice that is
not aligned. No kernel runs here."""

import pytest
import torch

from ggrmcp_tpu_torch.ops import attention as tatt
from ggrmcp_tpu_torch.ops.rope import apply_rope

BF16 = torch.bfloat16


def _byte_strides(t):
    return tuple(s * t.element_size() for s in tatt._kernel_strides(t))


@pytest.mark.parametrize("s_max", [4096, 8192])
def test_cache_slice_is_addressable_as_it_is(s_max):
    """[:, :S_max] of a [B, S_max + 1, KVH, D] cache: strided, not
    contiguous, and readable through its strides (no copy)."""
    b, kvh, d = 2, 8, 128
    cache = torch.zeros((b, s_max + 1, kvh, d), dtype=BF16)
    k = cache[:, :s_max]
    assert not k.is_contiguous()
    assert tatt._kernel_layout_ok(k)
    assert tatt._kernel_strides(k) == ((s_max + 1) * kvh * d, kvh * d, d)
    assert _byte_strides(k) == (2 * (s_max + 1) * kvh * d, 2 * kvh * d, 2 * d)
    assert all(s % 16 == 0 for s in _byte_strides(k))


@pytest.mark.parametrize("s_max", [4096, 8192])
def test_layer_of_stacked_cache_is_addressable(s_max):
    """The slice of one layer of the [L, B, S_max + 1, KVH, D] cache
    starts at a layer offset that keeps the base 16-byte aligned."""
    cache = torch.zeros((2, 1, s_max + 1, 8, 64), dtype=BF16)
    k = cache[1][:, :s_max]
    assert k.data_ptr() % 16 == 0
    assert tatt._kernel_layout_ok(k)


def test_q_from_wqkv_split_and_rope():
    """q after the fused projection's split is a strided view into the
    qkv rows; after RoPE it is a fresh tensor. Both are addressable, and
    so are the k and v views of the split (offset bases)."""
    b, s, h, kvh, hd = 2, 40, 32, 8, 128
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn((b, s, (h + 2 * kvh) * hd), generator=g).to(BF16)
    q, k, v = qkv.split([h * hd, kvh * hd, kvh * hd], dim=-1)
    q4, k4, v4 = (q.reshape(b, s, h, hd), k.reshape(b, s, kvh, hd),
                  v.reshape(b, s, kvh, hd))
    row = (h + 2 * kvh) * hd
    assert tatt._kernel_strides(q4) == (s * row, row, hd)
    for t in (q4, k4, v4):
        assert tatt._kernel_layout_ok(t)
    positions = torch.arange(s)[None].expand(b, s)
    roped = apply_rope(q4, positions, 500000.0)
    assert roped.dtype == BF16 and roped.is_contiguous()
    assert tatt._kernel_layout_ok(roped)
    assert tatt._kernel_strides(roped) == (s * h * hd, h * hd, hd)


def test_misaligned_view_is_refused():
    """The view of test_kernel_copies_views_it_cannot_read: head_dim
    sliced out of a wider tensor starts 8 bytes into a row."""
    wide = torch.zeros((2, 128, 4, 72), dtype=BF16)
    q = wide[..., 4:68]
    assert q.data_ptr() % 16 != 0
    assert not tatt._kernel_layout_ok(q)
    assert tatt._kernel_layout_ok(q.contiguous())


def test_stride_not_multiple_of_16_bytes_is_refused():
    """A seq stride of 68 elements (136 bytes) is no multiple of 16."""
    base = torch.zeros((2, 64, 68), dtype=BF16)
    t = base[..., :64].unsqueeze(2)
    assert t.shape == (2, 64, 1, 64)
    assert tatt._kernel_strides(t) == (64 * 68, 68, 64)
    assert not tatt._kernel_layout_ok(t)


def test_head_dim_stride_must_be_one():
    t = torch.zeros((1, 16, 2, 64), dtype=BF16).transpose(2, 3)
    assert t.stride(-1) != 1
    assert not tatt._kernel_layout_ok(t)
    t32 = torch.zeros((1, 16, 64, 2)).transpose(2, 3)
    assert not tatt._kernel_layout_ok(t32)


def test_size_one_dims_get_packed_strides():
    """torch gives a size-1 dimension any stride (here 7, 3 and 5
    elements); the kernel gets packed ones, so TMA sees only valid
    strides."""
    storage = torch.zeros(4096, dtype=BF16)
    t = storage.as_strided((1, 1, 1, 64), (7, 3, 5, 1))
    assert tatt._kernel_strides(t) == (64, 64, 64)
    assert tatt._kernel_layout_ok(t)
    t = storage.as_strided((1, 16, 1, 64), (7, 64, 5, 1))
    assert tatt._kernel_strides(t) == (16 * 64, 64, 64)
    assert tatt._kernel_layout_ok(t)


def test_float32_needs_only_unit_head_dim_stride():
    """The float32 kernel reads through plain pointers: any alignment."""
    wide = torch.zeros((2, 16, 4, 36))
    q = wide[..., 1:33]
    assert q.data_ptr() % 16 != 0
    assert tatt._kernel_layout_ok(q)


@pytest.mark.parametrize(
    "err,words",
    [(-1, "not supported"), (-2, "cuTensorMapEncodeTiled"),
     (-1001, "CUresult 1"), (700, "CUDA error 700")],
)
def test_launch_errors_are_named(err, words):
    assert words in tatt._launch_error(err)
