"""Attention parity: the PyTorch port's `attention_ref` and
`flash_attention_ref` against the reference's `attention_xla` and its
Pallas `flash_attention` (interpret mode on the CPU), on the cases of
tests/test_models.py and tests/test_sliding_window.py.

The same numpy inputs (fixed seed) go through both packages. Tolerance:
atol 1e-5, rtol 1e-5 in float32 — both sides compute in float32 and
differ only in summation order (the blockwise online softmax vs one
softmax over all keys). The Pallas kernel needs sequence lengths that
are multiples of its 64 blocks; ragged lengths are held against the
port's own `attention_ref`. The CUDA kernel itself is held to
`flash_attention_ref` on the card in tests/test_torch_gpu.py.
"""

import subprocess
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggrmcp_tpu.ops.attention import attention_xla
from ggrmcp_tpu.ops.attention import flash_attention as jax_flash
from ggrmcp_tpu_torch.ops import attention as tatt

ATOL = RTOL = 1e-5


def _inputs(seed, b, sq, sk, h, kvh, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d), dtype=np.float32)
    k = rng.standard_normal((b, sk, kvh, d), dtype=np.float32)
    v = rng.standard_normal((b, sk, kvh, d), dtype=np.float32)
    return q, k, v


def _opt(a, torch_side):
    if a is None:
        return None
    a = np.asarray(a, np.int32)
    return torch.from_numpy(a) if torch_side else jnp.asarray(a)


# (name, (b, sq, sk, h, kvh, d), causal, q_offset, kv_len, window)
CASES = [
    ("causal", (2, 256, 256, 4, 4, 64), True, None, None, None),
    ("non_causal", (1, 128, 128, 2, 2, 32), False, None, None, None),
    ("gqa", (2, 128, 128, 8, 2, 32), True, None, None, None),
    ("cached_prefill", (2, 128, 256, 2, 2, 32), True, [0, 64], [128, 192],
     None),
    ("window_64", (2, 256, 256, 4, 2, 16), True, None, None, 64),
    ("window_128", (2, 256, 256, 4, 2, 16), True, None, None, 128),
    ("window_200", (2, 256, 256, 4, 2, 16), True, None, None, 200),
    ("window_cached", (2, 64, 256, 4, 4, 16), True, [128, 70], [192, 134],
     80),
]


@pytest.mark.parametrize(
    "name,shape,causal,q_off,kv_len,window", CASES, ids=[c[0] for c in CASES]
)
class TestAgainstReference:
    def test_flash_ref_matches_pallas(
        self, name, shape, causal, q_off, kv_len, window
    ):
        q, k, v = _inputs(zlib.crc32(name.encode()) % 1000, *shape)
        ref = jax_flash(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            q_offset=_opt(q_off, False), kv_len=_opt(kv_len, False),
            block_q=64, block_k=64, interpret=True, window=window,
        )
        out = tatt.flash_attention_ref(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=causal, q_offset=_opt(q_off, True),
            kv_len=_opt(kv_len, True), window=window,
        )
        np.testing.assert_allclose(
            out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL
        )

    def test_attention_ref_matches_xla(
        self, name, shape, causal, q_off, kv_len, window
    ):
        q, k, v = _inputs(zlib.crc32(name.encode()) % 1000, *shape)
        ref = attention_xla(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            q_offset=_opt(q_off, False), kv_len=_opt(kv_len, False),
            window=window,
        )
        out = tatt.attention_ref(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=causal, q_offset=_opt(q_off, True),
            kv_len=_opt(kv_len, True), window=window,
        )
        np.testing.assert_allclose(
            out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL
        )


@pytest.mark.parametrize("sq", [1, 4, 8])
def test_attention_ref_grouped_decode_matches_xla(sq):
    """Decode-shaped GQA queries take the grouped contraction."""
    q, k, v = _inputs(7 + sq, 3, sq, 96, 8, 2, 32)
    q_off = np.array([10, 50, 90], np.int32)
    kv_len = q_off + sq
    ref = attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_offset=jnp.asarray(q_off), kv_len=jnp.asarray(kv_len),
    )
    out = tatt.attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, q_offset=torch.from_numpy(q_off),
        kv_len=torch.from_numpy(kv_len),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_attention_ref_k_positions_matches_xla():
    """Ring-layout key positions (negative = never written)."""
    q, k, v = _inputs(21, 2, 1, 32, 4, 2, 32)
    k_pos = np.tile(np.arange(32, dtype=np.int32), (2, 1))
    k_pos[1, 20:] = -1
    q_off = np.array([31, 19], np.int32)
    kv_len = q_off + 1
    args = dict(causal=True, window=16)
    ref = attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_offset=jnp.asarray(q_off), kv_len=jnp.asarray(kv_len),
        k_positions=jnp.asarray(k_pos), **args,
    )
    out = tatt.attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_offset=torch.from_numpy(q_off), kv_len=torch.from_numpy(kv_len),
        k_positions=torch.from_numpy(k_pos), **args,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_fully_masked_rows_are_zero():
    """A batch row with kv_len 0 has no valid key: the kernel contract
    writes zeros, exactly like the Pallas kernel."""
    q, k, v = _inputs(31, 2, 64, 128, 4, 2, 32)
    kv_len = np.array([0, 100], np.int32)
    ref = jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        kv_len=jnp.asarray(kv_len), block_q=64, block_k=64, interpret=True,
    )
    out = tatt.flash_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, kv_len=torch.from_numpy(kv_len),
    )
    assert not out[0].any()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize(
    "sq,sk,q_off,kv_len,window",
    [(300, 300, None, None, None), (77, 333, [5, 200], [82, 277], None),
     (100, 180, [60, 80], [160, 180], 48)],
)
def test_flash_ref_ragged_matches_attention_ref(sq, sk, q_off, kv_len, window):
    """Lengths that are no block multiple (the CUDA kernel masks the
    ragged edge itself) against the port's own reference."""
    q, k, v = _inputs(41 + sq, 2, sq, sk, 8, 2, 32)
    kw = dict(causal=True, q_offset=_opt(q_off, True),
              kv_len=_opt(kv_len, True), window=window)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    np.testing.assert_allclose(
        tatt.flash_attention_ref(*args, **kw).numpy(),
        tatt.attention_ref(*args, **kw).numpy(), atol=ATOL, rtol=RTOL,
    )


def test_dispatcher_on_cpu_never_launches():
    """CPU tensors take the plain versions: prefill-shaped calls go to
    flash_attention_ref, decode-shaped to attention_ref, and the
    kernel's launch counter does not move."""
    before = tatt.flash_attention.launches
    q, k, v = _inputs(51, 2, 64, 64, 8, 2, 32)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    out = tatt.attention(*args, causal=True)
    np.testing.assert_allclose(
        out.numpy(), tatt.flash_attention_ref(*args).numpy(), atol=0, rtol=0
    )
    dec = tatt.attention(args[0][:, :1], *args[1:], causal=False)
    assert dec.shape == (2, 1, 8, 32)
    assert tatt.flash_attention.launches == before


def test_import_needs_no_nvcc():
    """Importing the ops module builds nothing (no nvcc here)."""
    code = (
        "import ggrmcp_tpu_torch.ops.attention as a, "
        "ggrmcp_tpu_torch.ops._build as b; "
        "assert not b._loaded and not b.build_log; print('ok')"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
