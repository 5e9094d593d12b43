"""BERT parity: the PyTorch port's LayerNorm, encoder and pooled
embeddings against the reference's, on bert-tiny in float32 with the
same weights (the JAX init tree crossed through `params_from_numpy`).

Tolerance: 1e-5 absolute on float32 activations and embeddings. Both
sides compute in float32; XLA and PyTorch sum in a different order, and
every LayerNorm renormalises what drift there is.

On the CPU the encoder's attention (S > GQA_GROUPED_MAX_SQ) takes the
plain version of the FlashAttention kernel; at S <= GQA_GROUPED_MAX_SQ
it takes `attention_ref`, the counterpart of `attention_xla`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggrmcp_tpu import models as jmodels
from ggrmcp_tpu.models import bert as jb
from ggrmcp_tpu.models import common as jcommon
from ggrmcp_tpu_torch import models as tmodels
from ggrmcp_tpu_torch.models import bert as tb
from ggrmcp_tpu_torch.models import common as tcommon
from ggrmcp_tpu_torch.models.convert import params_from_numpy
from ggrmcp_tpu_torch.ops import attention as tatt

ATOL = 1e-5
CPU = torch.device("cpu")
CFG_NAME = "bert-tiny"


@pytest.fixture(scope="module")
def weights():
    jparams = jb.init_params(jax.random.PRNGKey(0), jb.CONFIGS[CFG_NAME])
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)


def _batch(lengths, s, seed=0):
    """Token ids with trailing pads: row i holds lengths[i] real ids."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((len(lengths), s), np.int32)
    mask = np.zeros((len(lengths), s), np.int32)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.integers(1, 30522, n)
        mask[i, :n] = 1
    return tokens, mask


def _both(tokens, mask):
    return (jnp.asarray(tokens), jnp.asarray(mask),
            torch.from_numpy(tokens), torch.from_numpy(mask))


def test_configs_and_registry_match_reference():
    assert set(tb.CONFIGS) == set(jb.CONFIGS)
    for name, cfg in jb.CONFIGS.items():
        assert dataclasses.asdict(tb.CONFIGS[name]) == dataclasses.asdict(cfg)
    ported = [n for n in jmodels.available_models()
              if jmodels.get_model(n)[0] != "moe"]
    assert tmodels.available_models() == ported
    for name in ported:
        family, cfg = tmodels.get_model(name)
        ref_family, ref_cfg = jmodels.get_model(name)
        assert family == ref_family
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    with pytest.raises(ValueError, match="unknown model"):
        tmodels.get_model("no-such-model")


def test_init_params_tree_matches_reference():
    """The port's own init (a torch.Generator) builds the reference's
    tree: same keys, shapes and dtype; the same seed gives the same
    values."""
    cfg = jb.CONFIGS[CFG_NAME]
    shapes = jax.eval_shape(lambda k: jb.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    ours = tb.init_params(tb.CONFIGS[CFG_NAME], CPU, 3)
    flat_ref = jax.tree_util.tree_leaves_with_path(shapes)
    assert len(flat_ref) == len(jax.tree_util.tree_leaves(ours))
    for path, leaf in flat_ref:
        keys = [p.key for p in path]
        t = ours[keys[0]] if len(keys) == 1 else ours[keys[0]][keys[1]]
        assert tuple(t.shape) == leaf.shape, keys
        assert t.dtype == torch.float32 == getattr(torch, str(leaf.dtype))
    again = tb.init_params(tb.CONFIGS[CFG_NAME], CPU, 3)
    assert torch.equal(ours["layers"]["wqkv"], again["layers"]["wqkv"])


def test_params_from_numpy_carries_a_bert_tree(weights):
    jparams, tparams = weights
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        keys = [p.key for p in path]
        t = tparams[keys[0]] if len(keys) == 1 else tparams[keys[0]][keys[1]]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    """float32 to 1e-5; bfloat16 within one bf16 step (2**-7 relative)
    of the output: both normalise in float32 and round to bf16 before
    the affine part, whose rounding the two frameworks place apart."""
    rng = np.random.default_rng(1)
    x = rng.normal(2.0, 3.0, (3, 5, 64)).astype(np.float32)
    w = rng.normal(1.0, 0.1, 64).astype(np.float32)
    b = rng.normal(0.0, 0.1, 64).astype(np.float32)
    ref = jcommon.layer_norm(*(jnp.asarray(a, dtype) for a in (x, w, b)))
    out = tcommon.layer_norm(*(torch.from_numpy(a).to(getattr(torch, dtype))
                               for a in (x, w, b)))
    assert out.dtype == getattr(torch, dtype)
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    else:
        np.testing.assert_allclose(out.float().numpy(), ref, atol=1e-2,
                                   rtol=2 ** -7)


@pytest.mark.parametrize("lengths", [(40, 17, 33, 1, 40), (64, 64), (3, 9)],
                         ids=["ragged", "full", "short"])
def test_encode_matches_reference(weights, lengths):
    jparams, tparams = weights
    cfg_j, cfg_t = jb.CONFIGS[CFG_NAME], tb.CONFIGS[CFG_NAME]
    tokens, mask = _batch(lengths, max(lengths))
    jt, jm, tt, tm = _both(tokens, mask)
    ref = np.asarray(jb.encode(jparams, cfg_j, jt, jm))
    out = tb.encode(tparams, cfg_t, tt, tm)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    # Padding positions are computed too (they attend to the real keys).
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    assert tatt.flash_attention.launches == 0  # CPU: plain versions only


@pytest.mark.parametrize("pooling", ["mean", "cls", "max"])
@pytest.mark.parametrize("pad_to", [48, 128], ids=["pad48", "pad128"])
def test_embed_matches_reference(weights, pooling, pad_to):
    """Trailing pads of several lengths: the same rows padded to 48 and
    to 128 positions give the reference's vectors."""
    jparams, tparams = weights
    tokens, mask = _batch((40, 17, 33, 1, 5, 40), pad_to)
    jt, jm, tt, tm = _both(tokens, mask)
    ref = np.asarray(jb.embed(jparams, jb.CONFIGS[CFG_NAME], jt, jm, pooling))
    out = tb.embed(tparams, tb.CONFIGS[CFG_NAME], tt, tm, pooling)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(out.numpy(), axis=-1), 1.0,
                               atol=1e-6)
    # The mask defaults to tokens != pad.
    default = tb.embed(tparams, tb.CONFIGS[CFG_NAME], tt, pooling=pooling)
    np.testing.assert_allclose(default.numpy(), out.numpy(), atol=0, rtol=0)


@pytest.mark.parametrize("s", [6, 40])
def test_row_without_tokens(weights, s):
    """A row with kv_len 0 exists only as padding (the reference's batch
    bucket; the port's engine never builds one) and is dropped. At S >
    GQA_GROUPED_MAX_SQ the kernel's function writes zeros for it where
    the reference's masked softmax spreads uniform weights, so that row
    differs while every live row still matches; at S <= 8 the port takes
    `attention_ref` and matches the reference on it too. Mean pooling of
    an empty row is the zero vector on both sides."""
    jparams, tparams = weights
    cfg_j, cfg_t = jb.CONFIGS[CFG_NAME], tb.CONFIGS[CFG_NAME]
    tokens, mask = _batch((s, 3, 0), s)
    jt, jm, tt, tm = _both(tokens, mask)
    ref = np.asarray(jb.encode(jparams, cfg_j, jt, jm))
    out = tb.encode(tparams, cfg_t, tt, tm).numpy()
    np.testing.assert_allclose(out[:2], ref[:2], atol=ATOL, rtol=0)
    if s > tatt.GQA_GROUPED_MAX_SQ:
        assert not np.allclose(out[2], ref[2], atol=1e-3)
    else:
        np.testing.assert_allclose(out[2], ref[2], atol=ATOL, rtol=0)
    ref_vec = np.asarray(jb.embed(jparams, cfg_j, jt, jm, "mean"))
    vec = tb.embed(tparams, cfg_t, tt, tm, "mean").numpy()
    np.testing.assert_allclose(vec, ref_vec, atol=ATOL, rtol=0)
    assert not vec[2].any()
