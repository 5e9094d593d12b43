"""The sharded HF loader and int8 on a mesh, bit for bit: every shard of
`load_hf_checkpoint_sharded` equals the split of `load_hf_checkpoint`'s
whole tree by the specs (head-aligned wqkv included), on
`scripts/make_tiny_hf_checkpoint.py`'s checkpoint and on float32, bf16,
tied and index-sharded checkpoints; the int8 shards equal the split of
the whole tree's quantization (values and scales; a row-parallel
weight's scale is formed from every shard's rows). Also the windowed
reader against whole reads, the sidecar serving a checkpoint on a mesh,
and the load's refusals."""

import importlib.util
import json
import os

import pytest
import torch

transformers = pytest.importorskip("transformers")
st = pytest.importorskip("safetensors.torch")

from ggrmcp_tpu_torch.core.config import (  # noqa: E402
    BatchingConfig,
    MeshConfig,
    ServingConfig,
)
from ggrmcp_tpu_torch.models import llama as tl  # noqa: E402
from ggrmcp_tpu_torch.ops import quant  # noqa: E402
from ggrmcp_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from ggrmcp_tpu_torch.parallel.collectives import (  # noqa: E402
    Sharded,
    shard,
    unshard,
)
from ggrmcp_tpu_torch.serving import safetensors_io  # noqa: E402
from ggrmcp_tpu_torch.serving import weights as tw  # noqa: E402
from ggrmcp_tpu_torch.serving.engine import GenerationEngine  # noqa: E402
from ggrmcp_tpu_torch.serving.sidecar import Sidecar  # noqa: E402
from tests import torch_threads  # noqa: F401, E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _hf(path, dtype=torch.float32, tied=False, heads=4, kv=2):
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=heads,
        num_key_value_heads=kv, max_position_embeddings=256,
        tie_word_embeddings=tied,
    )
    torch.manual_seed(1)
    transformers.LlamaForCausalLM(cfg).to(dtype).save_pretrained(
        path, safe_serialization=True)
    return str(path)


def _split_files(path):
    """The one file as two, listed by an index."""
    single = os.path.join(path, "model.safetensors")
    tensors = st.load_file(single)
    names = sorted(tensors)
    weight_map = {}
    for i, part in enumerate((names[::2], names[1::2])):
        fname = f"model-0000{i + 1}-of-00002.safetensors"
        st.save_file({n: tensors[n] for n in part}, os.path.join(path, fname))
        weight_map.update({n: fname for n in part})
    os.remove(single)
    with open(os.path.join(path, safetensors_io.INDEX), "w") as fh:
        json.dump({"weight_map": weight_map}, fh)
    return path


def _tiny(path):
    spec = importlib.util.spec_from_file_location(
        "make_tiny_hf_checkpoint",
        os.path.join(REPO, "scripts", "make_tiny_hf_checkpoint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build(str(path))
    return str(path)


CHECKPOINTS = {
    "tiny_script": _tiny,
    "f32": _hf,
    "bf16": lambda p: _hf(p, torch.bfloat16),
    "tied": lambda p: _hf(p, tied=True),
    "index": lambda p: _split_files(_hf(p, torch.bfloat16)),
}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp-hf")
    return {name: make(root / name) for name, make in CHECKPOINTS.items()}


def _mesh(tensor):
    return tmesh.build_mesh(MeshConfig(tensor=tensor), [CPU] * tensor)


def _split(cfg, tree, mesh):
    """The whole tree split by the specs, as the engine splits it (the
    leaves of a block `whole_blocks` names replicated over tensor)."""
    whole = tl.whole_leaves(cfg, mesh.shape["tensor"])
    out = {"layers": {}}
    for key, spec in tl.param_specs(cfg).items():
        group = spec if isinstance(spec, dict) else {key: spec}
        for name, sp in group.items():
            leaf = tree["layers"][name] if isinstance(spec, dict) else (
                tree[name])
            fn = None
            if name == "wqkv":
                def fn(dim, block, n):
                    return tl.qkv_columns(cfg, n, block) if dim == 2 else None
            sh = shard(leaf, tl.placed_spec(sp, leaf.shape, mesh,
                                            name in whole), mesh, fn)
            (out["layers"] if isinstance(spec, dict) else out)[name] = sh
    return out


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}.")
        else:
            yield prefix + key, value


def _parts(leaf):
    if isinstance(leaf, quant.QuantizedTensor):
        return list(zip(leaf.q.parts, leaf.scale.parts))
    return list(leaf.parts)


def _equal(a, b):
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b) and a.dtype == b.dtype


@pytest.mark.parametrize("tensor", [2, 3, 4])
@pytest.mark.parametrize("name", sorted(CHECKPOINTS))
def test_sharded_load_equals_the_split_of_the_whole_load(checkpoints, name,
                                                         tensor):
    path = checkpoints[name]
    cfg, whole = tw.load_hf_checkpoint(path, CPU)
    # At 4 the 2 KV heads load replicated; at 3 no split dim divides and
    # every leaf loads whole onto each shard.
    mesh = _mesh(tensor)
    cfg2, params = tw.load_hf_checkpoint_sharded(path, mesh)
    assert cfg2 == cfg
    want = dict(_leaves(_split(cfg, whole, mesh)))
    got = dict(_leaves(params))
    assert set(got) == set(want)
    for key in want:
        assert isinstance(got[key], Sharded), key
        assert got[key].factors == want[key].factors, key
        for a, b in zip(_parts(got[key]), _parts(want[key])):
            assert _equal(a, b), key
    stats = tw.last_load_stats
    assert stats["weight_load_sharded"] and stats["weight_load_bytes_read"]
    assert stats["weight_load_peak_host_rss_mb"] >= stats[
        "weight_load_rss_before_mb"]


@pytest.mark.parametrize("name", ["tiny_script", "bf16"])
def test_int8_shards_equal_the_split_of_the_whole_quantization(checkpoints,
                                                               name):
    """Loaded sharded, then quantized by the engine on its shards: every
    shard's int8 values and scales equal the whole quantization's
    split, the row-parallel leaves' (wo, w_down) scales included."""
    _check_int8(checkpoints[name], 2)


def test_int8_whole_blocks_equal_the_whole_quantization(checkpoints):
    """At tensor=3 no split dim of the tiny checkpoint divides: every
    leaf is loaded whole onto each shard and quantized there, to the
    whole quantization's bits."""
    _check_int8(checkpoints["tiny_script"], 3)


def _check_int8(path, tensor):
    cfg, whole = tw.load_hf_checkpoint(path, CPU)
    mesh = _mesh(tensor)
    placed = tl.whole_leaves(cfg, tensor)
    qwhole = quant.quantize_model(whole)
    _, params = tw.load_hf_checkpoint_sharded(path, mesh)
    eng = GenerationEngine(cfg, ServingConfig(quantize="int8"), params=params,
                           mesh=mesh)
    for key, leaf in _leaves(eng.params):
        ref = qwhole
        for part in key.split("."):
            ref = ref[part]
        if not isinstance(ref, quant.QuantizedTensor):
            continue
        assert isinstance(leaf, quant.QuantizedTensor), key
        spec = tl.param_specs(cfg)
        for part in key.split("."):
            spec = spec[part]
        fn = None
        if key.endswith("wqkv"):
            def fn(dim, block, n):
                return tl.qkv_columns(cfg, n, block) if dim == 2 else None
        name = key.split(".")[-1]
        for field in ("q", "scale"):
            t = getattr(ref, field)
            sh = shard(t, tl.placed_spec(spec, t.shape, mesh,
                                         name in placed), mesh, fn)
            for a, b in zip(getattr(leaf, field).parts, sh.parts):
                assert _equal(a, b), (key, field)
        # The shards put back together give the whole quantization.
        if not key.endswith("wqkv"):
            assert torch.equal(unshard(
                leaf.q, tl.placed_spec(spec, ref.q.shape, mesh,
                                       name in placed)), ref.q)


def test_window_reads_equal_whole_reads(checkpoints):
    with safetensors_io.Checkpoint(checkpoints["index"]) as ckpt:
        for name in sorted(ckpt.names):
            whole = ckpt.read(name, CPU)
            if whole.dim() != 2:
                out = torch.empty((1,) + tuple(whole.shape), dtype=whole.dtype)
                ckpt.read_window(name, slice(None), slice(None), out)
                assert torch.equal(out[0], whole)
                continue
            r, c = whole.shape
            for rows, cols in ((slice(0, r), slice(0, c)),
                               (slice(r // 4, r // 2), slice(0, c)),
                               (slice(0, r), slice(c // 2, c)),
                               (slice(1, r - 1), slice(3, c - 5))):
                out = torch.empty(
                    (rows.stop - rows.start, cols.stop - cols.start),
                    dtype=torch.float32)
                ckpt.read_window(name, rows, cols, out)
                assert torch.equal(out, whole[rows, cols].float()), name


def test_sharded_load_refuses_what_it_cannot_split(checkpoints, tmp_path):
    """Once refused, what the mesh cannot split loads whole: 4 query heads
    at tensor=8 hold attention whole (no dim to count: the reference
    splits wqkv's 128 columns); a 129-row vocabulary at tensor=2 loads
    embed and lm_head whole onto each shard, counted at both leaves, the
    layers split. Every part equals the whole load's."""
    seen = []
    cfg, params = tw.load_hf_checkpoint_sharded(
        checkpoints["f32"], _mesh(8), on_downgrade=lambda *a: seen.append(a))
    assert seen == []
    assert params["layers"]["wqkv"].factors[-1] == 1
    assert params["layers"]["w_down"].factors[-2] == 8
    path = _hf(tmp_path / "odd")
    # A vocabulary that tensor=2 cannot split: 129 rows.
    tensors = st.load_file(os.path.join(path, "model.safetensors"))
    for key in ("model.embed_tokens.weight", "lm_head.weight"):
        tensors[key] = torch.cat([tensors[key], tensors[key][:1]])
    st.save_file(tensors, os.path.join(path, "model.safetensors"),
                 metadata={"format": "pt"})
    with open(os.path.join(path, "config.json")) as fh:
        hf = json.load(fh)
    hf["vocab_size"] = 129
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(hf, fh)
    cfg, params = tw.load_hf_checkpoint_sharded(
        path, _mesh(2), on_downgrade=lambda *a: seen.append(a))
    assert seen == [("['embed']", 0, "tensor", 129, 2),
                    ("['lm_head']", 1, "tensor", 129, 2)]
    _, whole = tw.load_hf_checkpoint(path, CPU)
    for key, leaf in _leaves(params):
        ref = whole
        for part in key.split("."):
            ref = ref[part]
        if key in ("embed", "lm_head"):
            assert leaf.factors == (1, 1)
            assert all(torch.equal(p, ref) for p in leaf.parts), key
    assert params["layers"]["w_gate"].factors[-1] == 2


async def test_sidecar_serves_a_checkpoint_on_the_mesh(checkpoints):
    """The sidecar builds the mesh, loads the checkpoint sharded and
    serves the same greedy tokens as on one device."""
    outs = []
    for tensor in (1, 2):
        side = Sidecar(ServingConfig(
            hf_checkpoint_path=checkpoints["tiny_script"],
            mesh=MeshConfig(tensor=tensor),
            batching=BatchingConfig(max_batch_size=2, kv_cache_max_seq=128)),
            device="cpu")
        assert side.generation.mesh_stats()["tp_chips"] == tensor
        outs.append(side.generation.generate([[1, 5, 9, 40]], 8))
    assert outs[0] == outs[1]
