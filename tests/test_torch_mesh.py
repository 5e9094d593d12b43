"""The port's mesh (`ggrmcp_tpu_torch/parallel/mesh.py`) against the JAX
package's `parallel/mesh.py`: axis resolution, spec adaptation with its
downgrade observer, the shape label and the device layout, over a table
of `MeshConfig`s and shapes (the error cases included), each case its
own test. The JAX side runs on the suite's forced 8-device CPU platform
(`jax.devices()[:n]`); the port's device list is the CPU repeated n
times. Also `serving.mesh` through a `--config` file, the axes the
port refuses (data, fsdp above 1) and the ones it serves since
sequence- and pipeline-parallel serving were ported (sequence, stage).
Exact equality throughout."""

import json

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ggrmcp_tpu.core.config import MeshConfig as JMesh
from ggrmcp_tpu.parallel import mesh as jmesh
from ggrmcp_tpu_torch.core.config import (
    MeshConfig,
    ServingConfig,
    load_serving_config,
)
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.parallel import mesh as tmesh
from ggrmcp_tpu_torch.serving.engine import GenerationEngine
from tests import torch_threads  # noqa: F401

CPU = torch.device("cpu")

# (MeshConfig fields, device count): resolvable and not.
RESOLVE = [
    ({}, 1), ({}, 2), ({}, 8), ({"tensor": 1}, 1), ({"tensor": 2}, 2),
    ({"tensor": 2, "data": 0}, 8), ({"tensor": 0, "expert": 2}, 4),
    ({"tensor": 2, "expert": 2}, 4), ({"tensor": 0, "data": 0}, 4),
    ({"tensor": 4, "fsdp": 2}, 8), ({"tensor": 3}, 4), ({"tensor": 2}, 4),
    ({"tensor": 2, "expert": 0, "data": 0}, 8), ({"tensor": 8}, 2),
]


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as exc:
        return ("error", str(exc))


@pytest.mark.parametrize("fields,n", RESOLVE,
                         ids=[f"{f}-{n}" for f, n in RESOLVE])
def test_resolve_axis_sizes_matches_reference(fields, n):
    want = _outcome(lambda: jmesh.resolve_axis_sizes(JMesh(**fields), n))
    got = _outcome(lambda: tmesh.resolve_axis_sizes(MeshConfig(**fields), n))
    assert got == want


def _meshes(fields, n):
    return (jmesh.build_mesh(JMesh(**fields), jax.devices()[:n]),
            tmesh.build_mesh(MeshConfig(**fields), [CPU] * n))


# (spec, shape, MeshConfig fields, n): the observer sees every real
# downgrade, never a drop over a size-1 axis.
SPECS = [
    ((None, "tensor"), (4, 7), {"tensor": 2}, 2),
    (("tensor", None), (512, 256), {"tensor": 2}, 2),
    ((None, None, "tensor"), (4, 256, 512), {"tensor": 8}, 8),
    ((None, ("data", "fsdp"), None, "tensor", None), (4, 2, 64, 4, 32),
     {"tensor": 8}, 8),
    ((None, ("data", "fsdp"), None, "tensor", None), (4, 3, 64, 4, 32),
     {"tensor": 2, "data": 2}, 4),
    ((None, "expert", None, "tensor"), (2, 4, 256, 512),
     {"tensor": 2, "expert": 2}, 4),
    ((None, "expert", "tensor", None), (2, 3, 512, 256),
     {"tensor": 2, "expert": 2}, 4),
    (("tensor",), (7,), {"tensor": 1}, 1),
    ((), (5, 6), {"tensor": 2}, 2),
    ((("tensor", "expert"), None), (12, 3), {"tensor": 2, "expert": 2}, 4),
]


@pytest.mark.parametrize("spec,shape,fields,n", SPECS,
                         ids=[str(i) for i in range(len(SPECS))])
def test_compatible_spec_and_observer_match_reference(spec, shape, fields,
                                                      n):
    jm, tm = _meshes(fields, n)
    jseen, tseen = [], []
    want = jmesh.compatible_spec(P(*spec), shape, jm,
                                 on_downgrade=lambda *a: jseen.append(a))
    got = tmesh.compatible_spec(spec, shape, tm,
                                on_downgrade=lambda *a: tseen.append(a))
    assert got == tuple(want) and len(got) == len(shape)
    assert tseen == jseen


SHAPES = [({"tensor": 1}, 1), ({"tensor": 2}, 2), ({"tensor": 8}, 8),
          ({"tensor": 2, "expert": 2}, 4), ({"tensor": 2, "data": 0}, 8),
          ({"tensor": 0, "expert": 2}, 8)]


@pytest.mark.parametrize("fields,n", SHAPES,
                         ids=[f"{f}-{n}" for f, n in SHAPES])
def test_mesh_shape_and_layout_match_reference(fields, n):
    """The label, the axis sizes, and which device each coordinate of the
    reference's device array holds: the port's flat coordinate order is
    the reference's row-major order over the same axes."""
    jm, tm = _meshes(fields, n)
    assert tmesh.mesh_shape_str(tm) == jmesh.mesh_shape_str(jm)
    assert tm.shape == dict(zip(jm.axis_names, jm.devices.shape))
    for axis in tmesh.AXES:
        assert tmesh.axis_size(tm, axis) == jmesh.axis_size(jm, axis)
    ids = [d.id for d in jm.devices.flat]
    for i in range(tm.size):
        coord = tm.coord(i)
        assert tm.index(**coord) == i
        assert jm.devices[tuple(coord[a] for a in tmesh.AXES)].id == ids[i]


def test_default_devices_on_the_cpu_infer_to_one():
    assert tmesh.default_devices(MeshConfig(), CPU) == [CPU]
    assert tmesh.default_devices(MeshConfig(tensor=2, expert=2), CPU) == (
        [CPU] * 4)
    mesh = tmesh.build_mesh(MeshConfig(),
                            tmesh.default_devices(MeshConfig(), CPU))
    assert tmesh.mesh_shape_str(mesh) == "single" and mesh.size == 1


def test_default_devices_on_cuda_stay_on_the_named_card(monkeypatch):
    """On a machine with two cards the default config serves on the one
    card asked for (tensor resolves to 1); only a config that asks for a
    mesh takes every card, and not when the caller named one."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert tmesh.default_devices(MeshConfig(), c1, named=True) == [c1]
    assert tmesh.default_devices(None, c0) == [c0]
    assert tmesh.default_devices(MeshConfig(tensor=2), c0) == [c0, c1]
    with pytest.raises(ValueError, match="names one card"):
        tmesh.default_devices(MeshConfig(tensor=2), c1, named=True)
    for device, want in (("cuda:1", (c1,)), (None, (c0,)), ("cuda", (c0,))):
        mesh = tmesh.serving_mesh(MeshConfig(), device)
        assert mesh.devices == want and tmesh.mesh_shape_str(mesh) == "single"
    mesh = tmesh.serving_mesh(MeshConfig(tensor=2))
    assert mesh.devices == (c0, c1) and tmesh.mesh_shape_str(mesh) == "tensor=2"
    with pytest.raises(ValueError, match="names one card"):
        tmesh.serving_mesh(MeshConfig(tensor=2), "cuda:1")


def test_mesh_from_a_config_file(tmp_path):
    path = tmp_path / "mesh.json"
    path.write_text(json.dumps(
        {"serving": {"mesh": {"tensor": 2, "expert": 1,
                              "allow_cpu_fallback": False}}}))
    cfg = load_serving_config(str(path))
    assert cfg.mesh == MeshConfig(tensor=2, allow_cpu_fallback=False)
    path.write_text(json.dumps({"serving": {"mesh": {"tensors": 2}}}))
    with pytest.raises(ValueError, match="serving.mesh: unknown keys"):
        load_serving_config(str(path))
    # The reference's defaults.
    assert MeshConfig() == MeshConfig(**{
        k: getattr(JMesh(), k) for k in MeshConfig.__dataclass_fields__})


# The ids keep the ROADMAP item that once refused each axis.
@pytest.mark.parametrize("axis", ["data", "fsdp"],
                         ids=["data-A18b", "fsdp-A18b"])
def test_unported_axes_are_refused(axis):
    """The data axes, once refused, are served: accepted in a config,
    inferred from the devices (0) as the reference's
    `resolve_axis_sizes` does, and the batch split over them."""
    assert ServingConfig(mesh=MeshConfig(tensor=1, **{axis: 2})).mesh
    mesh = tmesh.build_mesh(MeshConfig(tensor=2, **{axis: 0}), [CPU] * 4)
    engine = GenerationEngine(tl.CONFIGS["tiny-llama"], mesh=mesh)
    assert engine.mesh_stats()["mesh_shape"] == f"{axis}=2,tensor=2"
    assert tmesh.data_size(mesh) == 2
    assert engine.make_cache(4, 16).k.factors[1] == 2


@pytest.mark.parametrize("axis", ["sequence", "stage"])
def test_sequence_and_stage_axes_are_served(axis):
    assert ServingConfig(mesh=MeshConfig(tensor=1, **{axis: 2})).mesh
    mesh = tmesh.build_mesh(MeshConfig(tensor=2, **{axis: 0}), [CPU] * 4)
    engine = GenerationEngine(tl.CONFIGS["tiny-llama"], mesh=mesh)
    assert engine.mesh_stats()["mesh_shape"] == f"tensor=2,{axis}=2"
    assert (engine.pp_serving, bool(engine.sp_prefill)) == (
        (True, False) if axis == "stage" else (False, True))


def test_negative_axis_refused():
    with pytest.raises(ValueError, match="serving.mesh.tensor must be >= 0"):
        MeshConfig(tensor=-1)
