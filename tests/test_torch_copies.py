"""The port's copies of the JAX package's jax-free modules:
`utils/failpoints.py`, `serving/flight_recorder.py`, `serving/slo.py`,
`serving/scheduler.py`, `serving/host_pool.py`,
`serving/spec_batcher.py` and `serving/tiered.py`, and the host half of
`serving/adapter_arena.py`. Each equals the reference's text except for
the lines listed here (imports, the logger's name, and comments that
cite the reference project's issue and PR numbers), and the reference's
own unit cases for each pass against the port's module: each case's
code runs with the names it takes from the JAX package bound to the
port's objects of the same name.
"""

import difflib
import importlib
import inspect
import os
import re
import types

import pytest

import tests.test_chaos as t_chaos
import tests.test_host_pool as t_host
import tests.test_lora_arena as t_arena
import tests.test_observability as t_obs
import tests.test_scheduler as t_sched
import tests.test_slo_accounting as t_slo
from ggrmcp_tpu.serving import adapter_arena as j_arena
from ggrmcp_tpu_torch.models import llama as tl
from ggrmcp_tpu_torch.serving import adapter_arena as t_arena_mod
from tests import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Module -> the import and logger lines allowed to differ: (reference
# line, port line).
ALLOWED = {
    "utils/failpoints.py": [(
        'logger = logging.getLogger("ggrmcp.utils.failpoints")',
        'logger = logging.getLogger("ggrmcp.torch.failpoints")',
    )],
    "serving/flight_recorder.py": [(
        "from ggrmcp_tpu.core.config import ObservabilityConfig",
        "from ggrmcp_tpu_torch.core.config import ObservabilityConfig",
    )],
    "serving/slo.py": [
        ("from ggrmcp_tpu.core.config import (",
         "from ggrmcp_tpu_torch.core.config import ("),
        ("from ggrmcp_tpu.serving.flight_recorder import LatencyHistogram",
         "from ggrmcp_tpu_torch.serving.flight_recorder import "
         "LatencyHistogram"),
    ],
    "serving/scheduler.py": [],
    "serving/host_pool.py": [(
        'logger = logging.getLogger("ggrmcp.serving.host_pool")',
        'logger = logging.getLogger("ggrmcp.torch.host_pool")',
    )],
    "serving/spec_batcher.py": [
        ("from ggrmcp_tpu.core.config import BatchingConfig",
         "from ggrmcp_tpu_torch.core.config import BatchingConfig"),
        ("from ggrmcp_tpu.serving.flight_recorder import FlightRecorder",
         "from ggrmcp_tpu_torch.serving.flight_recorder import "
         "FlightRecorder"),
        ('logger = logging.getLogger("ggrmcp.serving.spec_batcher")',
         'logger = logging.getLogger("ggrmcp.torch.spec_batcher")'),
    ],
    "serving/tiered.py": [
        ("from ggrmcp_tpu.core.config import BatchingConfig",
         "from ggrmcp_tpu_torch.core.config import BatchingConfig"),
        ("from ggrmcp_tpu.ops.sampling import SamplingConfig",
         "from ggrmcp_tpu_torch.ops.sampling import SamplingConfig"),
        ("from ggrmcp_tpu.serving.batching import ContinuousBatcher, "
         "OverloadedError",
         "from ggrmcp_tpu_torch.serving.batching import ContinuousBatcher, "
         "OverloadedError"),
        ('logger = logging.getLogger("ggrmcp.serving.tiered")',
         'logger = logging.getLogger("ggrmcp.torch.tiered")'),
        ("        from ggrmcp_tpu.serving.flight_recorder import "
         "FlightRecorder",
         "        from ggrmcp_tpu_torch.serving.flight_recorder import "
         "FlightRecorder"),
        ("        from ggrmcp_tpu.serving.slo import SloAccount, TenantTable",
         "        from ggrmcp_tpu_torch.serving.slo import SloAccount, "
         "TenantTable"),
    ],
}
# Module -> the port's comment lines that drop the reference's citation
# of its own issue or PR number (the rest of the line may be reworded).
SCRUBBED = {
    "serving/flight_recorder.py": [
        "The postmortem layer (SURVEY.md §5.1): the batcher's existing",
    ],
    "serving/slo.py": [
        "  the three partition total_requests EXACTLY per class — the same",
        "        # storage and no computation anywhere (the recorder's "
        "contract).",
    ],
    "serving/host_pool.py": [
        "— the thrash cliff the page arena flipped at 3x the working set "
        "comes back at",
    ],
}
CITATION = re.compile(r"\b(?:ISSUE|PR) \d")


@pytest.mark.parametrize("path", sorted(ALLOWED))
def test_copy_equals_reference_text(path):
    def lines(pkg):
        with open(os.path.join(REPO, pkg, path), encoding="utf-8") as fh:
            return fh.read().splitlines()

    ref, port = lines("ggrmcp_tpu"), lines("ggrmcp_tpu_torch")
    changed, scrubbed = [], []
    for op, i1, i2, j1, j2 in difflib.SequenceMatcher(
            None, ref, port, autojunk=False).get_opcodes():
        if op == "equal":
            continue
        assert op == "replace" and i2 - i1 == j2 - j1, (op, ref[i1:i2],
                                                        port[j1:j2])
        for old, new in zip(ref[i1:i2], port[j1:j2]):
            if CITATION.search(old):
                assert not CITATION.search(new), new
                scrubbed.append(new)
            else:
                changed.append((old, new))
    assert changed == ALLOWED[path]
    assert scrubbed == SCRUBBED.get(path, [])


def _port_twin(obj):
    """The port's object of the same name as a JAX-package class,
    function or module, or None."""
    if isinstance(obj, types.ModuleType):
        mod, name = obj.__name__, None
    else:
        mod = getattr(obj, "__module__", None)
        name = getattr(obj, "__name__", None)
        if not isinstance(mod, str) or not isinstance(name, str):
            return None
    if not mod.startswith("ggrmcp_tpu."):
        return None
    try:
        port = importlib.import_module(
            "ggrmcp_tpu_torch." + mod[len("ggrmcp_tpu."):])
    except ImportError:
        return None
    return port if name is None else getattr(port, name, None)


def _rebind(fn, env):
    return types.FunctionType(fn.__code__, env, fn.__name__, fn.__defaults__,
                              fn.__closure__)


def _port_env(module) -> dict:
    """The test module's globals with each JAX-package name bound to the
    port's twin, and its helper functions rebound to those globals."""
    env = dict(vars(module))
    for key, value in vars(module).items():
        twin = _port_twin(value)
        if twin is not None:
            env[key] = twin
    env.update(EXTRA.get(module, {}))
    for key, value in vars(module).items():
        if isinstance(value, types.FunctionType) and (
                value.__globals__ is vars(module)):
            env[key] = _rebind(value, env)
    return env


# (module, class, names whose port twin must be bound): every method of
# the class that takes no fixture is a case.
CLASSES = [
    (t_chaos, "TestFailpointRegistry", ("FailpointRegistry", "parse_spec",
                                        "FailpointError")),
    (t_obs, "TestLatencyHistogram", ("LatencyHistogram", "FlightRecorder",
                                     "ObservabilityConfig")),
    (t_slo, "TestSloClassification", ("SloAccount", "SloConfig")),
    (t_slo, "TestBurnRate", ("SloAccount", "SloConfig")),
    (t_slo, "TestTenantTable", ("TenantTable", "SloConfig")),
    (t_sched, "TestSchedulerQueue", ("SchedulerQueue", "SchedulerConfig")),
    (t_sched, "TestSchedulerPolicy", ("Scheduler", "SchedulerConfig",
                                      "SloAccount", "TenantTable")),
    (t_host, "TestPageCodec", ("tensors",)),
    (t_host, "TestHostPagePool", ("HostPagePool", "tensors")),
    (t_host, "TestAllocatorTwoTier", ("PageAllocator", "HostPagePool")),
    (t_host, "TestReclaimVictimSelection", ("PageAllocator",)),
    (t_arena, "TestArenaUnits", ("AdapterArena", "AdapterExhaustedError",
                                 "AdapterLoadError", "UnknownAdapterError")),
]
# Module-level objects that are no class, function or module: the
# reference model config the arena units build on becomes the port's.
EXTRA = {t_arena: {"CFG": tl.CONFIGS["tiny-llama"]}}
# The fixtures a reference unit case may take.
FIXTURES = ("self", "tmp_path", "registry")
# The reference's check of its own Config.validate, held for the port by
# tests/test_torch_serving.py::test_unsupported_config_raises.
SKIP = {("TestFailpointRegistry", "test_config_validates_failpoint_spec")}


def _cases():
    out = []
    for module, cls_name, _ in CLASSES:
        cls = getattr(module, cls_name)
        for name, fn in vars(cls).items():
            if not name.startswith("test_") or (cls_name, name) in SKIP:
                continue
            params = list(inspect.signature(fn).parameters)
            assert set(params) <= set(FIXTURES), (
                f"{cls_name}.{name} takes a fixture")
            out.append(pytest.param(cls_name, name,
                                    id=f"{cls_name}.{name}"))
    return out


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    """The reference arena units' registry of three adapters."""
    path = str(tmp_path_factory.mktemp("lora-registry"))
    for i, name in enumerate(("a0", "a1", "a2")):
        t_arena.save_adapter(path, name, seed=10 + i)
    return path


@pytest.mark.parametrize("cls_name,method", _cases())
async def test_reference_unit_case_on_port(cls_name, method, tmp_path,
                                           registry):
    module, _, bound = next(c for c in CLASSES if c[1] == cls_name)
    env = _port_env(module)
    for name in bound:
        twin = env[name]
        where = (twin.__name__ if isinstance(twin, types.ModuleType)
                 else twin.__module__)
        assert where.startswith("ggrmcp_tpu_torch."), name
    cls = getattr(module, cls_name)
    port_cls = type(cls_name, (), {
        k: _rebind(v, env) if isinstance(v, types.FunctionType) else v
        for k, v in vars(cls).items() if k not in ("__dict__", "__weakref__")
    })
    fn = getattr(port_cls(), method)
    given = {"tmp_path": tmp_path, "registry": registry}
    result = fn(**{name: given[name]
                   for name in inspect.signature(fn).parameters})
    if inspect.isawaitable(result):
        await result


# The adapter arena's host half: each of these equals the reference's
# source except for the listed port lines, which drop a docstring's
# hyphenated cross-reference tag (an upper-case word and a number) of
# the reference's own history.
ARENA_HOST_HALF = (
    "AdapterExhaustedError", "UnknownAdapterError", "AdapterLoadError",
    "AdapterLease", "AdapterArena.register_ledger",
    "AdapterArena.attach_commit", "AdapterArena._check_name",
    "AdapterArena.registered", "AdapterArena.resident",
    "AdapterArena.acquire", "AdapterArena._take_row_locked",
    "AdapterArena.release", "AdapterArena.stats",
    "AdapterArena.check_invariants",
)
ARENA_SCRUBBED = {
    "AdapterExhaustedError": [
        "    overload ladder) — and resident rows are untouched.\"\"\"",
    ],
}


@pytest.mark.parametrize("name", ARENA_HOST_HALF)
def test_adapter_arena_host_half_equals_reference(name):
    def source(module):
        obj = module
        for part in name.split("."):
            obj = getattr(obj, part)
        return inspect.getsource(obj).splitlines()

    ref, port = source(j_arena), source(t_arena_mod)
    assert len(ref) == len(port)
    scrubbed = []
    tag = re.compile(r"\b[A-Z]+-\d+ ")
    for op, i1, i2, j1, j2 in difflib.SequenceMatcher(
            None, ref, port, autojunk=False).get_opcodes():
        for old, new in zip(ref[i1:i2], port[j1:j2]):
            if op != "equal":
                assert tag.sub("", old, count=1) == new, (old, new)
                scrubbed.append(new)
    assert scrubbed == ARENA_SCRUBBED.get(name, [])
