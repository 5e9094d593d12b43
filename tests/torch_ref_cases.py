"""The reference's own test modules, run against the port's copies.

`port_module("test_headers")` reads `tests/test_headers.py`, points each
import of a module of `ggrmcp_tpu` that the port holds a copy of (the
names in `PORTED`) at `ggrmcp_tpu_torch`, and runs the result as a new
module; `collect(module, globals())` then hands its test classes, test
functions and fixtures to the calling test file, so pytest collects the
reference's cases there, unchanged but for the package they import.
Imports of modules the port has no copy of (the JAX model plane, the
test protos `hello_pb2` / `complex_pb2`, the reference's sidecar) stay
the reference's: those are the cases' backends and fixtures, not the
code under test. A reference test module that imports another one
(`test_fastlane` takes `test_gateway_http`'s helpers) gets that one's
port version.
"""

import importlib.util
import os
import re
import sys
import types

TESTS = os.path.dirname(os.path.abspath(__file__))

# The modules of ggrmcp_tpu that the port holds as copies of the
# reference's text (their gateway-plane halves for config and fleet).
PORTED = (
    "core.config", "core.types", "core.headers", "core.sessions",
    "mcp.types", "mcp.validation", "mcp", "schema.builder",
    "rpc.connection", "rpc.descriptors", "rpc.reflection_client",
    "rpc.discovery", "rpc.router",
    "rpc.pb.serving_pb2", "rpc.pb.health_pb2", "rpc.pb.reflection_pb2",
    "serving.timeline", "serving.fleet", "gateway.metrics",
    "gateway.middleware", "gateway.handler", "gateway.fastlane",
    "gateway.app", "gateway", "utils.tracing", "utils.jsonlog",
    "utils.aio_compat", "utils.failpoints",
)


def _swap(src: str, ported: tuple) -> str:
    names = "|".join(re.escape(n) for n in sorted(ported, key=len,
                                                  reverse=True))
    # `from ggrmcp_tpu.X import ...` and `from ggrmcp_tpu.A import B`
    # where A.B is ported (`from ggrmcp_tpu.core import config`).
    src = re.sub(rf"(^\s*from )ggrmcp_tpu\.(({names})\b)", r"\1ggrmcp_tpu_torch.\2",
                 src, flags=re.M)

    def pkg_import(m):
        # Split `from ggrmcp_tpu.P import a, b` by which names are ported.
        pkg, names = m.group(2), [n.strip() for n in m.group(3).split(",")]
        lines = []
        for torch_side in (False, True):
            take = [n for n in names if (
                f"{pkg}.{n.split(' as ')[0]}" in ported) == torch_side]
            if take:
                root = "ggrmcp_tpu_torch" if torch_side else "ggrmcp_tpu"
                lines.append(f"{m.group(1)}{root}.{pkg} import "
                             f"{', '.join(take)}")
        indent = m.group(1)[:-len("from ")]
        return ("\n" + indent).join(lines)

    return re.sub(r"(^\s*from )ggrmcp_tpu\.([a-z_]+) import ([^\n(]+)$",
                  pkg_import, src, flags=re.M)


def port_module(name: str, ported: tuple = PORTED,
                redirect: dict = None) -> types.ModuleType:
    """`tests/<name>.py` with its imports of `ported` modules pointed at
    the port, as module `tests.torch_port_<name>` (built once). Its
    imports of the test modules named in `redirect` import the given
    modules instead; those of other reference test modules import their
    port versions."""
    modname = f"tests.torch_port_{name}"
    if modname in sys.modules:
        return sys.modules[modname]
    path = os.path.join(TESTS, f"{name}.py")
    with open(path, encoding="utf-8") as fh:
        src = _swap(fh.read(), ported)
    redirect = redirect or {}
    for other in set(re.findall(
            r"^\s*(?:from|import) tests\.(test_\w+)\b", src, re.M)):
        target = redirect.get(other)
        if target is None:
            if other != name:
                port_module(other, ported, redirect)
            target = f"torch_port_{other}"
        src = re.sub(rf"^(\s*(?:from|import) )tests\.{other}\b",
                     rf"\1tests.{target}", src, flags=re.M)
    spec = importlib.util.spec_from_loader(modname, loader=None)
    module = importlib.util.module_from_spec(spec)
    module.__file__ = path
    sys.modules[modname] = module
    exec(compile(src, path, "exec"), module.__dict__)
    return module


def collect(module: types.ModuleType, into: dict,
            skip: tuple = ()) -> None:
    """Put `module`'s test classes, test functions and fixtures into the
    namespace `into` (a test file's globals), but the names in `skip`."""
    for key, value in vars(module).items():
        if key in skip:
            continue
        fixture = hasattr(value, "_fixture_function_marker") or (
            type(value).__name__ == "FixtureFunctionDefinition")
        if key.startswith(("test_", "Test")) or fixture:
            assert key not in into, f"{module.__name__}.{key} shadows a name"
            into[key] = value
