"""Descriptor registry construction, comment extraction, and the
FileDescriptorSet loader.

Capability parity with the reference loader (pkg/descriptors/loader.go):
load `.binpb` produced by `protoc --descriptor_set_out
--include_source_info`, register files dependency-ordered into a
registry (with default-pool fallback for well-known types), extract
per-method MethodInfo WITH doc comments from SourceCodeInfo, and apply
the service-name compatibility trim (keep the last two dotted segments)
so FDS names match reflection names (loader.go:221-235).

Comments are indexed by symbol full name, so the same index serves both
the tool builder's descriptions and the schema engine's field docs.
"""

from __future__ import annotations

import logging
from typing import Iterable, Optional

from google.protobuf import descriptor as _d
from google.protobuf import descriptor_pb2, descriptor_pool

from ggrmcp_tpu_torch.core.types import MethodInfo, SourceLocation

logger = logging.getLogger("ggrmcp.rpc.descriptors")


# ---------------------------------------------------------------------------
# Comment index: FileDescriptorProto.source_code_info → {symbol: comment}
# ---------------------------------------------------------------------------

# FileDescriptorProto field numbers used in SourceCodeInfo paths.
_F_MESSAGE = 4
_F_ENUM = 5
_F_SERVICE = 6
# DescriptorProto
_M_FIELD = 2
_M_NESTED = 3
_M_ENUM = 4
# ServiceDescriptorProto
_S_METHOD = 2
# EnumDescriptorProto
_E_VALUE = 2


class CommentIndex:
    """Maps protobuf symbol full names to their doc comments."""

    def __init__(self) -> None:
        self._comments: dict[str, str] = {}

    def add_file(self, fdp: descriptor_pb2.FileDescriptorProto) -> None:
        if not fdp.HasField("source_code_info"):
            return
        paths = self._symbol_paths(fdp)
        for location in fdp.source_code_info.location:
            symbol = paths.get(tuple(location.path))
            if symbol is None:
                continue
            comment = _clean_comment(
                location.leading_comments, location.trailing_comments
            )
            if comment:
                self._comments[symbol] = comment

    def get(self, full_name: str) -> str:
        return self._comments.get(full_name, "")

    def __len__(self) -> int:
        return len(self._comments)

    def comment_fn(self, desc) -> str:
        """Adapter usable as SchemaBuilder's comment provider: accepts
        message/field/enum/enum-value descriptor objects."""
        return self.get(symbol_key(desc))

    # -- path table construction -------------------------------------------

    def _symbol_paths(
        self, fdp: descriptor_pb2.FileDescriptorProto
    ) -> dict[tuple[int, ...], str]:
        prefix = fdp.package + "." if fdp.package else ""
        paths: dict[tuple[int, ...], str] = {}

        def walk_message(msg, path, scope):
            fqn = scope + msg.name
            paths[path] = fqn
            for i, field in enumerate(msg.field):
                paths[path + (_M_FIELD, i)] = f"{fqn}.{field.name}"
            for i, nested in enumerate(msg.nested_type):
                walk_message(nested, path + (_M_NESTED, i), fqn + ".")
            for i, enum in enumerate(msg.enum_type):
                walk_enum(enum, path + (_M_ENUM, i), fqn + ".")

        def walk_enum(enum, path, scope):
            fqn = scope + enum.name
            paths[path] = fqn
            for i, value in enumerate(enum.value):
                paths[path + (_E_VALUE, i)] = f"{fqn}.{value.name}"

        for i, msg in enumerate(fdp.message_type):
            walk_message(msg, (_F_MESSAGE, i), prefix)
        for i, enum in enumerate(fdp.enum_type):
            walk_enum(enum, (_F_ENUM, i), prefix)
        for i, svc in enumerate(fdp.service):
            svc_fqn = prefix + svc.name
            paths[(_F_SERVICE, i)] = svc_fqn
            for j, method in enumerate(svc.method):
                paths[(_F_SERVICE, i, _S_METHOD, j)] = f"{svc_fqn}.{method.name}"
        return paths


def symbol_key(desc) -> str:
    """Full-name key for any descriptor object the schema builder sees."""
    if isinstance(desc, _d.EnumValueDescriptor):
        return f"{desc.type.full_name}.{desc.name}"
    full_name = getattr(desc, "full_name", None)
    return full_name or ""


def _clean_comment(leading: str, trailing: str) -> str:
    parts = []
    for raw in (leading, trailing):
        text = " ".join(line.strip() for line in raw.strip().splitlines())
        if text:
            parts.append(text)
    return " ".join(parts)


# ---------------------------------------------------------------------------
# Pool construction from FileDescriptorProtos (dependency-ordered)
# ---------------------------------------------------------------------------


def build_pool(
    file_protos: Iterable[descriptor_pb2.FileDescriptorProto],
    pool: Optional[descriptor_pool.DescriptorPool] = None,
) -> descriptor_pool.DescriptorPool:
    """Register files into a pool in dependency order (loader.go:67-134
    parity). Missing dependencies (typically well-known types the server
    didn't send) are pulled from the default pool as a fallback."""
    pool = pool or descriptor_pool.DescriptorPool()
    by_name = {fdp.name: fdp for fdp in file_protos}
    registered: set[str] = set()

    def ensure(name: str) -> None:
        if name in registered or _in_pool(pool, name):
            return
        fdp = by_name.get(name)
        if fdp is None:
            fdp = _from_default_pool(name)
            if fdp is None:
                raise KeyError(f"missing dependency descriptor: {name}")
        for dep in fdp.dependency:
            ensure(dep)
        try:
            pool.Add(fdp)
        except Exception as exc:  # duplicate registration etc.
            logger.debug("pool.Add(%s) failed: %s", name, exc)
        registered.add(name)

    for name in by_name:
        ensure(name)
    return pool


def _in_pool(pool: descriptor_pool.DescriptorPool, name: str) -> bool:
    try:
        pool.FindFileByName(name)
        return True
    except KeyError:
        return False


def _from_default_pool(name: str) -> Optional[descriptor_pb2.FileDescriptorProto]:
    try:
        fd = descriptor_pool.Default().FindFileByName(name)
    except KeyError:
        return None
    fdp = descriptor_pb2.FileDescriptorProto()
    fd.CopyToProto(fdp)
    return fdp


# ---------------------------------------------------------------------------
# MethodInfo extraction from a registered pool
# ---------------------------------------------------------------------------


def extract_methods(
    file_protos: Iterable[descriptor_pb2.FileDescriptorProto],
    pool: descriptor_pool.DescriptorPool,
    comments: Optional[CommentIndex] = None,
) -> list[MethodInfo]:
    """Walk services in `file_protos`, resolving message descriptors from
    `pool` (loader.go:137-216 parity)."""
    methods: list[MethodInfo] = []
    for fdp in file_protos:
        prefix = fdp.package + "." if fdp.package else ""
        for svc in fdp.service:
            svc_fqn = prefix + svc.name
            svc_comment = comments.get(svc_fqn) if comments else ""
            for method in svc.method:
                method_fqn = f"{svc_fqn}.{method.name}"
                try:
                    input_desc = pool.FindMessageTypeByName(
                        method.input_type.lstrip(".")
                    )
                    output_desc = pool.FindMessageTypeByName(
                        method.output_type.lstrip(".")
                    )
                except KeyError as exc:
                    logger.warning("skipping %s: %s", method_fqn, exc)
                    continue
                methods.append(
                    MethodInfo(
                        name=method.name,
                        full_name=method_fqn,
                        service_name=svc_fqn,
                        input_type=input_desc.full_name,
                        output_type=output_desc.full_name,
                        description=comments.get(method_fqn) if comments else "",
                        service_description=svc_comment,
                        input_descriptor=input_desc,
                        output_descriptor=output_desc,
                        is_client_streaming=method.client_streaming,
                        is_server_streaming=method.server_streaming,
                        source_location=SourceLocation(file=fdp.name),
                    )
                )
    return methods


def trim_service_name(full_name: str) -> str:
    """Compatibility trim: keep the last two dotted segments so
    `com.example.hello.HelloService` matches reflection's
    `hello.HelloService` (loader.go:221-235 behavior)."""
    parts = full_name.split(".")
    if len(parts) <= 2:
        return full_name
    return ".".join(parts[-2:])


# ---------------------------------------------------------------------------
# FileDescriptorSet loader
# ---------------------------------------------------------------------------


class DescriptorSetLoader:
    """Loads a protoc-produced FileDescriptorSet (.binpb)."""

    def __init__(self, path: str, apply_name_trim: bool = True):
        self.path = path
        self.apply_name_trim = apply_name_trim
        self.file_set: Optional[descriptor_pb2.FileDescriptorSet] = None
        self.pool: Optional[descriptor_pool.DescriptorPool] = None
        self.comments = CommentIndex()

    def load(self) -> "DescriptorSetLoader":
        with open(self.path, "rb") as fh:
            data = fh.read()
        if not data:
            raise ValueError(f"empty descriptor set file: {self.path}")
        self.file_set = descriptor_pb2.FileDescriptorSet.FromString(data)
        if not self.file_set.file:
            raise ValueError(f"descriptor set has no files: {self.path}")
        self.pool = build_pool(self.file_set.file)
        for fdp in self.file_set.file:
            self.comments.add_file(fdp)
        return self

    def extract_method_info(self) -> list[MethodInfo]:
        if self.file_set is None or self.pool is None:
            raise RuntimeError("load() first")
        methods = extract_methods(self.file_set.file, self.pool, self.comments)
        if self.apply_name_trim:
            for mi in methods:
                trimmed = trim_service_name(mi.service_name)
                if trimmed != mi.service_name:
                    mi.options["untrimmed_service_name"] = mi.service_name
                    mi.service_name = trimmed
                    mi.full_name = f"{trimmed}.{mi.name}"
        return methods
