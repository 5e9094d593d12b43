"""gRPC server-side building blocks: generic service registration
without generated stubs, a server-reflection service, and a health
service. A copy of `ggrmcp_tpu/rpc/server_utils.py` for grpc.aio
servers only, without its failpoint hooks (this package imports nothing of the reference).

The reference relied on grpc-go's built-in reflection registration
(examples/hello-service/main.go:43-49); here the reflection *server* is
implemented from the protocol spec since grpcio ships no reflection
package in this environment. Serving uses generic method handlers, so no
protoc service plugin is required anywhere.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Optional

import grpc
import grpc.aio
from google.protobuf import descriptor_pb2, descriptor_pool

from ggrmcp_tpu_torch.rpc.pb import health_pb2, reflection_pb2

logger = logging.getLogger("ggrmcp.rpc.server")


# ---------------------------------------------------------------------------
# Generic service registration
# ---------------------------------------------------------------------------


class MethodDef:
    """One servable method: async handler + message classes."""

    def __init__(
        self,
        handler: Callable[..., Any],
        request_class: Any,
        response_class: Any,
        server_streaming: bool = False,
        client_streaming: bool = False,
    ):
        self.handler = handler
        self.request_class = request_class
        self.response_class = response_class
        self.server_streaming = server_streaming
        self.client_streaming = client_streaming


def add_service(
    server: grpc.aio.Server,
    service_full_name: str,
    methods: dict[str, MethodDef],
) -> None:
    """Register `methods` under `service_full_name` via generic handlers."""
    rpc_handlers = {}
    for name, md in methods.items():
        kwargs = dict(
            request_deserializer=md.request_class.FromString,
            response_serializer=lambda msg: msg.SerializeToString(),
        )
        if md.client_streaming and md.server_streaming:
            rpc_handlers[name] = grpc.stream_stream_rpc_method_handler(
                md.handler, **kwargs
            )
        elif md.server_streaming:
            rpc_handlers[name] = grpc.unary_stream_rpc_method_handler(
                md.handler, **kwargs
            )
        elif md.client_streaming:
            raise ValueError(f"{name}: client-streaming-only is not served")
        else:
            rpc_handlers[name] = grpc.unary_unary_rpc_method_handler(
                md.handler, **kwargs
            )
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(service_full_name, rpc_handlers),)
    )


# ---------------------------------------------------------------------------
# Server reflection service (v1alpha + v1 aliases)
# ---------------------------------------------------------------------------


class ReflectionService:
    """Serves the ServerReflection protocol for a set of service names
    out of a descriptor pool (default pool by default)."""

    def __init__(
        self,
        service_names: list[str],
        pool: Optional[descriptor_pool.DescriptorPool] = None,
    ):
        self.service_names = list(service_names)
        self.pool = pool or descriptor_pool.Default()

    def _file_with_deps(self, fd) -> list[bytes]:
        """A file descriptor plus all transitive dependencies, serialized
        — the complete set, since clients (including ours) need deps to
        build a registry."""
        out: list[bytes] = []
        seen: set[str] = set()

        def visit(f) -> None:
            if f.name in seen:
                return
            seen.add(f.name)
            for dep in f.dependencies:
                visit(dep)
            fdp = descriptor_pb2.FileDescriptorProto()
            f.CopyToProto(fdp)
            out.append(fdp.SerializeToString())

        visit(fd)
        return out

    def _handle(
        self, request: reflection_pb2.ServerReflectionRequest
    ) -> reflection_pb2.ServerReflectionResponse:
        response = reflection_pb2.ServerReflectionResponse(
            valid_host=request.host, original_request=request
        )
        which = request.WhichOneof("message_request")
        try:
            if which == "list_services":
                for name in self.service_names:
                    response.list_services_response.service.add(name=name)
            elif which == "file_containing_symbol":
                fd = self.pool.FindFileContainingSymbol(
                    request.file_containing_symbol
                )
                response.file_descriptor_response.file_descriptor_proto.extend(
                    self._file_with_deps(fd)
                )
            elif which == "file_by_filename":
                fd = self.pool.FindFileByName(request.file_by_filename)
                response.file_descriptor_response.file_descriptor_proto.extend(
                    self._file_with_deps(fd)
                )
            else:
                response.error_response.error_code = grpc.StatusCode.UNIMPLEMENTED.value[0]
                response.error_response.error_message = (
                    f"unsupported reflection request: {which}"
                )
        except KeyError:
            response.error_response.error_code = grpc.StatusCode.NOT_FOUND.value[0]
            response.error_response.error_message = "symbol not found"
        return response

    async def server_reflection_info(self, request_iterator, context):
        async for request in request_iterator:
            yield self._handle(request)

    def attach(self, server: grpc.aio.Server) -> None:
        for package in ("grpc.reflection.v1alpha", "grpc.reflection.v1"):
            add_service(
                server,
                f"{package}.ServerReflection",
                {
                    "ServerReflectionInfo": MethodDef(
                        self.server_reflection_info,
                        reflection_pb2.ServerReflectionRequest,
                        reflection_pb2.ServerReflectionResponse,
                        server_streaming=True,
                        client_streaming=True,
                    )
                },
            )


# ---------------------------------------------------------------------------
# Health service (grpc.health.v1)
# ---------------------------------------------------------------------------

SERVING = health_pb2.HealthCheckResponse.SERVING


class HealthService:
    """Standard gRPC health protocol: the server as a whole is SERVING
    while it runs; other service names are unknown."""

    def __init__(self) -> None:
        self._status: dict[str, int] = {"": SERVING}

    async def check(self, request: health_pb2.HealthCheckRequest, context):
        status = self._status.get(request.service)
        if status is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "unknown service")
        return health_pb2.HealthCheckResponse(status=status)

    async def watch(self, request: health_pb2.HealthCheckRequest, context):
        # Minimal watch: emit current status once, then hold the stream.
        status = self._status.get(
            request.service, health_pb2.HealthCheckResponse.SERVICE_UNKNOWN
        )
        yield health_pb2.HealthCheckResponse(status=status)

    def attach(self, server: grpc.aio.Server) -> None:
        add_service(
            server,
            "grpc.health.v1.Health",
            {
                "Check": MethodDef(
                    self.check,
                    health_pb2.HealthCheckRequest,
                    health_pb2.HealthCheckResponse,
                ),
                "Watch": MethodDef(
                    self.watch,
                    health_pb2.HealthCheckRequest,
                    health_pb2.HealthCheckResponse,
                    server_streaming=True,
                ),
            },
        )
