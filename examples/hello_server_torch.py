"""Standalone hello gRPC server on the PyTorch port's modules: unary
SayHello, reflection and health, the backend of the port's quick start.
It imports only `ggrmcp_tpu_torch` (its copies of the generated
messages and of the service helpers), and neither torch nor JAX.

An asyncio server: the port's service helpers serve grpc.aio only.

Run:  python examples/hello_server_torch.py --port 50051
Then: python -m ggrmcp_tpu_torch gateway --grpc-port 50051 --http-port 50053
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import grpc.aio  # noqa: E402

from ggrmcp_tpu_torch.rpc.pb import hello_pb2  # noqa: E402
from ggrmcp_tpu_torch.rpc.server_utils import (  # noqa: E402
    HealthService,
    MethodDef,
    ReflectionService,
    add_service,
)


async def say_hello(request: hello_pb2.HelloRequest, context):
    salutation = request.salutation or "Hello"
    return hello_pb2.HelloResponse(message=f"{salutation}, {request.name}!")


async def serve(port: int, uds: str = "") -> None:
    server = grpc.aio.server()
    add_service(
        server,
        "hello.HelloService",
        {"SayHello": MethodDef(say_hello, hello_pb2.HelloRequest,
                               hello_pb2.HelloResponse)},
    )
    ReflectionService(["hello.HelloService"]).attach(server)
    HealthService().attach(server)
    if uds:
        if server.add_insecure_port(f"unix:{uds}") == 0:
            raise OSError(f"failed to bind unix:{uds}")
        target = f"unix:{uds}"
    else:
        bound = server.add_insecure_port(f"0.0.0.0:{port}")
        target = f"localhost:{bound}"
    await server.start()
    # Machine-readable for callers that pass --port 0 / --uds.
    print(f"TARGET={target}", flush=True)
    logging.info("hello-service listening on %s", target)
    await server.wait_for_termination()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=50051)
    parser.add_argument(
        "--uds", default="", help="listen on a unix socket instead of TCP"
    )
    args = parser.parse_args()
    asyncio.run(serve(args.port, args.uds))
