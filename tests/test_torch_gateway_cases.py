"""The reference's cases of the gRPC plane and the fast lane, run
against the port's copies (tests/torch_ref_cases.py): `test_connection`
(the channel manager), `test_router` (replica routing through the
port's discoverer and gateway over in-process backends) and
`test_fastlane` (the port's hand-rolled HTTP/1.1 server, byte for byte
on the wire)."""

from tests import torch_ref_cases
from tests import torch_threads  # noqa: F401

for _name in ("test_connection", "test_router", "test_fastlane"):
    torch_ref_cases.collect(torch_ref_cases.port_module(_name), globals())
