"""The reference's `test_fleet` cases against the port's supervisor
(`ggrmcp_tpu_torch/serving/fleet.py`: FleetSupervisor, ReplicaObs,
TtftWindow, hist_p99, ProcessReplicaFactory, GatewayFleetAdapter) and
the port's gateway with its `/admin/fleet` endpoint
(tests/torch_ref_cases.py). The replica sidecars of its cases, and the
failpoint registry they read, stay the reference's; the port's workers
behind this supervisor are held by tests/test_torch_fleet.py, which
also holds the SIGKILL and `replica_crash` drills of the reference's
`slow` class TestFleetSidecarChaos on the port's workers: that class is
not taken here, since its drill reads the greedy text of the
reference's seeded weights, which the port's weights (drawn by torch
from the same seed) do not reproduce."""

from tests import torch_ref_cases
from tests import torch_threads  # noqa: F401

torch_ref_cases.collect(torch_ref_cases.port_module(
    "test_fleet", tuple(m for m in torch_ref_cases.PORTED
                        if m != "utils.failpoints")), globals(),
    skip=("TestFleetSidecarChaos",))
