"""Mesh axes across four processes, one coordinate each: every group a
collective spans is a proper subset of the world, so
parallel/distributed.py `form_groups` creates real subgroups and
models/training.py `_reduce_across` meets them in one order on every
process. Four gloo processes (tests/torch_distributed_worker.py) take
tiny-llama at data=2 x tensor=2 (the batch pair and the tensor pair
groups of their own) and at stage=2 x tensor=2 (the stage pair's reduce
of the replicated leaves beside the tensor pair's sums), three AdamW
steps each, against the JAX package's global-mesh training on
`jax.devices()[:4]` with the same mesh, held as
tests/test_torch_process_axes.py holds its runs (its helpers).
"""

import json

import pytest

from tests import torch_threads  # noqa: F401
from tests.test_torch_process_axes import (
    _params_off,
    check_blocks,
    check_layout,
    check_losses,
    parity,
    run_processes,
)

RUNS = {
    "data2_tensor2": dict(model="tiny-llama", axes=dict(data=2, tensor=2)),
    "stage2_tensor2": dict(model="tiny-llama", axes=dict(stage=2, tensor=2)),
}
LAYOUT = {
    "data2_tensor2": ([2, 1, 2, 1, 1, 1], [1, 1, 1, 1, 1, 1]),
    "stage2_tensor2": ([1, 1, 2, 1, 1, 2], [1, 1, 1, 1, 1, 1]),
}


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return run_processes(tmp_path_factory.mktemp("groups"), RUNS, 4)


@pytest.mark.parametrize("key", parity(RUNS))
def test_losses_match_jax(four, key):
    check_losses(four["got"][key], four["want"][key])


@pytest.mark.parametrize("key", parity(RUNS))
def test_params_match_jax(four, key):
    for got in four["got"][key]:
        assert not _params_off(got, four["want"][key]["params"])


@pytest.mark.parametrize("key", parity(RUNS))
def test_blocks_held_twice_are_bitwise_equal(four, key):
    held = check_blocks(four["got"][key])
    # Blocks held by a pair (a tensor block over the batch or the stage
    # pair, a layer's norms over the tensor pair) and by all four (the
    # final norm).
    assert {2, 4} <= {len(ranks) for ranks in held.values()}


@pytest.mark.parametrize("key", list(RUNS))
def test_each_axis_crosses_the_processes(four, key):
    check_layout(four["got"][key], *LAYOUT[key])


@pytest.mark.parametrize("key", list(RUNS))
def test_four_processes_form_their_pairs(four, key):
    """Each collective spans a pair: the tensor pair and the batch (data)
    or stage pair of each process are groups of their own, beside the
    whole world."""
    for rank, g in enumerate(four["got"][key]):
        first, second = 2 * (rank // 2), rank % 2
        want = [[0, 1, 2, 3], [first, first + 1], [second, second + 2]]
        assert json.loads(str(g["seen"]))["groups"] == sorted(want)
