"""Tensor parallelism on a (2, 2) grid of gloo CPU ranks against JAX's
``make_sharded_train_step`` on ``make_mesh_2d(2, 2)``, in float64: Adam
with the description rows replicated and class-sharded, the ``mou`` mix
and a ragged class count (tests/tp_cases.py; the (1, 2) cases, the specs
and the placement checks are in tests/test_torch_tensor_parallel.py).
Four ranks: two data shards, each split over two model ranks, so both
axes' collectives run."""

import pytest

from tests.tp_cases import (CASES, check_collectives, check_steps_match_jax,
                            port_results_for)

SHAPE = (2, 2)
NAMES = [n for n, c in CASES.items() if c[0] == SHAPE]


@pytest.fixture(scope="module")
def port_results():
    return port_results_for(SHAPE)


@pytest.mark.parametrize("name", NAMES)
def test_tp_steps_match_jax(name, port_results):
    check_steps_match_jax(name, port_results[name])


@pytest.mark.parametrize("name", NAMES)
def test_collectives_per_axis(name, port_results):
    check_collectives(name, port_results[name])
