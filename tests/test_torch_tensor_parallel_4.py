"""Tensor and sequence parallelism of the port against the JAX package at
four ``gloo`` ranks: the mappings and rings and GPT's tensor-parallel
configurations.  The set-up, the references and the tolerances are
``tests/_torch_tp.py``'s (2 ranks: ``tests/test_torch_tensor_parallel.py``)."""

import pytest

from _torch_tp import (F32_GPT, MAPPINGS, _run, check_gpt_step,
                       check_mapping, check_sliced_serial, check_surface)


@pytest.fixture(scope="module")
def tp4(tmp_path_factory):
    return (4,) + _run(4, tmp_path_factory)


@pytest.mark.parametrize("name", MAPPINGS)
def test_mappings_and_rings_match_jax_exactly(tp4, name):
    """The seven mappings and both overlap rings (chunks 1 and 2) at four
    ranks, forward and backward, equal JAX's under shard_map bit for
    bit."""
    check_mapping(tp4, name)


@pytest.mark.parametrize("name", F32_GPT)
def test_gpt_step_matches_jax_shard_map(tp4, name):
    """GPT at 4 ranks in each tensor-parallel configuration: the loss,
    every rank's gradients and one FusedAdam step against JAX's shard_map
    step."""
    check_gpt_step(tp4, name)


@pytest.mark.parametrize("name", F32_GPT)
def test_gpt_grads_match_sliced_serial_grads(tp4, name):
    """The same against the JAX serial gradients sliced by JAX's
    ``shard_params_for_tp``."""
    check_sliced_serial(tp4, name)


def test_layers_broadcast_and_rng_across_ranks(tp4):
    """The column / row layers' gather and scatter paths,
    ``broadcast_data`` and the per-rank random streams at four ranks."""
    check_surface(tp4)
