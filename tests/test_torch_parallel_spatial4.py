"""The slab-sharded Lucy iteration (hyperion_tpu_torch/parallel/spatial.py)
at four gloo ranks on the CPU against the JAX package's
run_lucy_iteration_spatial on a mesh of four CPU devices: the cases and
checks of tests/test_torch_parallel_spatial.py (world 2 there), in a file
of their own so that the two worlds run side by side."""

import pytest

from test_torch_parallel_spatial import (CASES, check_dryrun_thick_mrw,
                                         check_spatial_against_jax)


@pytest.mark.parametrize('case', list(CASES))
@pytest.mark.parametrize('world', [4])
def test_spatial_against_jax(world, case):
    check_spatial_against_jax(world, case)


@pytest.mark.parametrize('world', [4])
def test_dryrun_thick_mrw_every_slab(world):
    check_dryrun_thick_mrw(world)
