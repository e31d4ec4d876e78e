"""Module fixtures shared by the port's test files; import one into a
test module to apply it there.

* ``_one_torch_thread`` pins one torch intra-op thread: under
  pytest-xdist every worker's thread pool would spread over all the
  cores, and the pools' contention costs more than they gain at the
  tests' tiny shapes.
* ``_partitionable`` turns ``jax_threefry_partitionable`` on, the key
  schedule the port's sampler follows, and restores it afterwards.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _partitionable():
    import jax
    was = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", was)
