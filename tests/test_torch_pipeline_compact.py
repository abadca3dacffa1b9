"""The compact-key cases of the port's party-pipelined multikey blind rotate
against the JAX package (see tests/test_torch_pipeline.py, which holds the
expanded-key cases and the rest; both share tests/_torch_pipeline_helpers.py).
Tolerance: word-for-word equality.
"""

import pytest
import torch
from _torch_pipeline_helpers import check_pipelined_kernels, check_pipelined_rotate, skip_without_jax


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tensors here are tiny: one intra-op thread, so that the
    workers of a parallel test run do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def needs_jax():
    skip_without_jax()


@pytest.mark.parametrize("form", ["compact"])
@pytest.mark.parametrize("microbatches", [1, 2, 4, 8])
@pytest.mark.parametrize("parties", [2, 4])
def test_pipelined_rotate_equals_jax_and_single_device(needs_jax, parties, microbatches, form):
    check_pipelined_rotate(parties, microbatches, form)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["compact"])
def test_pipelined_kernels_equal_single_call(form):
    check_pipelined_kernels(form)
