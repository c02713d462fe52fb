"""The intra-op thread count of the port's tests.

Tier-1 runs six pytest workers on eight cores beside the JAX package's
compile-bound config-zoo test, and torch's default of one intra-op thread
per core oversubscribes them: the port's tests took about three times as
long under that load, and the zoo test with them. Every port test module
imports `torch_test_threads`, an autouse fixture that gives torch
TORCH_TEST_THREADS threads while the module runs and gives the worker back
its count after it, so the JAX package's tests keep torch's default.
"""
import pytest
import torch

TORCH_TEST_THREADS = 2


@pytest.fixture(scope='module', autouse=True)
def torch_test_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(TORCH_TEST_THREADS)
    yield
    torch.set_num_threads(before)


def test_a_port_module_runs_on_two_threads():
    assert torch.get_num_threads() == TORCH_TEST_THREADS
