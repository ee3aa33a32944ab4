"""One torch intra-op thread for a port test module, as
test_torch_optimize.py holds its own: the suite runs several workers on
one host, where spinning torch thread pools slow every worker down,
timed tests of the JAX package included. Import the fixture into a test
module to apply it there."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
