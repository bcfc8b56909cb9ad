import pytest
import torch


@pytest.fixture
def card():
    """The first CUDA card; the test skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
