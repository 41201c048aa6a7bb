import pytest


@pytest.fixture
def cuda():
    """Skip unless a CUDA card is present (decided when the test runs)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda"
