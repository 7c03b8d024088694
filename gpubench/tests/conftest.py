"""The fixture that decides, inside a test, whether a card is there."""

import pytest


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
