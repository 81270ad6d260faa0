"""Tests of the benchmark.  CPU tests run anywhere; tests marked ``cuda``
decide inside a fixture whether there is a card, and skip without one."""

import pytest


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: torch.cuda.is_available() is False')
    return torch.device('cuda:0')
