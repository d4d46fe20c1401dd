"""Tests of the benchmark. They run on the CPU; a test that needs a card
asks for the ``card`` fixture, which skips it without one."""

import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
