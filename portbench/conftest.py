"""Pytest settings of the benchmark's own tests (`python -m pytest
portbench/tests -q`). Tests that need a CUDA card carry the `card` marker
and take the `card` fixture, which skips them where there is none: the
decision is made when the test runs, never when a module is imported."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run `python -m pytest portbench/tests -q -m card` on the chip")
