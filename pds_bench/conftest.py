"""Pytest settings of the benchmark's own tests (``pds_bench/tests``).

Tests that need a CUDA card carry the ``chip`` marker and take the
``cuda_card`` fixture, which skips them where there is none; the decision
is made when the fixture runs, never when a module is imported.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skipped without one")


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
