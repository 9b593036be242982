"""Shared fixtures of the benchmark's own tests."""

import pytest

# the configurations' tables at a size a test run holds
TINY_ROWS = {
    "tpch-sf10": {"supplier": 100, "customer": 1500, "part": 2000,
                  "orders": 15000},
}


@pytest.fixture
def card():
    """The CUDA device, or a skip where this machine has none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return "cuda"


@pytest.fixture(autouse=True, scope="session")
def _data_cache(tmp_path_factory):
    """The program's data cache and decision file under a temporary
    directory, never in the checkout."""
    import os
    saved = os.environ.get("TRINO_TPU_DATA_CACHE")
    os.environ["TRINO_TPU_DATA_CACHE"] = str(tmp_path_factory.mktemp(
        "datacache"))
    yield
    if saved is None:
        os.environ.pop("TRINO_TPU_DATA_CACHE", None)
    else:
        os.environ["TRINO_TPU_DATA_CACHE"] = saved
