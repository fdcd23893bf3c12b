import pytest
import torch


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    # the tiny model gains nothing from more; the host is shared
    torch.set_num_threads(2)
