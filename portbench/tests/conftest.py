import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny runs are dispatch-bound: one intra-op thread each keeps
    several test workers from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
