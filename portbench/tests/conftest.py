import pytest
import torch


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    """Each test process runs the program's CPU path on few threads: several
    processes (pytest-xdist) of one thread a core each would otherwise spin
    against each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
