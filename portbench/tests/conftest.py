import pytest
import torch

from portbench import manifest

from ._small import FAMILIES


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    """Each test process runs the program's CPU path on few threads: several
    processes (pytest-xdist) of one thread a core each would otherwise spin
    against each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def files(monkeypatch):
    """The benchmark's files found in ``families/`` (``_small.SOLVENT``'s)."""
    monkeypatch.setattr(manifest, "HERE", FAMILIES)
