"""A fixture for the port's test modules that run whole pipelines: one
torch intra-op thread while the module runs.

The suite runs in several worker processes at once (``pytest -n``).  Each
torch process otherwise starts an OpenMP team as wide as the machine for
every small operator, and the teams of the workers (and of a pipeline's
own producer and emitter threads) oversubscribe the cores: a module that
takes ~25 s alone then takes ten times that.  Import the fixture into a
test module to use it; values do not depend on the thread count beyond
the summation order the tests' tolerances already allow."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
