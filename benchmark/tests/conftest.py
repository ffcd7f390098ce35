"""Fixtures of the benchmark's own tests: ``python -m pytest benchmark/tests``
from the root of the repository. Tests marked ``cuda`` take the ``card``
fixture and skip where there is no card; run them on one with
``python -m pytest benchmark/tests -m cuda``."""

import pytest
import torch

# one intra-op thread: the plain path's small ops under several test
# processes spend their time in the pool's barriers otherwise
torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
