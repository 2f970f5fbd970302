"""One torch intra-op thread for a port test module: every
``tests/test_torch_*.py`` that runs torch code imports the fixture
(``test_torch_api_repairs.py`` holds that).

At the tests' sizes a parallel region saves nothing, and when xdist's
workers share the cores the pools' barriers stall: the folded MC passes
took 3 s alone and 659 s in a six-worker run.  Only torch's threads are
set; XLA's, which the JAX package's tests in the same workers use, are not.
"""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (the old count restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
