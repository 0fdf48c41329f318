"""Two torch intra-op threads while a port test module runs.

The suite runs its files in parallel workers on one host; there more
threads a process only contend (a small bf16 product on eight threads took
several times as long as on two). A test module takes the fixture by
importing it; it is autouse, so nothing else refers to it.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
