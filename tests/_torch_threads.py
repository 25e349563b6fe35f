"""One torch CPU thread per test of the port's trainer-level files.

The tier-1 command runs the suite in 6 pytest-xdist workers on one host.
Torch's default of one intra-op thread per core in each worker
oversubscribes the cores, and the many small convolutions of these tests
then slowed ~20x (``tests/test_torch_trainer.py``: ~40 s alone, 954 s of
its worker inside the 6-worker suite).  The fixture restores the thread
count after each test, so other files keep torch's default."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
