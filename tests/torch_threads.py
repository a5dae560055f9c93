"""One share of the host's cores for torch in each pytest-xdist worker.

The port's CPU tests issue many thousands of small torch ops. With torch's
default of one intra-op thread per core in every worker, 6 workers on 8
cores run about 48 threads that wait on each other, and the port's tests
take about three times as long as with one thread per worker. Every
tests/test_torch_*.py imports this module, which gives torch the host's
cores divided by the workers (PYTEST_XDIST_WORKER_COUNT; all of them when
pytest runs in one process). THREADS is the count, for the subprocesses
that a test starts.
"""

import os

import torch

THREADS = max(1, (os.cpu_count() or 1)
              // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
torch.set_num_threads(THREADS)
