"""Share the host's cores among pytest-xdist workers for PyTorch.

By default each process's PyTorch runs one OpenMP thread per core, so six
workers on eight cores run 48 threads that wait on each other's cores, and
a CPU test's convolutions take many times their time alone. Under xdist
(PYTEST_XDIST_WORKER_COUNT set) each worker's PyTorch gets cores // workers
threads (at least 1), and OMP_NUM_THREADS says the same to the processes
the tests start (the CLIs' fresh processes). Outside xdist nothing changes.
Imported for that effect by every `test_torch_*.py`.
"""

import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _WORKERS > 1:
    THREADS = max(1, len(os.sched_getaffinity(0)) // _WORKERS)
    os.environ["OMP_NUM_THREADS"] = str(THREADS)
    torch.set_num_threads(THREADS)
