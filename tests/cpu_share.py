"""Port test processes share the CPUs instead of oversubscribing them.

Under pytest-xdist (``PYTEST_XDIST_WORKER_COUNT`` is set) every worker
would start torch with one intra-op thread per CPU, so six workers on eight
CPUs run ~48 OpenMP threads, and a convolution-heavy case ran nine times
slower than with one thread per worker. Importing this module gives torch
the worker's share of the CPUs this process may use,
``max(1, CPUs // workers)``, and puts the same share in ``OMP_NUM_THREADS``
for the subprocesses the tests start. Outside xdist it changes nothing.

Every ``tests/test_torch_*.py`` imports it before its first torch work, as
``import cpu_share`` (pytest puts ``tests/`` on the path; the package name
``tests`` may belong to another installed package on some hosts).
"""

import os

import torch

_workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _workers:
    share = max(1, len(os.sched_getaffinity(0)) // int(_workers))
    os.environ["OMP_NUM_THREADS"] = str(share)
    torch.set_num_threads(share)
