"""One intra-op torch thread in each pytest-xdist worker.

Every ``tests/test_torch_*.py`` module imports this first. Under ``pytest
-n 6`` six worker processes share the host's cores; at torch's default
intra-op thread count (one a core) each of them would run as many threads
as the host has cores, and the workers slow each other down several times
over. A worker is known by ``PYTEST_XDIST_WORKER``, which xdist sets; a
serial run keeps torch's default. The multi-process worlds of
``tests/test_torch_mp.py`` cap their ranks with ``OMP_NUM_THREADS=1``
instead.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)
