"""The port's tests run ``torch`` on one intra-op thread.

The suite runs under pytest-xdist with several workers, and each worker's
``torch`` would start one intra-op thread per core: six workers on an
eight-core machine then run about 48 threads that fight for the cores,
and a file whose matmuls take seconds alone takes minutes beside them.
One thread a worker gives each process a core's worth of work.

Every ``tests/test_torch_*.py`` imports this module first.  An xdist
worker imports every test file while it collects, so the setting holds in
every worker whatever file it runs; the explicit import keeps it from
depending on that.  ``torch.set_num_interop_threads`` is left alone: it
raises once inter-op work has started.  JAX's threads are the reference's
and are not set here.
"""

import torch

torch.set_num_threads(1)
