"""One intra-op thread for torch in each process of the test suite.

The suite runs in six pytest-xdist workers on one host (the tier-1 command
in ROADMAP.md). torch starts an intra-op pool of as many threads as the host
has cores in every worker that imports it, and six such pools on one host
spin against each other and against the workers running the JAX package's
tests: the port's tests took 746 s of wall time on an 8-core host with the
default pools and 248 s with one thread each (``-n 6 --dist loadfile``).
Every worker imports every test module while it collects, so this module's
import sets the count for the worker's whole run, the JAX package's tests
included (they do not run torch). A file run on its own keeps torch's
default.
"""

import torch

torch.set_num_threads(1)


def test_torch_runs_one_intra_op_thread():
    assert torch.get_num_threads() == 1
