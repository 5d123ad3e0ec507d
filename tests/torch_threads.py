"""The port's test processes run torch on one intra-op thread.

The suite runs on six xdist workers over eight cores, and torch sizes its
intra-op pool to every core in each worker: the workers' pools oversubscribe
the cores, and the port's tests took about twice as long on the CPU for it
(the same six test files, the same machine: 1270 s of test time on the
default pools, 638 s on one thread each). Importing this module sets one
thread in the importing process. ``default_pool()`` runs a block on the pool
torch sized itself (``DEFAULT``), where a check's numbers were fixed on it:
a float32 sum splits over the pool's threads, and its rounding with it.
"""

import contextlib

import torch

DEFAULT = torch.get_num_threads()  # read before this module changes it
torch.set_num_threads(1)


@contextlib.contextmanager
def default_pool():
    """Torch's own intra-op pool (``DEFAULT`` threads) inside the block."""
    threads = torch.get_num_threads()
    torch.set_num_threads(DEFAULT)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
