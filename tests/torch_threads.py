"""The CPU thread setting of the port's tests.

Every ``tests/test_torch_*.py`` calls :func:`use_one_cpu_thread` when it
is imported. The tier-1 run spreads the tests over several pytest-xdist
workers on one host; torch's intra-op pool starts one thread per core in
every worker, so the workers oversubscribe the cores and the port's
tests slow down many times over. One torch thread per worker keeps each
worker on its own core (the JAX tests are not affected: XLA has its own
thread pool).
"""

import torch


def use_one_cpu_thread() -> None:
    """Run torch's CPU operators on one thread in this process."""
    torch.set_num_threads(1)
