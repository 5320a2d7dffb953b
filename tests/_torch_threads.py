"""One thread budget for the port's tests.

The tier-1 suite runs six pytest-xdist workers (``-n 6 --dist loadfile``) on
an eight-core host. Left alone, every worker sizes torch's intra-op pool and
numpy's and scipy's OpenBLAS pools to all eight cores: some 150 runnable
threads on 8 cores, where multi-threaded BLAS, LAPACK and oneDNN spin against
each other. A 2048² ``scipy.linalg.eigh`` takes 0.5-0.7 s in a quiet process
and 8-11 s beside one other busy worker. The 23 slowest port files took 981 s
of wall time under ``-n 6`` with the default pools, 219 s with one thread a
worker and 239 s with two; so ``THREADS`` is 1.

Every ``tests/test_torch_*.py`` takes the budget explicitly, as a
module-scoped autouse fixture::

    from _torch_threads import thread_budget  # noqa: F401  (autouse)

For the module's tests it sets torch's intra-op threads and the OpenBLAS
pools to ``THREADS``, and ``OMP_NUM_THREADS``, ``MKL_NUM_THREADS`` and
``OPENBLAS_NUM_THREADS`` for the processes they start (``_torch_mp_worker``
ranks, the CLI), so that a result compared bitwise across a process boundary
is computed under one budget on both sides. Afterwards it puts everything
back. XLA's pool belongs to the JAX package's ``conftest.py`` and is left as
it is.
"""

import os

import pytest
import scipy.linalg  # noqa: F401  (loads scipy's OpenBLAS, so that the limit reaches it)
import torch
from threadpoolctl import threadpool_limits

THREADS = 1
ENV = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


@pytest.fixture(scope="module", autouse=True)
def thread_budget():
    """torch and OpenBLAS on ``THREADS`` threads for the module, and the
    same for the processes its tests start."""
    threads = torch.get_num_threads()
    env = {k: os.environ.get(k) for k in ENV}
    os.environ.update({k: str(THREADS) for k in ENV})
    torch.set_num_threads(THREADS)
    with threadpool_limits(limits=THREADS, user_api="blas"):
        yield THREADS
    torch.set_num_threads(threads)
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
