"""The port's CPU tests' share of the machine's cores.

A distributed run (pytest-xdist, a process a worker) puts several
workers on the cores. PyTorch's intra-op pool takes every core in each
worker, and its threads spin at the end of each parallel region, so a
test that takes seconds alone took minutes among the other workers
(the Ken Burns CLI test: 5 s alone, 129 s among 6 workers on 8 cores).
Each port test module imports the autouse fixture ``torch_threads``,
which gives the module's tests the worker's share of the cores and
restores the thread count after them. A run in one process keeps every
core. tests/test_torch_detector.py does not import it: one of its exact
box comparisons (``test_anime_insseg_infer_vs_jax``) holds at the
default thread count and not at one thread, where the convs sum in
another order.
"""
import os

import pytest
import torch


def worker_threads() -> int:
    """The cores over the xdist workers (all of them without xdist)."""
    cores = len(os.sched_getaffinity(0))
    workers = int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))
    return max(1, cores // workers)


@pytest.fixture(scope='module', autouse=True)
def torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, worker_threads()))
    yield
    torch.set_num_threads(before)
