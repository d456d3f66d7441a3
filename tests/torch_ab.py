"""Shared by the port's A/B tests: one A/B at a time, the subprocess ones
on two cores.

An A/B's gates read wall clocks: a subprocess A/B (the router's
kill-and-replace, the fleet straggler, the hang and the audit A/Bs)
starts several processes that each import torch, and an in-process one
(slo, capacity) serves on engines in the test process. `one_at_a_time`
takes a file lock in the test run's shared temporary root, so two A/Bs on
different xdist workers never run at once; `two_cores` also keeps the
test process (and so the children, which inherit its affinity) on its
last two cores.
"""

import contextlib
import fcntl
import os


@contextlib.contextmanager
def one_at_a_time(tmp_path_factory):
    # the parent of an xdist worker's basetemp is the test run's root,
    # shared by every worker (without xdist, the user's pytest root)
    lock = tmp_path_factory.getbasetemp().parent / "torch_ab.lock"
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


@contextlib.contextmanager
def two_cores(tmp_path_factory, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with one_at_a_time(tmp_path_factory):
        keep = os.sched_getaffinity(0)
        os.sched_setaffinity(0, sorted(keep)[-2:])
        try:
            yield
        finally:
            os.sched_setaffinity(0, keep)
