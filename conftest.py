"""A time limit of its own for every test under tests/.

Every test not marked ``slow`` gets ``TEST_TIME_LIMIT_S`` seconds for its
set-up, call and teardown together. At the limit the test fails, after a
dump of every thread, and the run goes on with the next test. ``slow`` tests
(more than 60 s alone) are not armed: under a loaded machine a compile alone
can pass the limit. A hang inside C code that never returns to the
interpreter is not cut here; the run's own time limit still is.

Tests outside ``TIME_LIMITED_DIR`` (``benchmark/tests``, whose card runs take
their own time) are left as they are.
"""

import faulthandler
import math
import os
import signal
import tempfile
import time

import pytest

TEST_TIME_LIMIT_S = 300
TIME_LIMITED_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests")

_DEADLINE = pytest.StashKey[float]()


def _expired(signum, frame):
    with tempfile.TemporaryFile(mode="w+") as f:
        faulthandler.dump_traceback(file=f, all_threads=True)
        f.seek(0)
        threads = f.read()
    pytest.fail(f"ran past the per-test time limit of {TEST_TIME_LIMIT_S} s "
                f"(conftest.py TEST_TIME_LIMIT_S); every thread:\n"
                f"{threads}", pytrace=False)


def _time_limited(item):
    if (item.get_closest_marker("slow") is not None
            or not str(item.path).startswith(TIME_LIMITED_DIR + os.sep)):
        yield
        return
    deadline = item.stash.setdefault(_DEADLINE,
                                     time.monotonic() + TEST_TIME_LIMIT_S)
    previous = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(max(1, math.ceil(deadline - time.monotonic())))
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    yield from _time_limited(item)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    yield from _time_limited(item)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_teardown(item, nextitem):
    yield from _time_limited(item)
