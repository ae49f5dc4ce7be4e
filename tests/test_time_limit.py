"""The per-test time limit of the repo's root conftest.py: a test that runs
past it fails by itself, with a dump of every thread, and the run goes on.

A two-test file runs in a child pytest with that conftest loaded as a plugin,
its limit patched down to 1 s and its directory set to the child's: one test
sleeps 3 s, the other passes. Once in one process, once in an xdist worker (the tier-1 runs use
xdist, whose workers must run tests in their main thread for the alarm).
"""

import os
import re
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = textwrap.dedent("""
    import os
    import time

    import conftest as limits

    limits.TEST_TIME_LIMIT_S = 1
    limits.TIME_LIMITED_DIR = os.path.dirname(os.path.abspath(__file__))


    def test_sleeps_past_the_limit():
        time.sleep(3)


    def test_after_the_sleeper_still_runs():
        assert True
""")


@pytest.mark.parametrize("mode", [["-p", "no:xdist"],
                                  ["-p", "xdist", "-n", "1"]],
                         ids=["one_process", "xdist_worker"])
def test_sleeper_fails_at_the_limit_and_the_run_goes_on(tmp_path, mode):
    (tmp_path / "test_child.py").write_text(CHILD)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu")
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "conftest",
         "-p", "no:cacheprovider", "-p", "no:randomly", "-rA", *mode,
         "test_child.py"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    out = run.stdout + run.stderr
    assert run.returncode == 1, out
    assert "1 failed, 1 passed" in out, out
    assert "FAILED test_child.py::test_sleeps_past_the_limit" in out, out
    assert "PASSED test_child.py::test_after_the_sleeper_still_runs" in out, out
    assert "ran past the per-test time limit of 1 s" in out, out
    # faulthandler's dump names the main thread and the sleeping frame
    assert "Current thread" in out, out
    assert re.search(r"line \d+ in test_sleeps_past_the_limit", out), out
