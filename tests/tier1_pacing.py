"""Pacing of the tier-1 suite (`pytest tests/ -n 6 --dist loadfile` under a
1470 s limit): the units of work xdist hands out and their order, and time
limits on every test.  The conftest.py at the root of the repo loads the
hooks; a run with `--noconftest` never does.

- `--dist loadfile` makes each file one unit of work, run in turn on one
  worker, and queues the units by test count, most first.  SPLIT cuts the
  JAX package's compile-bound files into units of the tests that share
  programs, so that several workers take them (each unit builds its own
  module fixtures); the files themselves stay as they are.  The units of
  QUEUE_HEAD go out first, costliest first (longest-processing-time-first
  scheduling); every other unit keeps xdist's order behind them.  A worker
  takes its next unit only when down to the one test it holds back.
- Each test's setup and call get TEST_LIMIT_S seconds and, under
  `--dist loadfile`, no more than is left before the suite's deadline,
  DEADLINE_S after the run started.  SIGALRM then fails the test with a
  message that names it and the limit; a call stuck in C++ (an XLA
  compile) never returns to Python's signal handler, so GRACE_S later
  faulthandler dumps every thread's stack and ends the process, and xdist
  reports that test as crashed and goes on with a fresh worker.  A test
  due to start after the deadline fails at once.  A hang costs the tests
  it holds up, each named, and pytest's summary still prints inside the
  suite's limit.
"""

from __future__ import annotations

import contextlib
import faulthandler
import os
import signal
import sys
import time

import pytest

# Tests (by function name) that leave their file for a unit of their own,
# grouped by the programs they compile; the file's other tests stay in the
# file's unit.  A renamed test falls back to its file's unit.
SPLIT = {
    "test_pipeline.py": {
        "test_composite_equals_plain_cfg_when_disabled": "composite",
        "test_composite_two_pass_equals_fused": "composite",
        "test_composite_stream_capture_equals_fused": "composite",
        "test_encoder_reuse": "reuse",
        "test_composite_two_pass_with_encoder_reuse": "reuse",
        "test_pab_cache_replaces_attention_exactly": "reuse",
        "test_composite_pab_interval": "reuse",
        "test_composite_capture_reuse": "capture_reuse",
    },
    "test_parallel.py": {
        "test_64frame_windowed_ring_composite_step": "composite",
        "test_composite_batch_matches_sequential": "composite",
        "test_pipeline_mesh_matches_single_device_e2e": "pipeline",
        "test_batched_inversion_matches_sequential": "pipeline",
    },
    "test_sharded_kernels.py": {
        "test_effective_natural_layout": "cp",
        "test_context_parallel_overrides_natural_layout": "cp",
        "test_apply_unet_options_with_cp_template": "cli",
    },
}

# Worker seconds of each unit (setup + call + teardown of its tests, junit
# XML) in a tier-1 run on an 8-core host, costliest first: every unit over
# ~150 s, which with few tests would otherwise go out near the end.
QUEUE_HEAD = (
    "test_approx_quality.py",  # 984
    "test_pipeline.py[capture_reuse]",  # 606
    "test_pipeline.py",  # 493
    "test_pipeline.py[reuse]",  # 485
    "test_unet.py",  # 469
    "test_parallel.py[composite]",  # 443
    "test_parallel.py[pipeline]",  # 399
    "test_sharded_kernels.py[cli]",  # 333
    "test_pipeline.py[composite]",  # 321
    "test_sharded_kernels.py[cp]",  # 305
    "test_parallel.py",  # 297
    "test_sharded_kernels.py",  # 289
    "test_sitemap.py",  # 221 (43 after test_unet.py on one worker)
    "test_autoreuse.py",  # 212
    "test_cli.py",  # 164
)

# Above the slowest test or module-fixture setup of a tier-1 run (the
# report fixture of tests/test_approx_quality.py, 870-1110 s) and below
# the suite's 1470 s.
TEST_LIMIT_S = 1200
# the deadline of a `--dist loadfile` run: the 1470 s less the time to end
# a worker stuck in C++ (GRACE_S), start and collect its replacement
# (15-30 s), fail the tests left to it and print the summary
DEADLINE_S = 1380
# seconds the alarm has to reach Python before faulthandler ends the process
GRACE_S = 20
# the directory whose tests get the time limits
ROOT = os.path.dirname(os.path.abspath(__file__))

STARTED = time.time()


def unit_of(scope: str, nodeid: str) -> str:
    """The unit of work of a test: its file's, or a SPLIT unit of it."""
    groups = SPLIT.get(scope.rsplit("/", 1)[-1], {})
    group = groups.get(nodeid.split("::", 1)[-1].split("[", 1)[0])
    return f"{scope}[{group}]" if group else scope


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    """Under `--dist loadfile`, xdist's file scheduling with the SPLIT units
    and QUEUE_HEAD at the head of its queue; any other `--dist` keeps
    xdist's own."""
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class CostliestFirst(LoadFileScheduling):
        _head_queued = False

        def _split_scope(self, nodeid):
            return unit_of(super()._split_scope(nodeid), nodeid)

        def _reschedule(self, node):
            # A worker holds its last test back until it knows the next one.
            # xdist hands it a new unit once two tests are left, which
            # commits that unit at once to a worker whose one or two tests
            # take minutes; here a new unit waits for the held test.
            if self.workqueue and self._pending_of(self.assigned_work[node]) > 1:
                return
            super()._reschedule(node)

        def _assign_work_unit(self, node):
            if not self._head_queued:  # the queue is whole before the first assignment
                self._head_queued = True
                by_name = {scope.rsplit("/", 1)[-1]: scope for scope in self.workqueue}
                for name in reversed(QUEUE_HEAD):
                    if name in by_name:
                        self.workqueue.move_to_end(by_name[name], last=False)
            super()._assign_work_unit(node)

    return CostliestFirst(config, log)


@pytest.hookimpl(optionalhook=True)
def pytest_configure_node(node):
    # the workers' deadline counts from the start of the whole run
    if node.config.getvalue("dist") == "loadfile":
        node.workerinput["tier1_started"] = STARTED


def _stderr_fd(config) -> int:
    # pytest's faulthandler plugin keeps a descriptor of the stderr that
    # output capture does not swallow; a dumped worker's stacks reach the
    # run's log through it
    from _pytest.faulthandler import fault_handler_stderr_fd_key

    return config.stash.get(fault_handler_stderr_fd_key, sys.__stderr__.fileno())


@contextlib.contextmanager
def _time_limit(item, phase: str):
    limit, why = TEST_LIMIT_S, f"the tier-1 limit of {TEST_LIMIT_S} s a test"
    started = getattr(item.config, "workerinput", {}).get("tier1_started")
    if started is not None:
        left = started + DEADLINE_S - time.time()
        if left < 1:
            pytest.fail(f"{item.nodeid}: {phase} not started: the tier-1 suite is past its "
                        f"deadline, {DEADLINE_S} s after it started")
        if left < limit:
            limit, why = left, f"the tier-1 suite's deadline, {DEADLINE_S} s after it started"

    def expire(signum, frame):
        pytest.fail(f"{item.nodeid}: {phase} took longer than {why}")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, limit)
    faulthandler.dump_traceback_later(limit + GRACE_S, exit=True, file=_stderr_fd(item.config))
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


def _limited(item) -> bool:
    return str(item.path).startswith(ROOT + os.sep)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _time_limit(item, "setup") if _limited(item) else contextlib.nullcontext():
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _time_limit(item, "call") if _limited(item) else contextlib.nullcontext():
        return (yield)
