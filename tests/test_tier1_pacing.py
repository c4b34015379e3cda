"""The tier-1 pacing hooks (tests/tier1_pacing.py) in nested pytest runs on
a throwaway tree whose conftest imports them: the per-test time limit, the
suite's deadline, the units of xdist's file queue and its head."""

import ast
import os
import pathlib
import subprocess
import sys
import types

import tier1_pacing

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))

CONFTEST = f"""
import os
import sys

sys.path.insert(0, {TESTS_DIR!r})
import tier1_pacing

tier1_pacing.ROOT = os.path.dirname(os.path.abspath(__file__))
tier1_pacing.TEST_LIMIT_S = int(os.environ.get("LIMIT", "1"))
tier1_pacing.DEADLINE_S = int(os.environ.get("DEADLINE", "1350"))
tier1_pacing.GRACE_S = 5
if os.environ.get("PACING") != "off":
    from tier1_pacing import (pytest_configure_node, pytest_runtest_call,  # noqa: F401
                              pytest_runtest_setup, pytest_xdist_make_scheduler)
"""

XDIST = ("-p", "xdist", "--dist", "loadfile")


def _pytest(root, *args, **env):
    env = {**os.environ, "PACING": "on", **env}
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "no:cacheprovider", "-p", "no:randomly",
         "-o", "addopts=", "-v", *args],
        cwd=root, env=env, capture_output=True, text=True, timeout=120)
    return run.returncode, run.stdout + run.stderr


def _tree(tmp_path, files):
    (tmp_path / "conftest.py").write_text(CONFTEST)
    for name, body in files.items():
        (tmp_path / name).write_text(body)
    return tmp_path


def _ran(out, outcome="PASSED"):
    """(worker, file, test) of each test an xdist run reports with outcome."""
    ran = []
    for line in out.splitlines():
        if line.startswith("[gw") and f" {outcome} " in line:
            path, _, name = line.split()[-1].partition("::")
            ran.append((line.split()[0], path, name))
    return ran


def test_limit_fails_a_slow_test_by_name(tmp_path):
    root = _tree(tmp_path, {"test_timing.py": (
        "import time\n"
        "import pytest\n"
        "@pytest.fixture(scope='module')\n"
        "def slow_fixture():\n    time.sleep(4)\n"
        "def test_sleeps_past_the_limit():\n    time.sleep(4)\n"
        "def test_ends_in_time():\n    time.sleep(0.1)\n"
        "def test_slow_setup(slow_fixture):\n    pass\n")})
    rc, out = _pytest(root, "test_timing.py")
    assert rc == 1, out
    assert "test_timing.py::test_sleeps_past_the_limit FAILED" in out, out
    assert "test_timing.py::test_ends_in_time PASSED" in out, out
    assert "test_timing.py::test_slow_setup ERROR" in out, out
    for nodeid, phase in (("test_sleeps_past_the_limit", "call"), ("test_slow_setup", "setup")):
        assert (f"test_timing.py::{nodeid}: {phase} took longer than the tier-1 limit of 1 s "
                "a test") in out, out


def test_deadline_fails_the_test_it_cuts_and_those_after(tmp_path):
    root = _tree(tmp_path, {"test_late.py": (
        "import time\n"
        "def test_a_ends_in_time():\n    pass\n"
        "def test_b_runs_into_the_deadline():\n    time.sleep(30)\n"
        "def test_c_due_after_the_deadline():\n    pass\n")})
    rc, out = _pytest(root, *XDIST, "-n", "1", LIMIT="60", DEADLINE="8")
    assert rc == 1, out
    assert [name for _, _, name in _ran(out)] == ["test_a_ends_in_time"], out
    assert ("test_late.py::test_b_runs_into_the_deadline: call took longer than the tier-1 "
            "suite's deadline, 8 s after it started") in out, out
    assert ("test_late.py::test_c_due_after_the_deadline: setup not started: the tier-1 "
            "suite is past its deadline, 8 s after it started") in out, out


def test_queue_head_goes_out_first(tmp_path):
    head = tier1_pacing.QUEUE_HEAD[0]
    root = _tree(tmp_path, {
        head: "def test_one():\n    pass\n",
        "test_three.py": "".join(f"def test_{i}():\n    pass\n" for i in range(3)),
    })

    def order(pacing):
        rc, out = _pytest(root, *XDIST, "-n", "1", PACING=pacing)
        assert rc == 0, out
        ran = [path for _, path, _ in _ran(out)]
        assert sorted(ran) == sorted([head] + ["test_three.py"] * 3), out
        return ran

    assert order("off")[0] == "test_three.py"  # xdist's own queue: most tests first
    assert order("on")[0] == head


def test_split_units_run_on_different_workers(tmp_path):
    split = "test_composite_capture_reuse"
    assert tier1_pacing.SPLIT["test_pipeline.py"][split] == "capture_reuse"
    root = _tree(tmp_path, {"test_pipeline.py": "".join(
        f"def {name}():\n    pass\n" for name in ("test_a", "test_b", split, "test_c"))})
    rc, out = _pytest(root, *XDIST, "-n", "2")
    assert rc == 0, out
    worker = {name: gw for gw, _, name in _ran(out)}
    assert sorted(worker) == sorted(["test_a", "test_b", "test_c", split]), out
    assert worker["test_a"] == worker["test_b"] == worker["test_c"] != worker[split], out
    assert (tier1_pacing.unit_of("tests/test_pipeline.py", f"tests/test_pipeline.py::{split}")
            == "tests/test_pipeline.py[capture_reuse]")
    assert (tier1_pacing.unit_of("tests/test_unet.py", "tests/test_unet.py::test_x[a]")
            == "tests/test_unet.py")


def test_next_unit_waits_for_the_held_test(tmp_path):
    # test_b.py (3 tests) and test_a.py (2, the first slow) go out first;
    # xdist commits test_c.py at once behind test_a.py's slow test, the
    # pacing scheduler gives it to the worker that finishes test_b.py
    root = _tree(tmp_path, {
        "test_a.py": "import time\ndef test_a1():\n    time.sleep(3)\ndef test_a2():\n    pass\n",
        "test_b.py": "".join(f"def test_b{i}():\n    pass\n" for i in range(3)),
        "test_c.py": "def test_c1():\n    pass\n",
    })

    def worker_of(pacing):
        rc, out = _pytest(root, *XDIST, "-n", "2", PACING=pacing, LIMIT="60")
        assert rc == 0, out
        return {path: gw for gw, path, _ in _ran(out)}

    off = worker_of("off")
    assert off["test_c.py"] == off["test_a.py"] != off["test_b.py"]
    on = worker_of("on")
    assert on["test_c.py"] == on["test_b.py"] != on["test_a.py"]


def test_tables_name_tier1_tests():
    """Every unit of QUEUE_HEAD and every test of SPLIT exists under tests/:
    a stale name would silently drop its unit back to xdist's order."""
    tests = pathlib.Path(TESTS_DIR)
    defined = {}
    for name in {entry.split("[", 1)[0] for entry in tier1_pacing.QUEUE_HEAD} | set(tier1_pacing.SPLIT):
        assert (tests / name).is_file(), name
        defined[name] = {node.name for node in ast.parse((tests / name).read_text()).body
                         if isinstance(node, ast.FunctionDef)}
    for name, groups in tier1_pacing.SPLIT.items():
        assert set(groups) <= defined[name], (name, set(groups) - defined[name])
    for entry in tier1_pacing.QUEUE_HEAD:
        name, _, group = entry.partition("[")
        assert not group or group.rstrip("]") in tier1_pacing.SPLIT[name].values(), entry
    assert len(set(tier1_pacing.QUEUE_HEAD)) == len(tier1_pacing.QUEUE_HEAD)


def test_limits_act_only_under_tests_dir():
    inside = types.SimpleNamespace(path=pathlib.Path(TESTS_DIR, "test_unet.py"))
    outside = types.SimpleNamespace(path=pathlib.Path(TESTS_DIR).parent / "portbench" / "test_x.py")
    assert tier1_pacing._limited(inside) and not tier1_pacing._limited(outside)


def test_other_dist_modes_keep_xdist_scheduling():
    for dist in ("load", "loadscope", "each", "no"):
        config = types.SimpleNamespace(getvalue=lambda name, dist=dist: dist)
        assert tier1_pacing.pytest_xdist_make_scheduler(config=config, log=None) is None
