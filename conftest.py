"""Loads the tier-1 suite's pacing hooks (tests/tier1_pacing.py: the units
of work xdist hands out, their order, and the time limit of every test).
pytest reads this file before tests/conftest.py; the hooks act only on the
tests under tests/."""

import importlib.util
import pathlib
import sys


def _pacing():
    if "tier1_pacing" not in sys.modules:
        path = pathlib.Path(__file__).parent / "tests" / "tier1_pacing.py"
        spec = importlib.util.spec_from_file_location("tier1_pacing", path)
        sys.modules["tier1_pacing"] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules["tier1_pacing"])
    return sys.modules["tier1_pacing"]


pytest_configure_node = _pacing().pytest_configure_node
pytest_runtest_call = _pacing().pytest_runtest_call
pytest_runtest_setup = _pacing().pytest_runtest_setup
pytest_xdist_make_scheduler = _pacing().pytest_xdist_make_scheduler
