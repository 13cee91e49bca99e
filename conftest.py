"""Test selection shared by every test directory of the repo."""
import pytest


@pytest.hookimpl(tryfirst=True)  # before the -m deselection
def pytest_collection_modifyitems(config, items):
    """Mark tests/test_pallas_interpret.py's tests slow: each compiles an
    unrolled Pallas kernel body under the interpreter for 10+ minutes on XLA
    CPU (the file's docstring), and the tier-1 command's own -m 'not slow'
    replaces pytest.ini's -m "not interpret".  The other interpret tests
    (tests/test_pallas_combine.py) take seconds and stay in the tier-1 run."""
    for item in items:
        if item.path.name == "test_pallas_interpret.py":
            item.add_marker(pytest.mark.slow)
