"""The tier-1 command's ``-m 'not slow'`` replaces pytest.ini's
``-m "not interpret"``: the repo's conftest.py marks the interpreter-mode
Pallas tests of test_pallas_interpret.py slow, so tier-1 leaves them out,
while ``-m interpret`` still runs them and ``-m 'not slow'`` deselects none
of the quick interpret tests of test_pallas_combine.py.  Collection only: no
kernel is compiled."""
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _collect(marks, path):
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q",
         "-p", "no:cacheprovider", "-m", marks, path],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert run.returncode in (0, 5), run.stdout[-2000:] + run.stderr[-2000:]
    return run.stdout


# want: how many tests are collected, or None for "none deselected"
@pytest.mark.parametrize("marks,path,want", [
    ("not slow", "tests/test_pallas_interpret.py", 0),
    ("interpret", "tests/test_pallas_interpret.py", 6),
    ("not slow", "tests/test_pallas_combine.py", None),
])
def test_tier1_selection(marks, path, want):
    out = _collect(marks, path)
    if want is None:
        assert "::" in out and "deselected" not in out, out[-2000:]
    else:
        ids = [line for line in out.splitlines() if "::" in line]
        assert len(ids) == want, out[-2000:]
