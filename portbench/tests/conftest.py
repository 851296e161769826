"""The benchmark's tests import the port from the repository's ``src``,
as ``run.py`` does."""
import sys
from pathlib import Path

_REPO = Path(__file__).resolve().parents[2]
for p in (str(_REPO / "src"), str(_REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)
