"""The benchmark's CPU tests: ``python -m pytest -q portbench/tests``
from the root of the repository (the card's tests, marked ``cuda``,
skip without a card)."""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for path in (str(ROOT), str(ROOT / "src")):
    if path not in sys.path:
        sys.path.insert(0, path)
