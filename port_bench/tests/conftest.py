"""The benchmark's own CPU tests (``python -m pytest port_bench/tests``).
Tests that need a card carry the ``cuda`` marker and decide inside the
test whether one is there."""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
