"""The benchmark's tests: the checkout's root on the path, so
``fspbench`` and the program import as the harness imports them."""
import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
