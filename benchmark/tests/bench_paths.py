"""Puts benchmark/ (the harness and the reference) and the checkout's root
(the port) on sys.path for the harness's tests."""

import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
for p in (str(BENCH_DIR.parent), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)
