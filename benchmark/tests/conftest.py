"""The benchmark's own tests (run them from the checkout's root with
``python -m pytest benchmark/tests -q``; the card's with ``-m cuda`` on a
machine with one). The harness's modules import as the run does: from the
benchmark's folder and the checkout's root."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]
