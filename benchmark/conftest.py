"""Tests of the benchmark (CPU; the ones marked `cuda` need a card). The
harness's modules import as `mtsbench` and `reference`, the program from the
checkout's root."""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
for p in (HERE, os.path.dirname(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)
